"""The benchmark's plain reference equals the port: at 8 envs and a few
rollouts, on both configurations, the bank, the reset, every rollout
buffer field and the final states bit for bit; and a subset of rows
follows the same trajectory as in the whole batch."""
import json

import pytest
import torch

from benchmark import check, spec, traffic
from benchmark.reference import env as ref_env
from procgen2_tpu_torch.dist import make_vec, rollout

CONFIGS = ("maze_easy", "coinrun_easy")
N, LEVELS, CALLS, T = 8, 12, 3, 8
SEED = 1  # maze: an episode ends in these calls, so auto-reset runs


def _on_the_coin(state, rows=3):
    """Coinrun: the first rows' agent on its coin, so that its episode ends
    at the next step and auto-reset runs (a copy of the state)."""
    game = state.game
    pos = game.pos.clone()
    pos[:rows] = game.level.coin_pos[:rows]
    return type(state)(game=type(game)(**{**vars(game), "pos": pos}),
                       ep_return=state.ep_return, ep_length=state.ep_length,
                       rng=state.rng)


def _config(name):
    conf = {c["name"]: c for c in spec.load_spec()["configs"]}[name]
    return json.loads((spec.ROOT / conf["file"]).read_text())


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_equals_the_port(name):
    cfg = _config(name)
    keys = traffic.Keys(SEED, "cpu")
    venv = make_vec(cfg["game"], num_envs=N, num_levels=LEVELS, device="cpu",
                    **cfg["config"])
    state, ts = venv.reset(keys.reset)
    ref = ref_env.Env(cfg["game"], cfg["config"], N, LEVELS, "cpu")
    rows = torch.arange(N)
    bank = ref.generate_bank(keys.reset)
    ref_state, ref_obs = ref.reset(bank, keys.reset, rows)
    assert check.tree_differ(venv.bank, bank) == 0
    assert check.tree_differ(state, ref_state) == 0
    assert torch.equal(ts.obs, ref_obs)
    if cfg["game"] == "coinrun":
        state, ref_state = _on_the_coin(state), _on_the_coin(ref_state)
    dones = 0
    for c in range(CALLS):
        state, buf = rollout(venv, state, keys.call(c), T)
        ref_state, ref_buf = ref.rollout(bank, ref_state, keys.call(c), T, rows)
        for f in ("obs", "actions", "rewards", "dones", "ep_returns",
                  "ep_lengths"):
            assert check.differ(getattr(buf, f), getattr(ref_buf, f)) == 0, f
        assert check.tree_differ(state, ref_state) == 0
        dones += int(buf.dones.sum())
    assert dones > 0  # auto-reset ran


@pytest.mark.parametrize("name", CONFIGS)
def test_rows_follow_their_whole_batch_trajectory(name):
    cfg = _config(name)
    keys = traffic.Keys(77, "cpu")
    ref = ref_env.Env(cfg["game"], cfg["config"], N, LEVELS, "cpu")
    bank = ref.generate_bank(keys.reset)
    whole, _ = ref.reset(bank, keys.reset, torch.arange(N))
    sub = torch.tensor([6, 1, 3])
    part, _ = ref.reset(bank, keys.reset, sub)
    whole, wbuf = ref.rollout(bank, whole, keys.call(1), 4, torch.arange(N))
    part, pbuf = ref.rollout(bank, part, keys.call(1), 4, sub)
    assert check.tree_differ(ref_env.rows_of(whole, sub), part) == 0
    assert torch.equal(wbuf.obs[:, sub], pbuf.obs)
    assert torch.equal(wbuf.rewards[:, sub], pbuf.rewards)
