"""The port's data-parallel env (procgen2_tpu_torch/dist/vec.py) on the
CPU, one process (W = 1), against the JAX package's `make_vec` on its
8-device virtual CPU mesh (tests/test_dist.py's shape: maze easy, 16
envs, 8 levels), bitwise: the bank from fold_in(key, 17), the reset's
obs and state, 3 steps under the same actions with a goal lane and a
timeout lane ending on the first, `metrics` at each step, and
`rollout(venv, ...)`'s buffer. Then a W = 1 ShardedEnv against the
port's plain Environment on coinrun, the checks that raise, and
`init_multihost`'s arguments. Two real processes over gloo:
tests/test_torch_multihost.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import game_lanes
import procgen2_tpu_torch as pt
from procgen2_tpu.dist import make_vec as jmake_vec
from procgen2_tpu.dist import rollout as jrollout
from procgen2_tpu_torch import random as R
from procgen2_tpu_torch.dist import (ShardedEnv, init_multihost, local_slice,
                                     make_vec, rollout, vec)
from torch_parity import np_tree, same, same_tree
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N, LEVELS, STEPS = 16, 8, 3
FIELDS = ("obs", "actions", "rewards", "dones", "ep_returns", "ep_lengths")


def _to_jax(st):
    wrap = jax.random.wrap_key_data
    return jax.tree.map(jnp.asarray, st.replace(
        rng=wrap(st.rng), game=st.game.replace(rng=wrap(st.game.rng))))


@pytest.fixture(scope="module")
def runs():
    """Both packages' make_vec from key(0); after the reset lane 0 is put
    on its goal and lane 1 at its last step (chip_smoke's maze placement,
    both holding still first), then STEPS steps of the same actions."""
    jv = jmake_vec("maze", num_envs=N, num_levels=LEVELS, mode="easy")
    tv = make_vec("maze", N, num_levels=LEVELS, device="cpu", mode="easy")
    jst, jts = jv.reset(jax.random.key(0))
    tst, tts = tv.reset(R.key(0))
    reset = (np_tree(jst), np.asarray(jts.obs), tst, tts)
    gs, lanes = game_lanes.place_maze_lanes(tst.game, tv.env.cfg)
    tst = dataclasses.replace(tst, game=gs)
    start = np_tree(jst)
    jst = _to_jax(start.replace(game=start.game.replace(
        pos=gs.pos.numpy(), t=gs.t.numpy())))
    acts = np.random.default_rng(5).integers(0, 15, (STEPS, N)).astype(np.int32)
    acts[0, lanes] = 4
    steps = []
    for a in acts:
        jst, jts = jv.step(jst, jax.device_put(jnp.asarray(a), jv.shard))
        tst, tts = tv.step(tst, torch.from_numpy(a))
        steps.append((np_tree(jst), np_tree(jts), tst, tts,
                      {k: np.asarray(v) for k, v in jv.metrics(jts).items()},
                      tv.metrics(tts)))
    return dict(jv=jv, tv=tv, reset=reset, steps=steps, jst=jst, tst=tst)


def test_bank_matches_jax(runs):
    same_tree(np_tree(runs["jv"].bank), runs["tv"].bank)


def test_reset_matches_jax(runs):
    jst, jobs, tst, tts = runs["reset"]
    same_tree(jst, tst)
    assert tts.obs.shape == (N, 64, 64, 3) and tts.obs.dtype == torch.uint8
    np.testing.assert_array_equal(jobs, tts.obs.numpy())


@pytest.mark.parametrize("t", range(STEPS))
def test_step_matches_jax(runs, t):
    jst, jts, tst, tts, _, _ = runs["steps"][t]
    same_tree(jst, tst)
    np.testing.assert_array_equal(jts.obs, tts.obs.numpy())
    for k in ("reward", "terminated", "truncated"):
        same(getattr(jts, k), getattr(tts, k))
    for k in ("returned_episode_return", "returned_episode_length", "done"):
        same(jts.info[k], tts.info[k])


@pytest.mark.parametrize("t", range(STEPS))
def test_metrics_match_jax(runs, t):
    """Maze's rewards are 0 or 10 and N a power of two, so every sum and
    mean is exact in f32 whatever the order of the adds: the port's
    metrics equal XLA's bitwise. Step 0 ends lane 0 with 10 and lane 1
    with 0."""
    *_, want, got = runs["steps"][t]
    assert set(want) == set(got)
    for k in want:
        same(want[k], got[k])
    if t == 0:
        assert int(got["episodes_done"]) == 2
        assert float(got["episode_return_mean"]) == 5.0


@pytest.fixture(scope="module")
def rollouts(runs):
    jfinal, jbuf = jrollout(runs["jv"], runs["jst"], jax.random.key(3), 4)
    tfinal, tbuf = rollout(runs["tv"], runs["tst"], R.key(3), 4)
    return np_tree(jfinal), np_tree(jbuf), tfinal, tbuf


@pytest.mark.parametrize("field", FIELDS)
def test_rollout_matches_jax(rollouts, field):
    _, jbuf, _, tbuf = rollouts
    same(getattr(jbuf, field), getattr(tbuf, field))


def test_rollout_final_state_matches_jax(rollouts):
    jfinal, _, tfinal, _ = rollouts
    same_tree(jfinal, tfinal)


def test_one_process_equals_the_plain_environment():
    """W = 1: the ShardedEnv's bank is generate_bank(fold_in(key, 17)),
    its reset and steps those of the port's Environment, every row."""
    env = pt.make("coinrun", device="cpu")
    venv = ShardedEnv(env, 8, num_levels=8)
    assert (venv.world, venv.rank, venv.lo, venv.hi) == (1, 0, 0, 8)
    vst, vts = venv.reset(R.key(4))
    bank = env.generate_bank(R.fold_in(R.key(4), 17), 8)
    st, ts = env.reset(bank, R.key(4), 8)
    pt.utils.tree_map(lambda a, b: None if torch.equal(a, b) else
                      pytest.fail("bank differs"), venv.bank, bank)
    assert torch.equal(vts.obs, ts.obs)
    for i in range(2):
        a = R.randint(R.key(10 + i), (8,), 0, 15)
        vst, vts = venv.step(vst, a)
        st, ts = env.step(bank, st, a)
        assert torch.equal(vts.obs, ts.obs)
        assert torch.equal(vts.reward, ts.reward)
    pt.utils.tree_map(lambda a, b: None if torch.equal(a, b) else
                      pytest.fail("state differs"), vst, st)
    rows, start = local_slice(vts.reward, venv)
    assert start == 0 and np.array_equal(rows, vts.reward.numpy())
    assert local_slice(vts.reward)[1] == 0


def test_bank_key_and_start_level():
    """An explicit bank key, and a level set starting at start_level:
    level i keyed fold_in(bank_key, start_level + i)."""
    env = pt.make("maze", device="cpu", mode="easy")
    venv = ShardedEnv(env, 4, num_levels=3, start_level=5)
    venv.reset(R.key(1), bank_key=R.key(2))
    want = env.generate_bank(R.key(2), 8)
    pt.utils.tree_map(lambda a, b: None if torch.equal(a, b[5:]) else
                      pytest.fail("level set differs"), venv.bank, want)


def test_checks_raise(monkeypatch):
    venv = ShardedEnv(pt.make("maze", device="cpu", mode="easy"), 4, 2)
    with pytest.raises(RuntimeError, match="reset"):
        venv.bank
    with pytest.raises(RuntimeError, match="reset"):
        venv.step(None, torch.zeros(4, dtype=torch.int32))
    monkeypatch.setattr(vec, "_group_shape", lambda group=None: (2, 1))
    with pytest.raises(ValueError, match="divide over 2"):
        ShardedEnv(pt.make("maze", device="cpu"), 7, 2)
    assert ShardedEnv(pt.make("maze", device="cpu"), 8, 2).lo == 4


def test_init_multihost_arguments(monkeypatch):
    """The JAX-style arguments become init_process_group's: gloo on the
    CPU, NCCL for the card (which must exist); without arguments the
    launcher's environment variables serve (init_method unset)."""
    calls = []
    monkeypatch.setattr(vec.dist, "init_process_group",
                        lambda **kw: calls.append(kw))
    init_multihost("localhost:1234", num_processes=2, process_id=1,
                   device="cpu")
    init_multihost(device="cpu")
    assert calls == [dict(backend="gloo", init_method="tcp://localhost:1234",
                          world_size=2, rank=1), dict(backend="gloo")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            init_multihost("localhost:1234", num_processes=2, process_id=0)
