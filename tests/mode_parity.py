"""A game's main path at a config other than its default (the Procgen
benchmark's hard distribution, `memory`, `easy_mode`, the level features
off), held against the JAX package's, bitwise: the level bank, the
reset's states and frames, then T `Environment.step`s under the same
actions, every step's state, reward, termination, truncation, info and
`observe_batch` frame.

Both Environments start from the same keys. After the reset the lanes
are placed as chip_smoke.py places them on the card (game_lanes.MODE_CASES): a
goal lane and, where the level has one, a hazard lane, which end their
episodes on the first step, so the auto-reset's draw from the bank is
held too. The JAX render runs on its TPU path: the scene kernel
(`scene_tpu_raw`) and the stamp kernel (`composite_tpu`) in interpret
mode, which B1 and B3 replace."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import game_lanes
import jax_reference as JR
import procgen2_tpu_torch as pt
from procgen2_tpu_torch.utils import convert
from render_parity import games, np_tree
from torch_parity import same, same_tree

N, NUM_LEVELS, T = 8, 8, 8


def _placed(name, place, start):
    """The numpy EnvState `start` with the lanes placed by `place` (the
    fields the placement changed, taken from the port's placed state)."""
    tg = games(name)[1]
    before = convert.state(tg, start.game, "cpu")
    after, lanes = place(before, N)
    moved = {f.name: getattr(after, f.name).numpy().astype(
        getattr(start.game, f.name).dtype)
        for f in dataclasses.fields(tg.State) if f.name != "level"
        and not torch.equal(getattr(before, f.name), getattr(after, f.name))}
    return start.replace(game=start.game.replace(**moved)), lanes


def _to_jax(st):
    wrap = jax.random.wrap_key_data
    return jax.tree.map(jnp.asarray, st.replace(
        rng=wrap(st.rng), game=st.game.replace(rng=wrap(st.game.rng))))


@functools.lru_cache(maxsize=None)
def env_run(label):
    """Both Environments of game_lanes.MODE_CASES[label] from the same
    keys: bank of NUM_LEVELS, reset of N envs, the lanes placed as on the
    card, T steps under the same random actions, each rendered. One run
    per label and process, whichever module's fixture asks first."""
    name, kw, place, _ = game_lanes.MODE_CASES[label]
    kw = tuple(sorted(kw.items()))
    jenv, tenv = JR.env(name, kw, tpu=True), pt.make(name, device="cpu",
                                                      **dict(kw))
    jbank = JR.bank(name, kw, seed=7, n=NUM_LEVELS)
    tbank = tenv.generate_bank(pt.random.key(7), NUM_LEVELS)
    jst, jts = jenv.reset(jbank, jax.random.key(8), num_envs=N)
    tst, tts = tenv.reset(tbank, pt.random.key(8), N)
    reset = (np_tree(jst), np.asarray(jts.obs), tst, tts)
    start, lanes = _placed(name, place, np_tree(jst))
    jst = _to_jax(start)
    tst = convert.env_state(tenv.game, start, "cpu")
    actions = np.random.default_rng(3).integers(0, 15, (T, N)).astype(
        np.int32)
    steps = []
    for t in range(T):
        jst, jts = jenv.step(jbank, jst, jnp.asarray(actions[t]))
        tst, tts = tenv.step(tbank, tst, torch.from_numpy(actions[t]))
        steps.append((np_tree(jst), np_tree(jts), tst, tts))
    return dict(jbank=np_tree(jbank), tbank=tbank, reset=reset, steps=steps,
                lanes=lanes)


# The tests each test_torch_mode_*.py file imports, beside its own `run`
# fixture (one env_run per config label)

def test_bank_and_reset_match(run):
    same_tree(run["jbank"], run["tbank"])
    jst, jobs, tst, tts = run["reset"]
    same_tree(jst, tst)
    assert tts.obs.shape == (N, 64, 64, 3) and tts.obs.dtype == torch.uint8
    np.testing.assert_array_equal(jobs, tts.obs.numpy())


@pytest.mark.parametrize("t", range(T))
def test_step_matches(run, t):
    jst, jts, tst, tts = run["steps"][t]
    same_tree(jst, tst)
    np.testing.assert_array_equal(jts.obs, tts.obs.numpy())
    for k in ("reward", "terminated", "truncated"):
        same(getattr(jts, k), getattr(tts, k))
    assert set(jts.info) == set(tts.info)
    for k in jts.info:
        same(jts.info[k], tts.info[k])


def test_placed_lanes_end_and_restart(run):
    """The placed lanes end on step 0 and restart on a bank level."""
    _, _, tst, tts = run["steps"][0]
    for lane in run["lanes"]:
        assert bool(tts.terminated[lane])
        assert int(tst.ep_length[lane]) == 0 and int(tst.game.t[lane]) == 0
