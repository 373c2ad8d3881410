"""The port's plug-in surface: `procgen2_tpu_torch.make(module)` takes any
module of the batched game protocol (procgen2_tpu_torch/core/env.py), as
the JAX package's `make` takes any module of its own protocol
(tests/test_protocol.py). `check_module` drives a module through the
whole Environment: bank, reset, auto-resetting steps, both renders.

The port's wave game (procgen2_tpu_torch/examples/wave_game.py) is held
against the JAX wave game (examples/wave_game.py) run through the JAX
package's Environment, bitwise: bank, obs, rewards and terminations of 8
envs over 45 steps, past the horizon of 10.0 (40 steps) and its
auto-reset; and it round-trips through a checkpoint."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import procgen2_tpu as pg
import procgen2_tpu_torch as pt
from examples import wave_game as jwave
from procgen2_tpu_torch import random as R
from procgen2_tpu_torch.core.env import Environment
from procgen2_tpu_torch.examples import wave_game
from torch_parity import np_tree, same, same_tree
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PROTOCOL = ("Config", "Level", "State", "generate", "reset", "step",
            "observe_batch", "observe", "obs_space", "action_space")


def check_module(mod, cfg=None, num_levels=4, num_envs=8, steps=5):
    """Protocol conformance of a batched game module on the CPU: the
    protocol's names, a hashable Config dataclass, then the Environment:
    a bank of `num_levels` (every leaf's leading dim), a reset of
    `num_envs` (obs shape and dtype as the obs space says), `steps`
    auto-resetting steps (reward f32 [N], terminated bool [N]) and the
    exact render. Returns the final (state, timestep)."""
    for name in PROTOCOL:
        assert hasattr(mod, name), f"protocol name missing: {name}"
    cfg = mod.Config() if cfg is None else cfg
    assert dataclasses.is_dataclass(cfg)
    hash(cfg)
    env = (pt.make(mod, device="cpu") if cfg == mod.Config()
           else Environment(mod, cfg, "cpu"))
    bank = env.generate_bank(R.key(0), num_levels)
    assert all(x.shape[0] == num_levels for x in pt.utils.tree.tree_leaves(bank))
    state, ts = env.reset(bank, R.key(1), num_envs)
    space = env.observation_space()["screen"]
    assert tuple(ts.obs.shape) == (num_envs,) + tuple(space.shape)
    assert ts.obs.dtype == torch.uint8
    for t in range(steps):
        act = torch.full((num_envs,), t % 15, dtype=torch.int32)
        state, ts = env.step(bank, state, act)
        assert ts.reward.shape == (num_envs,)
        assert ts.reward.dtype == torch.float32
        assert ts.terminated.shape == (num_envs,)
        assert ts.terminated.dtype == torch.bool
    frame = env.render(state, 64, 1)
    assert frame.shape == (64, 64, 3) and frame.dtype == torch.uint8
    return state, ts


@pytest.mark.parametrize("mod", ["wave", "maze"])
def test_conformance(mod):
    """The example module, and a built-in game through the same checker."""
    check_module(wave_game if mod == "wave" else
                 pt.make("maze", device="cpu").game)


def test_make_takes_a_module_or_a_name():
    env = pt.make(wave_game, device="cpu", horizon=5.0)
    assert env.game is wave_game and env.cfg == wave_game.Config(horizon=5.0)
    assert pt.make("maze", device="cpu").game.NAME == "maze"
    with pytest.raises(ValueError, match="unknown game"):
        pt.make("wave", device="cpu")


def test_wave_game_matches_reference_example():
    """The C example's math (test_env.c:85-105): obs cos(t + 0.5 i),
    reward sin(t) before the step, dt 0.25, terminated at t >= 10, on
    game step 40; stepping on past the horizon keeps it terminated."""
    cfg = wave_game.Config()
    level = wave_game.generate(cfg, R.split(R.key(0), 1))
    state = wave_game.reset(cfg, level, R.split(R.key(1), 1))
    np.testing.assert_allclose(
        wave_game.wave(cfg, state)[0].numpy(),
        np.cos(0.5 * np.arange(16, dtype=np.float32)), rtol=1e-6)
    t = 0.0
    for k in range(1, 41):
        state, r, term, _ = wave_game.step(cfg, state, torch.tensor([4]))
        assert float(r[0]) == pytest.approx(np.sin(np.float32(t)), abs=1e-7)
        t += 0.25
        assert bool(term[0]) == (k == 40), f"step {k}"
    state, r, term, _ = wave_game.step(cfg, state, torch.tensor([0]))
    assert bool(term[0])


STEPS = 45


@pytest.fixture(scope="module")
def wave_runs():
    """The JAX wave game through the JAX Environment and the port's
    through its own, from the same keys and actions: 8 envs on a 4-level
    bank, STEPS steps."""
    n = 8
    jenv = pg.make(jwave)
    tenv = pt.make(wave_game, device="cpu")
    jbank = jenv.generate_bank(jax.random.key(0), num_levels=4)
    tbank = tenv.generate_bank(R.key(0), 4)
    jst, jts = jenv.reset(jbank, jax.random.key(1), num_envs=n)
    tst, tts = tenv.reset(tbank, R.key(1), n)
    out = [(np_tree(jst), np_tree(jts), tst, tts)]
    actions = np.random.default_rng(0).integers(0, 15, (STEPS, n))
    for a in actions.astype(np.int32):
        jst, jts = jenv.step(jbank, jst, jnp.asarray(a))
        tst, tts = tenv.step(tbank, tst, torch.from_numpy(a))
        out.append((np_tree(jst), np_tree(jts), tst, tts))
    return dict(jbank=np_tree(jbank), tbank=tbank, steps=out, jenv=jenv,
                tenv=tenv, jst=jst, tst=tst)


def test_wave_bank_matches_jax(wave_runs):
    same_tree(wave_runs["jbank"], wave_runs["tbank"])
    assert len({float(r) for *_, tts in wave_runs["steps"]
                for r in tts.reward}) > 10  # the wave moves


@pytest.mark.parametrize("t", range(STEPS + 1))
def test_wave_step_matches_jax(wave_runs, t):
    """State, obs, reward and termination at step t (0 is the reset; 40
    ends every episode at the horizon and restarts it)."""
    jst, jts, tst, tts = wave_runs["steps"][t]
    same_tree(jst, tst)
    np.testing.assert_array_equal(jts.obs, tts.obs.numpy())
    for k in ("reward", "terminated"):
        same(getattr(jts, k), getattr(tts, k))
    assert bool(tts.terminated.all()) == (t == 40)


def test_wave_render_matches_jax(wave_runs):
    """Environment.render at 128 px is the 64-px plot on both sides: the
    wave game's observe does not scale."""
    want = np.asarray(wave_runs["jenv"].render(wave_runs["jst"], 128, 2))
    got = wave_runs["tenv"].render(wave_runs["tst"], 128, 2)
    assert got.shape == (64, 64, 3)
    np.testing.assert_array_equal(want, got.numpy())


def test_wave_game_checkpoint_roundtrip(tmp_path):
    """A wave-game state and bank saved mid-run restore and continue bit
    for bit as the live ones (the JAX test_protocol.py counterpart)."""
    from procgen2_tpu_torch.utils import checkpoint

    env = pt.make(wave_game, device="cpu")
    bank = env.generate_bank(R.key(0), 4)
    state, _ = env.reset(bank, R.key(1), 8)
    for i in range(3):
        state, _ = env.step(bank, state, torch.full((8,), i, dtype=torch.int32))
    p = str(tmp_path / "wave.npz")
    checkpoint.save(p, state=state, bank=bank)
    res = checkpoint.restore(p, state=state, bank=bank)
    sa, sb, rb = state, res["state"], res["bank"]
    for i in range(10):
        act = torch.full((8,), (3 * i) % 15, dtype=torch.int32)
        sa, tsa = env.step(bank, sa, act)
        sb, tsb = env.step(rb, sb, act)
        assert torch.equal(tsa.obs, tsb.obs)
        assert torch.equal(tsa.reward, tsb.reward)
    pt.utils.tree_map(lambda a, b: None if torch.equal(a, b) else
                      pytest.fail("restored run differs"), sa, sb)
