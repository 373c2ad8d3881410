"""The port's Gymnasium adapter (procgen2_tpu_torch/core/gym_adapter.py)
against the JAX package's `GymEnv` on the CPU, given the same seed: obs,
rewards, terminations and truncations bitwise over 30 steps; dict
actions; `reset(options={"seed": ...})`; the terminal-frame semantics of
`test_tools.py::test_gym_adapter_terminal_frame_semantics`; every game
constructs and steps. Maze easy where the game does not matter."""
import numpy as np
import pytest

import procgen2_tpu as pg
import procgen2_tpu_torch as pt
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

STEPS = 30


def _pair(**kw):
    kw = dict(dict(mode="easy", num_levels=8, seed=0), **kw)
    return pg.GymEnv("maze", **kw), pt.GymEnv("maze", device="cpu", **kw)


def _same_step(j, t):
    jo, jr, jt, jtr, _ = j
    to, tr, tt, ttr, _ = t
    np.testing.assert_array_equal(jo["screen"], to["screen"])
    assert to["screen"].dtype == np.uint8
    assert (jr, jt, jtr) == (tr, tt, ttr)


@pytest.fixture(scope="module")
def pair():
    return _pair(timeout=10)  # episodes end within the 30 steps


def test_gym_steps_match_jax(pair):
    jenv, tenv = pair
    jo, _ = jenv.reset(seed=3)
    to, _ = tenv.reset(seed=3)
    np.testing.assert_array_equal(jo["screen"], to["screen"])
    actions = np.random.default_rng(1).integers(0, 15, STEPS)
    ends = 0
    for a in actions:
        j, t = jenv.step(int(a)), tenv.step(int(a))
        _same_step(j, t)
        ends += j[2]
        if j[2]:  # the caller resets a finished episode, as the reference
            jo, _ = jenv.reset()
            to, _ = tenv.reset()
            np.testing.assert_array_equal(jo["screen"], to["screen"])
    assert ends  # the run crossed a reset


def test_gym_dict_actions_and_reset_options_match_jax(pair):
    jenv, tenv = pair
    jo, _ = jenv.reset(options={"seed": 5})
    to, _ = tenv.reset(options={"seed": 5})
    np.testing.assert_array_equal(jo["screen"], to["screen"])
    for a in (7, 7, 5, 3):
        act = {"action": np.array([a])}
        _same_step(jenv.step(act), tenv.step(act))
    # the same options seed restarts the same episode
    again, _ = tenv.reset(options={"seed": 5})
    np.testing.assert_array_equal(again["screen"], to["screen"])


def test_gym_terminal_frame_semantics():
    """As the JAX package's test: maze's step-counter timeout keeps
    flagging terminated on the dead world (no auto-reset), and the two
    packages agree on every step of it."""
    jenv, env = _pair(timeout=5)
    jenv.reset(seed=3)
    env.reset(seed=3)
    term = False
    for _ in range(5):
        j, t = jenv.step(4), env.step(4)  # NOOP: stand on the start cell
        _same_step(j, t)
        term = t[2]
    assert term  # timeout-as-terminated quirk (maze.cpp:49-50)
    j, t = jenv.step(4), env.step(4)
    _same_step(j, t)
    assert t[2]  # no auto-reset: t counts past the timeout
    obs3, _ = env.reset()
    assert obs3["screen"].shape == (64, 64, 3)


def test_gym_render(pair):
    _, tenv = pair
    obs, _ = tenv.reset(seed=2)
    np.testing.assert_array_equal(tenv.render(), obs["screen"])
    frame = tenv.render(128)
    assert frame.shape == (128, 128, 3) and frame.dtype == np.uint8
    np.testing.assert_array_equal(
        frame, tenv._env.render(tenv._state, 128).numpy())


@pytest.mark.parametrize("game", pt.GAMES)
def test_gym_every_game_constructs(game):
    env = pt.GymEnv(game, num_levels=2, seed=0, device="cpu")
    assert env.observation_space["screen"].shape == (64, 64, 3)
    assert env.action_space["action"].nvec.tolist() == [15]
    obs, _ = env.reset()
    out = env.step(env.action_space.sample())
    assert obs["screen"].shape == out[0]["screen"].shape == (64, 64, 3)
    assert isinstance(out[1], float) and isinstance(out[2], bool)
