"""The port's copies of the reference-level tools held against the JAX
package's, exactly: the reference banks (tools/reference_levels.py) for
every game and mode, the scripted routes (tools/scripted.py), chaser's
route planner and predictor (tools/bots.py), and the independent
predictors of coinrun, jumper and bossfight (tools/predict.py) on the
same levels, action logs and post-reset keys; and the slice as a whole
(below), where the port's and the JAX package's closed-loop bots act on
the two engines' states."""
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax_reference as JR
import procgen2_tpu as pg
import procgen2_tpu_torch as pt
from procgen2_tpu.tools import bots as jbots
from procgen2_tpu.tools import predict as jpredict
from procgen2_tpu.tools import reference_levels as JRL
from procgen2_tpu.tools import scripted as jscripted
from procgen2_tpu_torch.tools import bots, predict, scripted
from procgen2_tpu_torch.tools import reference_levels as RL
from procgen2_tpu_torch.tools import reference_play as play
from procgen2_tpu_torch.tools.reference_play import PIN_KEY, pinned
from render_parity import np_tree
from torch_parity import same, same_tree
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)


pytestmark = [
    pytest.mark.skipif(
        shutil.which("g++") is None, reason="no C++ toolchain (the oracle)"
    ),
    pytest.mark.usefixtures("one_torch_thread"),
]

SEEDS = list(range(8))
f32 = np.float32

BANKS = (
    [("maze", {"mode": m}) for m in ("easy", "hard", "memory")]
    + [("chaser", {"mode": m}) for m in ("easy", "hard", "extreme")]
    + [("jumper", {"mode": m}) for m in ("easy", "hard", "memory")]
    + [("caveflyer", {"mode": m}) for m in ("easy", "hard", "memory")]
    + [("climber", {"easy_mode": e}) for e in (False, True)]
    + [("coinrun", {}), ("coinrun", {"easy_mode": True}),
       ("coinrun", {"allow_pit": False, "allow_crate": False,
                    "allow_dy": False, "allow_mobs": False})]
    + [("bossfight", {})]
)


def _id(game, kw):
    return "-".join([game] + [f"{k}={v}" for k, v in kw.items()])


@pytest.mark.parametrize("game,kw", BANKS, ids=[_id(*c) for c in BANKS])
def test_bank_matches_jax(game, kw):
    """Every field of the port's reference bank equals the JAX one's, in
    dtype, shape and bits; generate_reference is the bank's row."""
    want = JRL.reference_bank(game, SEEDS, **kw)
    got = RL.reference_bank(game, SEEDS, "cpu", **kw)
    for f in dataclasses.fields(got):
        same(getattr(want, f.name), getattr(got, f.name))
    one = RL.generate_reference(game, SEEDS[3], "cpu", **kw)
    row = RL.host_level(got, 3)
    for f in dataclasses.fields(one):
        np.testing.assert_array_equal(getattr(one, f.name).numpy(),
                                      getattr(row, f.name))


def test_scripted_matches_jax():
    """bfs_actions and bfs_cell_path on the maze levels (agent to goal)
    and the jumper levels (agent to goal over empty cells)."""
    for game, kw in (("maze", {"mode": "easy"}), ("maze", {"mode": "hard"}),
                     ("jumper", {"mode": "easy"})):
        bank = RL.reference_bank(game, range(20), "cpu", **kw)
        for i in range(20):
            lvl = RL.host_level(bank, i)
            grid = (lvl.grid != 0).astype(np.int8)
            start = (int(lvl.agent_pos[1]), int(lvl.agent_pos[0]))
            goal = (int(lvl.goal_pos[1]), int(lvl.goal_pos[0]))
            assert scripted.bfs_actions(grid, start, goal) == \
                jscripted.bfs_actions(grid, start, goal)
            assert scripted.bfs_cell_path(grid, start, goal) == \
                jscripted.bfs_cell_path(grid, start, goal)
            assert scripted.bfs_actions(grid, start, goal) is not None


def test_chaser_route_and_predictor_match_jax():
    """chaser_full_route, route_to_actions and chaser_predict on the
    scripted suite's chaser levels."""
    seeds = [5, 17, 20, 21, 28, 34, 35, 36, 119, 137, 261]
    bank = RL.reference_bank("chaser", seeds, "cpu")
    for i in range(len(seeds)):
        lvl = RL.host_level(bank, i)
        route = bots.chaser_full_route(lvl)
        assert route == jbots.chaser_full_route(lvl)
        acts = bots.route_to_actions(route, bots.CHASER_STEPS_PER_CELL)
        assert acts == jbots.route_to_actions(route,
                                              jbots.CHASER_STEPS_PER_CELL)
        (r, t), (jr, jt) = (bots.chaser_predict(lvl, acts),
                            jbots.chaser_predict(lvl, acts))
        same(jr, torch.from_numpy(r))
        np.testing.assert_array_equal(t, jt)


def _logs(n, steps, seed, fixed):
    """Action logs: the fixed scripts and seeded random ones."""
    rng = np.random.default_rng(seed)
    return [[a] * steps for a in fixed] + [
        list(rng.integers(0, 15, steps)) for _ in range(n - len(fixed))]


@pytest.mark.parametrize("game,seeds,fixed", [
    ("coinrun", [0, 1, 3, 6, 8, 10, 12, 17], (8, 7, 4)),
    ("jumper", [0, 3, 6, 7, 8, 16, 19, 37], (7, 8, 5)),
])
def test_platformer_predictors_match_jax(game, seeds, fixed):
    """coinrun_predict / jumper_predict: the same (reward, terminated)
    streams as the JAX copies, for scripted and random action logs of
    300 steps."""
    kw = {"mode": "easy"} if game == "jumper" else {}
    bank = RL.reference_bank(game, seeds, "cpu", **kw)
    name = f"{game}_predict"
    for i, acts in enumerate(_logs(len(seeds), 300, 1, fixed)):
        lvl = RL.host_level(bank, i)
        (r, t), (jr, jt) = (getattr(predict, name)(lvl, acts),
                            getattr(jpredict, name)(lvl, acts))
        same(jr, torch.from_numpy(r))
        np.testing.assert_array_equal(t, jt)


def _jax_volley(pattern, u2, speed):
    """The JAX predictor's volley (procgen2_tpu/tools/predict.py,
    BossfightSim._substep), eager jnp ops as it runs them."""
    if pattern == -1:
        rot = jnp.pi * (1.0 + u2)
        return np.asarray(jnp.stack([jnp.cos(rot), -jnp.sin(rot)]) * speed,
                          f32)[None]
    if pattern == 0:
        rots = jnp.pi * 1.5 + (jnp.arange(5) - 2) * jnp.pi * 0.125
    elif pattern == 1:
        rots = jnp.pi * (1.25 + 8 * 0.0625) + jnp.arange(4) * jnp.pi * 0.5
    elif pattern == 2:
        rots = jnp.pi * 0.25 * jnp.arange(8) + u2 * 2 * jnp.pi
    else:
        rots = jnp.pi * (1.0 + u2) * jnp.ones(1)
    return np.asarray(jnp.stack([jnp.cos(rots), -jnp.sin(rots)], axis=1)
                      * speed, f32)


def test_bossfight_volleys_match_jax():
    """Every volley pattern's velocities, bitwise, at both bullet speeds
    over 64 draws of u2 (the JAX key's uniform draws)."""
    us = np.asarray(jax.random.uniform(jax.random.key(5), (64,)), f32)
    for speed in (f32(0.1), f32(0.05)):
        for pattern in (-1, 0, 1, 2, 3):
            for u2 in us:
                want = _jax_volley(pattern, jnp.asarray(u2), speed)
                got = predict._volley(pattern, u2, speed)
                assert got.dtype == np.float32
                np.testing.assert_array_equal(want.view(np.int32),
                                              got.view(np.int32))


def _sim_bot_log(level, key, steps, mode):
    """A duel's action log: BossfightBot acting on the port's predictor
    sim (whose fields are the engine state's), cheap to make."""
    sim = predict.BossfightSim(level, key, mode)
    bot = bots.BossfightBot(level)
    acts = []
    for _ in range(steps):
        a = bot.act(sim.pos, sim.vel, sim.boss_pos, sim.phase_index,
                    sim.bb_pos, sim.bb_vel, sim.bb_frame)
        acts.append(a)
        if sim.step(a)[1]:
            break
    return acts


def test_bossfight_predictor_matches_jax():
    """bossfight_predict from the post-reset keys of both engines (the
    port's int64 words equal the JAX key's uint32 words): a stationary
    agent's death (hard) and a bot's duel log (easy, up to 400 steps:
    shield bounces, volleys, boss damage), the same streams as the JAX
    predictor."""
    seeds = [1, 2, 4]
    bank_np = JRL.reference_bank("bossfight", seeds)
    bank = RL.reference_bank("bossfight", seeds, "cpu")
    for mode in ("hard", "easy"):
        jenv = pg.make("bossfight", mode=mode)
        jst = jenv.reset_pinned(jax.tree.map(jnp.asarray, bank_np),
                                jax.random.key(PIN_KEY),
                                jnp.asarray(seeds, jnp.uint32))
        st = pinned(pt.make("bossfight", device="cpu", mode=mode), bank,
                    seeds)
        same(jax.random.key_data(jst.game.rng), st.game.rng)
        for i in range(len(seeds)):
            lvl = RL.host_level(bank, i)
            acts = ([bots.NOOP] * 250 if mode == "hard" else
                    _sim_bot_log(lvl, st.game.rng[i], 400, mode))
            r, t = predict.bossfight_predict(lvl, st.game.rng[i], acts, mode)
            jr, jt = jpredict.bossfight_predict(
                jax.tree.map(lambda x: np.asarray(x[i]), bank_np),
                jst.game.rng[i], acts, mode=mode)
            same(jr, torch.from_numpy(r))
            np.testing.assert_array_equal(t, jt)


# ===========================================================================
# The slice as a whole against the JAX package: each game on a bank of
# the reference's own levels (8 seeds of its parity suite), the port's
# bots and the JAX package's each acting on their own engine's states (or
# the scripted plans of chaser and maze), 32 `Environment.step`s from the
# same pinned key. Every step's actions, state, reward, termination,
# truncation, info and `observe_batch` frame must be equal, bitwise. The
# JAX render runs on its TPU path, its kernels (B1 `scene_tpu_raw`, B3
# `composite_tpu`) in interpret mode, as tests/mode_parity.py runs it.
# ===========================================================================

STEPS = 32
# game -> (config, the first 8 seeds of its parity test's list)
CASES = {
    "coinrun": ({}, [0, 1, 2, 5, 7, 9, 11, 12]),
    "bossfight": ({"mode": "easy"}, [0, 1, 2, 4, 5, 6, 8, 9]),
    "climber": ({"easy_mode": True}, [0, 5, 7, 9, 11, 12, 13, 17]),
    "caveflyer": ({"mode": "hard"}, [7, 9, 20, 27, 35, 36, 39, 51]),
    "jumper": ({"mode": "easy"}, [0, 6, 8, 9, 11, 12, 14, 15]),
    "chaser": ({"mode": "easy"}, [5, 17, 20, 21, 28, 34, 35, 36]),
    "maze": ({"mode": "easy"}, [0, 1, 2, 3, 4, 5, 6, 7]),
}
PLANS = {"maze": play.maze_plan, "chaser": play.chaser_plan}


def _layout_kw(game, cfg):
    return {} if game == "bossfight" else cfg  # layouts ignore its mode


@pytest.mark.parametrize("game", list(CASES))
def test_reference_slice_matches_jax(game):
    cfg, seeds = CASES[game]
    n = len(seeds)
    jbank_np = JRL.reference_bank(game, seeds, **_layout_kw(game, cfg))
    tbank = RL.reference_bank(game, seeds, "cpu", **_layout_kw(game, cfg))
    levels = [RL.host_level(tbank, i) for i in range(n)]
    jenv = JR.env(game, tuple(sorted(cfg.items())), tpu=True)
    tenv = pt.make(game, device="cpu", **cfg)
    jbank = jax.tree.map(jnp.asarray, jbank_np)
    jst = jenv.reset_pinned(jbank, jax.random.key(play.PIN_KEY),
                            jnp.asarray(seeds, jnp.uint32))
    tst = play.pinned(tenv, tbank, seeds)
    same_tree(np_tree(jst), tst)
    if game in PLANS:
        plan = play.pad([PLANS[game](lvl) for lvl in levels], STEPS)
    else:
        tbot = play.make_bots(game, levels)
        jbot = [getattr(jbots, type(b).__name__)(lvl)
                for b, lvl in zip(tbot, levels)]
        fields = play.BOTS[game][1]
    done = np.zeros(n, bool)
    for t in range(STEPS):
        if game in PLANS:
            a = plan[t]
        else:
            a = play.bot_actions(tbot, play.read(tst.game, fields, n),
                                 done)
            ja = play.bot_actions(
                jbot, [np.asarray(getattr(jst.game, f)) for f in fields],
                done)
            np.testing.assert_array_equal(a, ja, err_msg=f"step {t}")
        jst, jts = jenv.step(jbank, jst, jnp.asarray(a))
        tst, tts = tenv.step(tbank, tst, torch.from_numpy(a))
        same_tree(np_tree(jst), tst)
        np.testing.assert_array_equal(np.asarray(jts.obs),
                                      tts.obs.numpy(), err_msg=f"step {t}")
        for k in ("reward", "terminated", "truncated"):
            same(getattr(jts, k), getattr(tts, k))
        assert set(jts.info) == set(tts.info)
        for k in jts.info:
            same(jts.info[k], tts.info[k])
        done |= tts.terminated.numpy()
