"""Parity of the port on the *reference's* own levels, on the CPU: the
JAX package's tests/test_parity.py, test_parity_scripted.py (with its
bossfight duel) and test_parity_fatal.py, on procgen2_tpu_torch. One file,
so that its long runs start with the suite's first files (pytest-xdist
hands out the files with the most tests first)."""
import shutil

import numpy as np
import pytest
import torch

import procgen2_tpu_torch as pt
from procgen2_tpu_torch.games.chaser import HATCH_TIME
from procgen2_tpu_torch.tools import bots, predict
from procgen2_tpu_torch.tools import rng_oracle as O
from procgen2_tpu_torch.tools import scripted
from procgen2_tpu_torch.tools.reference_levels import host_level, reference_bank
from procgen2_tpu_torch.tools.reference_play import chaser_plan, pad, play
from procgen2_tpu_torch.utils import bank_gather
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)


pytestmark = [
    pytest.mark.skipif(
        shutil.which("g++") is None, reason="no C++ toolchain (the oracle)"
    ),
    pytest.mark.usefixtures("one_torch_thread"),
]

f32 = np.float32


# ===========================================================================
# Fixed-seed parity of the port: it plays the *reference's* levels
# (tests/test_parity.py, on procgen2_tpu_torch on the CPU).
#
# For reference seeds, the port's mt19937 oracle (tools/rng_oracle.py)
# predicts the C++ engine's level layout and the port's
# tools/reference_levels.py converts it to a Level bank; these tests
# assert (a) the converted layout is exactly what the engine loads
# (coordinate-transform checks + engine invariants) and (b) scripted
# trajectories reproduce the reference's reward/termination rules
# bit-exactly on those layouts (maze: full +10.0 episode return on the
# BFS path with terminated on the goal step, games/maze/maze.cpp:295-310;
# bossfight and climber: quiescent no-op windows yield exactly 0.0).
# ===========================================================================

SEEDS = list(range(20))
NOOP = 4


def _bank(game, seeds, **kw):
    return reference_bank(game, seeds, "cpu", **kw)


# ---------------------------------------------------------------------------
# maze: full bit-exact scripted-return parity
# ---------------------------------------------------------------------------

def test_maze_reference_layout_and_return_parity():
    env = pt.make("maze", device="cpu", mode="easy")
    bank = _bank("maze", SEEDS)
    for i, seed in enumerate(SEEDS):
        lay = O.reference_maze_layout(seed, "easy")
        level = host_level(bank, i)
        # (a) layout == what the engine loads
        D, m = lay["maze_dim"], lay["margin"]
        for ii in range(D):
            for jj in range(D):
                want = 1 if lay["wall"][ii, jj] else 0
                assert level.grid[14 - (jj + m), ii + m] == want
        gi, gj = lay["goal"]
        assert tuple(level.goal_pos) == (gi + m + 0.5, 14 - (gj + m) + 0.5)

        # (b) scripted trajectory: BFS path -> +10.0 on the goal step
        start = (int(14 - m), int(m))
        goal = (int(14 - (gj + m)), int(gi + m))
        acts = scripted.bfs_actions(level.grid, start, goal)
        assert acts is not None, f"seed {seed}: reference maze unsolvable?"
        assert len(acts) < 500  # must beat the timeout (maze.cpp:49)

        sub = bank_gather(bank, torch.tensor([i]))
        state, _ = env.reset(sub, pt.random.key(seed), 1)
        total = 0.0
        for k, a in enumerate(acts):
            state, ts = env.step(sub, state,
                                 torch.tensor([a], dtype=torch.int32))
            r = float(ts.reward[0])
            total += r
            if k < len(acts) - 1:
                assert r == 0.0 and not bool(ts.terminated[0])
        assert r == 10.0, f"seed {seed}: goal step reward {r}"
        assert bool(ts.terminated[0])
        assert total == 10.0  # bit-exact fixed-seed episode return


# ---------------------------------------------------------------------------
# layout invariants per game ("what the engine loads")
# ---------------------------------------------------------------------------

def test_chaser_reference_layouts():
    bank = _bank("chaser", SEEDS)
    for i, seed in enumerate(SEEDS):
        lay = O.reference_chaser_layout(seed, "easy")
        lvl = host_level(bank, i)
        D = 11
        # agent spawn on a free non-orb cell
        ax, ay = lay["agent_cell"]
        assert not lay["wall"][ax, ay]
        assert tuple(lvl.agent_pos) == (ax + 0.5, D - 1 - ay + 0.5)
        # counts: 3 eggs, 4 orbs (easy), pellets = free - orbs - eggs - 1
        assert lvl.egg_exists.sum() == 3
        assert lvl.orb_exists.sum() == 4
        free = int((~lay["wall"]).sum())
        assert lvl.point_grid0.sum() == free - 4 - 3 - 1
        # orbs on free cells, one per quadrant (easy)
        for cell in lay["orb_cells"]:
            assert not lay["wall"][cell // D, cell % D]
        quads = {(c // D >= D // 2) * 2 + (c % D >= D // 2)
                 for c in lay["orb_cells"]}
        assert quads == {0, 1, 2, 3}


def test_jumper_reference_layouts():
    bank = _bank("jumper", SEEDS)
    grounded = 0
    for i, seed in enumerate(SEEDS):
        lvl = host_level(bank, i)
        grid = lvl.grid
        D = grid.shape[0]
        gx, gy = float(lvl.goal_pos[0]), float(lvl.goal_pos[1])
        ax, ay = float(lvl.agent_pos[0]), float(lvl.agent_pos[1])
        # agent y sits on the cell's bottom edge (tilemap.cpp:227): the
        # spawn cell's render row is exactly int(ay)
        assert grid[int(gy), int(gx)] == 0
        assert grid[int(ay), int(ax)] == 0
        # the later vertical-wall breakup pass (tilemap.cpp:222-233) may
        # open the very cell below the spawn: a faithful reference quirk
        below = grid[min(int(ay) + 1, D - 1), int(ax)]
        assert below in (0, 1, 2)
        grounded += below in (1, 2)
        # no spike under the agent or goal (tilemap.cpp:241-242)
        assert not lvl.spike_grid[int(ay), int(ax)]
        assert not lvl.spike_grid[int(gy), int(gx)]
        # goal reachable from agent over empty cells (the reference's
        # expand_room(4) keeps the whole BFS path open)
        acts = scripted.bfs_actions(
            (grid != 0).astype(np.int8),
            (int(ay), int(ax)), (int(gy), int(gx)),
        )
        assert acts is not None
    assert grounded >= len(SEEDS) * 3 // 4  # breakup-opened spawns are rare


def test_caveflyer_reference_layouts():
    bank = _bank("caveflyer", SEEDS)
    for i, seed in enumerate(SEEDS):
        lay = O.reference_caveflyer_layout(seed, "easy")
        lvl = host_level(bank, i)
        # object classes: equal chunks (tilemap.cpp:232-236)
        assert len(lay["obstacles"]) == len(lay["targets"])
        assert len(lay["enemies"]) in (len(lay["obstacles"]),)
        assert lvl.obst_exists.sum() == len(lay["obstacles"])
        assert lvl.target_exists.sum() == len(lay["targets"])
        assert lvl.enemy_exists.sum() == len(lay["enemies"])
        # enemy speeds in [0.1, 0.2), axis-aligned (tilemap.cpp:81)
        for e in range(int(lvl.enemy_exists.sum())):
            v = lvl.enemy_vel0[e]
            mag = abs(v[0]) + abs(v[1])
            assert 0.1 <= mag < 0.2
            assert v[0] == 0.0 or v[1] == 0.0
        # goal/agent distinct empty cells
        assert lay["goal_cell"] != lay["agent_cell"]


def test_climber_reference_layouts():
    bank = _bank("climber", SEEDS, easy_mode=True)
    for i, seed in enumerate(SEEDS):
        lay = O.reference_climber_layout(seed, easy_mode=True)
        lvl = host_level(bank, i)
        assert 1 <= lay["difficulty"] <= 3
        d = lay["difficulty"]
        assert d * d + 1 <= lay["num_platforms"] <= (d + 1) ** 2 + 1
        assert lvl.point_exists.sum() == len(lay["crystals"]) >= 1
        assert lvl.mob_alive.sum() == len(lay["mobs"])
        # crystals sit one above a platform tile (tilemap.cpp:163-165)
        for (x, y) in lay["crystals"]:
            if y - 1 < 64:
                assert lay["grid"][x, y - 1] == 1  # wall_top platform


def test_coinrun_reference_layouts():
    bank = _bank("coinrun", SEEDS)
    for i, seed in enumerate(SEEDS):
        lay = O.reference_coinrun_layout(seed)
        lvl = host_level(bank, i)
        cx, cy = lay["coin_cell"]
        assert tuple(lvl.coin_pos) == (cx + 0.5, 63 - cy + 0.5)
        # the coin column is walled closed behind it (tilemap.cpp:287-291)
        assert np.all(lvl.grid[:, cx + 1:] == 2)
        # coin sits on a wall column top
        assert lay["tiles"][cx, cy - 1] in (1, 2)
        # saws/mobs sit on (then) walkable ground cells
        for (x, y) in lay["saws"]:
            assert lay["tiles"][x, y] in (0, 5)
        assert lvl.saw_alive.sum() == len(lay["saws"])
        assert lvl.mob_alive.sum() == len(lay["mobs"])


def test_bossfight_reference_layouts():
    bank = _bank("bossfight", SEEDS)
    for i, seed in enumerate(SEEDS):
        lay = O.reference_bossfight_layout(seed)
        lvl = host_level(bank, i)
        assert 0 <= len(lay["barriers"]) <= 4
        assert lvl.barrier_exists.sum() == len(lay["barriers"])
        # barriers near the bottom: y = 2.0 - U[0.7, 1.2]
        for (x, y, _tex) in lay["barriers"]:
            assert 0.8 - 1e-5 <= y <= 1.3 + 1e-5
            assert abs(x) <= 1.8 + 1e-6
        # accepted barriers pairwise non-overlapping (0.2 x 0.2 rects)
        bs = lay["barriers"]
        for a in range(len(bs)):
            for b in range(a + 1, len(bs)):
                assert (abs(bs[a][0] - bs[b][0]) >= 0.2
                        or abs(bs[a][1] - bs[b][1]) >= 0.2)
        assert abs(float(lvl.agent_pos0[0])) <= 2.0


# ---------------------------------------------------------------------------
# (b) quiescent no-op windows: reward is exactly 0.0, no termination
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("game,kw", [
    ("bossfight", {}),
    ("climber", dict(easy_mode=True)),
])
def test_reference_noop_window_zero_reward(game, kw):
    """For the first 2 env-steps from a reference spawn nothing can score
    or kill (bossfight: shield phase lasts >=180 ticks, boss fires on
    timers, common_systems.cpp:199-287; climber: agent stands on the
    floor, mobs patrol platforms above)."""
    env = pt.make(game, device="cpu", **kw)
    n = 8
    bank = _bank(game, range(n), **kw)
    state, _ = env.reset(bank, pt.random.key(0), n)
    for _ in range(2):
        state, ts = env.step(bank, state,
                             torch.full((n,), NOOP, dtype=torch.int32))
        assert np.all(ts.reward.numpy() == 0.0)
        assert not ts.terminated.numpy().any()


# ===========================================================================
# Scripted bit-exact return parity of the port for the non-maze games
# (tests/test_parity_scripted.py, on procgen2_tpu_torch on the CPU).
#
# For each game, the reference's own levels (the port's oracle and
# tools/reference_levels) are played by scripted/bot trajectories that
# *score*, and the port's per-step reward/termination sequence is
# asserted against the reference's reward rules — re-derived from the
# layout by an independent predictor where the game's kinematics permit
# (tools/bots.py, tools/predict.py), or as exact event values/counts/order
# where the trajectory is found by a closed-loop bot. The seeds, modes,
# step caps and the pinned reset key (123) are the JAX suite's.
#
# Reward-rule citations per game:
#   chaser    +0.04/point, +10 all collected   chaser.cpp:307-309
#   climber   +1/crystal, +10 all collected    climber.cpp:348-350
#   coinrun   +10 coin                         coinrun.cpp:357-371
#   jumper    +10 carrot                       jumper.cpp:362-364
#   caveflyer +3/target, +10 goal              caveflyer.cpp:330-332
#   bossfight -10 death                        bossfight.cpp:318-320
# The bossfight boss kill (+10) is the duel below.
# ===========================================================================

def _levels(bank, n):
    return [host_level(bank, i) for i in range(n)]


# ---------------------------------------------------------------------------
# chaser: full clear — every pellet (+0.04 each), orbs, completion +10
# ---------------------------------------------------------------------------

# Most scripted routes END IN ENEMY CONTACT (enemies re-decide every
# sub-step, games/chaser.py:_mob_substep): economy parity is asserted as
# exact prefixes up to death; CHASER_CLEAR_SEEDS are the rare full clears.
CHASER_SEEDS = [5, 17, 20, 21, 28, 34, 35, 36, 43, 46, 59, 71, 83, 84, 88]
CHASER_CLEAR_SEEDS = [119, 137, 261]


def test_chaser_scripted_full_clear_return_parity():
    env = pt.make("chaser", device="cpu", mode="easy")
    bank = reference_bank("chaser", CHASER_SEEDS, "cpu")

    acts, preds = [], []
    for i, seed in enumerate(CHASER_SEEDS):
        lvl = host_level(bank, i)
        a = chaser_plan(lvl)
        rew, term = bots.chaser_predict(lvl, a)
        # The predictor's economy has the reference's last-write-wins
        # sub-step quirk (chaser.cpp:297-307): observable scoring events
        # are <= the layout's point count, every nonzero is an exact 0.04
        # multiple, and the completion step pays delta*0.04 + 10.0.
        n_points = int(lvl.point_grid0.sum()) + int(lvl.orb_exists.sum())
        scoring = rew[rew != 0.0]
        assert 1 <= len(scoring) <= n_points
        assert term[-1] and not term[:-1].any()
        assert rew[-1] >= f32(10.0)  # completion bonus observed
        candidates = {f32(f32(k) * f32(0.04)) for k in range(1, 5)} | {
            f32(f32(f32(k) * f32(0.04)) + f32(10.0)) for k in range(0, 5)
        }
        assert all(r in candidates for r in scoring), seed
        acts.append(a)
        preds.append((rew, term))

    out = play(env, bank, CHASER_SEEDS, pad(acts))
    R, D = out["rewards"], out["dones"]
    for i, seed in enumerate(CHASER_SEEDS):
        rew, term = preds[i]
        n = len(rew)
        if D[: n - 1, i].any():
            # enemy contact: economy bit-exact up to the death step,
            # which pays 0.0
            end = int(np.argmax(D[:, i]))
            assert np.array_equal(R[:end, i], rew[:end]), (
                f"seed {seed}: prefix mismatch at "
                f"{np.nonzero(R[:end, i] != rew[:end])[0][:5]}"
            )
            assert R[end, i] == f32(0.0), f"seed {seed}: death reward"
        else:
            assert D[n - 1, i], f"seed {seed}: no completion"
            assert np.array_equal(R[:n, i], rew), (
                f"seed {seed}: reward sequence mismatch at "
                f"{np.nonzero(R[:n, i] != rew)[0][:5]}"
            )

    # the full-clear pool: routes that beat the enemies end to end
    bank = reference_bank("chaser", CHASER_CLEAR_SEEDS, "cpu")
    acts, preds = [], []
    for i, seed in enumerate(CHASER_CLEAR_SEEDS):
        lvl = host_level(bank, i)
        a = chaser_plan(lvl)
        acts.append(a)
        preds.append(bots.chaser_predict(lvl, a))
    out = play(env, bank, CHASER_CLEAR_SEEDS, pad(acts))
    R, D = out["rewards"], out["dones"]
    for i, seed in enumerate(CHASER_CLEAR_SEEDS):
        rew, term = preds[i]
        n = len(rew)
        assert not D[: n - 1, i].any(), f"seed {seed}: early death"
        assert D[n - 1, i], f"seed {seed}: no completion"
        assert rew[-1] >= f32(10.0)
        assert np.array_equal(R[:n, i], rew), f"seed {seed}"


# ---------------------------------------------------------------------------
# climber: scripted ascent — +1 per crystal, +10 on collecting all
# ---------------------------------------------------------------------------

CLIMBER_SEEDS = [0, 5, 7, 9, 11, 12, 13, 17, 18, 19, 22, 23, 24, 25, 28]


def test_climber_scripted_ascent_return_parity():
    env = pt.make("climber", device="cpu", easy_mode=True)
    bank = reference_bank("climber", CLIMBER_SEEDS, "cpu", easy_mode=True)
    levels = _levels(bank, len(CLIMBER_SEEDS))
    out = play(env, bank, CLIMBER_SEEDS, game="climber", levels=levels,
               max_steps=1200)
    R, D = out["rewards"], out["dones"]
    for i, seed in enumerate(CLIMBER_SEEDS):
        n_crystals = int(levels[i].point_exists.sum())
        d = D[:, i]
        assert d.any(), f"seed {seed}: never completed"
        end = int(np.argmax(d))
        r = R[: end + 1, i]
        # final crystal (+1) and all-collected (+10) share the completion
        # sub-step: exactly 11.0f (climber.cpp:348-350)
        assert r[end] == f32(11.0), f"seed {seed}: end reward {r[end]}"
        # every other scoring step is an exact whole crystal count
        mid = r[:end]
        nz = mid[mid != 0.0]
        assert all(v in (f32(1.0), f32(2.0)) for v in nz), (seed, nz)
        assert len(nz) <= n_crystals - 1
        assert not d[:end].any()


# ---------------------------------------------------------------------------
# coinrun: run right to the coin — single +10 on the coin step
# ---------------------------------------------------------------------------

COINRUN_SEEDS = [0, 1, 2, 5, 7, 9, 11, 12, 17, 19, 22, 26, 27, 31, 33]


def test_coinrun_scripted_run_right_return_parity():
    env = pt.make("coinrun", device="cpu")
    bank = reference_bank("coinrun", COINRUN_SEEDS, "cpu")
    levels = _levels(bank, len(COINRUN_SEEDS))
    out = play(env, bank, COINRUN_SEEDS, game="coinrun", levels=levels,
               max_steps=400)
    R, D, A = out["rewards"], out["dones"], out["actions"]
    for i, seed in enumerate(COINRUN_SEEDS):
        d = D[:, i]
        assert d.any(), f"seed {seed}: never reached the coin"
        end = int(np.argmax(d))
        r = R[: end + 1, i]
        # exactly one scoring event: the coin, +10.0f, terminal
        assert r[end] == f32(10.0), f"seed {seed}: end reward {r[end]}"
        assert not r[:end].any(), f"seed {seed}: stray rewards"
        assert not d[:end].any()
        # the independent re-simulation (predict.CoinrunSim), bit-exact
        pr, pt_ = predict.coinrun_predict(levels[i], A[: end + 1, i])
        assert len(pr) == end + 1, f"seed {seed}: predictor ended at " \
            f"{len(pr) - 1}, engine at {end}"
        assert np.array_equal(r, pr), f"seed {seed}: reward mismatch at " \
            f"{np.nonzero(r != pr)[0][:5]}"
        assert pt_[-1] and not pt_[:-1].any()


# ---------------------------------------------------------------------------
# jumper: BFS waypoint flight to the carrot — single +10, terminal
# ---------------------------------------------------------------------------

JUMPER_SEEDS = [0, 6, 8, 9, 11, 12, 14, 15, 19, 20, 21, 22, 25, 26, 37]


def test_jumper_scripted_carrot_return_parity():
    env = pt.make("jumper", device="cpu", mode="easy")
    bank = reference_bank("jumper", JUMPER_SEEDS, "cpu")
    levels = _levels(bank, len(JUMPER_SEEDS))
    out = play(env, bank, JUMPER_SEEDS, game="jumper", levels=levels,
               max_steps=500)
    R, D, A = out["rewards"], out["dones"], out["actions"]
    for i, seed in enumerate(JUMPER_SEEDS):
        d = D[:, i]
        assert d.any(), f"seed {seed}: never reached the carrot"
        end = int(np.argmax(d))
        r = R[: end + 1, i]
        assert r[end] == f32(10.0), f"seed {seed}: end reward {r[end]}"
        assert not r[:end].any(), f"seed {seed}: stray rewards"
        assert not d[:end].any()
        # the independent re-simulation (predict.JumperSim), bit-exact
        pr, pt_ = predict.jumper_predict(levels[i], A[: end + 1, i])
        assert len(pr) == end + 1, f"seed {seed}: predictor ended at " \
            f"{len(pr) - 1}, engine at {end}"
        assert np.array_equal(r, pr), f"seed {seed}: reward mismatch at " \
            f"{np.nonzero(r != pr)[0][:5]}"
        assert pt_[-1] and not pt_[:-1].any()


# ---------------------------------------------------------------------------
# caveflyer: shoot a target (+3 visible), fly to the goal (+10 terminal)
# ---------------------------------------------------------------------------

# Hard mode: easy levels frequently have zero targets (tilemap.cpp:232-236)
CAVEFLYER_SEEDS = [7, 9, 20, 27, 35, 36, 39, 51, 53, 68, 69, 77]


def test_caveflyer_scripted_target_and_goal_return_parity():
    env = pt.make("caveflyer", device="cpu", mode="hard")
    bank = reference_bank("caveflyer", CAVEFLYER_SEEDS, "cpu", mode="hard")
    levels = _levels(bank, len(CAVEFLYER_SEEDS))
    out = play(env, bank, CAVEFLYER_SEEDS, game="caveflyer", levels=levels,
               max_steps=900)
    R, D = out["rewards"], out["dones"]
    for i, seed in enumerate(CAVEFLYER_SEEDS):
        d = D[:, i]
        assert d.any(), f"seed {seed}: never reached the goal"
        end = int(np.argmax(d))
        r = R[: end + 1, i]
        # goal step: exactly +10.0f (or +13.0f if a kill shares the
        # sub-step), terminal (caveflyer.cpp:330-332)
        assert r[end] in (f32(10.0), f32(13.0)), \
            f"seed {seed}: end reward {r[end]}"
        # at least one VISIBLE +3 target kill; every mid scoring value
        # an exact multiple of 3.0f
        mid = r[:end]
        nz = mid[mid != 0.0]
        total_target = float(nz.sum()) + float(r[end]) - 10.0
        assert total_target >= 3.0, f"seed {seed}: no visible +3"
        assert all(v in (f32(3.0), f32(6.0)) for v in nz), (seed, nz)
        assert not d[:end].any()


# ---------------------------------------------------------------------------
# bossfight: death -10
# ---------------------------------------------------------------------------

BOSSFIGHT_NOOP_SEEDS = [1, 2, 3, 4, 5, 6, 7, 8, 9, 12]  # all die in ~170


def test_bossfight_noop_death_return_parity():
    """A stationary agent is eventually hit by a boss bullet: exactly
    one scoring step, the terminal -10.0f (bossfight.cpp:318-320), and
    0.0 everywhere before — with the exact death step independently
    predicted by predict.BossfightSim (the boss phase machine + bullet
    kinematics, common_systems.cpp:199-386, on the engine's keyed
    draws)."""
    seeds = BOSSFIGHT_NOOP_SEEDS
    env = pt.make("bossfight", device="cpu")  # hard (reference default)
    bank = reference_bank("bossfight", seeds, "cpu")
    out = play(env, bank, seeds, pad([[bots.NOOP] * 250] * len(seeds)))
    R, D = out["rewards"], out["dones"]
    preds = predict.bossfight_predict_many(
        _levels(bank, len(seeds)), out["keys0"],
        [[bots.NOOP] * 250] * len(seeds), mode="hard")
    for i, seed in enumerate(seeds):
        d = D[:, i]
        assert d.any(), f"seed {seed}: noop agent survived 250 steps?"
        end = int(np.argmax(d))
        assert R[end, i] == f32(-10.0), f"seed {seed}: {R[end, i]}"
        assert not R[:end, i].any()
        pr, pt_ = preds[i]
        assert len(pr) == end + 1, f"seed {seed}: predictor death at " \
            f"{len(pr) - 1}, engine at {end}"
        assert np.array_equal(R[: end + 1, i], pr), f"seed {seed}"
        assert pt_[-1] and not pt_[:-1].any()


# ===========================================================================
# Bossfight's boss kill on the reference's levels, on the port
# (tests/test_parity_scripted.py::test_bossfight_scripted_boss_kill_return_parity,
# on procgen2_tpu_torch on the CPU; the duel runs up to 1,500 steps).
# ===========================================================================

BOSSFIGHT_KILL_SEEDS = [0, 1, 2, 4, 5, 6, 8, 9, 10, 11]


def test_bossfight_scripted_boss_kill_return_parity():
    """Closed-loop duel through the full phase machine: hide in a
    barrier's shadow while shielded, volley while unshielded, 3 HP x 3
    rounds -> phase_index 6; exactly one scoring step, the terminal
    +10.0f, zero everywhere else (common_systems.cpp:199-287, 385-386).
    Easy mode (half bullet speed, common_systems.cpp:104) — level
    layouts are mode-independent. The predictor re-simulates the whole
    duel from the action log and the post-reset keys."""
    seeds = BOSSFIGHT_KILL_SEEDS
    env = pt.make("bossfight", device="cpu", mode="easy")
    bank = reference_bank("bossfight", seeds, "cpu")
    levels = [host_level(bank, i) for i in range(len(seeds))]
    out = play(env, bank, seeds, game="bossfight", levels=levels,
               max_steps=1500)
    R, D, A = out["rewards"], out["dones"], out["actions"]
    ends = []
    for i, seed in enumerate(seeds):
        d = D[:, i]
        assert d.any(), f"seed {seed}: boss survived"
        end = int(np.argmax(d))
        assert R[end, i] == f32(10.0), f"seed {seed}: end {R[end, i]}"
        assert not R[:end, i].any(), f"seed {seed}: stray rewards"
        assert not d[:end].any()
        ends.append(end)
    preds = predict.bossfight_predict_many(
        levels, out["keys0"], [A[: e + 1, i] for i, e in enumerate(ends)],
        mode="easy")
    for i, (seed, end) in enumerate(zip(seeds, ends)):
        pr, pt_ = preds[i]
        assert len(pr) == end + 1, f"seed {seed}: predictor ended at " \
            f"{len(pr) - 1}, engine at {end}"
        assert np.array_equal(R[: end + 1, i], pr), f"seed {seed}"
        assert pt_[-1] and not pt_[:-1].any()


# ===========================================================================
# Deliberately fatal scripted runs on the port: exact death-step parity
# (tests/test_parity_fatal.py, on procgen2_tpu_torch on the CPU).
#
# Each game runs trajectories chosen to DIE on the reference's own levels
# — walking into saws/spikes/mobs/meteors — and the exact termination
# step and the 0.0 terminal reward are asserted:
#
#   * coinrun / jumper: the death step is independently predicted by the
#     scalar numpy re-simulations in tools/predict (mob patrols, spike
#     boxes), compared with exact f32 equality.
#   * chaser / climber / caveflyer: enemies are simulated only by the
#     engine, so the death steps are the JAX suite's pinned constants
#     (regression locks measured from the deterministic engine, reset key
#     123); the port must die on the same steps. The *semantics* — death
#     yields no reward and terminates (chaser.cpp:296-312,
#     climber.cpp:339-355, caveflyer.cpp:317-332) — are asserted directly,
#     plus state evidence that the agent overlaps a live hazard at the
#     recorded death step.
#
# maze has no hazards (maze.cpp:49, 308-310).
# ===========================================================================

RIGHT, JUMP_R = bots.RIGHT, 8


def _run_script(env, bank, seeds, actions, max_steps):
    """All lanes follow the same open-loop action list for max_steps."""
    out = play(env, bank, seeds, pad([actions] * len(seeds), max_steps),
               keep_states=True)
    return out["rewards"], out["dones"], out["states"]


def _assert_predicted_death(R, D, pr, pt_, seed, i):
    assert D[:, i].any(), f"seed {seed}: survived"
    end = int(np.argmax(D[:, i]))
    assert R[end, i] == f32(0.0), f"seed {seed}: death reward {R[end, i]}"
    assert not R[:end, i].any(), f"seed {seed}: stray rewards"
    assert len(pr) == end + 1, (
        f"seed {seed}: predictor death at {len(pr) - 1}, engine at {end}"
    )
    assert np.array_equal(R[: end + 1, i], pr), f"seed {seed}"
    assert pt_[-1] and not pt_[:-1].any()


# ---------------------------------------------------------------------------
# coinrun: jump-right spam lands in saw/lava/mob hazards
# ---------------------------------------------------------------------------

COINRUN_FATAL_SEEDS = [3, 6, 8, 10, 15, 16, 20, 23, 24, 25, 28, 29]


def test_coinrun_fatal_death_step_parity():
    """Blind jump-right runs die on the first hazard; death pays 0.0 and
    terminates (coinrun.cpp:357-371). Exact step from CoinrunSim."""
    env = pt.make("coinrun", device="cpu")
    bank = reference_bank("coinrun", COINRUN_FATAL_SEEDS, "cpu")
    acts = [JUMP_R] * 300
    R, D, _ = _run_script(env, bank, COINRUN_FATAL_SEEDS, acts, 150)
    for i, seed in enumerate(COINRUN_FATAL_SEEDS):
        pr, pt_ = predict.coinrun_predict(host_level(bank, i), acts)
        _assert_predicted_death(R, D, pr, pt_, seed, i)


# ---------------------------------------------------------------------------
# jumper: blind right walk into ground spikes
# ---------------------------------------------------------------------------

JUMPER_FATAL_SEEDS = [3, 6, 7, 16, 17, 27, 36, 37, 39, 43, 52, 53]


def test_jumper_fatal_death_step_parity():
    """Walking right into a spike cell terminates with 0.0
    (jumper.cpp:362-364). Exact step from JumperSim (spike rects at cell
    centers, common_systems.cpp:149-162)."""
    env = pt.make("jumper", device="cpu", mode="easy")
    bank = reference_bank("jumper", JUMPER_FATAL_SEEDS, "cpu")
    acts = [RIGHT] * 300
    R, D, _ = _run_script(env, bank, JUMPER_FATAL_SEEDS, acts, 30)
    for i, seed in enumerate(JUMPER_FATAL_SEEDS):
        pr, pt_ = predict.jumper_predict(host_level(bank, i), acts)
        _assert_predicted_death(R, D, pr, pt_, seed, i)


# ---------------------------------------------------------------------------
# chaser / climber / caveflyer: the JAX suite's pinned death steps
# ---------------------------------------------------------------------------

CHASER_FATAL = [  # easy mode, NOOP agent eaten by a patrolling enemy
    (0, 56), (2, 118), (3, 126), (6, 88), (7, 50), (8, 69),
    (9, 50), (10, 60), (11, 102), (12, 86),
]


def _np(x, i):
    return x[i].cpu().numpy()


def test_chaser_fatal_enemy_contact():
    """Enemy contact with eat_timer==0 terminates with reward 0.0
    (chaser.cpp:296-312)."""
    seeds = [s for s, _ in CHASER_FATAL]
    env = pt.make("chaser", device="cpu", mode="easy")
    bank = reference_bank("chaser", seeds, "cpu")
    R, D, states = _run_script(env, bank, seeds, [NOOP] * 200, 200)
    for i, (seed, step_pin) in enumerate(CHASER_FATAL):
        assert D[:, i].any(), f"seed {seed}: survived"
        end = int(np.argmax(D[:, i]))
        assert end == step_pin, f"seed {seed}: died at {end} != {step_pin}"
        assert R[end, i] == f32(0.0)
        assert not R[:end, i].any()  # stationary agent scores nothing
        gs = states[end].game
        pos = _np(gs.pos, i)
        mob_pos = _np(gs.mob_pos, i)
        hatched = _np(gs.hatch_timer, i) >= HATCH_TIME
        overlap = hatched & (
            (np.abs(mob_pos[:, 0] - pos[0]) < 1.0)
            & (np.abs(mob_pos[:, 1] - pos[1]) < 1.0)
        )
        assert overlap.any(), f"seed {seed}: no enemy at death position"
        assert _np(gs.eat_timer, i) == 0.0


CLIMBER_FATAL = [  # hard mode, blind jump-right into patrol mobs
    (1, 24), (3, 47), (4, 100), (5, 115), (7, 43), (8, 20),
    (9, 41), (10, 14), (14, 78), (15, 9), (17, 27), (19, 71),
]


def test_climber_fatal_mob_contact():
    """Flying-mob contact terminates with reward 0.0
    (climber.cpp:339-355; mob bounds (-0.4,-0.4,0.8,0.8) vs agent
    (-0.5,-1,1,1), common_systems.cpp:146-153)."""
    seeds = [s for s, _ in CLIMBER_FATAL]
    env = pt.make("climber", device="cpu", easy_mode=False)
    bank = reference_bank("climber", seeds, "cpu", easy_mode=False)
    R, D, states = _run_script(env, bank, seeds, [JUMP_R] * 150, 150)
    for i, (seed, step_pin) in enumerate(CLIMBER_FATAL):
        assert D[:, i].any(), f"seed {seed}: survived"
        end = int(np.argmax(D[:, i]))
        assert end == step_pin, f"seed {seed}: died at {end} != {step_pin}"
        assert R[end, i] == f32(0.0), f"seed {seed}: {R[end, i]}"
        # crystals may be collected en route (+1 each), never +10
        assert all(v in (f32(0.0), f32(1.0), f32(2.0)) for v in R[:end, i])
        gs = states[end].game
        pos = _np(gs.pos, i)
        mob_pos = _np(gs.mob_pos, i)
        mob_alive = _np(gs.level.mob_alive, i)
        overlap = mob_alive & (
            (pos[0] - 0.5 < mob_pos[:, 0] + 0.4)
            & (pos[0] + 0.5 > mob_pos[:, 0] - 0.4)
            & (pos[1] - 1.0 < mob_pos[:, 1] + 0.4)
            & (pos[1] > mob_pos[:, 1] - 0.4)
        )
        assert overlap.any(), f"seed {seed}: no mob at death position"


CAVEFLYER_FATAL = [  # hard mode, blind thrust+turn into meteors/targets
    (1, 3), (3, 1), (6, 95), (7, 95), (8, 116), (10, 115),
    (12, 95), (13, 124), (17, 11), (18, 28), (20, 14), (21, 52),
]


def test_caveflyer_fatal_hazard_contact():
    """Meteor/target/enemy contact terminates with reward 0.0
    (caveflyer.cpp:317-332; hazard rects common_systems.cpp:182-195)."""
    seeds = [s for s, _ in CAVEFLYER_FATAL]
    env = pt.make("caveflyer", device="cpu", mode="hard")
    bank = reference_bank("caveflyer", seeds, "cpu", mode="hard")
    R, D, states = _run_script(
        env, bank, seeds, [bots.UP_RIGHT] * 200, 200)
    for i, (seed, step_pin) in enumerate(CAVEFLYER_FATAL):
        assert D[:, i].any(), f"seed {seed}: survived"
        end = int(np.argmax(D[:, i]))
        assert end == step_pin, f"seed {seed}: died at {end} != {step_pin}"
        assert R[end, i] == f32(0.0), f"seed {seed}: {R[end, i]}"
        assert not R[:end, i].any(), f"seed {seed}: stray rewards"
        gs = states[end].game
        pos = _np(gs.pos, i)
        lvl = host_level(gs.level, i)

        def _rects_overlap(cx, cy, half):
            return (
                (pos[0] - 0.4 < cx + half) & (pos[0] + 0.4 > cx - half)
                & (pos[1] - 0.4 < cy + half) & (pos[1] + 0.4 > cy - half)
            )

        enemy_pos = _np(gs.enemy_pos, i)
        hit = (
            (lvl.obst_exists & _rects_overlap(
                lvl.obst_pos[:, 0], lvl.obst_pos[:, 1], 0.25)).any()
            or (_np(gs.target_alive, i) & _rects_overlap(
                lvl.target_pos[:, 0], lvl.target_pos[:, 1], 0.25)).any()
            # enemies advance within the killing sub-step after the
            # (pre-move) contact test — allow their one-sub-step drift
            or (lvl.enemy_exists & _rects_overlap(
                enemy_pos[:, 0], enemy_pos[:, 1], 0.4 + 0.2)).any()
        )
        assert hit, f"seed {seed}: no hazard at death position"
