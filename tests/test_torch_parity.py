"""Fixed-seed parity of the port: it plays the *reference's* levels
(tests/test_parity.py, on procgen2_tpu_torch on the CPU).

For reference seeds, the port's mt19937 oracle (tools/rng_oracle.py)
predicts the C++ engine's level layout and the port's
tools/reference_levels.py converts it to a Level bank; these tests
assert (a) the converted layout is exactly what the engine loads
(coordinate-transform checks + engine invariants) and (b) scripted
trajectories reproduce the reference's reward/termination rules
bit-exactly on those layouts (maze: full +10.0 episode return on the
BFS path with terminated on the goal step, games/maze/maze.cpp:295-310;
bossfight and climber: quiescent no-op windows yield exactly 0.0).
"""
import shutil

import numpy as np
import pytest
import torch

import procgen2_tpu_torch as pt
from procgen2_tpu_torch.tools import rng_oracle as O
from procgen2_tpu_torch.tools import scripted
from procgen2_tpu_torch.tools.reference_levels import host_level, reference_bank
from procgen2_tpu_torch.utils import bank_gather
from torch_threads import one_torch_thread  # noqa: F401


pytestmark = [
    pytest.mark.skipif(
        shutil.which("g++") is None, reason="no C++ toolchain (the oracle)"
    ),
    pytest.mark.usefixtures("one_torch_thread"),
]

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
