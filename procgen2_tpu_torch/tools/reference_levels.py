"""Reference level banks: oracle layouts -> the port's Level dataclasses
(procgen2_tpu/tools/reference_levels.py, the port's own copy).

`generate_reference(game, seed, device, ...)` replays the reference C++
engine's mt19937 draw stream for `seed` (tools/rng_oracle.py) and
converts the predicted layout into the exact `Level` the port's game
consumes. The port can then *play the reference's level*: stepping it
reproduces the reference's reward and termination rules on the
reference's own fixed-seed layouts (tests/test_torch_parity*.py).

Conversions follow each game module's coordinate convention: internal
(x, y_up) grids become render-row grids via `flip(grid.T, axis=0)`,
cells become centers `(x + 0.5, D - 1 - y + 0.5)` in world units (the
reference's own transform, e.g. games/chaser/tilemap.cpp:229).

Each `<game>_level(seed, ...)` returns the game's `Level` with numpy
leaves (one level, no leading dim); `reference_bank(game, seeds,
device, ...)` stacks them with numpy and carries the stack to `device`
once (utils/convert.py), a bank usable anywhere
`Environment.generate_bank` output is. `host_level(bank, i)` is row i
of a bank with numpy leaves, the form the bots and predictors read.
"""
from __future__ import annotations

import numpy as np

from ..utils import convert
from ..utils.tree import tree_map
from . import rng_oracle as O


def _flip_T(a):
    """(x, y_up) -> render [ry, x]."""
    return np.flip(np.asarray(a).T, axis=0)


def maze_level(seed: int, mode: str = "easy"):
    from ..games import maze as G

    lay = O.reference_maze_layout(seed, mode)
    wd = {"easy": 15, "hard": 25, "memory": 31}[mode]
    D = lay["maze_dim"]
    m = lay["margin"]
    grid = np.full((wd, wd), G.WALL, np.int8)  # render [row, x]
    wall = lay["wall"]  # maze coords (i, j)
    for i in range(D):
        for j in range(D):
            grid[wd - 1 - (j + m), i + m] = G.WALL if wall[i, j] else G.EMPTY
    gi, gj = lay["goal"]
    return G.Level(
        grid=grid,
        goal_pos=np.array([gi + m + 0.5, wd - 1 - (gj + m) + 0.5], np.float32),
        agent_pos=np.array([m + 0.5, wd - 1 - m + 0.5], np.float32),
        maze_dim=np.int32(D),
        bg_index=np.int32(lay["bg_index"]),
        bg_offset=np.float32(lay["bg_offset"]),
    )


def chaser_level(seed: int, mode: str = "easy"):
    from ..games import chaser as G

    lay = O.reference_chaser_layout(seed, mode)
    D = lay["wall"].shape[0]
    wall_xy = np.asarray(lay["wall"])  # (x, y_up)

    def center(cell):
        x, y = cell // D, cell % D
        return [x + 0.5, D - 1 - y + 0.5]

    orb_pos = np.zeros((G.MAX_ORBS, 2), np.float32)
    orb_ex = np.zeros(G.MAX_ORBS, bool)
    # oracle orb cells arrive quadrant-by-quadrant; lay them out in the
    # engine's 2-slots-per-quadrant layout
    qcount = [0, 0, 0, 0]
    for cell in lay["orb_cells"]:
        x, y = cell // D, cell % D
        q = (x >= D // 2) * 2 + (y >= D // 2)
        slot = 2 * q + qcount[q]
        qcount[q] += 1
        orb_pos[slot] = center(cell)
        orb_ex[slot] = True

    egg_pos = np.zeros((G.MAX_ENEMIES, 2), np.float32)
    egg_ex = np.zeros(G.MAX_ENEMIES, bool)
    for e, cell in enumerate(lay["egg_cells"]):
        egg_pos[e] = center(cell)
        egg_ex[e] = True

    ax, ay = lay["agent_cell"]
    point_xy = np.zeros((D, D), bool)
    for cell in lay["point_cells"]:
        point_xy[cell // D, cell % D] = True

    return G.Level(
        wall=_flip_T(wall_xy),
        orb_pos=orb_pos,
        orb_exists=orb_ex,
        egg_pos=egg_pos,
        egg_exists=egg_ex,
        agent_pos=np.array([ax + 0.5, D - 1 - ay + 0.5], np.float32),
        point_grid0=_flip_T(point_xy),
        respawn_free=point_xy,
        bg_index=np.int32(lay["bg_index"]),
        bg_offset=np.float32(lay["bg_off_x"]),
    )


def jumper_level(seed: int, mode: str = "easy"):
    from ..games import jumper as G

    lay = O.reference_jumper_layout(seed, mode)
    tiles = np.asarray(lay["tiles"]).copy()  # (x, y_up): 0/2/3
    D = tiles.shape[0]
    gx, gy = lay["goal_cell"]
    ax, ay = lay["agent_cell"]

    # spikes -> entities; tile reverts to empty; agent/goal cells are
    # cleared (games/jumper/tilemap.cpp:238-245)
    spike = tiles == 3
    spike[ax, ay] = False
    spike[gx, gy] = False
    tiles = np.where(tiles == 3, 0, tiles).astype(np.int8)

    # wall-top classification (tilemap.cpp:248-252): wall with empty above
    above_empty = np.zeros_like(tiles, bool)
    above_empty[:, :-1] = tiles[:, 1:] == G.EMPTY
    tiles = np.where(
        (tiles == G.WALL_MID) & above_empty, G.WALL_TOP, tiles
    ).astype(np.int8)

    return G.Level(
        grid=_flip_T(tiles),
        spike_grid=_flip_T(spike),
        goal_pos=np.array([gx + 0.5, D - 1 - gy + 0.5], np.float32),
        agent_pos=np.array([ax + 0.5, D - 1 - ay], np.float32),
        theme=np.int32(lay["map_theme"]),
        bg_index=np.int32(lay["bg_index"]),
        bg_offset=np.float32(lay["bg_off_x"]),
    )


def caveflyer_level(seed: int, mode: str = "easy"):
    from ..games import caveflyer as G

    cfg = G.Config(mode=mode)
    M = cfg.max_obj
    lay = O.reference_caveflyer_layout(seed, mode)
    wall_xy = np.asarray(lay["tiles"])
    D = wall_xy.shape[0]

    def center(cell):
        x, y = cell // D, cell % D
        return [x + 0.5, D - 1 - y + 0.5]

    def fill(cells, n):
        pos = np.zeros((n, 2), np.float32)
        ex = np.zeros(n, bool)
        for i, c in enumerate(cells[:n]):
            pos[i] = center(c)
            ex[i] = True
        return pos, ex

    obst_pos, obst_ex = fill(lay["obstacles"], M)
    target_pos, target_ex = fill(lay["targets"], M)
    enemy_pos = np.zeros((M, 2), np.float32)
    enemy_vel = np.zeros((M, 2), np.float32)
    enemy_ex = np.zeros(M, bool)
    for i, (cell, vx, vy) in enumerate(lay["enemies"][:M]):
        enemy_pos[i] = center(cell)
        # reference velocities live in render coords (y down), applied
        # directly to the Transform position — no flip
        enemy_vel[i] = [vx, vy]
        enemy_ex[i] = True

    gx, gy = lay["goal_cell"]
    ax, ay = lay["agent_cell"]
    return G.Level(
        wall=_flip_T(wall_xy),
        goal_pos=np.array([gx + 0.5, D - 1 - gy + 0.5], np.float32),
        agent_pos=np.array([ax + 0.5, D - 1 - ay], np.float32),
        obst_pos=obst_pos,
        obst_exists=obst_ex,
        target_pos=target_pos,
        target_exists=target_ex,
        enemy_pos0=enemy_pos,
        enemy_vel0=enemy_vel,
        enemy_exists=enemy_ex,
        bg_index=np.int32(lay["bg_index"]),
        bg_offset=np.float32(lay["bg_off_x"]),
    )


def climber_level(seed: int, easy_mode: bool = False):
    from ..games import climber as G

    lay = O.reference_climber_layout(seed, easy_mode)
    grid = np.asarray(lay["grid"], np.int8)  # [20, 64] (x, y_up), 0/1/2
    H = G.MAP_H

    mob_pos = np.zeros((G.MAX_MOBS, 2), np.float32)
    mob_sx = np.zeros(G.MAX_MOBS, np.float32)
    mob_vx = np.zeros(G.MAX_MOBS, np.float32)
    mob_al = np.zeros(G.MAX_MOBS, bool)
    for i, (x, y, sgn) in enumerate(lay["mobs"][: G.MAX_MOBS]):
        mob_pos[i] = [x + 0.5, H - 1 - y + 0.5]
        mob_sx[i] = x
        mob_vx[i] = 0.15 * sgn
        mob_al[i] = True

    pt_pos = np.zeros((G.MAX_POINTS, 2), np.float32)
    pt_ex = np.zeros(G.MAX_POINTS, bool)
    for i, (x, y) in enumerate(lay["crystals"][: G.MAX_POINTS]):
        pt_pos[i] = [x + 0.5, H - 1 - y + 0.5]
        pt_ex[i] = True

    return G.Level(
        grid=_flip_T(grid),
        mob_pos0=mob_pos,
        mob_spawn_x=mob_sx,
        mob_vx0=mob_vx,
        mob_alive=mob_al,
        point_pos=pt_pos,
        point_exists=pt_ex,
        theme=np.int32(lay["map_theme"]),
        agent_theme=np.int32(lay["agent_theme"]),
        bg_index=np.int32(lay["bg_index"]),
        difficulty=np.int32(lay["difficulty"]),
    )


def coinrun_level(seed: int, **flags):
    from ..games import coinrun as G

    lay = O.reference_coinrun_layout(seed, **flags)
    tiles = np.asarray(lay["tiles"], np.int8)  # (x, y_up), reference ids
    W = tiles.shape[0]

    saw_pos = np.zeros((G.MAX_SAWS, 2), np.float32)
    saw_al = np.zeros(G.MAX_SAWS, bool)
    for i, (x, y) in enumerate(lay["saws"][: G.MAX_SAWS]):
        saw_pos[i] = [x + 0.5, W - 1 - y + 0.5]
        saw_al[i] = True

    mob_pos = np.zeros((G.MAX_MOBS, 2), np.float32)
    mob_vx = np.zeros(G.MAX_MOBS, np.float32)
    mob_var = np.zeros(G.MAX_MOBS, np.int8)
    mob_al = np.zeros(G.MAX_MOBS, bool)
    for i, (x, y, kind, vx) in enumerate(lay["mobs"][: G.MAX_MOBS]):
        mob_pos[i] = [x + 0.5, W - 1 - y + 0.5]
        mob_vx[i] = vx
        mob_var[i] = kind
        mob_al[i] = True

    cx, cy = lay["coin_cell"]
    return G.Level(
        grid=_flip_T(tiles),
        crate_variant=_flip_T(np.asarray(lay["crate_types"], np.int8)),
        coin_pos=np.array([cx + 0.5, W - 1 - cy + 0.5], np.float32),
        saw_pos=saw_pos,
        saw_alive=saw_al,
        mob_pos0=mob_pos,
        mob_vx0=mob_vx,
        mob_variant=mob_var,
        mob_alive=mob_al,
        theme=np.int32(lay["map_theme"]),
        agent_theme=np.int32(lay["agent_theme"]),
        bg_index=np.int32(lay["bg_index"]),
        difficulty=np.int32(lay["difficulty"]),
    )


def bossfight_level(seed: int):
    from ..games import bossfight as G

    lay = O.reference_bossfight_layout(seed)
    bpos = np.zeros((G.MAX_BARRIERS, 2), np.float32)
    bex = np.zeros(G.MAX_BARRIERS, bool)
    btex = np.zeros(G.MAX_BARRIERS, np.int32)
    for i, (x, y, tex) in enumerate(lay["barriers"][: G.MAX_BARRIERS]):
        bpos[i] = [x, y]
        bex[i] = True
        btex[i] = tex % 3  # 8 reference meteor PNGs -> 3 procedural sprites

    return G.Level(
        agent_pos0=np.array(lay["agent_pos"], np.float32),
        barrier_pos=bpos,
        barrier_exists=bex,
        barrier_tex=btex,
        boss_tex=np.int32(lay["boss_ship"]),
        ship_tex=np.int32(lay["agent_ship"]),
        bullet_tex=np.int32(lay["agent_bullet"]),
        bg_index=np.int32(lay["bg_index"]),
    )


_BUILDERS = {
    "maze": maze_level,
    "chaser": chaser_level,
    "jumper": jumper_level,
    "caveflyer": caveflyer_level,
    "climber": climber_level,
    "coinrun": coinrun_level,
    "bossfight": bossfight_level,
}


def _game(game: str):
    import importlib

    return importlib.import_module(f"..games.{game}", __package__)


def generate_reference(game: str, seed: int, device, **kw):
    """The reference engine's Level for (game, seed) on `device`: what
    libX.so's reset() would load after rng.seed(seed)."""
    return convert.level(_game(game), _BUILDERS[game](seed, **kw), device)


def reference_bank(game: str, seeds, device, **kw):
    """The per-seed reference Levels stacked (with numpy) into a bank on
    `device`, row i for seeds[i]."""
    levels = [_BUILDERS[game](int(s), **kw) for s in seeds]
    stacked = tree_map(lambda *xs: np.stack(xs), *levels)
    return convert.level(_game(game), stacked, device)


def host_level(bank, i: int):
    """Row i of a bank with numpy leaves."""
    return tree_map(lambda x: x[i].cpu().numpy(), bank)
