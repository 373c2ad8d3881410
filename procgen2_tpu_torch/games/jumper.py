"""Jumper in PyTorch (procgen2_tpu/games/jumper.py), batched.

The same game as the JAX package, which cites the reference engine
(Procgen2's `games/jumper/`) line by line: a no-dead-end Kruskal maze
upsampled x3 as a wall prior (0.8 wall / 0.2 open), 2 cellular-automata
passes, border walls, the largest room, a goal cell and a ground cell for
the agent, the world pruned to the BFS path dilated 4 times (not in
"memory" mode), spikes on 3-wide ground runs, a vertical wall breakup and
wall tops (tilemap.cpp:79-253); the double-jump platformer with a jump
cooldown, full air control and ceiling hits (common_systems.cpp:57-201);
jump dust particles while airborne (common_systems.cpp:250-279); +10 at
the carrot and death on a spike, over 4 physics sub-steps with early exit
(jumper.cpp:341-375); and the quantized-camera scene render through the
scene kernel, with the compass HUD blended over it and its needle drawn by
the stamp kernel (jumper.cpp:445-509).

Every function works on a batch: `generate` on a batch of keys [L, 2]
(one level each), `reset`/`step`/`observe_batch`/`observe` on a batch of
envs. The random draws are the JAX package's, key for key (`..random`),
and the needle's angle is XLA CPU's `arctan2` (`..trig.atan2f`), so a
level, a state and an observation can be compared with it bit for bit.

Modes (tilemap.cpp:80-87): easy 20, hard 40, memory 45 (no prune, no
spikes).
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from .. import random as prng
from ..core import spaces
from ..gen import rooms
from ..gen.kruskal import kruskal_maze, masked_uniform_cell, open_dead_ends
from ..physics.aabb import check_collision
from ..physics.tiles import FULL, NONE, resolve_tile_collisions
from ..render import atlas as atlas_lib
from ..render import compositor as C
from ..render import phases as phases_lib
from ..render import png_assets
from ..render import scene_kernel
from ..trig import atan2f
from ..utils.consts import const
from ..utils.tree import key_field

NAME = "jumper"
NUM_ACTIONS = 15
SUB_STEPS = 4  # jumper.cpp:44
DT = 1.0 / SUB_STEPS
ZOOM = 0.3  # jumper.cpp:32
PPU = 16.0 * ZOOM

EMPTY, WALL_TOP, WALL_MID, SPIKE = 0, 1, 2, 3
MAZE_SCALE = 3  # tilemap.cpp:100

# Physics (common_systems.cpp:62-67)
MAX_JUMP = 0.92
GRAVITY = 0.1
MAX_SPEED = 0.5
MIX = 0.2
AIR_CONTROL = 1.0
JUMP_COOLDOWN = 3.0

NUM_PARTICLES = 10  # tilemap.cpp:236
PART_LIFESPAN = 5.0  # common_components.h:63
PART_SPAWN_TIME = 0.5  # common_components.h:65

_MODES = {"easy": 20, "hard": 40, "memory": 45}  # tilemap.cpp:80-87

NUM_BGS = 49
NUM_TILE_THEMES = 4  # tilemap.cpp:10-21 (climber's Blue/Green/Yellow/Brown)

# wall_mid and wall_top are full, spikes and empty none
# (common_systems.cpp:122-124)
_LUT_WALL = (NONE, FULL, FULL, NONE)

# the dust spawn's offset below the agent's rect top, 0.8 - 0.2 as XLA
# folds it (in f32)
_SPAWN_DY = float(np.float32(0.8) - np.float32(0.2))

PART_BINS = 6  # particle shrink quantization of the render
NEEDLE_BINS = 64  # compass-needle rotations of the render

# the compass HUD in screen pixels (jumper.cpp:473-509): compass_size 200
# x game_zoom, offset (-32, 32) x game_zoom, as Python floats
_CS = 200.0 * ZOOM
_OFFX, _OFFY = -32.0 * ZOOM, 32.0 * ZOOM


def _folded(*terms):
    """A sum of Python-float constants as XLA folds it: each term rounded
    to f32 and the sum taken left to right in f32."""
    acc = np.float32(terms[0])
    for t in terms[1:]:
        acc = np.float32(acc + np.float32(t))
    return float(acc)


# the needle's centre, cs/4 along the unit vector to the goal from
# (OBS - cs * 0.75 + offx + cs/4, cs * 0.5 + offy + cs * 0.05)
# (jumper.cpp:497-502), less half its 32-px patch
_NEEDLE_C0 = _folded(C.OBS - _CS * 0.75 + _OFFX, _CS * 0.25, -16.0)
_NEEDLE_R0 = _folded(_CS * 0.5 + _OFFY, _CS * 0.05, -16.0)


@dataclasses.dataclass(frozen=True)
class Config:
    mode: str = "easy"  # tilemap.h default (easy world_dim 20)
    # Render-only: camera phase quantization of the scene render
    # (render/phases.py); 0 = the exact, continuous camera.
    scene_phases: int = 4

    @property
    def world_dim(self):
        return _MODES[self.mode]

    @property
    def prune(self):
        return self.mode != "memory"  # tilemap.cpp:176

    @property
    def spike_prob(self):
        return 0.0 if self.mode == "memory" else 0.2  # tilemap.cpp:205


@dataclasses.dataclass
class Level:
    """One level per row of the leading dimension."""
    grid: torch.Tensor  # int8 [L, D, D] render coords [ry, x]
    spike_grid: torch.Tensor  # bool [L, D, D] render coords
    goal_pos: torch.Tensor  # f32 [L, 2] render units
    agent_pos: torch.Tensor  # f32 [L, 2]
    theme: torch.Tensor  # i32 [L]
    bg_index: torch.Tensor  # i32 [L]
    bg_offset: torch.Tensor  # f32 [L]


@dataclasses.dataclass
class State:
    """One env per row of the leading dimension."""
    level: Level
    pos: torch.Tensor  # f32 [N, 2]
    vel: torch.Tensor  # f32 [N, 2]
    on_ground: torch.Tensor  # bool [N]
    jumps_left: torch.Tensor  # i32 [N] (common_components.h:50: starts at 2)
    jump_timer: torch.Tensor  # f32 [N]
    face_forward: torch.Tensor  # bool [N]
    anim_t: torch.Tensor  # f32 [N]
    part_pos: torch.Tensor  # f32 [N, NUM_PARTICLES, 2]
    part_life: torch.Tensor  # f32 [N, NUM_PARTICLES]
    part_spawn_timer: torch.Tensor  # f32 [N]
    t: torch.Tensor  # i32 [N]
    rng: torch.Tensor = key_field()  # int64 [N, 2] key words


# ---------------------------------------------------------------------------
# Assets (numpy, built by the port's asset modules)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _assets():
    names = []
    for th in atlas_lib.CLIMBER_TILE_THEMES:
        names += [f"ctile_top_{th}", f"ctile_mid_{th}"]
    names += ["carrot", "spikeman", "particle_circle",
              "compass_circle", "solid_yellow"]
    names += [f"bunny_{k}" for k in ("stand", "jump", "walk1", "walk2")]
    atlas, idx = atlas_lib.build_atlas(tuple(names))
    bgs = atlas_lib.build_backgrounds("sky", NUM_BGS)
    return dict(atlas_p=atlas.transpose(3, 0, 1, 2), idx=idx,
                bgs_p=bgs.transpose(3, 0, 1, 2))


@functools.lru_cache(maxsize=None)
def _stamp_banks():
    """Pixel-snapped patch banks u8 [V, 4, P, P]: moving (the carrot, then
    the dust circle at PART_BINS shrink ratios, common_systems.cpp:281-303;
    P = 8), bunny (4 poses x flip, common_systems.cpp:204-243; P = 8) and
    needle (solid_yellow cs*0.5 x cs*0.1 px at NEEDLE_BINS rotations,
    jumper.cpp:497-502; P = 32)."""
    A = atlas_lib
    u = PPU  # 1 world unit in obs pixels (4.8 at zoom 0.3)
    specs = [("carrot", u, u)]
    for q in range(PART_BINS):
        r = (q + 0.5) / PART_BINS
        sc = 0.45 * (0.4 * r + 0.6)
        specs.append(("particle_circle", sc * u, sc * u))
    moving = A.build_pixel_bank(tuple(specs), patch=8)
    bspecs = []
    for k in ("stand", "jump", "walk1", "walk2"):
        scale = 0.6 if k == "jump" else 0.5
        for fl in (False, True):
            bspecs.append((f"bunny_{k}", scale * u, scale * 1.33 * u, 0.0, fl))
    bunny = A.build_pixel_bank(tuple(bspecs), patch=8)
    nspecs = tuple(
        ("solid_yellow", _CS * 0.5, _CS * 0.1, 2 * np.pi * q / NEEDLE_BINS)
        for q in range(NEEDLE_BINS))
    needle = A.build_pixel_bank(nspecs, patch=32)
    return dict(moving=moving, bunny=bunny, needle=needle)


@functools.lru_cache(maxsize=None)
def _compass_overlay(obs: int):
    """The compass circle as one premultiplied overlay at obs resolution,
    numpy (rgbp f32 [1, 3, obs, obs], a f32 [1, 1, obs, obs]). The circle
    sits at a fixed screen position (jumper.cpp:487-495: compass_size 200
    x game_zoom 0.3 = 60 px on any target), so it is the same for every
    env: sampled nearest at pixel centres. Where an overlay installed
    the compass PNG (`png_assets.source_path("compass_circle")`), the
    source is that PNG decoded at display resolution, max(64, obs) px,
    times 255 in f32, not rounded to uint8 (the 60 px circle upsampled
    from the 32 px atlas entry smears its rim); otherwise, as with the
    procedural art, the atlas's compass_circle sprite (uint8)."""
    x0, y0 = obs - _CS + _OFFX, _OFFY
    sp = png_assets.source_path("compass_circle")
    if sp is not None:
        src = png_assets.load_png(sp, size=max(64, obs)) * 255.0
    else:
        src = atlas_lib.sprite_rgba("compass_circle").astype(np.float32)
    S = src.shape[0]
    c = np.arange(obs) + 0.5
    u_f = (c - x0) / _CS
    v_f = (c - y0) / _CS
    in_u = (u_f >= 0) & (u_f < 1)
    in_v = (v_f >= 0) & (v_f < 1)
    ui = np.clip((u_f * S).astype(np.int32), 0, S - 1)
    vi = np.clip((v_f * S).astype(np.int32), 0, S - 1)
    tex = src[vi[:, None], ui[None, :]]  # [obs, obs, 4]
    tex *= (in_v[:, None] & in_u[None, :])[..., None]
    a = tex[..., 3:4] / 255.0
    rgbp = tex[..., :3] * a
    return rgbp.transpose(2, 0, 1)[None], a.transpose(2, 0, 1)[None]


@functools.lru_cache(maxsize=None)
def _scene_assets(qp, D):
    """Tile-entry phase bank (the themed wall tops and mids, then the
    unthemed spike), padded backgrounds and the phase offset table of the
    scene render (numpy)."""
    A = _assets()
    atlas_s = np.asarray(A["atlas_p"]).transpose(1, 0, 2, 3)
    idx = A["idx"]
    texs, kinds, themes = [], [], []
    for t, th in enumerate(atlas_lib.CLIMBER_TILE_THEMES):
        texs += [atlas_s[idx[f"ctile_top_{th}"]],
                 atlas_s[idx[f"ctile_mid_{th}"]]]
        kinds += [WALL_TOP, WALL_MID]
        themes += [t, t]
    texs.append(atlas_s[idx["spikeman"]])
    kinds.append(SPIKE)
    themes.append(-1)
    bank = phases_lib.tile_phase_bank(np.stack(texs), PPU, 64, qp)
    P = phases_lib.WIN
    GP = D + 2 * P
    bgs = np.asarray(A["bgs_p"])  # [3, NB, 64, 64]
    bgpad = np.zeros((NUM_BGS, 3, GP, GP), np.uint8)
    n = min(64, GP - P)
    bgpad[:, :, P:P + n, P:P + n] = bgs.transpose(1, 0, 2, 3)[:, :, :n, :n]
    TR, _, _ = phases_lib.phase_tables(PPU, 64, qp)
    return dict(bank=bank, kinds=tuple(kinds), themes=tuple(themes),
                bgpad=bgpad, TRtab=TR[:, None, :].astype(np.int32))


@functools.lru_cache(maxsize=None)
def _scene_tensors(qp, D, device):
    """The render's constant tensors on `device` (built once per device):
    bf16 tile and bg banks, TR, the premultiplied stamp banks, and the
    compass overlay in bf16."""
    SA = _scene_assets(qp, D)
    dev = torch.device(device)
    R = _observe_assets(device)
    bf16 = torch.bfloat16
    return dict(
        tile_bank=torch.from_numpy(SA["bank"]).to(bf16).to(dev),
        bg_bank=torch.from_numpy(SA["bgpad"]).to(bf16).to(dev),
        tr_tab=torch.from_numpy(SA["TRtab"]).to(dev),
        banks=R["banks"], kinds=SA["kinds"], themes=SA["themes"],
        compass_rgbp=R["compass_rgbp"], compass_a=R["compass_a"])


@functools.lru_cache(maxsize=None)
def _observe_assets(device: str):
    """The constant tensors of the exact renders on `device`: the atlas
    and backgrounds (`C.bank`), the premultiplied stamp banks, the
    compass overlay in bf16, and the atlas tables tile_lut [theme, kind]
    (-1 transparent) and bunny_lut [pose]."""
    A = _assets()
    idx = A["idx"]
    dev = torch.device(device)
    tile_lut = np.full((NUM_TILE_THEMES, 4), -1, np.int64)
    for t, th in enumerate(atlas_lib.CLIMBER_TILE_THEMES):
        tile_lut[t, WALL_TOP] = idx[f"ctile_top_{th}"]
        tile_lut[t, WALL_MID] = idx[f"ctile_mid_{th}"]
    rgbp, a = _compass_overlay(C.OBS)
    bf16 = torch.bfloat16
    return dict(
        atlas=C.bank(A["atlas_p"], device), bgs=C.bank(A["bgs_p"], device),
        idx=idx, tile_lut=tile_lut,
        bunny_lut=torch.tensor([idx[f"bunny_{k}"] for k in
                                ("stand", "jump", "walk1", "walk2")],
                               device=dev),
        banks={k: C._premultiply_bank(v).to(dev)
               for k, v in _stamp_banks().items()},
        compass_rgbp=torch.from_numpy(rgbp).to(bf16).to(dev),
        compass_a=torch.from_numpy(a).to(bf16).to(dev))


# ---------------------------------------------------------------------------
# Generation (tilemap.cpp:79-253), batched over levels
# ---------------------------------------------------------------------------

def _place_spikes(grid, u, prob):
    """Spikes on ground runs (tilemap.cpp:205-213), grid int8 [L, D, D]
    indexed [x, y_up]. The JAX package scans the cells in x-major order
    and a placed spike blocks its right neighbour's run; with u f32
    [L, D, D] the cells' uniform draws, this is a scan over columns:
    a cell (x, y) reads columns x - 1 (already final), x and x + 1 (not yet
    changed), and within column x a spike placed at (x, y') changes only
    what (x, y' + 1) reads as the cell below, which was EMPTY before and
    SPIKE after, neither a wall. So every row of a column is decided at
    once from the grid before it."""
    L, D, _ = grid.shape
    wall = torch.full((L, 1, D), WALL_MID, dtype=torch.int8,
                      device=grid.device)  # outside the map is wall

    def ground(col):
        """Space on ground (tilemap.cpp:54-64) for each row of a column
        [L, 1, D]: empty, empty above, a wall below (rows beyond the map
        are wall)."""
        pad = torch.cat([wall[..., :1], col, wall[..., :1]], dim=2)
        below = pad[..., :-2]
        return ((col == EMPTY) & (pad[..., 2:] == EMPTY)
                & ((below == WALL_MID) | (below == WALL_TOP)))

    for x in range(D):
        left = grid[:, x - 1:x] if x > 0 else wall
        right = grid[:, x + 1:x + 2] if x < D - 1 else wall
        col = grid[:, x:x + 1]
        ok = (ground(col) & ground(left) & ground(right)
              & (u[:, x:x + 1] < prob))
        grid[:, x:x + 1] = torch.where(ok, SPIKE, col).to(torch.int8)
    return grid


def _break_walls(grid, r1, r2):
    """Vertical wall breakup (tilemap.cpp:215-225) in the JAX package's
    x-major cell order, grid int8 [L, D, D] indexed [x, y_up]; r1, r2 int
    [L, D, D] the cells' two randint(0, 3) draws. At (x, y), where rows
    y..y+2 of column x are wall_mid and empty in column x + 1 (x - 1 for
    the second opening), row y + r is cleared. Column x + 1 is not yet
    changed when column x runs, column x - 1 is final, and a cell reads
    what the cells below it cleared in its own column: the loop over rows
    stays, all levels at once."""
    L, D, _ = grid.shape
    dev = grid.device
    three = torch.arange(3, device=dev)

    def runs(side):
        """Per row y, rows y..y+2 of column `side` all empty; False past
        D - 3, and everywhere for a column beyond the map."""
        ok = torch.zeros((L, D), dtype=torch.bool, device=dev)
        if side is not None:
            e = side == EMPTY
            ok[:, :D - 2] = e[:, :D - 2] & e[:, 1:D - 1] & e[:, 2:]
        return ok

    for x in range(D):
        col = grid[:, x].clone()
        right = runs(grid[:, x + 1] if x < D - 1 else None)
        left = runs(grid[:, x - 1] if x > 0 else None)
        mid = col == WALL_MID
        for y in range(D - 2):
            for side, r in ((right, r1), (left, r2)):
                hit = mid[:, y:y + 3].all(1) & side[:, y]
                mid[:, y:y + 3] &= ~((three == r[:, x, y, None])
                                     & hit[:, None])
        grid[:, x] = torch.where((col == WALL_MID) & ~mid, EMPTY,
                                 col).to(torch.int8)
    return grid


def generate(cfg: Config, keys: torch.Tensor) -> Level:
    """One level per key: keys int64 [L, 2] -> Level with leading dim L."""
    D = cfg.world_dim
    L = keys.shape[0]
    dev = keys.device
    f32 = torch.float32
    i8 = torch.int8
    maze_dim = D // MAZE_SCALE
    (k_maze, k_de, k_fill, k_goal, k_agent, k_spike, k_break, k_theme, k_bg,
     k_bgoff) = prng.split(keys, 10).unbind(-2)

    # Maze prior: no-dead-end Kruskal, upsampled x3 (tilemap.cpp:103-120);
    # the grid is [L, x, y_up] during generation
    mwall = open_dead_ends(k_de, kruskal_maze(k_maze, maze_dim, maze_dim),
                           maze_dim)
    m = torch.arange(D, device=dev) // MAZE_SCALE
    mc = m.clamp(max=maze_dim - 1)
    in_maze = (m[:, None] < maze_dim) & (m[None, :] < maze_dim)
    prior = torch.where(in_maze, mwall[:, mc[:, None], mc[None, :]], True)
    wall = prng.uniform(k_fill, (D, D)) < torch.where(prior, 0.8, 0.2)

    # 2 CA passes + borders (tilemap.cpp:122-140)
    for _ in range(2):
        wall = rooms.ca_smooth(wall)
    xs = torch.arange(D, device=dev)
    edge = (xs == 0) | (xs == D - 1)
    wall = wall | edge[:, None] | edge[None, :]

    # Largest room, goal and agent cells (tilemap.cpp:142-171)
    open0 = rooms.largest_room(~wall, iters=D * D // 2)
    gx, gy = masked_uniform_cell(k_goal, open0)
    # is_space_on_ground (tilemap.cpp:54-64): open, open above, wall below
    up = torch.zeros_like(open0)
    up[:, :, :-1] = open0[:, :, 1:]
    down = torch.zeros_like(open0)
    down[:, :, 1:] = open0[:, :, :-1]
    ground = open0 & up & ~down
    goal = ((xs[None, :, None] == gx[:, None, None])
            & (xs[None, None, :] == gy[:, None, None]))
    ax, ay = masked_uniform_cell(k_agent, ground & ~goal)

    # BFS path + prune (tilemap.cpp:173-188)
    if cfg.prune:
        dist = rooms.bfs_dist(open0, ax, ay, iters=D * D // 2)
        path = rooms.shortest_path_mask(dist, gx, gy)
        open_f = rooms.dilate_in(path, open0, 4)
    else:
        open_f = open0
    grid = torch.where(open_f, EMPTY, WALL_MID).to(i8)

    # Spikes and the wall breakup: each cell splits its own key off a
    # chain, walked before the scans (tilemap.cpp:205-225)
    u = prng.uniform(prng.split_chain(k_spike, D * D)[:, :, 0])
    grid = _place_spikes(grid, u.reshape(L, D, D), cfg.spike_prob)
    kb = prng.split_chain(k_break, D * D, 3)
    r1 = prng.randint(kb[:, :, 0], (), 0, 3).reshape(L, D, D)
    r2 = prng.randint(kb[:, :, 1], (), 0, 3).reshape(L, D, D)
    grid = _break_walls(grid, r1, r2)

    # Spike tiles -> spike mask + empty, never on the agent or goal cell
    # (tilemap.cpp:238-245)
    n = torch.arange(L, device=dev)
    is_spike = grid == SPIKE
    is_spike[n, ax, ay] = False
    is_spike[n, gx, gy] = False
    grid = torch.where(grid == SPIKE, EMPTY, grid).to(i8)

    # Wall tops (tilemap.cpp:248-252): wall_mid with empty above
    above = torch.zeros_like(is_spike)
    above[:, :, :-1] = grid[:, :, 1:] == EMPTY
    grid = torch.where((grid == WALL_MID) & above, WALL_TOP, grid).to(i8)

    # [x, y_up] -> render [ry, x]
    def render(a):
        return torch.flip(a.transpose(1, 2), dims=(1,)).contiguous()

    goal_pos = torch.stack([gx.to(f32) + 0.5, (D - 1.0) - gy.to(f32) + 0.5], -1)
    # the agent's spawn y has no +0.5 (tilemap.cpp:227: feet on the floor)
    agent_pos = torch.stack([ax.to(f32) + 0.5, (D - 1.0) - ay.to(f32)], -1)
    return Level(
        grid=render(grid),
        spike_grid=render(is_spike),
        goal_pos=goal_pos,
        agent_pos=agent_pos,
        theme=prng.randint(k_theme, (), 0, NUM_TILE_THEMES),
        bg_index=prng.randint(k_bg, (), 0, NUM_BGS),
        bg_offset=prng.uniform(k_bgoff),
    )


def reset(cfg: Config, level: Level, keys: torch.Tensor) -> State:
    """Fresh episodes on `level` (leading dim N) with keys [N, 2]."""
    N = keys.shape[0]
    dev = keys.device
    f32 = torch.float32
    return State(
        level=level,
        pos=level.agent_pos,
        vel=torch.zeros((N, 2), dtype=f32, device=dev),
        on_ground=torch.zeros(N, dtype=torch.bool, device=dev),
        jumps_left=torch.full((N,), 2, dtype=torch.int32, device=dev),
        jump_timer=torch.zeros(N, dtype=f32, device=dev),
        face_forward=torch.ones(N, dtype=torch.bool, device=dev),
        anim_t=torch.zeros(N, dtype=f32, device=dev),
        part_pos=torch.zeros((N, NUM_PARTICLES, 2), dtype=f32, device=dev),
        part_life=torch.zeros((N, NUM_PARTICLES), dtype=f32, device=dev),
        part_spawn_timer=torch.zeros(N, dtype=f32, device=dev),
        t=torch.zeros(N, dtype=torch.int32, device=dev),
        rng=keys,
    )


# ---------------------------------------------------------------------------
# Step (jumper.cpp:341-375)
# ---------------------------------------------------------------------------

def _spike_hit(level, rx, ry):
    """The agent's rect (rx, ry, 0.5, 0.8) against the spike rects
    (-0.25, -0.25, 0.5, 0.5) about each spike cell's centre
    (common_systems.cpp:149-162): per axis the strict overlap with every
    cell, then any spike cell overlapped on both. The JAX package counts
    those cells with a bf16 contraction of 0/1 values, an exact count."""
    D = level.spike_grid.shape[-1]
    bx = torch.arange(D, dtype=torch.float32, device=rx.device) + 0.25
    ox = (rx[:, None] < bx + 0.5) & (rx[:, None] + 0.5 > bx)  # [N, D] x
    oy = (ry[:, None] < bx + 0.5) & (ry[:, None] + 0.8 > bx)  # [N, D] rows
    return (oy[:, :, None] & level.spike_grid & ox[:, None, :]).flatten(1).any(1)


def _agent_substep(level, pos, vel, on_ground, jumps_left, jump_timer,
                   face_forward, anim_t, a):
    """System_Agent::update (common_systems.cpp:57-201)."""
    f32 = torch.float32
    movement_x = (((a == 6) | (a == 7) | (a == 8)).to(f32)
                  - ((a == 0) | (a == 1) | (a == 2)).to(f32))
    jump = (a == 2) | (a == 5) | (a == 8)

    mix_x = torch.where(on_ground, MIX, MIX * AIR_CONTROL)
    vx = vel[:, 0] + mix_x * (MAX_SPEED * movement_x - vel[:, 0]) * DT
    vx = torch.where(torch.abs(vx) < mix_x * MAX_SPEED * DT, 0.0, vx)

    jumps_left = torch.where(on_ground, 2, jumps_left)
    do_jump = jump & (jumps_left > 0) & (jump_timer == 0.0)
    vy = torch.where(do_jump, -MAX_JUMP, vel[:, 1])
    jumps_left = (jumps_left - do_jump.to(torch.int32)).to(torch.int32)
    jump_timer = torch.where(do_jump, JUMP_COOLDOWN, jump_timer)
    jump_timer = torch.clamp(jump_timer - DT, min=0.0)

    vy = torch.clamp(vy + GRAVITY * DT, -MAX_JUMP, MAX_JUMP)
    x = pos[:, 0] + vx * DT
    y = pos[:, 1] + vy * DT

    # Collision bounds (-0.25, -0.8, 0.5, 0.8) (tilemap.cpp:233). XLA folds
    # (x - 0.25) + 0.5 into x + 0.25 and (y - 0.8) + 0.8 into y for the far
    # edges, and the centre's (y - 0.8) + 0.4 into y - 0.4
    rx, ry, col = resolve_tile_collisions(
        level.grid, _LUT_WALL, x - 0.25, y - 0.8, 0.5, 0.8, WALL_MID,
        edges=(x + 0.25, y, x, y - 0.4))
    dx_moved = rx - (x - 0.25)
    dy_moved = ry - (y - 0.8)
    new_on_ground = (dy_moved < 0.0) & col
    hit_ceiling = (dy_moved > 0.0) & col  # common_systems.cpp:143-144
    x = rx + 0.25
    y = ry + 0.8
    vx = torch.where(dx_moved != 0.0, 0.0, vx)
    vy = torch.where(hit_ceiling | new_on_ground, 0.0, vy)

    # the rect (x - 0.25, y - 0.8) is (rx, ry): XLA folds the constants
    dead = _spike_hit(level, rx, ry)
    goal = level.goal_pos
    achieved = check_collision(rx, ry, 0.5, 0.8, goal[:, 0] - 0.5,
                               goal[:, 1] - 0.5, 1.0, 1.0)

    anim_t = torch.remainder(anim_t + 0.1 * DT, 1.0)
    face_forward = torch.where(movement_x > 0, True,
                               torch.where(movement_x < 0, False, face_forward))
    # the dust spawn point (x, y - 0.2) (tilemap.cpp:236), where XLA folds
    # (ry + 0.8) - 0.2 into ry + f32(0.8 - 0.2)
    spawn = torch.stack([x, ry + _SPAWN_DY], -1)
    return (torch.stack([x, y], -1), torch.stack([vx, vy], -1), new_on_ground,
            jumps_left, jump_timer, face_forward, anim_t, dead, achieved,
            spawn)


def _particles_substep(spawn, part_pos, part_life, spawn_timer, enabled):
    """System_Particles::update (common_systems.cpp:250-279): the LAST
    dead slot respawns at `spawn` [N, 2], every PART_SPAWN_TIME while
    enabled."""
    life = part_life - DT
    slots = torch.arange(NUM_PARTICLES, device=spawn.device)
    dead_idx = torch.where(life <= 0.0, slots, -1).max(1).values
    spawn_timer = spawn_timer + DT
    do = (dead_idx >= 0) & (spawn_timer >= PART_SPAWN_TIME) & enabled
    spawn_timer = torch.where(do, torch.fmod(spawn_timer, PART_SPAWN_TIME),
                              spawn_timer)
    upd = do[:, None] & (slots[None] == dead_idx.clamp(0, NUM_PARTICLES - 1)[:, None])
    life = torch.where(upd, PART_LIFESPAN, life)
    part_pos = torch.where(upd[..., None], spawn[:, None], part_pos)
    return part_pos, life, spawn_timer


def step(cfg: Config, state: State, action):
    """One env step for every env: (State, reward f32 [N], done bool [N],
    info {"to_goal": f32 [N, 2]})."""
    level = state.level
    a = action.to(torch.int32)
    N = a.shape[0]
    dev = a.device
    pos, vel = state.pos, state.vel
    on_ground = state.on_ground
    jumps_left, jump_timer = state.jumps_left, state.jump_timer
    face_forward, anim_t = state.face_forward, state.anim_t
    part_pos, part_life = state.part_pos, state.part_life
    spawn_timer = state.part_spawn_timer
    done = torch.zeros(N, dtype=torch.bool, device=dev)
    reward = torch.zeros(N, dtype=torch.float32, device=dev)

    for _ in range(SUB_STEPS):  # jumper.cpp:355-369
        active = ~done
        (n_pos, n_vel, n_og, n_jl, n_jt, n_ff, n_anim, dead, achieved,
         spawn) = _agent_substep(level, pos, vel, on_ground, jumps_left,
                                 jump_timer, face_forward, anim_t, a)
        # dust only while airborne: the reference's `abs(velocity.x) > 0.01`
        # binds the int abs, always false for |vx| < 1
        # (common_systems.cpp:198)
        n_ppos, n_plife, n_ptimer = _particles_substep(
            spawn, part_pos, part_life, spawn_timer, ~n_og)

        act = active[:, None]
        pos = torch.where(act, n_pos, pos)
        vel = torch.where(act, n_vel, vel)
        on_ground = torch.where(active, n_og, on_ground)
        jumps_left = torch.where(active, n_jl, jumps_left)
        jump_timer = torch.where(active, n_jt, jump_timer)
        face_forward = torch.where(active, n_ff, face_forward)
        anim_t = torch.where(active, n_anim, anim_t)
        part_pos = torch.where(act[..., None], n_ppos, part_pos)
        part_life = torch.where(act, n_plife, part_life)
        spawn_timer = torch.where(active, n_ptimer, spawn_timer)
        reward = torch.where(active, achieved.to(torch.float32) * 10.0, reward)
        done = done | (active & (dead | achieved))

    new_state = State(
        level=level, pos=pos, vel=vel, on_ground=on_ground,
        jumps_left=jumps_left, jump_timer=jump_timer,
        face_forward=face_forward, anim_t=anim_t, part_pos=part_pos,
        part_life=part_life, part_spawn_timer=spawn_timer,
        t=state.t + 1, rng=state.rng)
    # the info vector to the goal (common_systems.cpp:193)
    return new_state, reward, done, {"to_goal": level.goal_pos - pos}


# ---------------------------------------------------------------------------
# Rendering (jumper.cpp:445-509)
# ---------------------------------------------------------------------------

def observe(cfg: Config, state: State, size: int = C.OBS):
    """Each env's frame at size x size by the exact render (jumper.cpp:
    445-509): background, themed walls, the dust particles, spikes, the
    carrot and the bunny, the camera spanning the same world at any size;
    then the compass HUD in screen pixels, whose size does not scale with
    the target (jumper.cpp:487: 60 px on any surface). uint8
    [N, size, size, 3]."""
    R = _observe_assets(str(state.pos.device))
    atlas, idx = R["atlas"], R["idx"]
    level = state.level
    N = state.pos.shape[0]
    dev = state.pos.device
    f32 = torch.float32
    cam_x = state.pos[:, 0]
    cam_y = state.pos[:, 1] - 0.5  # common_systems.cpp:180-181
    # window renders scale the zoom (render_game)
    wx, wy = C.camera_coords(PPU * (size / 64.0), cam_x, cam_y, size)

    img = C.clear(N, size, dev)
    img = C.draw_background(img, R["bgs"], level.bg_index, wx, wy)
    # out of bounds is a wall (tilemap.h:84-87)
    img = C.draw_tiles(img, level.grid, R["tile_lut"], atlas, wx, wy,
                       oob_tile=WALL_MID, theme=level.theme)

    # the dust, after the tiles and before the sprites (jumper.cpp:470-472):
    # fading and shrinking (common_systems.cpp:281-303). XLA CPU fuses
    # 0.4 * ratio + 0.6; the size is traced, so the rect divides by it
    ratio, centre = _dust(state)
    for i in range(NUM_PARTICLES):
        sc = prng._fma32(ratio[:, i], 0.4, 0.6) * 0.45
        img = C.draw_sprite(img, atlas, idx["particle_circle"],
                            centre[:, i, 0] - 0.5 * sc,
                            centre[:, i, 1] - 0.5 * sc, sc, sc, wx, wy,
                            alive=state.part_life[:, i] > 0.0,
                            alpha=0.5 * (1.0 - ratio[:, i]))
    # spikes: z=1, the sub-cell placement baked into the art (tilemap.cpp:49)
    spikes = torch.where(level.spike_grid, 0, -1)
    img = C.draw_tiles(img, spikes, [idx["spikeman"]], atlas, wx, wy,
                       oob_tile=-1)
    img = C.draw_sprite(img, atlas, idx["carrot"],
                        level.goal_pos[:, 0] - 0.5, level.goal_pos[:, 1] - 0.5,
                        1.0, 1.0, wx, wy)
    # the bunny: per-pose scale and offset (common_systems.cpp:204-243)
    pose = _pose(state)
    jumping = pose == 1
    scale = torch.where(jumping, 0.6, 0.5)
    img = C.draw_sprite(
        img, atlas, R["bunny_lut"][pose.long()],
        state.pos[:, 0] - 0.25 + torch.where(jumping, -0.05, 0.0),
        state.pos[:, 1] - 1.0 + torch.where(jumping, 0.25, 0.2),
        scale, scale * 1.33, wx, wy, flip_x=~state.face_forward)

    # the compass HUD in screen pixels (jumper.cpp:473-509)
    px, py = C.pixel_coords(N, size, dev)
    to_goal = level.goal_pos - state.pos
    tx, ty = to_goal[:, 0], to_goal[:, 1]
    # sqrt(x**2 + y**2): in this scalar code XLA CPU fuses x * x into the
    # add (the batched renders round each op)
    dist = torch.sqrt(prng._fma32(tx, tx, ty * ty))
    inv = 1.0 / torch.clamp(dist, min=1e-4)
    ratio_bar = torch.clamp(dist * C.recip32(cfg.world_dim * 1.414), max=1.0)

    def const(v):
        return torch.full((N,), v, dtype=f32, device=dev)
    x0 = const(size - _CS + _OFFX)
    img = C.draw_sprite(img, atlas, idx["compass_circle"], x0, const(_OFFY),
                        _CS, _CS, px, py)
    # the needle, rotated about its centre by the angle to the goal: XLA
    # CPU folds the top-left's constant with the half size, in f32, and
    # fuses cs/4 * dir into the add
    img = C.draw_sprite(
        img, atlas, idx["solid_yellow"], None, None, _CS * 0.5, _CS * 0.1,
        px, py, rotation=atan2f(ty, tx),
        centre=(prng._fma32(tx * inv, _CS * 0.25, _folded(
                    size - _CS * 0.75 + _OFFX, _CS * 0.25)),
                prng._fma32(ty * inv, _CS * 0.25, _folded(
                    _CS * 0.5 + _OFFY, _CS * 0.05))))
    # the distance bar (below a 64-px frame; on window renders)
    img = C.draw_sprite(img, atlas, idx["solid_yellow"], x0,
                        const(_CS + _OFFY), _CS * ratio_bar, _CS * 0.15, px,
                        py, alive=ratio_bar > 0.0)
    return C.finalize(img)


def _observe_exact(cfg: Config, states: State):
    """The exact-camera batched render (`scene_phases=0`): the camera at
    (x, y - 0.5) unsnapped; the background, the themed walls from the
    kind field (spikes merged in as their own kind; out of bounds is a
    wall), the dust and the carrot, the spikes, the bunny, the compass
    circle and the needle. The stamps go through
    `compositor.composite_stamps`: the dust (K = 10, P = 8), the carrot
    and the bunny (K = 1) take the matmul semantics; the needle (P = 32)
    is B3 on the card."""
    R = _observe_assets(str(states.pos.device))
    level = states.level
    N = states.pos.shape[0]
    dev = states.pos.device
    i32 = torch.int32
    cam_x = states.pos[:, 0]
    cam_y = states.pos[:, 1] - 0.5
    wx, wy = C.camera_coords(PPU, cam_x, cam_y)
    img = C.draw_background_batch(R["bgs"], level.bg_index, wx, wy)
    D = cfg.world_dim
    sel = C.tile_selectors(wx, wy, D, D)
    merged = torch.where(level.spike_grid, SPIKE, level.grid).to(torch.int8)
    G = C.kind_field(merged, sel, WALL_MID)
    atlas = R["atlas"]
    lut = const(R["tile_lut"], dev)[level.theme.long()]
    for kind in (WALL_TOP, WALL_MID):
        img = C.kind_layer(img, G == kind, atlas[lut[:, kind]], sel)

    def pix(centres):
        return _round(*C.stamp_origin(centres, cam_x, cam_y, PPU, 8))
    banks = R["banks"]
    ratio, pcentre = _dust(states)
    pvar = 1 + torch.clamp((ratio * PART_BINS).to(i32), 0, PART_BINS - 1)
    img = C.composite_stamps(img, banks["moving"], pvar, *pix(pcentre),
                             alives=states.part_life > 0.0,
                             alpha=0.5 * (1.0 - ratio))
    # spikes above the dust in class z-order (z=1, jumper.cpp:471)
    img = C.kind_layer(img, G == SPIKE, atlas[R["idx"]["spikeman"]], sel)
    img = C.composite_stamps(img, banks["moving"],
                             torch.zeros((N, 1), dtype=i32, device=dev),
                             *pix(level.goal_pos[:, None]))
    bvar, bcentre = _bunny(states)
    img = C.composite_stamps(img, banks["bunny"], bvar, *pix(bcentre))
    img = img * (1.0 - R["compass_a"]) + R["compass_rgbp"]
    img = C.composite_stamps(img, banks["needle"], *_needle_stamp(states))
    return torch.clamp(torch.round(img), 0, 255).to(torch.uint8)


def obs_space(cfg: Config):
    return spaces.Box(0, 255, (C.OBS, C.OBS, 3))


def action_space(cfg: Config):
    return spaces.MultiDiscrete((NUM_ACTIONS,))


def observe_batch(cfg: Config, states: State):
    """Planar uint8 [N, 3, 64, 64]: the quantized-phase scene render (the
    throughput path), or with `scene_phases=0` the exact-camera render.
    The distance bar of the reference's HUD lands at obs y 69.6, off the
    64-px frame (jumper.cpp:503-509), so it draws nothing here."""
    if cfg.scene_phases > 0:
        return _observe_scene(cfg, states)
    return _observe_exact(cfg, states)


def _round(*xs):
    """Round half to even, to int32."""
    return tuple(torch.round(x).to(torch.int32) for x in xs)


def _dust(states: State):
    """The dust particles' fade ratio f32 [N, P] and render centres
    [N, P, 2] (fading and drifting up, common_systems.cpp:281-303)."""
    # XLA CPU makes the division by PART_LIFESPAN a multiply by its f32
    # reciprocal, and fuses the drift y - ratio * 0.17 into one
    # multiply-add
    ratio = torch.clamp((PART_LIFESPAN - states.part_life)
                        * float(np.float32(1 / PART_LIFESPAN)), 0.0, 1.0)
    centre = torch.stack([states.part_pos[..., 0],
                          prng._fma32(-ratio, 0.17, states.part_pos[..., 1])],
                         -1)
    return ratio, centre


def _pose(states: State):
    """The bunny's pose int32 [N]: 0 stand, 1 jump, 2/3 the walk frames."""
    return torch.where(
        (torch.abs(states.vel[:, 0]) < 0.01) & states.on_ground, 0,
        torch.where(~states.on_ground, 1,
                    torch.where(states.anim_t > 0.5, 3, 2))).to(torch.int32)


def _bunny(states: State):
    """The bunny's stamp variant int32 [N, 1] (pose x 2 + flipped) and
    render centre f32 [N, 1, 2] (per-pose scale and offset,
    common_systems.cpp:204-243)."""
    i32 = torch.int32
    pose = _pose(states)
    var = (pose * 2 + (~states.face_forward).to(i32))[:, None]
    jumping = pose == 1
    bscale = torch.where(jumping, 0.6, 0.5)
    off_x = torch.where(jumping, -0.05, 0.0)
    off_y = torch.where(jumping, 0.25, 0.2)
    # XLA folds bscale * 1.33 * 0.5 into bscale * f32(0.665), a select of
    # constants that LLVM folds into rounded constants, so no multiply-add
    # is fused here; both give the source's roundings
    centre = torch.stack(
        [states.pos[:, 0] - 0.25 + off_x + bscale * 0.5,
         states.pos[:, 1] - 1.0 + off_y + bscale * 1.33 * 0.5], -1)[:, None]
    return var.contiguous(), centre


def _stamp_groups(states: State, cam_x, cam_y, banks):
    """The scene's two stamp groups in painter order, (bank, var, scale,
    r0, c0) with [N, K] each: the dust particles and the carrot (the
    "moving" bank, K = 11, drawn after the tiles, jumper.cpp:470-472), and
    the bunny (K = 1)."""
    level = states.level
    N = states.pos.shape[0]
    dev = states.pos.device
    i32 = torch.int32
    f32 = torch.float32
    ratio, pcentre = _dust(states)
    pvar = 1 + torch.clamp((ratio * PART_BINS).to(i32), 0, PART_BINS - 1)
    # the fading scale stays f32: B1 rounds texel * scale to bf16 once, as
    # the TPU kernel it replaces does (the JAX package's CPU fallback
    # rounds the scale to bf16 first; ROADMAP C)
    pscale = (states.part_life > 0.0).to(f32) * (0.5 * (1.0 - ratio))
    centres = torch.cat([pcentre, level.goal_pos[:, None]], dim=1)
    var = torch.cat([pvar, torch.zeros((N, 1), dtype=i32, device=dev)], 1)
    scale = torch.cat([pscale, torch.ones((N, 1), dtype=f32, device=dev)], 1)
    r0, c0 = _round(*C.stamp_origin(centres, cam_x, cam_y, PPU, 8))
    moving = (banks["moving"], var.contiguous(), scale.contiguous(), r0, c0)
    bvar, bcentre = _bunny(states)
    br0, bc0 = _round(*C.stamp_origin(bcentre, cam_x, cam_y, PPU, 8))
    bunny = (banks["bunny"], bvar, torch.ones((N, 1), dtype=f32, device=dev),
             br0, bc0)
    return [moving, bunny]


def _scene_inputs(cfg: Config, states: State):
    """The scene kernel's arguments for a batch of states (as a tuple in
    `scene_kernel.scene_raw`'s order): the render camera follows (x,
    y - 0.5) (common_systems.cpp:180-181) snapped to 1/qp units; spikes
    merge into the kind grid as their own tile kind; the grid is padded
    with wall (out of bounds is a wall, tilemap.h:84-87)."""
    qp = cfg.scene_phases
    D = cfg.world_dim
    ST = _scene_tensors(qp, D, str(states.pos.device))
    W = phases_lib.WIN
    i32 = torch.int32
    level = states.level
    mx = torch.round(states.pos[:, 0] * qp).to(i32)
    my = torch.round((states.pos[:, 1] - 0.5) * qp).to(i32)
    cam_x = mx.to(torch.float32) / qp
    cam_y = my.to(torch.float32) / qp
    _, _, t0_off = phases_lib.phase_tables(PPU, 64, qp)
    t0 = float(np.float32(t0_off))
    merged = torch.where(level.spike_grid, SPIKE, level.grid).to(torch.int8)
    gridp = torch.nn.functional.pad(merged, (W, W, W, W), value=WALL_MID)
    return (gridp, torch.floor(cam_y + t0).to(i32),
            torch.floor(cam_x + t0).to(i32), torch.remainder(my, qp),
            torch.remainder(mx, qp), level.bg_index.to(i32),
            level.theme.to(i32), ST["bg_bank"], ST["tr_tab"],
            ST["tile_bank"], ST["kinds"], ST["themes"],
            _stamp_groups(states, cam_x, cam_y, ST["banks"]), C.OBS, qp, W)


def _needle(states: State):
    """The compass needle (jumper.cpp:497-502) as f32 before rounding,
    [N] each: its rotation bin's angle * 64 / 2pi, and its top-left obs
    pixel (y, x), the needle centred cs/4 along the unit vector to the
    goal."""
    to_goal = states.level.goal_pos - states.pos
    tx, ty = to_goal[:, 0], to_goal[:, 1]
    # sqrt(x**2 + y**2), each op rounded: in the render's graph XLA CPU
    # fuses neither product into the add (a jit of this line alone fuses
    # x * x)
    dist = torch.sqrt(tx * tx + ty * ty)
    dinv = 1.0 / torch.clamp(dist, min=1e-4)
    # round(centre - 16): XLA CPU folds the chain of constant adds, in f32
    # from the f32 constants, into one and fuses the multiply by cs/4
    return (atan2f(ty, tx) * (NEEDLE_BINS / (2 * math.pi)),
            prng._fma32(ty * dinv, _CS * 0.25, _NEEDLE_R0),
            prng._fma32(tx * dinv, _CS * 0.25, _NEEDLE_C0))


def _needle_stamp(states: State):
    """The needle's stamp slot, (var, r0, c0) int32 [N, 1] each: its
    rotation bin, mod 64 after rounding half to even, and its pixel."""
    nvar, nr0, nc0 = _round(*_needle(states))
    return (torch.remainder(nvar, NEEDLE_BINS)[:, None], nr0[:, None],
            nc0[:, None])


def _compass(img, ST):
    """The compass circle over img bf16 [N, 3, OBS, OBS]: img * (1 - a) +
    rgbp in bf16, every op rounded on its own (jumper.py:805-806; plain
    ops, as the JAX package computes it outside any kernel)."""
    return img * (1.0 - ST["compass_a"]) + ST["compass_rgbp"]


def _observe_scene(cfg: Config, states: State):
    """Quantized-camera scene path: background, themed walls, spikes and
    the particle/carrot and bunny stamp groups in one scene kernel pass
    (B1); then the compass circle (`_compass`), and the needle drawn by
    the stamp kernel (B3: P = 32, K = 1 is on its path,
    `compositor.stamp_kernel_ok`)."""
    ST = _scene_tensors(cfg.scene_phases, cfg.world_dim,
                        str(states.pos.device))
    img = _compass(scene_kernel.scene_raw(*_scene_inputs(cfg, states)), ST)
    img = C.composite_stamps(img, ST["banks"]["needle"], *_needle_stamp(states))
    return torch.clamp(torch.round(img), 0, 255).to(torch.uint8)
