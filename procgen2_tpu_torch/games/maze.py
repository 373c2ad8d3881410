"""Maze in PyTorch (procgen2_tpu/games/maze.py), batched.

The same game as the JAX package, which cites the reference engine
(Procgen2's `games/maze/`) line by line: a Kruskal maze of a random odd
size in [3, world_dim] centred in an all-wall world, the goal on a free
cell other than the agent's start (tilemap.cpp:31-109); discrete
cell-snapped movement over 15 actions, where actions 9-14 probe 2-3
cells over, as the reference's unclamped `action / 3 - 1` does
(common_systems.cpp:69-136); +10 on the goal, and the timeout flagged as
`terminated` (maze.cpp:45-50, 295-310); the background, walls, cheese
and mouse in the reference's order (maze.cpp:386-414).

Every function works on a batch: `generate` on a batch of keys [L, 2]
(one level each), `reset`/`step`/`observe_batch`/`observe` on a batch of
envs. The random draws are the JAX package's, key for key (`..random`),
so a level, a state and an observation can be compared with it bit for
bit.

Modes (tilemap.cpp:35-47): easy 15x15 view 15; hard 25x25 view 25 (the
reference's default, tilemap.h:41); memory 31x31 view 8 with an
agent-centred camera.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import random as prng
from ..core import spaces
from ..gen.kruskal import kruskal_maze, masked_uniform_cell
from ..render import atlas as atlas_lib
from ..render import compositor as C

NAME = "maze"
NUM_ACTIONS = 15  # maze.cpp:28
TIMEOUT = 500  # maze.cpp:49
NUM_BGS = 9  # maze.cpp:62-72

_MODES = {  # world_dim, visibility, agent_centered (tilemap.cpp:35-47)
    "easy": (15, 15, False),
    "hard": (25, 25, False),
    "memory": (31, 8, True),
}

EMPTY, WALL = 0, 1  # tilemap.h Tile_ID: empty=0, wall=1
# the render's kinds: 0 empty, 1 wall, 2 cheese, 3 mouse, 4 mouse (flipped),
# 5 mouse on cheese, 6 mouse (flipped) on cheese
CHEESE, MOUSE, MOUSE_FLIP, MOUSE_ON_CHEESE, MOUSE_FLIP_ON_CHEESE = 2, 3, 4, 5, 6


@dataclasses.dataclass(frozen=True)
class Config:
    mode: str = "hard"  # reference default, games/maze/tilemap.h:41
    timeout: int = TIMEOUT

    @property
    def world_dim(self):
        return _MODES[self.mode][0]

    @property
    def visibility(self):
        return _MODES[self.mode][1]

    @property
    def agent_centered(self):
        return _MODES[self.mode][2]


@dataclasses.dataclass
class Level:
    """One level per row of the leading dimension."""
    grid: torch.Tensor  # int8 [L, D, D], render coords [y, x]
    goal_pos: torch.Tensor  # f32 [L, 2], cell centre, render units
    agent_pos: torch.Tensor  # f32 [L, 2]
    maze_dim: torch.Tensor  # i32 [L]
    bg_index: torch.Tensor  # i32 [L]
    bg_offset: torch.Tensor  # f32 [L]


@dataclasses.dataclass
class State:
    """One env per row of the leading dimension."""
    level: Level
    pos: torch.Tensor  # f32 [N, 2]
    face_forward: torch.Tensor  # bool [N]: flips the mouse,
    #                             common_systems.cpp:129-132
    t: torch.Tensor  # i32 [N] step counter (maze.cpp:50)
    rng: torch.Tensor  # int64 [N, 2] key words (carried, never drawn from)


# ---------------------------------------------------------------------------
# Assets (numpy, built by the port's asset modules)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _assets():
    atlas, idx = atlas_lib.build_atlas(("maze_wall", "cheese", "mouse"))
    bgs = atlas_lib.build_backgrounds("topdown", NUM_BGS)  # maze.cpp:62-72
    return atlas.transpose(3, 0, 1, 2), idx, bgs.transpose(3, 0, 1, 2)


# ---------------------------------------------------------------------------
# Generation (tilemap.cpp:31-109), batched over levels
# ---------------------------------------------------------------------------

def generate(cfg: Config, keys: torch.Tensor) -> Level:
    """One level per key: keys int64 [L, 2] -> Level with leading dim L."""
    wd = cfg.world_dim
    L = keys.shape[0]
    dev = keys.device
    k_dim, k_maze, k_goal, k_bg, k_bgoff = prng.split(keys, 5).unbind(-2)

    # maze_dim: a random odd size in [3, world_dim] (tilemap.cpp:62-63)
    n = prng.randint(k_dim, (), 0, (wd - 1) // 2)
    maze_dim = n * 2 + 3
    margin = (wd - maze_dim) // 2  # [L]

    wall = kruskal_maze(k_maze, maze_dim, max_dim=wd)  # [L, i, j]

    # the goal: uniform over free cells but the agent's start (0, 0)
    # (maze_generator.cpp:183-195, place_object excluding START_CELL)
    free = ~wall
    free[:, 0, 0] = False
    gi, gj = masked_uniform_cell(k_goal, free)

    # the maze in the all-wall world, maze coords (i, j) to render coords:
    # x = i + margin, row = wd - 1 - (j + margin) (tilemap.cpp:78-87 with
    # the storage flip folded in)
    xs = torch.arange(wd, device=dev)
    m = margin.long()[:, None, None]
    i = xs[None, None, :] - m  # per column
    j = (wd - 1 - xs)[None, :, None] - m  # per row
    in_maze = ((i >= 0) & (i < maze_dim.long()[:, None, None]) & (j >= 0)
               & (j < maze_dim.long()[:, None, None]))
    lv = torch.arange(L, device=dev)[:, None, None]
    val = wall[lv, i.clamp(0, wd - 1), j.clamp(0, wd - 1)]
    grid = torch.where(in_maze & ~val, EMPTY, WALL).to(torch.int8)

    f32 = torch.float32
    mf = margin.to(f32)
    goal_pos = torch.stack([gi.to(f32) + mf + 0.5,
                            (wd - 1) - (gj.to(f32) + mf) + 0.5], -1)
    agent_pos = torch.stack([mf + 0.5, (wd - 1) - mf + 0.5], -1)
    return Level(
        grid=grid,
        goal_pos=goal_pos,  # tilemap.cpp:92
        agent_pos=agent_pos,  # tilemap.cpp:99-101
        maze_dim=maze_dim.to(torch.int32),
        bg_index=prng.randint(k_bg, (), 0, NUM_BGS),  # maze.cpp:424-426
        bg_offset=prng.uniform(k_bgoff),  # maze.cpp:428-430
    )


def reset(cfg: Config, level: Level, keys: torch.Tensor) -> State:
    """Fresh episodes on `level` (leading dim N) with keys [N, 2]."""
    N = keys.shape[0]
    dev = keys.device
    return State(
        level=level,
        pos=level.agent_pos,
        face_forward=torch.zeros(N, dtype=torch.bool, device=dev),
        t=torch.zeros(N, dtype=torch.int32, device=dev),
        rng=keys,
    )


# ---------------------------------------------------------------------------
# Step (maze.cpp:279-310 + common_systems.cpp:69-136)
# ---------------------------------------------------------------------------

def _tile(grid, tx, ty):
    """grid [N, D, D] at (row ty, column tx) int [N]; outside is WALL."""
    D = grid.shape[-1]
    inb = (tx >= 0) & (tx < D) & (ty >= 0) & (ty < D)
    n = torch.arange(grid.shape[0], device=grid.device)
    return torch.where(inb, grid[n, ty.clamp(0, D - 1).long(),
                                 tx.clamp(0, D - 1).long()], WALL)


def step(cfg: Config, state: State, action):
    """One env step for every env: (State, reward f32 [N], done bool [N],
    info {})."""
    level = state.level
    grid = level.grid
    px, py = state.pos[:, 0], state.pos[:, 1]
    i32 = torch.int32

    # 15-action grid movement (common_systems.cpp:88-89): movement_x =
    # action / 3 - 1 is not range-clamped, so actions 9-14 probe 2-3
    # cells over
    a = action.to(i32)
    mx = torch.div(a, 3, rounding_mode="floor") - 1
    my = torch.where(mx != 0, 0, -(torch.remainder(a, 3) - 1))  # render y

    # C-style truncation toward zero (int casts, common_systems.cpp:92-99)
    tx = (px + mx).to(i32)
    ty = (py + my).to(i32)
    can_x = (mx != 0) & (_tile(grid, tx, py.to(i32)) == EMPTY)
    can_y = (mx == 0) & (my != 0) & (_tile(grid, px.to(i32), ty) == EMPTY)
    px = torch.where(can_x, tx.to(torch.float32) + 0.5, px)
    py = torch.where(can_y, ty.to(torch.float32) + 0.5, py)
    pos = torch.stack([px, py], -1)

    face_forward = torch.where(mx > 0, True, torch.where(
        mx < 0, False, state.face_forward))  # common_systems.cpp:129-132

    # the goal's AABB overlap, both 1x1 boxes on cell centres
    # (common_systems.cpp:103-117, check_collision)
    reached = (torch.abs(pos - level.goal_pos) < 1.0).all(-1)

    reward = reached.to(torch.float32) * 10.0  # maze.cpp:300
    t = state.t + 1
    # the timeout flagged as `terminated`, not truncated: the reference's
    # quirk, maze.cpp:308-310
    terminated = reached | (t >= cfg.timeout)
    return (State(level=level, pos=pos, face_forward=face_forward, t=t,
                  rng=state.rng), reward, terminated, {})


# ---------------------------------------------------------------------------
# Rendering (maze.cpp:386-414): the kind field
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _observe_assets(device: str):
    """The exact render's atlas u8 [A, 4, S, S], backgrounds u8
    [B, 3, H, W] (both on `device`), sprite indices and tile lut."""
    atlas, idx, bgs = _assets()
    return dict(atlas=C.bank(atlas, device), bgs=C.bank(bgs, device),
                idx=idx, lut=[-1, idx["maze_wall"]])


def observe(cfg: Config, state: State, size: int = C.OBS):
    """Each env's frame at size x size by the exact render (maze.cpp:
    386-414): background, walls, cheese and mouse over the whole frame,
    the camera spanning the same world at any size. uint8
    [N, size, size, 3]."""
    R = _observe_assets(str(state.pos.device))
    level = state.level
    N = state.pos.shape[0]
    dev = state.pos.device
    wd = cfg.world_dim
    ppu = size / cfg.visibility  # maze.cpp:397: zoom fits the visible width
    center = wd / 2.0
    if cfg.agent_centered:
        # the camera follows the agent once stepping begins
        # (common_systems.cpp:120-123); the first frame after reset uses
        # the map centre (maze.cpp:436-437)
        cam_x = torch.where(state.t > 0, state.pos[:, 0], center)
        cam_y = torch.where(state.t > 0, state.pos[:, 1], center)
    else:
        cam_x = cam_y = torch.full((N,), center, dtype=torch.float32,
                                   device=dev)
    wx, wy = C.camera_coords(ppu, cam_x, cam_y, size)

    img = C.clear(N, size, dev)
    img = C.draw_background(img, R["bgs"], level.bg_index, wx, wy)
    img = C.draw_tiles(img, level.grid, R["lut"], R["atlas"], wx, wy,
                       oob_tile=WALL)
    # the cheese: offset (-0.48, -0.5), scale 0.95 (tilemap.cpp:95)
    img = C.draw_sprite(img, R["atlas"], R["idx"]["cheese"],
                        level.goal_pos[:, 0] - 0.48,
                        level.goal_pos[:, 1] - 0.5, 0.95, 0.95, wx, wy)
    # the agent: 1x1 at pos, flipped when facing forward
    # (common_systems.cpp:138-149)
    img = C.draw_sprite(img, R["atlas"], R["idx"]["mouse"],
                        state.pos[:, 0] - 0.5, state.pos[:, 1] - 0.5, 1.0,
                        1.0, wx, wy, flip_x=state.face_forward)
    return C.finalize(img)


def obs_space(cfg: Config):
    return spaces.Box(0, 255, (C.OBS, C.OBS, 3))  # maze.cpp:117-125


def action_space(cfg: Config):
    return spaces.MultiDiscrete((NUM_ACTIONS,))  # maze.cpp:127-135


@functools.lru_cache(maxsize=None)
def _tables(mode: str):
    """The render's selectors, numpy (no batch dim; the view is square and
    centred, so each holds for rows and columns alike). The texels of a
    tile (u, v) and of the cheese's rect (top-left cell + (0.02, 0), size
    0.95, tilemap.cpp:95: cu, cv, with whether each pixel lies on it; XLA
    divides by 0.95 as a multiply by its f32 reciprocal). A fixed camera
    (easy, hard) also has the tile under each obs column / row (tx, ty)
    and the background's texel (ub, vb, with ub_ok, vb_ok; it spans 64
    units from the origin, maze.cpp:403-408). Memory mode: the camera
    sits on a cell centre (its first frame at the map centre, wd = 31,
    also a cell centre), so every env's tiles are its camera cell plus
    shared offsets (sx, sy), and its texel selectors are traced with the
    camera at cell 0 (world 0.5)."""
    cfg = Config(mode=mode)
    wd = cfg.world_dim
    ppu = C.OBS / cfg.visibility  # maze.cpp:397: zoom fits the visible width
    f32 = np.float32
    cam = f32(0.5) if cfg.agent_centered else f32(wd / 2.0)
    c = np.arange(C.OBS, dtype=f32) + f32(0.5 - C.OBS / 2)
    w = cam + c / f32(ppu)
    t = np.floor(w).astype(np.int32)
    frac = w - t.astype(f32)

    def tex(x):
        return np.clip((x * f32(C.S)).astype(np.int32), 0, C.S - 1)

    inv = f32(1.0) / f32(0.95)
    cu, cv = (frac - f32(0.02)) * inv, frac * inv
    out = dict(u=tex(frac), v=tex(frac), cu=tex(cu),
               cu_ok=(cu >= 0) & (cu < 1), cv=tex(cv),
               cv_ok=(cv >= 0) & (cv < 1))
    if cfg.agent_centered:
        out.update(sx=t, sy=t)
        return out
    # the view fits the maze (visibility == world_dim): no pixel lies off
    # the grid, so the JAX package's out-of-grid WALL never shows here
    assert ((t >= 0) & (t < wd)).all()
    b = w * f32(1 / 64.0)
    bi = np.clip((b * f32(atlas_lib.BG_SIZE)).astype(np.int32), 0,
                 atlas_lib.BG_SIZE - 1)
    b_ok = (b >= 0) & (b < 1)
    out.update(tx=t, ty=t, ub=bi, ub_ok=b_ok, vb=bi, vb_ok=b_ok)
    return out


@functools.lru_cache(maxsize=None)
def _render_tensors(mode: str, device: str):
    """The render's constant tensors on `device` (built once per mode and
    device): the four kind images (wall, cheese, mouse, flipped mouse) as
    (rgb, a) pairs for `compositor.blend_kind`; the fixed camera's
    backgrounds pre-sampled, u8 [B, 3, OBS, OBS]; the selectors as index
    tensors (memory mode: the shared tile offsets, and the backgrounds
    u8 [B, 3, H, W] for `draw_background_batch`)."""
    atlas, idx, bgs = _assets()
    T = _tables(mode)
    dev = torch.device(device)
    kinds = {
        "wall": C.kind_image(atlas[:, idx["maze_wall"]], T["v"], T["u"]),
        "cheese": C.kind_image(atlas[:, idx["cheese"]], T["cv"], T["cu"],
                               T["cv_ok"], T["cu_ok"]),
        "mouse": C.kind_image(atlas[:, idx["mouse"]], T["v"], T["u"]),
        # the flipped one-hot (ohu_t[:, ::-1]) selects texel S - 1 - u
        "mouse_flip": C.kind_image(atlas[:, idx["mouse"]], T["v"],
                                   C.S - 1 - T["u"]),
    }
    out = {k: tuple(x.to(dev) for x in v) for k, v in kinds.items()}
    bgs_t = torch.from_numpy(np.ascontiguousarray(bgs.transpose(1, 0, 2, 3)))
    if Config(mode=mode).agent_centered:
        out.update(sx=torch.from_numpy(T["sx"]).long().to(dev),
                   sy=torch.from_numpy(T["sy"]).long().to(dev),
                   bgs=bgs_t.to(dev))
        return out
    t = {k: torch.from_numpy(T[k]) for k in T}
    # pre-sampled backgrounds, exact integers (maze.py:294-299)
    bg_bank = C.sep_sample(bgs_t.to(torch.bfloat16), t["vb"].long(),
                           t["ub"].long(), t["vb_ok"], t["ub_ok"])
    out.update(
        tx=t["tx"].long().to(dev), ty=t["ty"].long().to(dev),
        bg_bank=torch.clamp(torch.round(bg_bank), 0, 255).to(
            torch.uint8).to(dev))
    return out


def _augmented(states: State):
    """The kind grid int8 [N, D, D]: the tiles, the cheese on the goal
    cell, then the mouse (kinds 3-6) on the agent's cell."""
    level = states.level
    i32 = torch.int32
    n = torch.arange(states.pos.shape[0], device=states.pos.device)
    gx, gy = level.goal_pos[:, 0].to(i32), level.goal_pos[:, 1].to(i32)
    mx, my = states.pos[:, 0].to(i32), states.pos[:, 1].to(i32)
    on_cheese = (mx == gx) & (my == gy)
    flip = states.face_forward
    mval = torch.where(on_cheese,
                       torch.where(flip, MOUSE_FLIP_ON_CHEESE, MOUSE_ON_CHEESE),
                       torch.where(flip, MOUSE_FLIP, MOUSE)).to(torch.int8)
    aug = level.grid.clone()
    aug[n, gy.long(), gx.long()] = CHEESE
    aug[n, my.long(), mx.long()] = mval
    return aug


def _compose(img, G, R):
    """The four kind layers over img bf16 [N, 3, OBS, OBS] by the kind
    field G int8 [N, 1, OBS, OBS], then the obs u8 (maze.py:341-350)."""
    img = C.blend_kind(img, G == WALL, *R["wall"])
    img = C.blend_kind(img, (G == CHEESE) | (G >= MOUSE_ON_CHEESE),
                       *R["cheese"])
    img = C.blend_kind(img, (G == MOUSE) | (G == MOUSE_ON_CHEESE), *R["mouse"])
    img = C.blend_kind(img, (G == MOUSE_FLIP) | (G == MOUSE_FLIP_ON_CHEESE),
                       *R["mouse_flip"])
    return torch.clamp(torch.round(img), 0, 255).to(torch.uint8)


def _kind_field(states: State, R):
    """The kind under each obs pixel of the fixed camera, int8
    [N, 1, OBS, OBS]."""
    return _augmented(states)[:, R["ty"]][:, :, R["tx"]][:, None]


def observe_batch(cfg: Config, states: State):
    """Planar uint8 [N, 3, OBS, OBS]. The fixed camera of easy and hard
    (maze.cpp:397: the zoom fits the whole maze) puts every object on a
    cell: the mouse spans its cell, and the cheese's rect stays inside
    its own. So the cheese and mouse are extra tile kinds, and each kind's
    texel image is the same for every env: the per-env work is the kind
    grid, its field under the pixels and the background row. Memory mode
    takes `_observe_batch_memory`."""
    if cfg.agent_centered:
        return _observe_batch_memory(cfg, states)
    R = _render_tensors(cfg.mode, str(states.pos.device))
    G = _kind_field(states, R)
    img = R["bg_bank"][states.level.bg_index.long()].to(torch.bfloat16)
    return _compose(img, G, R)


def _observe_batch_memory(cfg: Config, states: State):
    """Memory mode's agent-centred camera (maze.py:353-457). The agent
    only sits on cell centres, so every env's pixel-to-texel pattern is
    the shared one and its tiles are shifted by a whole cell: the per-env
    work is the kind grid, its shifted field, and the scrolling
    background. The first frame after reset uses the map centre
    (maze.cpp:436-437)."""
    R = _render_tensors(cfg.mode, str(states.pos.device))
    wd = cfg.world_dim
    ppu = C.OBS / cfg.visibility
    N = states.pos.shape[0]
    i32 = torch.int32
    center = wd / 2.0
    cam_x = torch.where(states.t > 0, states.pos[:, 0], center)
    cam_y = torch.where(states.t > 0, states.pos[:, 1], center)
    kx = torch.round(cam_x - 0.5).to(i32).long()  # the camera's cell
    ky = torch.round(cam_y - 0.5).to(i32).long()

    aug = _augmented(states)
    tX = kx[:, None] + R["sx"]  # [N, OBS]
    tY = ky[:, None] + R["sy"]
    inb = (((tY >= 0) & (tY < wd))[:, :, None]
           & ((tX >= 0) & (tX < wd))[:, None, :])
    rows = aug.gather(1, tY.clamp(0, wd - 1)[:, :, None].expand(N, -1, wd))
    G = rows.gather(2, tX.clamp(0, wd - 1)[:, None, :].expand(
        N, C.OBS, C.OBS))
    G = torch.where(inb, G, torch.tensor(WALL, dtype=torch.int8,
                                         device=G.device))[:, None]

    # the scrolling background (origin 0, 64 units, maze.cpp:403-408)
    wx_b, wy_b = C.camera_coords(ppu, cam_x, cam_y)
    img = C.draw_background_batch(R["bgs"], states.level.bg_index, wx_b,
                                  wy_b)
    return _compose(img, G, R)
