"""Caveflyer in PyTorch (procgen2_tpu/games/caveflyer.py), batched.

The same game as the JAX package, which cites the reference engine
(Procgen2's `games/caveflyer/`) line by line: a cellular-automata cave
(uniform 50% seed, 2 passes, the largest room), distinct goal and agent
cells, the BFS path, the cave pruned to the path dilated 4 times (not in
"memory" mode), then meteors, red-UFO targets and moving enemy ships on
free cells off the path (tilemap.cpp:118-278); the ship's rotation,
thrust and drag with tile collisions; a 32-slot bullet ring that hits
walls, meteors, targets (+3) and enemies and explodes; enemies that
reverse on walls; thrust smoke; +10 at the goal and death on a hazard,
over 4 physics sub-steps with early exit (caveflyer.cpp:302-341,
common_systems.cpp:50-396); and the quantized-camera scene render through
the scene kernel, with four stamp groups (smoke, objects, bullets, ship).

Every function works on a batch: `generate` on a batch of keys [L, 2]
(one level each), `reset`/`step`/`observe_batch`/`observe` on a batch of
envs. The random draws are the JAX package's, key for key (`..random`),
and the ship's cos/sin are XLA CPU's (`..trig`), so a level, a state and
an observation can be compared with it bit for bit.

Modes (tilemap.cpp:121-126): easy 20, hard 40, memory 45 (no prune).
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
from ..gen.kruskal import masked_uniform_cell
from ..physics.tiles import FULL, NONE, probe_any_solid, resolve_tile_collisions
from ..render import atlas as atlas_lib
from ..render import compositor as C
from ..render import phases as phases_lib
from ..render import scene_kernel
from ..trig import sincos32

NAME = "caveflyer"
NUM_ACTIONS = 15
SUB_STEPS = 4  # caveflyer.cpp:44
DT = 1.0 / SUB_STEPS
ZOOM = 0.5  # caveflyer.cpp:32
PPU = 16.0 * ZOOM

# Ship physics (common_systems.cpp:95-101)
ACCEL = 0.05
SPIN_RATE = 0.05
VEL_DECAY = 0.1
REVERSE_MUL = 0.5
BULLET_TIME = 0.5
BULLET_SPEED = 1.0
EXPLOSION_RATE = 0.5

NUM_BULLETS = 32  # common_systems.cpp:87
NUM_PARTICLES = 10  # tilemap.cpp:198
PART_LIFESPAN = 5.0
PART_SPAWN_TIME = 0.5

_MODES = {"easy": 20, "hard": 40, "memory": 45}
NUM_BGS = 13  # caveflyer.cpp:59-73 (13 space backgrounds)

_LUT_WALL = (NONE, FULL)  # wall -> full
# `jnp.pi * 0.5` as XLA adds it to an f32 angle: the f32 nearest pi/2
_HALF_PI = float(np.float32(math.pi * 0.5))
# the ship's centre less its position in the exact render: XLA folds
# (pos - offset) + 0.5 * size into pos + f32(0.5 * size) - f32(offset)
_SHIP_DX = float(np.float32(0.5 * 0.928) - np.float32(0.464))
_SHIP_DY = float(np.float32(0.5 * 0.703) - np.float32(0.352))

SHIP_ROT_BINS = 32
BULLET_ROT_BINS = 16
PART_ROT_BINS = 8
PART_SCALE_BINS = 4


@dataclasses.dataclass(frozen=True)
class Config:
    mode: str = "easy"
    # Render-only: camera phase quantization of the scene render
    # (render/phases.py); 0 = the exact, continuous camera.
    scene_phases: int = 4

    @property
    def world_dim(self):
        return _MODES[self.mode]

    @property
    def prune(self):
        return self.mode != "memory"  # tilemap.cpp:203

    @property
    def max_obj(self):
        # chunk_size = |free|/80 per class (tilemap.cpp:234-235)
        return self.world_dim * self.world_dim // 80 + 1


@dataclasses.dataclass
class Level:
    """One level per row of the leading dimension."""
    wall: torch.Tensor  # bool [L, D, D] render coords [ry, x]
    goal_pos: torch.Tensor  # f32 [L, 2]
    agent_pos: torch.Tensor  # f32 [L, 2]
    obst_pos: torch.Tensor  # f32 [L, M, 2] meteor obstacles
    obst_exists: torch.Tensor  # bool [L, M]
    target_pos: torch.Tensor  # f32 [L, M, 2] destroyable red UFOs
    target_exists: torch.Tensor  # bool [L, M]
    enemy_pos0: torch.Tensor  # f32 [L, M, 2]
    enemy_vel0: torch.Tensor  # f32 [L, M, 2]
    enemy_exists: torch.Tensor  # bool [L, M]
    bg_index: torch.Tensor  # i32 [L]
    bg_offset: torch.Tensor  # f32 [L]


@dataclasses.dataclass
class State:
    """One env per row of the leading dimension."""
    level: Level
    pos: torch.Tensor  # f32 [N, 2]
    vel: torch.Tensor  # f32 [N, 2]
    rot: torch.Tensor  # f32 [N] heading (0 = +x, screen-clockwise)
    bullet_timer: torch.Tensor  # f32 [N] (system-level, common_systems.h)
    b_pos: torch.Tensor  # f32 [N, 32, 2]
    b_vel: torch.Tensor  # f32 [N, 32, 2]
    b_rot: torch.Tensor  # f32 [N, 32]
    b_frame: torch.Tensor  # f32 [N, 32]: -1 dead, 0 live, [1, 5) explosion
    num_bullets: torch.Tensor  # i32 [N]
    next_bullet: torch.Tensor  # i32 [N]
    target_alive: torch.Tensor  # bool [N, M]
    enemy_pos: torch.Tensor  # f32 [N, M, 2]
    enemy_vel: torch.Tensor  # f32 [N, M, 2]
    part_pos: torch.Tensor  # f32 [N, 10, 2]
    part_life: torch.Tensor  # f32 [N, 10]
    part_dir: torch.Tensor  # f32 [N, 10, 2]
    part_rot: torch.Tensor  # f32 [N, 10]
    part_spawn_timer: torch.Tensor  # f32 [N]
    t: torch.Tensor  # i32 [N]
    rng: torch.Tensor  # int64 [N, 2] key words


# ---------------------------------------------------------------------------
# Assets (numpy, built by the port's asset modules)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _assets():
    names = ["cave_wall", "ufo_green", "ufo_red", "meteor", "enemy_ship",
             "laser", "ship_red", "smoke"]
    names += [f"explosion{i}" for i in range(5)]
    atlas, idx = atlas_lib.build_atlas(tuple(names))
    bgs = atlas_lib.build_backgrounds("space", NUM_BGS)
    return dict(atlas_p=atlas.transpose(3, 0, 1, 2), idx=idx,
                bgs_p=bgs.transpose(3, 0, 1, 2))


@functools.lru_cache(maxsize=None)
def _stamp_banks():
    """Pixel-snapped patch banks u8 [V, 4, P, P]; rotation (ship, bullets,
    smoke) is a quantized variant index: obj (meteor, red UFO, enemy ship,
    green UFO; P = 8), bullet (16 laser rotations, 5 explosion frames;
    P = 4), ship (32 rotations; P = 12), part (4 scales x 8 rotations of
    the smoke puff; P = 10)."""
    A = atlas_lib
    obj = A.build_pixel_bank(
        (("meteor", 0.8 * PPU, 0.8 * 84 / 101 * PPU),
         ("ufo_red", 0.8 * PPU, 0.8 * PPU),
         ("enemy_ship", 0.8 * PPU, 0.8 * 84 / 82 * PPU),
         ("ufo_green", 0.8 * PPU, 0.8 * PPU)),
        patch=8)
    specs = [("laser", 0.081 * PPU, 0.231 * PPU,
              t * 2 * math.pi / BULLET_ROT_BINS)
             for t in range(BULLET_ROT_BINS)]
    specs += [(f"explosion{i}", 0.375 * PPU, 0.375 * PPU) for i in range(5)]
    bullet = A.build_pixel_bank(tuple(specs), patch=4)
    ship = A.build_pixel_bank(
        tuple(("ship_red", 0.928 * PPU, 0.703 * PPU,
               t * 2 * math.pi / SHIP_ROT_BINS)
              for t in range(SHIP_ROT_BINS)),
        patch=12)
    specs = []
    for s in range(PART_SCALE_BINS):
        sc = 0.6 + 0.4 * (s + 0.5) / PART_SCALE_BINS
        for t in range(PART_ROT_BINS):
            specs.append(("smoke", sc * PPU, sc * PPU,
                          t * 2 * math.pi / PART_ROT_BINS))
    part = A.build_pixel_bank(tuple(specs), patch=10)
    return dict(obj=obj, bullet=bullet, ship=ship, part=part)


@functools.lru_cache(maxsize=None)
def _scene_assets(qp, D):
    """Tile phase bank of the one wall kind, padded backgrounds and the
    phase offset table of the scene render (numpy)."""
    A = _assets()
    atlas_s = np.asarray(A["atlas_p"]).transpose(1, 0, 2, 3)
    tex = atlas_s[A["idx"]["cave_wall"]][None]
    bank = phases_lib.tile_phase_bank(tex, PPU, 64, qp)
    W = phases_lib.win(PPU, 64, qp)
    GP = D + 2 * W
    bgs = np.asarray(A["bgs_p"])  # [3, NB, 64, 64]
    bgpad = np.zeros((bgs.shape[1], 3, GP, GP), np.uint8)
    n = min(64, GP - W)
    bgpad[:, :, W:W + n, W:W + n] = bgs.transpose(1, 0, 2, 3)[:, :, :n, :n]
    TR, _, _ = phases_lib.phase_tables(PPU, 64, qp)
    return dict(bank=bank, kinds=(1,), themes=(-1,), bgpad=bgpad,
                TRtab=TR[:, None, :].astype(np.int32), win=W)


@functools.lru_cache(maxsize=None)
def _scene_tensors(qp, D, device):
    """The scene render's constant tensors on `device` (built once per
    device): bf16 tile bank, bg bank, TR, the premultiplied stamp banks."""
    SA = _scene_assets(qp, D)
    dev = torch.device(device)
    return dict(
        tile_bank=torch.from_numpy(SA["bank"]).to(torch.bfloat16).to(dev),
        bg_bank=torch.from_numpy(SA["bgpad"]).to(torch.bfloat16).to(dev),
        tr_tab=torch.from_numpy(SA["TRtab"]).to(dev),
        banks=_observe_assets(device)["banks"], kinds=SA["kinds"],
        themes=SA["themes"], win=SA["win"])


@functools.lru_cache(maxsize=None)
def _observe_assets(device: str):
    """The constant tensors of the exact renders on `device`: the atlas
    and backgrounds (`C.bank`), the premultiplied stamp banks and the
    explosion frames' atlas indices."""
    A = _assets()
    idx = A["idx"]
    dev = torch.device(device)
    return dict(
        atlas=C.bank(A["atlas_p"], device), bgs=C.bank(A["bgs_p"], device),
        idx=idx, expl=torch.tensor([idx[f"explosion{i}"] for i in range(5)],
                                   device=dev),
        banks={k: C._premultiply_bank(v).to(dev)
               for k, v in _stamp_banks().items()})


# ---------------------------------------------------------------------------
# Generation (tilemap.cpp:118-278), batched over levels
# ---------------------------------------------------------------------------

def _cell_pos(x, y, D, dy=0.5):
    """(x, y_up) cell -> f32 render position [L, 2]: (x + 0.5,
    D - 1 - y + dy)."""
    f32 = torch.float32
    return torch.stack([x.to(f32) + 0.5, (D - 1.0) - y.to(f32) + dy], dim=-1)


def generate(cfg: Config, keys: torch.Tensor) -> Level:
    """One level per key: keys int64 [L, 2] -> Level with leading dim L."""
    D = cfg.world_dim
    M = cfg.max_obj
    L = keys.shape[0]
    dev = keys.device
    f32 = torch.float32
    k_seed, k_goal, k_agent, k_obj, k_vel, k_bg, k_bgoff = (
        prng.split(keys, 7).unbind(-2))
    n = torch.arange(L, device=dev)

    # CA cave from a uniform 50% seed (tilemap.cpp:142-146); [L, x, y_up]
    wall = prng.uniform(k_seed, (D, D)) < 0.5
    for _ in range(2):
        wall = rooms.ca_smooth(wall)
    room = rooms.largest_room(~wall, iters=D * D // 2)

    # Goal and agent: two uniform draws over the free cells; equal cells
    # move the agent to the next free cell in flat order, cyclic
    # (tilemap.cpp:163-172)
    gx, gy = masked_uniform_cell(k_goal, room)
    ax0, ay0 = masked_uniform_cell(k_agent, room)
    same = (ax0 == gx) & (ay0 == gy)
    flat = torch.arange(D * D, device=dev)[None]
    open_flat = room.reshape(L, -1)
    after = open_flat & (flat > (ax0 * D + ay0)[:, None])
    nxt = torch.where(after.any(1), torch.argmax(after.to(torch.int32), 1),
                      torch.argmax(open_flat.to(torch.int32), 1))
    ax = torch.where(same, nxt // D, ax0)
    ay = torch.where(same, nxt % D, ay0)
    goal_pos = _cell_pos(gx, gy, D)
    # the agent's spawn y lacks the +0.5 (tilemap.cpp:189)
    agent_pos = _cell_pos(ax, ay, D, dy=0.0)

    # BFS path and prune (tilemap.cpp:200-215); the 4 extra CA passes of
    # tilemap.cpp:217-222 never touch the tile map and are left out
    dist = rooms.bfs_dist(room, ax, ay, iters=D * D // 2)
    path = rooms.shortest_path_mask(dist, gx, gy)
    open_f = rooms.dilate_in(path, room, 4) if cfg.prune else room

    # Objects on distinct free cells off the path (tilemap.cpp:224-272):
    # every slot draws; slot j of a class exists if j < |free| / 80
    avail = open_f & ~path
    chunk = avail.sum((1, 2)) // 80
    okeys = prng.split(k_obj, 3 * M)
    vkeys = prng.split(k_vel, 2 * M)
    positions, exists = [], []
    for i in range(3 * M):
        have = (i % M) < chunk
        ox, oy = masked_uniform_cell(okeys[:, i], avail)
        avail[n, ox, oy] = avail[n, ox, oy] & ~have
        positions.append(_cell_pos(ox, oy, D))
        exists.append(have)
    positions = torch.stack(positions, dim=1)  # [L, 3M, 2]
    exists = torch.stack(exists, dim=1)
    enemy_pos = positions[:, 2 * M:]

    # Enemy velocities (tilemap.cpp:68-101): the axis avoids a head-on
    # collision with the agent's spawn (check_neighbors, tilemap.cpp:104-115)
    vels = []
    for i in range(M):
        kv, ks, ka = prng.split(vkeys[:, i], 3).unbind(-2)
        # XLA CPU fuses 0.1 * u + 0.1 into one multiply-add
        comp = prng._fma32(prng.uniform(kv), 0.1, 0.1) * torch.where(
            prng.uniform(ks) < 0.5, 1.0, -1.0)
        d = torch.abs(enemy_pos[:, i] - agent_pos)
        dx, dy = d[:, 0], d[:, 1]
        col = torch.where((dx <= 1e-3) & (dy <= 2.0), 1,
                          torch.where((dx <= 2.0) & (dy <= 1e-3), 2, 0))
        axis_x = torch.where(col == 1, True, torch.where(
            col == 2, False, prng.uniform(ka) < 0.5))
        zero = torch.zeros_like(comp)
        vels.append(torch.where(axis_x[:, None],
                                torch.stack([comp, zero], -1),
                                torch.stack([zero, comp], -1)))

    return Level(
        wall=torch.flip(~open_f.transpose(1, 2), dims=(1,)).contiguous(),
        goal_pos=goal_pos,
        agent_pos=agent_pos,
        obst_pos=positions[:, :M].contiguous(),
        obst_exists=exists[:, :M].contiguous(),
        target_pos=positions[:, M:2 * M].contiguous(),
        target_exists=exists[:, M:2 * M].contiguous(),
        enemy_pos0=enemy_pos.contiguous(),
        enemy_vel0=torch.stack(vels, dim=1).to(f32),
        enemy_exists=exists[:, 2 * M:].contiguous(),
        bg_index=prng.randint(k_bg, (), 0, NUM_BGS),
        bg_offset=prng.uniform(k_bgoff),
    )


def reset(cfg: Config, level: Level, keys: torch.Tensor) -> State:
    """Fresh episodes on `level` (leading dim N) with keys [N, 2]."""
    N = keys.shape[0]
    dev = keys.device
    f32 = torch.float32

    def zeros(*shape):
        return torch.zeros((N,) + shape, dtype=f32, device=dev)

    return State(
        level=level,
        pos=level.agent_pos,
        vel=zeros(2),
        rot=zeros(),
        bullet_timer=zeros(),
        b_pos=zeros(NUM_BULLETS, 2),
        b_vel=zeros(NUM_BULLETS, 2),
        b_rot=zeros(NUM_BULLETS),
        b_frame=torch.full((N, NUM_BULLETS), -1.0, dtype=f32, device=dev),
        num_bullets=torch.zeros(N, dtype=torch.int32, device=dev),
        next_bullet=torch.zeros(N, dtype=torch.int32, device=dev),
        target_alive=level.target_exists,
        enemy_pos=level.enemy_pos0,
        enemy_vel=level.enemy_vel0,
        part_pos=zeros(NUM_PARTICLES, 2),
        part_life=zeros(NUM_PARTICLES),
        part_dir=zeros(NUM_PARTICLES, 2),
        part_rot=zeros(NUM_PARTICLES),
        part_spawn_timer=zeros(),
        t=torch.zeros(N, dtype=torch.int32, device=dev),
        rng=keys,
    )


# ---------------------------------------------------------------------------
# Step (caveflyer.cpp:302-341)
# ---------------------------------------------------------------------------

def _ring_window(next_bullet, num_bullets):
    """Mask [N, 32] of the `num_bullets` ring slots before next_bullet
    (common_systems.cpp:217-218)."""
    j = torch.arange(NUM_BULLETS, device=next_bullet.device)
    back = torch.remainder(next_bullet[:, None] - 1 - j, NUM_BULLETS)
    return back < num_bullets[:, None]


def _span(c, half):
    """A rect's edges (c - half, c + half) about its centre c. The JAX
    package writes check_collision(c - half, ..., 2 * half, ...), whose
    far edge (c - half) + 2 * half XLA folds into c + half (one rounding);
    these are the edges the comparisons see."""
    return c - half, c + half


def _overlap(a, b):
    """Strict overlap (check_collision, helpers.cpp:40-46) of rects given
    by their edges ((x_lo, x_hi), (y_lo, y_hi)), broadcast."""
    (axl, axh), (ayl, ayh) = a
    (bxl, bxh), (byl, byh) = b
    return (axl < bxh) & (axh > bxl) & (ayl < byh) & (ayh > byl)


def _entities(pos, half):
    """Rects [N, 1, M] of entities pos [N, M, 2] about their centres."""
    return (_span(pos[:, None, :, 0], half), _span(pos[:, None, :, 1], half))


def _hazard_hit(level, target_alive, enemy_pos, ship):
    """The agent's rect (edges [N, 1, 1]) against every hazard
    (common_systems.cpp:182-195)."""
    def hit(pos, half, alive):
        return (alive[:, None] & _overlap(ship, _entities(pos, half)))[:, 0].any(1)

    return (hit(level.obst_pos, 0.25, level.obst_exists)
            | hit(level.target_pos, 0.25, target_alive)
            | hit(enemy_pos, 0.4, level.enemy_exists))


def step(cfg: Config, state: State, action):
    """One env step for every env: (State, reward f32 [N], done bool [N],
    info {})."""
    level = state.level
    a = action.to(torch.int32)
    N = a.shape[0]
    dev = a.device
    f32 = torch.float32
    i32 = torch.int32

    pos, vel, rot = state.pos, state.vel, state.rot
    bullet_timer = state.bullet_timer
    b_pos, b_vel = state.b_pos, state.b_vel
    b_rot, b_frame = state.b_rot, state.b_frame
    num_b, next_b = state.num_bullets, state.next_bullet
    target_alive = state.target_alive
    enemy_pos, enemy_vel = state.enemy_pos, state.enemy_vel
    part_pos, part_life = state.part_pos, state.part_life
    part_dir, part_rot = state.part_dir, state.part_rot
    spawn_timer = state.part_spawn_timer
    done = torch.zeros(N, dtype=torch.bool, device=dev)
    reward = torch.zeros(N, dtype=f32, device=dev)

    movement_x = (((a == 6) | (a == 7) | (a == 8)).to(f32)
                  - ((a == 0) | (a == 1) | (a == 2)).to(f32))
    movement_y = (((a == 2) | (a == 5) | (a == 8)).to(f32)
                  - ((a == 0) | (a == 3) | (a == 6)).to(f32))
    movement_y = torch.where(movement_y < 0, movement_y * REVERSE_MUL,
                             movement_y)
    fire = a == 9
    grid = level.wall.to(torch.int8)
    slots = torch.arange(NUM_BULLETS, device=dev)
    pslots = torch.arange(NUM_PARTICLES, device=dev)
    M = level.target_exists.shape[1]
    targets = torch.arange(M, device=dev)

    for _ in range(SUB_STEPS):
        active = ~done

        # ---- ship steering and thrust (common_systems.cpp:119-156) ----
        n_rot = rot + movement_x * SPIN_RATE * DT
        dirx, diry = sincos32(n_rot)

        # fire: spawn a bullet (common_systems.cpp:131-147)
        can_spawn = fire & (bullet_timer == 0.0) & (num_b < NUM_BULLETS)
        upd = can_spawn[:, None] & (slots[None] == next_b[:, None])
        b_rot_n = torch.where(upd, n_rot[:, None], b_rot)
        bvel = torch.stack([dirx * BULLET_SPEED, diry * BULLET_SPEED], -1)
        b_vel_n = torch.where(upd[..., None], bvel[:, None], b_vel)
        b_pos_n = torch.where(upd[..., None], pos[:, None], b_pos)
        b_frame_n = torch.where(upd, 0.0, b_frame)
        n_next_b = torch.where(can_spawn, (next_b + 1) % NUM_BULLETS, next_b)
        n_num_b = num_b + can_spawn.to(i32)
        # the timer only decays while fire is held and a spawn is blocked
        n_btimer = torch.where(
            can_spawn, BULLET_TIME,
            torch.where(fire, torch.clamp(bullet_timer - DT, min=0.0),
                        bullet_timer))

        dm = torch.stack([dirx, diry], -1) * movement_y[:, None]
        # XLA CPU fuses dm * 0.05 - vel * 0.1 into one multiply-add; the
        # * DT products are exact
        n_vel = vel + prng._fma32(dm, ACCEL, -(vel * VEL_DECAY)) * DT
        x = pos[:, 0] + n_vel[:, 0] * DT
        y = pos[:, 1] + n_vel[:, 1] * DT

        # tile collision, bounds (-0.4, -0.4, 0.8, 0.8) (tilemap.cpp:195);
        # outside the map is wall
        rx, ry, _ = resolve_tile_collisions(
            grid, _LUT_WALL, x - 0.4, y - 0.4, 0.8, 0.8, 1,
            edges=(x + 0.4, y + 0.4, x, y))
        dx_moved = rx - (x - 0.4)
        dy_moved = ry - (y - 0.4)
        x = rx + 0.4
        y = ry + 0.4
        n_vel = torch.stack([torch.where(dx_moved != 0.0, 0.0, n_vel[:, 0]),
                             torch.where(dy_moved != 0.0, 0.0, n_vel[:, 1])],
                            -1)
        n_pos = torch.stack([x, y], -1)

        # hazards and goal, against the enemies before they move (the
        # agent updates before mob_ai, caveflyer.cpp:323-325). The agent's
        # rect is (x - 0.4, y - 0.4, 0.8, 0.8) with x = rx + 0.4, which XLA
        # folds into (rx, ry) to (rx + 0.8, ry + 0.8)
        ship = ((rx[:, None, None], (rx + 0.8)[:, None, None]),
                (ry[:, None, None], (ry + 0.8)[:, None, None]))
        dead = _hazard_hit(level, target_alive, enemy_pos, ship)
        achieved = _overlap(ship, _entities(level.goal_pos[:, None], 0.4))[:, 0, 0]

        # ---- bullets (common_systems.cpp:216-280): 0.02-unit probes ----
        window = _ring_window(n_next_b, n_num_b)
        live = window & (b_frame_n == 0.0)
        bxs = _span(b_pos_n[..., 0], 0.01)
        bys = _span(b_pos_n[..., 1], 0.01)
        probe = ((bxs[0][..., None], bxs[1][..., None]),
                 (bys[0][..., None], bys[1][..., None]))  # [N, 32, 1]
        wall_hit = probe_any_solid(level.wall, bxs, bys) & live

        def probe_hits(pos, half, alive):  # [N, 32, M]
            return alive[:, None] & _overlap(probe, _entities(pos, half))

        obst_hit = live & probe_hits(level.obst_pos, 0.25,
                                     level.obst_exists).any(-1)
        # obstacles come before targets
        targ_overlap = (probe_hits(level.target_pos, 0.25, target_alive)
                        & (live & ~obst_hit)[..., None])
        targ_hit = targ_overlap.any(-1)
        # the first overlapping target of each bullet
        first_targ = torch.argmax(targ_overlap.to(i32), -1)
        destroyed = ((first_targ[..., None] == targets)
                     & targ_hit[..., None]).any(1)
        n_destroyed = (destroyed & target_alive).sum(1)
        n_target_alive = target_alive & ~destroyed
        enem_hit = live & ~obst_hit & ~targ_hit & probe_hits(
            enemy_pos, 0.4, level.enemy_exists).any(-1)

        impact = wall_hit | obst_hit | targ_hit | enem_hit
        b_vel_n = torch.where(impact[..., None], 0.0, b_vel_n)
        b_frame_n = torch.where(impact, 1.0, b_frame_n)
        # move and animate (window slots only)
        b_pos_n = torch.where(window[..., None], b_pos_n + b_vel_n * DT,
                              b_pos_n)
        exploding = window & (b_frame_n >= 1.0)
        expired = window & (b_frame_n >= 5.0)
        b_frame_n = torch.where(
            expired, -1.0,
            torch.where(exploding, b_frame_n + EXPLOSION_RATE * DT, b_frame_n))
        n_num_b = n_num_b - expired.sum(1).to(i32)

        # ---- enemy ships (common_systems.cpp:50-75) ----
        m_np = enemy_pos + enemy_vel * DT
        mxs, mys = _span(m_np[..., 0], 0.4), _span(m_np[..., 1], 0.4)
        m_col = probe_any_solid(level.wall, mxs, mys)
        m_vel = torch.where(m_col[..., None], -enemy_vel, enemy_vel)
        ex = level.enemy_exists[..., None]
        m_pos = torch.where(ex, m_np, enemy_pos)
        m_vel = torch.where(ex, m_vel, enemy_vel)

        # ---- thrust particles (common_systems.cpp:329-371) ----
        plife = part_life - DT
        dead_idx = torch.where(plife <= 0.0, pslots, -1).max(1).values
        n_ptimer = spawn_timer + DT
        do = (dead_idx >= 0) & (n_ptimer >= PART_SPAWN_TIME) & (movement_y > 0.0)
        n_ptimer = torch.where(do, torch.fmod(n_ptimer, PART_SPAWN_TIME),
                               n_ptimer)
        pslot = dead_idx.clamp(0, NUM_PARTICLES - 1)
        prot = n_rot + _HALF_PI
        pc, ps = sincos32(prot)
        # offset (0, 0.3) rotated by prot (tilemap.cpp:198)
        off = torch.stack([pc * 0.0 - ps * 0.3, ps * 0.0 + pc * 0.3], -1)
        pupd = do[:, None] & (pslots[None] == pslot[:, None])
        plife = torch.where(pupd, PART_LIFESPAN, plife)
        n_ppos = torch.where(pupd[..., None], (n_pos + off)[:, None], part_pos)
        n_pdir = torch.where(pupd[..., None],
                             torch.stack([-dirx, -diry], -1)[:, None],
                             part_dir)
        n_prot = torch.where(pupd, prot[:, None], part_rot)

        sub_reward = achieved.to(f32) * 10.0 + n_destroyed.to(f32) * 3.0

        # commit, masked by active
        act = active[:, None]
        act3 = act[..., None]
        pos = torch.where(act, n_pos, pos)
        vel = torch.where(act, n_vel, vel)
        rot = torch.where(active, n_rot, rot)
        bullet_timer = torch.where(active, n_btimer, bullet_timer)
        b_pos = torch.where(act3, b_pos_n, b_pos)
        b_vel = torch.where(act3, b_vel_n, b_vel)
        b_rot = torch.where(act, b_rot_n, b_rot)
        b_frame = torch.where(act, b_frame_n, b_frame)
        num_b = torch.where(active, n_num_b, num_b)
        next_b = torch.where(active, n_next_b, next_b)
        target_alive = torch.where(act, n_target_alive, target_alive)
        enemy_pos = torch.where(act3, m_pos, enemy_pos)
        enemy_vel = torch.where(act3, m_vel, enemy_vel)
        part_pos = torch.where(act3, n_ppos, part_pos)
        part_life = torch.where(act, plife, part_life)
        part_dir = torch.where(act3, n_pdir, part_dir)
        part_rot = torch.where(act, n_prot, part_rot)
        spawn_timer = torch.where(active, n_ptimer, spawn_timer)
        reward = torch.where(active, sub_reward, reward)
        done = done | (active & (dead | achieved))

    new_state = State(
        level=level, pos=pos, vel=vel, rot=rot, bullet_timer=bullet_timer,
        b_pos=b_pos, b_vel=b_vel, b_rot=b_rot, b_frame=b_frame,
        num_bullets=num_b, next_bullet=next_b, target_alive=target_alive,
        enemy_pos=enemy_pos, enemy_vel=enemy_vel,
        part_pos=part_pos, part_life=part_life, part_dir=part_dir,
        part_rot=part_rot, part_spawn_timer=spawn_timer,
        t=state.t + 1, rng=state.rng)
    return new_state, reward, done, {}


# ---------------------------------------------------------------------------
# Rendering (caveflyer.cpp:413-441)
# ---------------------------------------------------------------------------

def observe(cfg: Config, state: State, size: int = C.OBS):
    """Each env's frame at size x size by the exact render (caveflyer.cpp:
    413-441): background, cave walls, the thrust smoke (rotated), meteors,
    targets, enemies, the goal, the bullets and explosions (rotated) and
    the ship (rotated +90 degrees), the camera on the ship spanning the
    same world at any size. uint8 [N, size, size, 3]."""
    R = _observe_assets(str(state.pos.device))
    atlas, idx = R["atlas"], R["idx"]
    level = state.level
    N = state.pos.shape[0]
    dev = state.pos.device
    # window renders scale the zoom (render_game)
    wx, wy = C.camera_coords(PPU * (size / 64.0), state.pos[:, 0],
                             state.pos[:, 1], size)
    # the hazards' loops read the maps computed on their own
    lx, ly = C.camera_coords(PPU * (size / 64.0), state.pos[:, 0],
                             state.pos[:, 1], size, fused=False)

    img = C.clear(N, size, dev)
    img = C.draw_background(img, R["bgs"], level.bg_index, wx, wy)
    img = C.draw_tiles(img, level.wall.to(torch.int8), [-1, idx["cave_wall"]],
                       atlas, wx, wy, oob_tile=0)

    # thrust smoke after the tiles, before the sprites (caveflyer.cpp:437):
    # growing, fading, drifting back along its direction. XLA CPU fuses
    # 0.4 * ratio + 0.6 and the centre's multiply-add
    ratio = torch.clamp((PART_LIFESPAN - state.part_life)
                        * C.recip32(PART_LIFESPAN), 0.0, 1.0)
    centre = prng._fma32(state.part_dir, (ratio * 2.0)[..., None],
                         state.part_pos)
    for i in range(NUM_PARTICLES):
        sc = prng._fma32(ratio[:, i], 0.4, 0.6)
        img = C.draw_sprite(img, atlas, idx["smoke"],
                            centre[:, i, 0] - 0.5 * sc,
                            centre[:, i, 1] - 0.5 * sc, sc, sc, wx, wy,
                            rotation=state.part_rot[:, i],
                            alive=state.part_life[:, i] > 0.0,
                            alpha=0.5 * (1.0 - ratio[:, i]))

    # hazards and the goal: 0.8-unit sprites at offset -0.4
    for sid, p, h, alive in (
            ("meteor", level.obst_pos, 0.8 * 84 / 101, level.obst_exists),
            ("ufo_red", level.target_pos, 0.8, state.target_alive),
            ("enemy_ship", state.enemy_pos, 0.8 * 84 / 82,
             level.enemy_exists)):
        M = p.shape[1]
        img = C.draw_sprites(img, atlas, idx[sid], p[..., 0] - 0.4,
                             p[..., 1] - 0.4, _const(0.8, N, M, dev),
                             _const(h, N, M, dev), lx, ly, alives=alive)
    img = C.draw_sprite(img, atlas, idx["ufo_green"],
                        level.goal_pos[:, 0] - 0.4, level.goal_pos[:, 1] - 0.4,
                        0.8, 0.8, wx, wy)

    # bullets and explosions (common_systems.cpp:298-317): the laser 13x37
    # px at size 0.1 (0.081 x 0.231 units), explosions 0.375 units
    window = _ring_window(state.next_bullet, state.num_bullets)
    for i in range(NUM_BULLETS):
        frame = state.b_frame[:, i]
        is_live = window[:, i] & (frame == 0.0)
        is_expl = window[:, i] & (frame >= 1.0)
        eidx = torch.clamp(frame.to(torch.int32) - 1, 0, 4)
        sid = torch.where(is_live, idx["laser"], R["expl"][eidx.long()])
        w = torch.where(is_live, 0.081, 0.375)
        h = torch.where(is_live, 0.231, 0.375)
        img = C.draw_sprite(img, atlas, sid, state.b_pos[:, i, 0] - w * 0.5,
                            state.b_pos[:, i, 1] - h * 0.5, w, h, wx, wy,
                            rotation=state.b_rot[:, i] + _HALF_PI,
                            alive=is_live | is_expl)

    # the ship: 99x75 px at size 0.15 (0.93 x 0.70 units), rotated +90 deg
    # about its centre, which XLA folds to pos + (0.5 * size - offset)
    img = C.draw_sprite(img, atlas, idx["ship_red"], state.pos[:, 0] - 0.464,
                        state.pos[:, 1] - 0.352, 0.928, 0.703, wx, wy,
                        rotation=state.rot + _HALF_PI,
                        centre=(state.pos[:, 0] + _SHIP_DX,
                                state.pos[:, 1] + _SHIP_DY))
    return C.finalize(img)


def _const(v, N, M, device):
    """v as f32 [N, M]: a size that the JAX package passes as an array,
    so that its rects divide by it truly."""
    return torch.full((N, M), v, dtype=torch.float32, device=device)


def obs_space(cfg: Config):
    return spaces.Box(0, 255, (C.OBS, C.OBS, 3))


def action_space(cfg: Config):
    return spaces.MultiDiscrete((NUM_ACTIONS,))


def observe_batch(cfg: Config, states: State):
    """Planar uint8 [N, 3, 64, 64]: the quantized-phase scene render (the
    throughput path), or with `scene_phases=0` the exact-camera render."""
    if cfg.scene_phases > 0:
        img = scene_kernel.scene_raw(*_scene_inputs(cfg, states))
        return torch.clamp(torch.round(img), 0, 255).to(torch.uint8)
    return _observe_exact(cfg, states)


def _observe_exact(cfg: Config, states: State):
    """The exact-camera batched render (`scene_phases=0`): the camera on
    the ship unsnapped (caveflyer.cpp:452-453); the background and the
    cave walls (`draw_tiles_batch`), then the four stamp groups of
    `_stamp_groups` in turn by `compositor.composite_stamps`: the smoke
    (K = 10, P = 10), the objects (P = 8), the bullet ring (K = 32,
    P = 4) and the ship (P = 12), each one B3 launch on the card."""
    R = _observe_assets(str(states.pos.device))
    cam = states.pos
    wx, wy = C.camera_coords(PPU, cam[:, 0], cam[:, 1])
    img = C.draw_background_batch(R["bgs"], states.level.bg_index, wx, wy)
    img = C.draw_tiles_batch(img, states.level.wall.to(torch.int8),
                             [-1, R["idx"]["cave_wall"]], R["atlas"], wx, wy,
                             oob_tile=0)
    for g in _stamp_groups(states, cam, R["banks"]):
        img = C.composite_stamps(img, *g)
    return torch.clamp(torch.round(img), 0, 255).to(torch.uint8)


def _rot_bin(angle, bins):
    """The nearest of `bins` rotation variants: round(angle / (2 pi /
    bins)) mod bins, the division a multiply by its f32 reciprocal as XLA
    CPU makes it."""
    inv = float(np.float32(1.0) / np.float32(2 * math.pi / bins))
    return torch.remainder(torch.round(angle * inv).to(torch.int32), bins)


def _stamp_groups(states: State, cam, banks):
    """The render's four stamp groups in painter order, (bank, var, r0,
    c0, alives, alpha) as `compositor.composite_stamps` takes them, [N, K]
    each (alpha only on the smoke): thrust smoke (K = 10, drawn after the tiles,
    caveflyer.cpp:437), the objects (meteors, targets, enemies and the
    goal: K = 3M + 1), the bullets and explosions (K = 32), the ship."""
    level = states.level
    N = states.pos.shape[0]
    M = level.obst_exists.shape[1]
    dev = states.pos.device
    i32 = torch.int32

    def group(bank, var, centers, alives=None, alpha=None):
        py, px = C.stamp_origin(centers, cam[:, 0], cam[:, 1], PPU,
                                bank.shape[-1])
        return (bank, var, torch.round(py).to(i32), torch.round(px).to(i32),
                alives, alpha)

    # thrust smoke: fading, growing, drifting back. XLA CPU makes
    # (5 - life) / 5 a multiply by f32(1/5) and fuses the centre's
    # multiply-add; the scale bin ((0.4 * ratio + 0.6) - 0.6) / 0.4 * 4
    # it simplifies to ratio * 4 (the constants cancel and fold)
    ratio = torch.clamp((PART_LIFESPAN - states.part_life)
                        * float(np.float32(1 / PART_LIFESPAN)), 0.0, 1.0)
    pcent = prng._fma32(states.part_dir, (ratio * 2.0)[..., None],
                        states.part_pos)
    sbin = torch.clamp((ratio * PART_SCALE_BINS).to(i32), 0,
                       PART_SCALE_BINS - 1)
    rbin = _rot_bin(states.part_rot, PART_ROT_BINS)
    # the alpha stays f32: B1 rounds texel * scale to bf16 once, as the TPU
    # kernel it replaces does (the JAX package's CPU fallback rounds the
    # scale to bf16 first; ROADMAP C)
    alpha = 0.5 * (1.0 - ratio)
    smoke = group(banks["part"], sbin * PART_ROT_BINS + rbin, pcent,
                  alives=states.part_life > 0.0, alpha=alpha)

    # static objects and the goal (sprite centres are the entity positions)
    centers = torch.cat([level.obst_pos, level.target_pos, states.enemy_pos,
                         level.goal_pos[:, None]], dim=1)  # [N, 3M+1, 2]
    var = torch.cat([torch.full((N, M), k, dtype=i32, device=dev)
                     for k in range(3)]
                    + [torch.full((N, 1), 3, dtype=i32, device=dev)], dim=1)
    alives = torch.cat([level.obst_exists, states.target_alive,
                        level.enemy_exists,
                        torch.ones((N, 1), dtype=torch.bool, device=dev)], 1)
    objs = group(banks["obj"], var, centers, alives=alives)

    # bullets (rotation-quantized laser) and explosions
    window = _ring_window(states.next_bullet, states.num_bullets)
    frame = states.b_frame
    is_live = window & (frame == 0.0)
    is_expl = window & (frame >= 1.0)
    bbin = _rot_bin(states.b_rot + _HALF_PI, BULLET_ROT_BINS)
    bvar = torch.where(is_live, bbin, BULLET_ROT_BINS
                       + torch.clamp(frame.to(i32) - 1, 0, 4))
    bullets = group(banks["bullet"], bvar, states.b_pos,
                    alives=is_live | is_expl)

    # the ship, rotated +90 degrees as the reference draws it; its draw
    # offset (-0.464, -0.352) centres it on pos
    sbin2 = _rot_bin(states.rot + _HALF_PI, SHIP_ROT_BINS)
    ship = group(banks["ship"], sbin2[:, None], states.pos[:, None])
    return [smoke, objs, bullets, ship]


def _scene_inputs(cfg: Config, states: State):
    """The scene kernel's arguments for a batch of states (as a tuple in
    `scene_kernel.scene_raw`'s order). The render camera follows the ship
    (caveflyer.cpp:452-453), snapped to 1/qp units; the grid is padded
    with empty cells (the render's out of bounds, unlike the physics')."""
    qp = cfg.scene_phases
    D = cfg.world_dim
    ST = _scene_tensors(qp, D, str(states.pos.device))
    W = ST["win"]
    i32 = torch.int32
    level = states.level
    mq = torch.round(states.pos * qp).to(i32)  # [N, 2]
    cam = mq.to(torch.float32) / qp
    _, _, t0_off = phases_lib.phase_tables(PPU, 64, qp)
    t0 = torch.floor(cam + float(np.float32(t0_off))).to(i32)
    jq = torch.remainder(mq, qp)
    gridp = torch.nn.functional.pad(level.wall.to(torch.int8),
                                    (W, W, W, W), value=0)
    theme = torch.zeros_like(level.bg_index, dtype=i32)
    return (gridp, t0[:, 1].contiguous(), t0[:, 0].contiguous(),
            jq[:, 1].contiguous(), jq[:, 0].contiguous(),
            level.bg_index.to(i32), theme, ST["bg_bank"], ST["tr_tab"],
            ST["tile_bank"], ST["kinds"], ST["themes"],
            [C.stamp_group(*g) for g in _stamp_groups(states, cam,
                                                      ST["banks"])],
            C.OBS, qp, W)
