"""Chaser in PyTorch (procgen2_tpu/games/chaser.py), batched.

The same game as the JAX package, which cites the reference engine
(Procgen2's `games/chaser/`) line by line: a Kruskal maze, 4 quadrants
with one orb each (one more or one fewer in extreme and hard), the agent
and 3-5 enemy eggs on distinct free cells and a pellet on every other
free cell (tilemap.cpp:80-243); queued-direction turning with an input
reset timer (common_systems.cpp:305-444); eggs that hatch after 50 t and
chase (Manhattan-greedy) or wander at every junction, fleeing while the
system-global eat timer runs, eaten enemies respawning as eggs
(common_systems.cpp:117-295); +0.04 per pellet and per orb, +10 when all
are collected, death on contact with a hatched enemy while not
vulnerable, over 4 sub-steps with the last sub-step's reward kept and an
early exit (chaser.cpp:298-312). The reference's quirks are the JAX
package's: the missing y flip of the egg respawn, the dead-end push to
the left, and the global timers (its module docstring).

Every function works on a batch: `generate` on a batch of keys [L, 2]
(one level each), `reset`/`step`/`observe_batch`/`observe` on a batch of
envs; the mobs of all envs step together. The random draws are the JAX
package's, key for key (`..random`), so a level, a state and an
observation can be compared with it bit for bit.

Modes (tilemap.cpp:85-99): easy 11x11 with 3 enemies, hard 13x13 with 3,
extreme 19x19 with 5.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import random as prng
from ..core import spaces
from ..gen.kruskal import kruskal_maze, masked_uniform_cell
from ..physics.aabb import check_collision
from ..render import atlas as atlas_lib
from ..render import compositor as C

NAME = "chaser"
NUM_ACTIONS = 15
SUB_STEPS = 4  # chaser.cpp:44
DT = 1.0 / SUB_STEPS

AGENT_SPEED = 0.2  # common_systems.cpp:309
INPUT_RESET_TIME = 1.0 / AGENT_SPEED * 0.5  # = 2.5, common_systems.cpp:310
HATCH_TIME = 50.0  # common_systems.cpp:118
EAT_TIME = 75.0  # common_systems.cpp:298
SPEED_LOW = 0.125  # fleeing, common_systems.cpp:121
SPEED_HIGH = 0.25  # chasing, common_systems.cpp:122
ANIM_TIME = 1.0  # common_systems.cpp:119

_MODES = {  # world_dim, total_enemies, extra_orb_sign (tilemap.cpp:85-99)
    "easy": (11, 3, 0),
    "hard": (13, 3, -1),
    "extreme": (19, 5, 1),
}

MAX_ENEMIES = 5
MAX_ORBS = 8  # 2 slots per quadrant (extreme grants one quadrant 2 orbs)

# junction directions (common_systems.h:61-66), render coords
_DIRS = np.array([[-1.0, 0.0], [1.0, 0.0], [0.0, -1.0], [0.0, 1.0]], np.float32)
NUM_BGS = 9  # chaser.cpp:57-66

# the render's kinds: 0 empty, 1 wall, 2 pellet, 3 live orb
WALL, PELLET, ORB = 1, 2, 3


@dataclasses.dataclass(frozen=True)
class Config:
    mode: str = "easy"  # tilemap.h:40 default easy_mode

    @property
    def world_dim(self):
        return _MODES[self.mode][0]

    @property
    def total_enemies(self):
        return _MODES[self.mode][1]

    @property
    def extra_orb_sign(self):
        return _MODES[self.mode][2]


@dataclasses.dataclass
class Level:
    """One level per row of the leading dimension."""
    wall: torch.Tensor  # bool [L, D, D] render coords [ry, x]
    orb_pos: torch.Tensor  # f32 [L, MAX_ORBS, 2] render coords
    orb_exists: torch.Tensor  # bool [L, MAX_ORBS]
    egg_pos: torch.Tensor  # f32 [L, MAX_ENEMIES, 2] render coords
    egg_exists: torch.Tensor  # bool [L, MAX_ENEMIES]
    agent_pos: torch.Tensor  # f32 [L, 2]
    point_grid0: torch.Tensor  # bool [L, D, D] a pellet on the cell (render)
    respawn_free: torch.Tensor  # bool [L, D, D] in (x, y_up) indexing: the
    #   tilemap's free_cells list of the egg respawn (tilemap.cpp:174-179,
    #   common_systems.cpp:269-274)
    bg_index: torch.Tensor  # i32 [L]
    bg_offset: torch.Tensor  # f32 [L]


@dataclasses.dataclass
class State:
    """One env per row of the leading dimension."""
    level: Level
    pos: torch.Tensor  # f32 [N, 2]
    vel: torch.Tensor  # f32 [N, 2] unit direction (Component_Dynamics)
    next_vel: torch.Tensor  # f32 [N, 2] queued turn
    input_timer: torch.Tensor  # f32 [N] (System_Agent::input_timer)
    mob_pos: torch.Tensor  # f32 [N, MAX_ENEMIES, 2]
    mob_vel: torch.Tensor  # f32 [N, MAX_ENEMIES, 2] (speed included)
    hatch_timer: torch.Tensor  # f32 [N, MAX_ENEMIES]
    eat_timer: torch.Tensor  # f32 [N] (system-global)
    anim_timer: torch.Tensor  # f32 [N]
    anim_index: torch.Tensor  # i32 [N]
    point_grid: torch.Tensor  # bool [N, D, D]
    orb_taken: torch.Tensor  # bool [N, MAX_ORBS]
    t: torch.Tensor  # i32 [N]
    rng: torch.Tensor  # int64 [N, 2] key words


# ---------------------------------------------------------------------------
# Assets (numpy, built by the port's asset modules)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _assets():
    atlas, idx = atlas_lib.build_atlas(
        ("stone_wall", "chaser_point", "crystal", "egg_spikey",
         "flyer0", "flyer1", "flyer2", "walker_flee", "floater"))
    bgs = atlas_lib.build_backgrounds("topdown", NUM_BGS)
    return dict(atlas_p=atlas.transpose(3, 0, 1, 2), idx=idx,
                bgs_p=bgs.transpose(3, 0, 1, 2))


@functools.lru_cache(maxsize=None)
def _stamp_banks(ppu: float):
    """Pixel-snapped patches of the moving entities, u8 [9, 4, P, P] with
    P = int(ppu) + 3: the egg, walker_flee, the flyer's 6-frame cycle and
    the floater (the agent)."""
    names = ["egg_spikey", "walker_flee", "flyer0", "flyer1", "flyer2",
             "flyer2", "flyer1", "flyer0", "floater"]
    return atlas_lib.build_pixel_bank(
        tuple((n, ppu, ppu) for n in names), patch=int(ppu) + 3)


# ---------------------------------------------------------------------------
# Generation (tilemap.cpp:80-243), batched over levels
# ---------------------------------------------------------------------------

def _cell_pos(x, y_up, D):
    """Render coords of cell (x, y_up) int [L]: (x + 0.5, D - 1 - y + 0.5)."""
    f32 = torch.float32
    return torch.stack([x.to(f32) + 0.5, (D - 1.0) - y_up.to(f32) + 0.5], -1)


def generate(cfg: Config, keys: torch.Tensor) -> Level:
    """One level per key: keys int64 [L, 2] -> Level with leading dim L."""
    D = cfg.world_dim
    L = keys.shape[0]
    dev = keys.device
    lv = torch.arange(L, device=dev)
    k_maze, k_quad, k_orbs, k_spawn, k_bg, k_bgoff = prng.split(
        keys, 6).unbind(-2)

    # the maze in (x, y_up) coords; the reference reads the padded
    # generator grid at +1 offsets (tilemap.cpp:133), the unpadded maze
    wall_xy = kruskal_maze(k_maze, D, max_dim=D)
    free_xy = ~wall_xy

    # orbs, quadrant-balanced (tilemap.cpp:116-172)
    extra_quad = prng.randint(k_quad, (), 0, 4)
    xs = torch.arange(D, device=dev)
    quad_of = (xs[:, None] >= D // 2) * 2 + (xs[None, :] >= D // 2)
    orb_pos = torch.zeros((L, MAX_ORBS, 2), dtype=torch.float32, device=dev)
    orb_exists = torch.zeros((L, MAX_ORBS), dtype=torch.bool, device=dev)
    orb_mask = torch.zeros((L, D, D), dtype=torch.bool, device=dev)
    okeys = prng.split(k_orbs, 8)
    for q in range(4):
        n_orbs = 1 + torch.where(extra_quad == q, cfg.extra_orb_sign, 0)
        qmask = free_xy & (quad_of == q)
        # the second orb (extreme's extra) on a distinct cell of the
        # quadrant (the reference probes +1 on a collision,
        # tilemap.cpp:156-163)
        for s in range(2):
            ox, oy = masked_uniform_cell(okeys[:, 2 * q + s], qmask)
            have = n_orbs >= s + 1
            orb_mask[lv, ox, oy] |= have
            orb_pos[:, 2 * q + s] = _cell_pos(ox, oy, D)
            orb_exists[:, 2 * q + s] = have
            qmask = qmask.clone()
            qmask[lv, ox, oy] = False

    # the agent's start and the eggs on distinct remaining free cells
    # (tilemap.cpp:174-213); the draws of the eggs a mode lacks change
    # nothing, and are not made
    avail = free_xy & ~orb_mask
    skeys = prng.split(k_spawn, MAX_ENEMIES + 1)
    ax, ay = masked_uniform_cell(skeys[:, 0], avail)
    avail[lv, ax, ay] = False
    agent_pos = _cell_pos(ax, ay, D)
    egg_pos = torch.zeros((L, MAX_ENEMIES, 2), dtype=torch.float32,
                          device=dev)
    egg_exists = torch.zeros((L, MAX_ENEMIES), dtype=torch.bool, device=dev)
    for e in range(cfg.total_enemies):
        ex, ey = masked_uniform_cell(skeys[:, e + 1], avail)
        avail[lv, ex, ey] = False
        egg_pos[:, e] = _cell_pos(ex, ey, D)
        egg_exists[:, e] = True

    # pellets on every remaining free cell, the same set as the respawn
    # free_cells list (tilemap.cpp:215-225); (x, y_up) -> render [ry, x]
    def render(a):
        return torch.flip(a.transpose(1, 2), dims=(1,)).contiguous()

    return Level(
        wall=render(wall_xy),
        orb_pos=orb_pos,
        orb_exists=orb_exists,
        egg_pos=egg_pos,
        egg_exists=egg_exists,
        agent_pos=agent_pos,
        point_grid0=render(avail),
        respawn_free=avail,
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
        next_vel=zeros(2),
        input_timer=zeros(),
        mob_pos=level.egg_pos,
        mob_vel=zeros(MAX_ENEMIES, 2),
        hatch_timer=zeros(MAX_ENEMIES),
        eat_timer=zeros(),
        anim_timer=zeros(),
        anim_index=torch.zeros(N, dtype=torch.int32, device=dev),
        point_grid=level.point_grid0,
        orb_taken=torch.zeros((N, MAX_ORBS), dtype=torch.bool, device=dev),
        t=torch.zeros(N, dtype=torch.int32, device=dev),
        rng=keys,
    )


# ---------------------------------------------------------------------------
# Step (chaser.cpp:280-312)
# ---------------------------------------------------------------------------

def _wall_at(wall, cx, ry):
    """wall bool [N, D, D] at render (column cx, row ry), int [N, ...];
    outside the map is wall (tilemap get() returns out_of_bounds, which
    is not empty)."""
    N, D, _ = wall.shape
    inb = (cx >= 0) & (cx < D) & (ry >= 0) & (ry < D)
    flat = (ry.clamp(0, D - 1) * D + cx.clamp(0, D - 1)).long().reshape(N, -1)
    val = wall.reshape(N, D * D).gather(1, flat).reshape(cx.shape)
    return torch.where(inb, val, True)


def _sign(x):
    return torch.where(x == 0.0, 0, torch.where(x > 0.0, 1, -1))


def _agent_substep(wall, pos, vel, next_vel, input_timer, a):
    """System_Agent::update (common_systems.cpp:305-444)."""
    f32 = torch.float32
    i32 = torch.int32
    movement_x = (a == 7).to(f32) - (a == 1).to(f32)
    movement_y = (a == 3).to(f32) - (a == 5).to(f32)
    movement_y = torch.where(movement_x != 0.0, 0.0, movement_y)  # no diagonals

    has_input = (movement_x != 0.0) | (movement_y != 0.0)
    next_vel = torch.where(has_input[:, None],
                           torch.stack([movement_x, movement_y], -1), next_vel)
    input_timer = torch.where(has_input, 0.0, input_timer)

    px, py = pos[:, 0], pos[:, 1]
    ix, iy = px.to(i32), py.to(i32)
    # The reference's centring gates bind the int ::abs, so they are always
    # true: turns and stops engage anywhere in the cell (the JAX package's
    # _agent_substep). The queued turn takes the whole next_velocity
    # (common_systems.cpp:345-385).
    turn_x = (((next_vel[:, 0] > 0) & ~_wall_at(wall, ix + 1, iy))
              | ((next_vel[:, 0] < 0) & ~_wall_at(wall, ix - 1, iy)))
    turn_y = (((next_vel[:, 1] > 0) & ~_wall_at(wall, ix, iy + 1))
              | ((next_vel[:, 1] < 0) & ~_wall_at(wall, ix, iy - 1)))
    py = torch.where(turn_x, iy + 0.5, py)
    px = torch.where(turn_y, ix + 0.5, px)
    vel = torch.where((turn_x | turn_y)[:, None], next_vel, vel)

    # wall stops (common_systems.cpp:387-428; the same always-true gate)
    ix, iy = px.to(i32), py.to(i32)
    stop_x = (((vel[:, 0] < 0) & _wall_at(wall, ix - 1, iy))
              | ((vel[:, 0] > 0) & _wall_at(wall, ix + 1, iy)))
    stop_y = (((vel[:, 1] < 0) & _wall_at(wall, ix, iy - 1))
              | ((vel[:, 1] > 0) & _wall_at(wall, ix, iy + 1)))
    px = torch.where(stop_x, ix + 0.5, px)
    py = torch.where(stop_y, iy + 0.5, py)
    # vel * (~stop): XLA rewrites a product with a converted predicate
    # into a select, so a stopped -1 becomes +0.0, not -0.0
    vel = torch.where(torch.stack([stop_x, stop_y], -1), 0.0, vel)

    pos = torch.stack([px + vel[:, 0] * AGENT_SPEED * DT,
                       py + vel[:, 1] * AGENT_SPEED * DT], -1)

    reset_input = input_timer >= INPUT_RESET_TIME
    next_vel = torch.where(reset_input[:, None], 0.0, next_vel)
    input_timer = torch.where(reset_input, input_timer, input_timer + DT)
    return pos, vel, next_vel, input_timer


def _mob_substep(level, mob_pos, mob_vel, hatch_timer, eat_timer, agent_pos,
                 key):
    """System_Mob_AI::update for every enemy of every env
    (common_systems.cpp:117-295), [N, MAX_ENEMIES] at once. key [N, 2]:
    each enemy draws from split(split(key, 5)[e], 3). Returns (pos, vel,
    hatch_timer, player_hit [N])."""
    f32 = torch.float32
    i32 = torch.int32
    N = mob_pos.shape[0]
    D = level.wall.shape[-1]
    dirs = torch.from_numpy(_DIRS).to(mob_pos.device)
    speed = torch.where(eat_timer == 0.0, SPEED_HIGH, SPEED_LOW)[:, None, None]
    k_aggr, k_dir, k_respawn = prng.split(prng.split(key, MAX_ENEMIES),
                                          3).unbind(-2)  # [N, E, 2] each
    hatched = hatch_timer >= HATCH_TIME
    eating = (eat_timer > 0.0)[:, None]

    px, py = mob_pos[..., 0], mob_pos[..., 1]
    ix, iy = px.to(i32), py.to(i32)
    # at_junction binds the int ::abs as the agent's gates do: a hatched
    # enemy decides its direction at every sub-step (common_systems.cpp:
    # 165-166)
    decide = hatched

    # allowed: an open tile, and not a reversal (common_systems.cpp:173-194)
    sx, sy = -_sign(mob_vel[..., 0]), -_sign(mob_vel[..., 1])
    wall = level.wall
    poss = torch.stack([
        ~_wall_at(wall, ix - 1, iy) & (sx != -1),
        ~_wall_at(wall, ix + 1, iy) & (sx != 1),
        ~_wall_at(wall, ix, iy - 1) & (sy != -1),
        ~_wall_at(wall, ix, iy + 1) & (sy != 1),
    ], -1)  # [N, E, 4]
    any_poss = poss.any(-1)

    be_aggressive = prng.uniform(k_aggr) < 0.5
    # Manhattan-greedy toward (or away from) the agent, the first index
    # winning ties (common_systems.cpp:200-218): the deltas go through the
    # int ::abs, so each truncates toward zero first
    cand = (torch.abs(torch.trunc(px[..., None] + dirs[:, 0]
                                  - agent_pos[:, None, None, 0]))
            + torch.abs(torch.trunc(py[..., None] + dirs[:, 1]
                                    - agent_pos[:, None, None, 1])))
    cand = torch.where(eating[..., None], -cand, cand)
    greedy = torch.argmin(torch.where(poss, cand, float("inf")), dim=-1)
    greedy = torch.where(any_poss, greedy, 0)  # select_index stays 0
    # uniform over the allowed (roulette, common_systems.cpp:220-236)
    rand_sel = prng.categorical(k_dir, torch.where(poss, 0.0, float("-inf")))
    rand_sel = torch.where(any_poss, rand_sel, 0)
    sel = torch.where(be_aggressive, greedy, rand_sel)

    d = dirs[sel]  # [N, E, 2]
    new_v = d * speed
    # aligned on the other axis (common_systems.cpp:244-248)
    new_px = torch.where(d[..., 0] == 0.0, ix + 0.5, px)
    new_py = torch.where(d[..., 1] == 0.0, iy + 0.5, py)
    v = torch.where(decide[..., None], new_v, mob_vel)
    px = torch.where(decide, new_px, px)
    py = torch.where(decide, new_py, py)

    # move (hatched only)
    px = px + torch.where(hatched, v[..., 0] * DT, 0.0)
    py = py + torch.where(hatched, v[..., 1] * DT, 0.0)

    # contact with the agent (1x1 boxes, check_collision's f32 expression)
    contact = hatched & check_collision(
        agent_pos[:, None, 0] - 0.5, agent_pos[:, None, 1] - 0.5, 1.0, 1.0,
        px - 0.5, py - 0.5, 1.0, 1.0)
    hit = contact & ~eating
    eaten = contact & eating

    # eaten -> an egg again on a random free cell, with the reference's
    # missing y flip (common_systems.cpp:264-277): render y := y_up + 0.5.
    # Every enemy draws its cell, eaten or not.
    logits = torch.where(level.respawn_free.reshape(N, 1, D * D), 0.0,
                         float("-inf")).expand(N, MAX_ENEMIES, D * D)
    flat = prng.categorical(k_respawn, logits)
    px = torch.where(eaten, (flat // D).to(f32) + 0.5, px)
    py = torch.where(eaten, (flat % D).to(f32) + 0.5, py)
    hatch = torch.where(eaten, 0.0, hatch_timer)
    hatch = torch.where(hatched, hatch, hatch + DT)

    alive = level.egg_exists
    new_pos = torch.where(alive[..., None], torch.stack([px, py], -1),
                          mob_pos)
    new_vel = torch.where(alive[..., None], v, mob_vel)
    new_hatch = torch.where(alive, hatch, hatch_timer)
    return new_pos, new_vel, new_hatch, (hit & alive).any(-1)


# the pellet rects (-0.3, -0.3, 0.6, 0.6) about each cell centre, built in
# f32 as spawn_point does (tilemap.cpp:52-58): their low and high edges,
# evaluated step by step (XLA folds a traced constant chain in one
# higher-precision pass, which the JAX package avoids the same way)
_CF = np.arange(64, dtype=np.float32) + np.float32(0.5)
_PELLET_LO = np.float32(_CF - np.float32(0.3))
_PELLET_HI = np.float32(_PELLET_LO + np.float32(0.6))


def _collect_points(level, point_grid, orb_taken, agent_pos):
    """System_Point::update (common_systems.cpp:66-106): the pellets and
    orbs the agent overlaps, by check_collision's f32 expression. Returns
    (point_grid, orb_taken, delta i32 [N], available [N], orb_got
    bool [N])."""
    N, D, _ = point_grid.shape
    dev = point_grid.device
    lo = torch.from_numpy(_PELLET_LO[:D]).to(dev)
    hi = torch.from_numpy(_PELLET_HI[:D]).to(dev)
    ax = (agent_pos[:, 0] - 0.5)[:, None, None]
    ay = (agent_pos[:, 1] - 0.5)[:, None, None]
    hits = (point_grid
            & (ax < hi[None, None, :]) & (ax + 1.0 > lo[None, None, :])
            & (ay < hi[None, :, None]) & (ay + 1.0 > lo[None, :, None]))
    delta = hits.sum((1, 2), dtype=torch.int32)
    point_grid = point_grid & ~hits

    orb_hit = (level.orb_exists & ~orb_taken & check_collision(
        ax[:, :, 0], ay[:, :, 0], 1.0, 1.0, level.orb_pos[..., 0] - 0.5,
        level.orb_pos[..., 1] - 0.5, 1.0, 1.0))
    delta = delta + orb_hit.sum(1, dtype=torch.int32)
    orb_taken = orb_taken | orb_hit
    available = (point_grid.sum((1, 2), dtype=torch.int32)
                 + (level.orb_exists & ~orb_taken).sum(1, dtype=torch.int32))
    return point_grid, orb_taken, delta, available, orb_hit.any(1)


def _reward(delta, available):
    """+0.04 per pellet or orb collected, +10 once none is left
    (chaser.cpp:307-309). XLA may fuse the multiply into the add: for
    every delta a sub-step can reach, one rounding equals two
    (tests/test_torch_chaser.py)."""
    return delta.to(torch.float32) * 0.04 + (available == 0) * 10.0


def step(cfg: Config, state: State, action):
    """One env step for every env: (State, reward f32 [N], done bool [N],
    info {})."""
    level = state.level
    a = action.to(torch.int32)
    N = a.shape[0]
    dev = a.device
    pos, vel, next_vel = state.pos, state.vel, state.next_vel
    input_timer = state.input_timer
    mob_pos, mob_vel = state.mob_pos, state.mob_vel
    hatch_timer, eat_timer = state.hatch_timer, state.eat_timer
    anim_timer, anim_index = state.anim_timer, state.anim_index
    point_grid, orb_taken = state.point_grid, state.orb_taken
    rng = state.rng
    done = torch.zeros(N, dtype=torch.bool, device=dev)
    reward = torch.zeros(N, dtype=torch.float32, device=dev)

    for _ in range(SUB_STEPS):  # chaser.cpp:298-312, break on terminal
        ks = prng.split(rng)
        rng, k_mob = ks[:, 0], ks[:, 1]
        active = ~done
        n_pos, n_vel, n_next, n_itimer = _agent_substep(
            level.wall, pos, vel, next_vel, input_timer, a)
        n_mob_pos, n_mob_vel, n_hatch, dead = _mob_substep(
            level, mob_pos, mob_vel, hatch_timer, eat_timer, n_pos, k_mob)
        # the system-global timers tick inside the mob update
        # (common_systems.cpp:284-293)
        ticking = anim_timer < ANIM_TIME
        n_anim_t = torch.where(ticking, anim_timer + DT, anim_timer - ANIM_TIME)
        n_anim_i = torch.where(ticking, anim_index,
                               torch.remainder(anim_index + 1, 6))
        n_eat = torch.clamp(eat_timer - DT, min=0.0)

        n_points, n_orbs, delta, available, orb_got = _collect_points(
            level, point_grid, orb_taken, n_pos)
        n_eat = torch.where(orb_got, EAT_TIME, n_eat)  # eat(), cs.cpp:297-299

        act = active[:, None]
        pos = torch.where(act, n_pos, pos)
        vel = torch.where(act, n_vel, vel)
        next_vel = torch.where(act, n_next, next_vel)
        input_timer = torch.where(active, n_itimer, input_timer)
        mob_pos = torch.where(act[..., None], n_mob_pos, mob_pos)
        mob_vel = torch.where(act[..., None], n_mob_vel, mob_vel)
        hatch_timer = torch.where(act, n_hatch, hatch_timer)
        eat_timer = torch.where(active, n_eat, eat_timer)
        anim_timer = torch.where(active, n_anim_t, anim_timer)
        anim_index = torch.where(active, n_anim_i, anim_index)
        point_grid = torch.where(act[..., None], n_points, point_grid)
        orb_taken = torch.where(act, n_orbs, orb_taken)
        reward = torch.where(active, _reward(delta, available), reward)
        done = done | (active & (dead | (available == 0)))

    new_state = State(
        level=level, pos=pos, vel=vel, next_vel=next_vel,
        input_timer=input_timer, mob_pos=mob_pos, mob_vel=mob_vel,
        hatch_timer=hatch_timer, eat_timer=eat_timer, anim_timer=anim_timer,
        anim_index=anim_index, point_grid=point_grid, orb_taken=orb_taken,
        t=state.t + 1, rng=rng)
    return new_state, reward, done, {}


# ---------------------------------------------------------------------------
# Rendering (chaser.cpp:388-420): the kind field and one stamp group
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _observe_assets(device: str):
    """The exact render's atlas and backgrounds on `device` (`C.bank`)
    and the flyer's 6-frame cycle as atlas indices."""
    A = _assets()
    idx = A["idx"]
    return dict(atlas=C.bank(A["atlas_p"], device),
                bgs=C.bank(A["bgs_p"], device), idx=idx,
                # hatched: anim_index < 3 ? index : 5 - index
                # (common_systems.cpp:151-155)
                flyer=torch.tensor([idx[f"flyer{i}"] for i in (0, 1, 2, 2,
                                                                 1, 0)],
                                   device=torch.device(device)))


def observe(cfg: Config, state: State, size: int = C.OBS):
    """Each env's frame at size x size by the exact render (chaser.cpp:
    388-420): background, walls, pellets as a tile layer, orbs, enemies
    and the agent over the whole frame. uint8 [N, size, size, 3]."""
    R = _observe_assets(str(state.pos.device))
    idx, atlas = R["idx"], R["atlas"]
    level = state.level
    N = state.pos.shape[0]
    dev = state.pos.device
    D = cfg.world_dim
    centre = torch.full((N,), D / 2.0, dtype=torch.float32, device=dev)
    # the camera fits the map's width (chaser.cpp:400)
    wx, wy = C.camera_coords(size / D, centre, centre, size)
    # the orbs' and enemies' loops read the maps computed on their own
    lx, ly = C.camera_coords(size / D, centre, centre, size, fused=False)

    img = C.clear(N, size, dev)
    img = C.draw_background(img, R["bgs"], level.bg_index, wx, wy)
    img = C.draw_tiles(img, level.wall.to(torch.int8),
                       [-1, idx["stone_wall"]], atlas, wx, wy, oob_tile=0)
    # the pellets: a tile layer, one 1x1 sprite per cell holding one
    pellets = torch.where(state.point_grid, 0, -1)
    img = C.draw_tiles(img, pellets, [idx["chaser_point"]], atlas, wx, wy,
                       oob_tile=-1)
    img = C.draw_sprites(img, atlas, idx["crystal"],
                         level.orb_pos[..., 0] - 0.5,
                         level.orb_pos[..., 1] - 0.5, 1.0, 1.0, lx, ly,
                         alives=level.orb_exists & ~state.orb_taken)
    # enemies: an egg until hatched, then the flyer's cycle, or the
    # fleeing walker while the agent can eat them
    hatched = state.hatch_timer >= HATCH_TIME
    sid = torch.where(
        hatched,
        torch.where(state.eat_timer > 0.0, idx["walker_flee"],
                    R["flyer"][state.anim_index.long()])[:, None],
        idx["egg_spikey"])
    img = C.draw_sprites(img, atlas, sid, state.mob_pos[..., 0] - 0.5,
                         state.mob_pos[..., 1] - 0.5, 1.0, 1.0, lx, ly,
                         alives=level.egg_exists)
    # the agent (common_systems.cpp:446-460)
    img = C.draw_sprite(img, atlas, idx["floater"], state.pos[:, 0] - 0.5,
                        state.pos[:, 1] - 0.5, 1.0, 1.0, wx, wy)
    return C.finalize(img)


def obs_space(cfg: Config):
    return spaces.Box(0, 255, (C.OBS, C.OBS, 3))


def action_space(cfg: Config):
    return spaces.MultiDiscrete((NUM_ACTIONS,))


@functools.lru_cache(maxsize=None)
def _tables(mode: str):
    """The fixed camera's selectors, numpy (no batch dim): the camera sits
    at the map centre and spans the map (chaser.cpp:400), so wx == wy.
    The tile under each obs column (t, in the map), its texel (u), and the
    background's texel (b, b_ok; it spans 64 units from the origin).
    The JAX package builds the background's row selector from the column
    coords too (chaser.py:666-670, `ub` for both axes): with wx == wy
    this draws the same, and the port follows it."""
    D = Config(mode=mode).world_dim
    f32 = np.float32
    c = np.arange(C.OBS, dtype=f32) + f32(0.5 - C.OBS / 2)
    w = f32(D / 2.0) + c / f32(C.OBS / D)
    t = np.floor(w).astype(np.int32)
    u = np.clip(((w - t.astype(f32)) * f32(C.S)).astype(np.int32), 0,
                C.S - 1)
    b = w * f32(1 / 64.0)
    W = atlas_lib.BG_SIZE
    return dict(t=np.clip(t, 0, D - 1), u=u,
                b=np.clip((b * f32(W)).astype(np.int32), 0, W - 1),
                b_ok=(b >= 0) & (b < 1))


@functools.lru_cache(maxsize=None)
def _render_tensors(mode: str, device: str):
    """The render's constant tensors on `device` (built once per mode and
    device): the wall, pellet and orb kind images as (rgb, a) pairs for
    `compositor.blend_kind`, the backgrounds pre-sampled u8
    [B, 3, OBS, OBS], the tile selector, and the premultiplied stamp
    bank."""
    A = _assets()
    T = _tables(mode)
    dev = torch.device(device)
    atlas, idx = A["atlas_p"], A["idx"]
    out = {k: tuple(x.to(dev) for x in C.kind_image(atlas[:, idx[s]],
                                                      T["u"], T["u"]))
           for k, s in (("wall", "stone_wall"), ("pellet", "chaser_point"),
                        ("orb", "crystal"))}
    bgs = torch.from_numpy(np.ascontiguousarray(
        A["bgs_p"].transpose(1, 0, 2, 3))).to(torch.bfloat16)
    b = torch.from_numpy(T["b"]).long()
    b_ok = torch.from_numpy(T["b_ok"])
    bg_bank = C.sep_sample(bgs, b, b, b_ok, b_ok)
    out.update(
        t=torch.from_numpy(T["t"]).long().to(dev),
        bg_bank=torch.clamp(torch.round(bg_bank), 0, 255).to(
            torch.uint8).to(dev),
        bank=C._premultiply_bank(_stamp_banks(C.OBS / Config(
            mode=mode).world_dim)).to(dev))
    return out


def _kind_grid(states: State):
    """int8 [N, D, D]: 1 wall, 2 pellet, 3 live orb (chaser.py:681-693)."""
    level = states.level
    D = level.wall.shape[-1]
    cells = torch.arange(D, device=level.wall.device)
    i32 = torch.int32
    orb_r = torch.floor(level.orb_pos[..., 1]).to(i32)  # [N, MAX_ORBS]
    orb_c = torch.floor(level.orb_pos[..., 0]).to(i32)
    orb_live = level.orb_exists & ~states.orb_taken
    orb_mask = ((orb_r[:, :, None, None] == cells[:, None])
                & (orb_c[:, :, None, None] == cells)
                & orb_live[:, :, None, None]).any(1)
    i8 = torch.int8
    return (level.wall.to(i8) + states.point_grid.to(i8) * 2
            + orb_mask.to(i8) * 3)


def _stamp_slots(cfg: Config, states: State):
    """The one stamp group: the enemies (egg, flyer frame or fleeing
    walker) and then the agent, (var, r0 f32, c0 f32, alive) [N, 6] with
    the origins before rounding (chaser.py:711-728)."""
    level = states.level
    N = states.pos.shape[0]
    dev = states.pos.device
    D = cfg.world_dim
    ppu = C.OBS / D
    P = int(ppu) + 3
    i32 = torch.int32
    hatched = states.hatch_timer >= HATCH_TIME
    flee = states.eat_timer[:, None] > 0.0
    var = torch.where(hatched, torch.where(flee, 1, 2 + states.anim_index[:, None]),
                      0).to(i32)
    centres = torch.cat([states.mob_pos, states.pos[:, None, :]], 1)
    var = torch.cat([var, torch.full((N, 1), 8, dtype=i32, device=dev)], 1)
    alive = torch.cat([level.egg_exists,
                       torch.ones((N, 1), dtype=torch.bool, device=dev)], 1)
    cam = torch.full((N,), D / 2.0, dtype=torch.float32, device=dev)
    r0, c0 = C.stamp_origin(centres, cam, cam, ppu, P)
    return var, r0, c0, alive


def observe_batch(cfg: Config, states: State):
    """Planar uint8 [N, 3, OBS, OBS]. The fixed camera (chaser.cpp:400)
    makes walls, pellets and orbs tile kinds whose texel images are the
    same for every env; the enemies and the agent are one stamp group of
    K = 6 slots at P = int(64/D) + 3, off the stamp-kernel path
    (`compositor.stamp_kernel_ok`), so it takes the reference's matmul
    semantics in plain torch ops and launches no kernel."""
    R = _render_tensors(cfg.mode, str(states.pos.device))
    G = _kind_grid(states)[:, R["t"]][:, :, R["t"]][:, None]
    img = R["bg_bank"][states.level.bg_index.long()].to(torch.bfloat16)
    img = C.blend_kind(img, G == WALL, *R["wall"])
    img = C.blend_kind(img, G == PELLET, *R["pellet"])
    img = C.blend_kind(img, G == ORB, *R["orb"])
    var, r0, c0, alive = _stamp_slots(cfg, states)
    img = C.composite_stamps(img, R["bank"], var,
                             torch.round(r0).to(torch.int32),
                             torch.round(c0).to(torch.int32), alives=alive)
    return torch.clamp(torch.round(img), 0, 255).to(torch.uint8)
