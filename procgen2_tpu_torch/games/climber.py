"""Climber in PyTorch (procgen2_tpu/games/climber.py), batched.

The same game as the JAX package, which cites the reference engine
(Procgen2's `games/climber/`) line by line: a 20x64 vertical world with a
difficulty-scaled ladder of platforms, crystals on about half of them
(always the topmost) and flying patrol enemies (tilemap.cpp:75-172);
coinrun's platformer physics without crates (common_systems.cpp:184-269);
the patrol AI (common_systems.cpp:109-168); +1 per crystal and +10 for
the last one, the episode ending on enemy contact or when every crystal is
taken (climber.cpp:339-355), over 4 physics sub-steps with early exit;
and the quantized-camera scene render through the scene kernel.

Every function works on a batch: `generate` on a batch of keys [L, 2]
(one level each), `reset`/`step`/`observe_batch`/`observe` on a batch of
envs. The random draws are the JAX package's, key for key (`..random`),
so a level, a state and an observation can be compared with it bit for
bit."""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import random as prng
from ..core import spaces
from ..physics.aabb import check_collision
from ..physics.tiles import FULL, NONE, resolve_tile_collisions
from ..render import atlas as atlas_lib
from ..render import compositor as C
from ..render import phases as phases_lib
from ..render import scene_kernel

NAME = "climber"
NUM_ACTIONS = 15
MAP_W = 20  # tilemap.cpp:76
MAP_H = 64  # tilemap.cpp:77
SUB_STEPS = 4  # climber.cpp:44
DT = 1.0 / SUB_STEPS
ZOOM = 0.2  # climber.cpp:32
PPU = 16.0 * ZOOM  # obs pixels per world unit

EMPTY, WALL_TOP, WALL_MID = 0, 1, 2  # tilemap.h Tile_ID order
NUM_TILE_IDS = 3

# Agent physics (common_systems.cpp:185-190), coinrun's
MAX_JUMP = 1.55
GRAVITY = 0.2
MAX_SPEED = 0.5
MIX = 0.2
AIR_CONTROL = 0.15
PATROL_RANGE = 4.0  # common_systems.h:53

# Generation bound (tilemap.cpp:79-80,120-123: gen max_jump=1.5):
# max_dy = int(1.5^2 / (2*0.2) - 0.5) = 5; init_y_dist(3, max_dy-1)
GEN_MAX_DY = 5

MAX_PLATFORMS = 17  # (3+1)^2 + 1, tilemap.cpp:103-104
MAX_CAND = 11  # platform length 2..11, tilemap.cpp:139-140
MAX_MOBS = MAX_PLATFORMS
MAX_POINTS = MAX_PLATFORMS

NUM_BGS = 49  # climber.cpp:58-108
NUM_TILE_THEMES = len(atlas_lib.CLIMBER_TILE_THEMES)  # 4, tilemap.cpp:10-18
NUM_AGENT_THEMES = len(atlas_lib.CLIMBER_AGENT_THEMES)  # common_systems.h:61

# walls are full, everything else none (common_systems.cpp:138-140, 235-237)
_LUT_WALL = (NONE, FULL, FULL)


@dataclasses.dataclass(frozen=True)
class Config:
    easy_mode: bool = False  # enemy_prob .2 vs .5, tilemap.cpp:118
    # Render-only: camera phase quantization of the scene render
    # (render/phases.py); 0 = the exact, continuous camera.
    scene_phases: int = 4


@dataclasses.dataclass
class Level:
    """One level per row of the leading dimension."""
    grid: torch.Tensor  # int8 [L, MAP_H, MAP_W] render coords [y, x]
    mob_pos0: torch.Tensor  # f32 [L, MAX_MOBS, 2]
    mob_spawn_x: torch.Tensor  # f32 [L, MAX_MOBS] patrol anchor (tile x)
    mob_vx0: torch.Tensor  # f32 [L, MAX_MOBS]
    mob_alive: torch.Tensor  # bool [L, MAX_MOBS]
    point_pos: torch.Tensor  # f32 [L, MAX_POINTS, 2]
    point_exists: torch.Tensor  # bool [L, MAX_POINTS]
    theme: torch.Tensor  # i32 [L] tile theme
    agent_theme: torch.Tensor  # i32 [L]
    bg_index: torch.Tensor  # i32 [L]
    difficulty: torch.Tensor  # i32 [L]


@dataclasses.dataclass
class State:
    """One env per row of the leading dimension."""
    level: Level
    pos: torch.Tensor  # f32 [N, 2]
    vel: torch.Tensor  # f32 [N, 2]
    on_ground: torch.Tensor  # bool [N]
    face_forward: torch.Tensor  # bool [N]
    anim_t: torch.Tensor  # f32 [N] (agent.t, rate 0.1, common_components.h:61)
    mob_pos: torch.Tensor  # f32 [N, MAX_MOBS, 2]
    mob_vx: torch.Tensor  # f32 [N, MAX_MOBS]
    point_taken: torch.Tensor  # bool [N, MAX_POINTS]
    t: torch.Tensor  # i32 [N] env steps this episode
    rng: torch.Tensor  # int64 [N, 2] key words


# ---------------------------------------------------------------------------
# Assets (numpy, built by the port's asset modules)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _assets():
    names = []
    for th in atlas_lib.CLIMBER_TILE_THEMES:
        names += [f"ctile_top_{th}", f"ctile_mid_{th}"]
    names += ["crystal", "swimmer", "swimmer_move"]
    for th in atlas_lib.CLIMBER_AGENT_THEMES:
        names += [f"climber_{th}_{k}" for k in ("stand", "jump", "walk1", "walk2")]
    atlas, idx = atlas_lib.build_atlas(tuple(names))
    bgs = atlas_lib.build_backgrounds("sky", NUM_BGS)
    return dict(atlas_p=atlas.transpose(3, 0, 1, 2), idx=idx,
                bgs_p=bgs.transpose(3, 0, 1, 2))


@functools.lru_cache(maxsize=None)
def _stamp_banks():
    """Pixel-snapped patch banks u8 [V, 4, P, P], P=8: moving (the
    crystal, the two swimmer frames and their flipped twins) and agent
    (4 themes x 4 poses x flip, 0.8 x 1.1 units, common_systems.cpp:292-294)."""
    A = atlas_lib
    u = PPU  # 1 world unit in obs pixels (3.2)
    specs = [("crystal", u, u)]
    for f in ("swimmer", "swimmer_move"):
        specs.append((f, u, u))
        specs.append((f, u, u, 0.0, True))  # flipped
    moving = A.build_pixel_bank(tuple(specs), patch=8)
    aspecs = []
    for th in A.CLIMBER_AGENT_THEMES:
        for k in ("stand", "jump", "walk1", "walk2"):
            aspecs.append((f"climber_{th}_{k}", 0.8 * u, 1.1 * u))
            aspecs.append((f"climber_{th}_{k}", 0.8 * u, 1.1 * u, 0.0, True))
    agent = A.build_pixel_bank(tuple(aspecs), patch=8)
    return dict(moving=moving, agent=agent)


@functools.lru_cache(maxsize=None)
def _merged_bank():
    """The render's one stamp group bank, u8 [37, 4, 8, 8]: moving, then
    agent (crystals, mobs and the agent are one group in painter order)."""
    banks = _stamp_banks()
    return np.concatenate([banks["moving"], banks["agent"]], axis=0)


@functools.lru_cache(maxsize=None)
def _scene_assets(qp):
    """Tile-entry phase bank, padded tile-resolution backgrounds and the
    phase offset table of the scene render (numpy). The 0.2-zoom camera
    shows ~20 tiles, so the window span (the grid's pad) comes from
    `phases.win` (21 at qp=4), not the default 16."""
    A = _assets()
    atlas_s = np.asarray(A["atlas_p"]).transpose(1, 0, 2, 3)  # [A, 4, S, S]
    idx = A["idx"]
    texs, kinds, themes = [], [], []
    for t, th in enumerate(atlas_lib.CLIMBER_TILE_THEMES):
        texs += [atlas_s[idx[f"ctile_top_{th}"]],
                 atlas_s[idx[f"ctile_mid_{th}"]]]
        kinds += [WALL_TOP, WALL_MID]
        themes += [t, t]
    bank = phases_lib.tile_phase_bank(np.stack(texs), PPU, 64, qp)
    W = phases_lib.win(PPU, 64, qp)
    GP = MAP_H + 2 * W  # square pad covers the tall axis; x never OOB
    bgs = np.asarray(A["bgs_p"])  # [3, NB, 64, 64]
    bgpad = np.zeros((NUM_BGS, 3, GP, GP), np.uint8)
    n = min(64, GP - W)
    bgpad[:, :, W:W + n, W:W + n] = bgs.transpose(1, 0, 2, 3)[:, :, :n, :n]
    TR, _, _ = phases_lib.phase_tables(PPU, 64, qp)
    return dict(bank=bank, kinds=tuple(kinds), themes=tuple(themes),
                bgpad=bgpad, TRtab=TR[:, None, :].astype(np.int32), win=W)


@functools.lru_cache(maxsize=None)
def _scene_tensors(qp, device):
    """The scene render's constant tensors on `device` (built once per
    device): bf16 tile bank, bg bank, the premultiplied stamp bank, TR."""
    SA = _scene_assets(qp)
    dev = torch.device(device)
    return dict(
        tile_bank=torch.from_numpy(SA["bank"]).to(torch.bfloat16).to(dev),
        bg_bank=torch.from_numpy(SA["bgpad"]).to(torch.bfloat16).to(dev),
        tr_tab=torch.from_numpy(SA["TRtab"]).to(dev),
        stamps=C._premultiply_bank(_merged_bank()).to(dev),
        kinds=SA["kinds"], themes=SA["themes"], win=SA["win"])


# ---------------------------------------------------------------------------
# Generation (tilemap.cpp:75-172), batched over levels
# ---------------------------------------------------------------------------

def _ry(y_up):
    """y-up tile coord -> render-unit centre y (tilemap.cpp:45,64)."""
    return MAP_H - 1.0 - y_up + 0.5


def generate(cfg: Config, keys: torch.Tensor) -> Level:
    """One level per key: keys int64 [L, 2] -> Level with leading dim L."""
    dev = keys.device
    L = keys.shape[0]
    i32 = torch.int32
    f32 = torch.float32
    k_diff, k_nplat, k_x0, k_loop, k_theme, k_ag, k_bg = (
        prng.split(keys, 7).unbind(-2))

    # Border walls + floor (tilemap.cpp:90-93); the grid is [L, x, y_up]
    # during generation, flipped to render coords at the end.
    xs = torch.arange(MAP_W, device=dev)[:, None]
    ys = torch.arange(MAP_H, device=dev)[None, :]
    border = torch.where((xs == 0) | (xs == MAP_W - 1) | (ys == MAP_H - 1),
                         WALL_MID, EMPTY)
    border = torch.where(ys == 0, WALL_TOP, border)  # set_area_with_top h=1
    grid = border.to(torch.int8)[None].expand(L, MAP_W, MAP_H).clone()

    difficulty = prng.randint(k_diff, (), 1, 4)  # tilemap.cpp:99-101
    min_p = difficulty * difficulty + 1
    max_p = (difficulty + 1) * (difficulty + 1) + 1
    num_platforms = prng.randint(k_nplat, (), min_p, max_p + 1)

    curr_x = prng.randint(k_x0, (), 2, MAP_W - 2)  # init_x_dist(2, 17)
    curr_y = torch.ones(L, dtype=i32, device=dev)
    enemy_prob = 0.2 if cfg.easy_mode else 0.5  # tilemap.cpp:118

    slots = torch.arange(MAX_MOBS, device=dev)
    mob_pos = torch.zeros((L, MAX_MOBS, 2), dtype=f32, device=dev)
    mob_sx = torch.zeros((L, MAX_MOBS), dtype=f32, device=dev)
    mob_vx = torch.zeros((L, MAX_MOBS), dtype=f32, device=dev)
    mob_n = torch.zeros(L, dtype=i32, device=dev)
    pt_pos = torch.zeros((L, MAX_POINTS, 2), dtype=f32, device=dev)
    pt_n = torch.zeros(L, dtype=i32, device=dev)
    j = torch.arange(MAX_CAND, device=dev)
    cols = torch.arange(MAP_W, device=dev)
    rows = torch.arange(MAP_H, device=dev)

    key = k_loop
    for i in range(MAX_PLATFORMS):
        sp = prng.split(key, 10)
        key = sp[:, 0]
        k_dy, k_es, k_ey, k_ev, k_len, k_vx, k_pt, k_px, k_nx = (
            sp[:, 1:].unbind(-2))
        act = i < num_platforms

        delta_y = prng.randint(k_dy, (), 3, GEN_MAX_DY)  # init_y_dist(3, 4)

        # Enemy spawn at the pre-advance height (tilemap.cpp:131-135)
        can_spawn = (curr_x >= 3) & (curr_x <= MAP_W - 4)
        do_mob = act & can_spawn & (prng.uniform(k_es) < enemy_prob)
        mob_y = curr_y + prng.randint(k_ey, (), 0, 2) + 2
        mpos = torch.stack([curr_x + 0.5, _ry(mob_y)], dim=-1).to(f32)
        mvx = 0.15 * (prng.randint(k_ev, (), 0, 2) * 2 - 1).to(f32)
        hit = do_mob[:, None] & (slots[None] == mob_n[:, None])
        mob_pos = torch.where(hit[..., None], mpos[:, None], mob_pos)
        mob_sx = torch.where(hit, curr_x.to(f32)[:, None], mob_sx)
        mob_vx = torch.where(hit, mvx[:, None], mob_vx)
        mob_n = mob_n + do_mob.to(i32)

        curr_y = torch.where(act, curr_y + delta_y, curr_y)

        plat_len = 2 + prng.randint(k_len, (), 0, 10)  # tilemap.cpp:139-140
        vx = prng.randint(k_vx, (), 0, 2) * 2 - 1
        vx = torch.where(curr_x < 3, 1, torch.where(curr_x > MAP_W - 3, -1, vx))

        # Candidate cells nx_j = curr_x + (j+1)*vx while strictly inside
        # (tilemap.cpp:149-158); nx is monotonic in j, so the in-bounds
        # test is the loop-break prefix.
        nx = curr_x[:, None] + (j[None] + 1) * vx[:, None]  # [L, MAX_CAND]
        valid = ((j[None] < plat_len[:, None]) & (nx > 0)
                 & (nx < MAP_W - 1))
        n_cand = valid.sum(dim=1)

        # Platform tiles: wall_top at (nx, curr_y); writes above the map
        # are dropped (tilemap.h set() guard). Only these cells change:
        # the JAX package's scatter writes the old value everywhere else.
        put = valid & (act & (curr_y < MAP_H))[:, None]  # [L, MAX_CAND]
        on_x = ((nx[:, :, None] == cols[None, None]) & put[:, :, None]).any(1)
        cell = on_x[:, :, None] & (rows[None, None] == curr_y[:, None, None])
        grid = torch.where(cell, torch.tensor(WALL_TOP, dtype=torch.int8,
                                              device=dev), grid)

        # Crystal with p=.5, always on the final platform (tilemap.cpp:163-165)
        is_last = i == num_platforms - 1
        do_pt = act & ((prng.uniform(k_pt) < 0.5) | is_last)
        n_hi = torch.clamp(n_cand, min=1)
        pt_i = prng.randint(k_px, (), 0, n_hi)
        pt_x = nx.gather(1, pt_i.clamp(0, MAX_CAND - 1).long()[:, None])[:, 0]
        ppos = torch.stack([pt_x + 0.5, _ry(curr_y + 1)], dim=-1).to(f32)
        hit = do_pt[:, None] & (slots[None] == pt_n[:, None])
        pt_pos = torch.where(hit[..., None], ppos[:, None], pt_pos)
        pt_n = pt_n + do_pt.to(i32)

        nxt_i = prng.randint(k_nx, (), 0, n_hi)
        nxt_x = nx.gather(1, nxt_i.clamp(0, MAX_CAND - 1).long()[:, None])[:, 0]
        curr_x = torch.where(act, nxt_x.to(i32), curr_x)

    # [x, y_up] -> render rows [ry, x]
    return Level(
        grid=torch.flip(grid.transpose(1, 2), dims=(1,)).contiguous(),
        mob_pos0=mob_pos,
        mob_spawn_x=mob_sx,
        mob_vx0=mob_vx,
        mob_alive=slots[None] < mob_n[:, None],
        point_pos=pt_pos,
        point_exists=slots[None] < pt_n[:, None],
        theme=prng.randint(k_theme, (), 0, NUM_TILE_THEMES),  # climber.cpp:490-492
        agent_theme=prng.randint(k_ag, (), 0, NUM_AGENT_THEMES),
        bg_index=prng.randint(k_bg, (), 0, NUM_BGS),
        difficulty=difficulty,
    )


def reset(cfg: Config, level: Level, keys: torch.Tensor) -> State:
    """Fresh episodes on `level` (leading dim N) with keys [N, 2]."""
    N = keys.shape[0]
    dev = keys.device
    f32 = torch.float32
    return State(
        level=level,
        pos=torch.tensor([1.5, MAP_H - 1.0], dtype=f32,
                         device=dev).expand(N, 2).clone(),  # climber.cpp:478
        vel=torch.zeros((N, 2), dtype=f32, device=dev),
        on_ground=torch.zeros(N, dtype=torch.bool, device=dev),
        face_forward=torch.ones(N, dtype=torch.bool, device=dev),
        anim_t=torch.zeros(N, dtype=f32, device=dev),
        mob_pos=level.mob_pos0,
        mob_vx=level.mob_vx0,
        point_taken=torch.zeros((N, MAX_POINTS), dtype=torch.bool, device=dev),
        t=torch.zeros(N, dtype=torch.int32, device=dev),
        rng=keys,
    )


# ---------------------------------------------------------------------------
# Step (climber.cpp:323-376)
# ---------------------------------------------------------------------------

def _agent_substep(level, pos, vel, on_ground, face_forward, anim_t, a):
    """System_Agent::update (common_systems.cpp:184-269)."""
    f32 = torch.float32
    movement_x = (((a == 6) | (a == 7) | (a == 8)).to(f32)
                  - ((a == 0) | (a == 1) | (a == 2)).to(f32))
    jump = (a == 2) | (a == 5) | (a == 8)

    mix_x = torch.where(on_ground, MIX, MIX * AIR_CONTROL)
    vx = vel[:, 0] + mix_x * (MAX_SPEED * movement_x - vel[:, 0]) * DT
    vx = torch.where(torch.abs(vx) < mix_x * MAX_SPEED * DT, 0.0, vx)
    vy = torch.where(jump & on_ground, -MAX_JUMP, vel[:, 1])
    vy = vy + GRAVITY * DT
    vy = torch.clamp(vy, -MAX_JUMP, MAX_JUMP)

    x = pos[:, 0] + vx * DT
    y = pos[:, 1] + vy * DT

    # Collision bounds (-0.5, -1, 1, 1) (climber.cpp:481)
    rx, ry, col = resolve_tile_collisions(level.grid, _LUT_WALL, x - 0.5,
                                          y - 1.0, 1.0, 1.0, WALL_MID)
    dx_moved = rx - (x - 0.5)
    dy_moved = ry - (y - 1.0)
    new_on_ground = (dy_moved < 0.0) & col
    x = rx + 0.5
    y = ry + 1.0
    vx = torch.where(dx_moved != 0.0, 0.0, vx)
    vy = torch.where(new_on_ground, 0.0, vy)

    anim_t = torch.remainder(anim_t + 0.1 * DT, 1.0)  # common_systems.cpp:262-263
    face_forward = torch.where(
        movement_x > 0, True,
        torch.where(movement_x < 0, False, face_forward))
    return (torch.stack([x, y], dim=-1), torch.stack([vx, vy], dim=-1),
            new_on_ground, face_forward, anim_t)


def _mob_substep(level, mob_pos, mob_vx, agent_pos):
    """System_Mob_AI::update (common_systems.cpp:109-168): patrol with a
    rebound on a wall or the patrol's end; returns the new mobs and
    whether any live mob touches the agent."""
    x = mob_pos[..., 0] + mob_vx * DT
    y = mob_pos[..., 1]
    rx, _, wcol = resolve_tile_collisions(level.grid, _LUT_WALL, x - 0.5,
                                          y - 0.6, 1.0, 0.5, WALL_MID)
    new_x = rx + 0.5
    sx = level.mob_spawn_x
    end_patrol = (new_x > sx + PATROL_RANGE) | (new_x < sx - PATROL_RANGE)
    new_vx = torch.where(wcol | end_patrol, -mob_vx, mob_vx)
    alive = level.mob_alive
    new_pos = torch.where(alive[..., None], torch.stack([new_x, y], dim=-1),
                          mob_pos)
    new_vx = torch.where(alive, new_vx, mob_vx)

    # Agent rect (-0.5, -1, 1, 1) + pos against mob bounds
    # (-0.4, -0.4, 0.8, 0.8) + pos (tilemap.cpp:55, common_systems.cpp:146-153)
    hit = (alive & check_collision(
        agent_pos[:, 0:1] - 0.5, agent_pos[:, 1:2] - 1.0, 1.0, 1.0,
        new_pos[..., 0] - 0.4, new_pos[..., 1] - 0.4, 0.8, 0.8,
    )).any(dim=1)
    return new_pos, new_vx, hit


def step(cfg: Config, state: State, action):
    """One env step for every env: (State, reward f32 [N], done bool [N],
    info {})."""
    level = state.level
    a = action.to(torch.int32)
    N = a.shape[0]
    dev = a.device
    f32 = torch.float32
    pos, vel = state.pos, state.vel
    on_ground, face_forward = state.on_ground, state.face_forward
    anim_t = state.anim_t
    mob_pos, mob_vx = state.mob_pos, state.mob_vx
    taken = state.point_taken
    done = torch.zeros(N, dtype=torch.bool, device=dev)
    reward = torch.zeros(N, dtype=f32, device=dev)

    for _ in range(SUB_STEPS):  # climber.cpp:339-355, break on terminal
        active = ~done
        n_pos, n_vel, n_og, n_ff, n_anim = _agent_substep(
            level, pos, vel, on_ground, face_forward, anim_t, a)
        n_mob_pos, n_mob_vx, dead = _mob_substep(level, mob_pos, mob_vx,
                                                 n_pos)

        # System_Point::update (common_systems.cpp:66-107): 1x1 crystal
        # rects against the agent rect; collect, count the rest. The
        # reward is the last active sub-step's (climber.cpp:348).
        got = (level.point_exists & ~taken) & check_collision(
            n_pos[:, 0:1] - 0.5, n_pos[:, 1:2] - 1.0, 1.0, 1.0,
            level.point_pos[..., 0] - 0.5, level.point_pos[..., 1] - 0.5,
            1.0, 1.0)
        n_taken = taken | got
        available = (level.point_exists & ~n_taken).sum(dim=1)
        sub_reward = got.sum(dim=1).to(f32) + (available == 0).to(f32) * 10.0

        act2 = active[:, None]
        pos = torch.where(act2, n_pos, pos)
        vel = torch.where(act2, n_vel, vel)
        on_ground = torch.where(active, n_og, on_ground)
        face_forward = torch.where(active, n_ff, face_forward)
        anim_t = torch.where(active, n_anim, anim_t)
        mob_pos = torch.where(act2[..., None], n_mob_pos, mob_pos)
        mob_vx = torch.where(act2, n_mob_vx, mob_vx)
        taken = torch.where(act2, n_taken, taken)
        reward = torch.where(active, sub_reward, reward)
        done = done | (active & (dead | (available == 0)))

    new_state = State(level=level, pos=pos, vel=vel, on_ground=on_ground,
                      face_forward=face_forward, anim_t=anim_t,
                      mob_pos=mob_pos, mob_vx=mob_vx, point_taken=taken,
                      t=state.t + 1, rng=state.rng)
    return new_state, reward, done, {}


# ---------------------------------------------------------------------------
# Rendering (climber.cpp:431-457)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _observe_assets(device: str):
    """The exact renders' atlas and backgrounds on `device` (`C.bank`),
    the premultiplied stamp banks, and the atlas tables: tile_lut
    [theme, kind] (-1 transparent), swim_frames, agent_lut [theme, pose]."""
    A = _assets()
    idx = A["idx"]
    dev = torch.device(device)
    tile_lut = np.full((NUM_TILE_THEMES, NUM_TILE_IDS), -1, np.int64)
    for t, th in enumerate(atlas_lib.CLIMBER_TILE_THEMES):
        tile_lut[t, WALL_TOP] = idx[f"ctile_top_{th}"]
        tile_lut[t, WALL_MID] = idx[f"ctile_mid_{th}"]
    agent_lut = [[idx[f"climber_{th}_{k}"]
                  for k in ("stand", "jump", "walk1", "walk2")]
                 for th in atlas_lib.CLIMBER_AGENT_THEMES]
    banks = _stamp_banks()
    return dict(
        atlas=C.bank(A["atlas_p"], device), bgs=C.bank(A["bgs_p"], device),
        idx=idx, tile_lut=tile_lut,
        swim_frames=torch.tensor([idx["swimmer"], idx["swimmer_move"]],
                                 device=dev),
        agent_lut=torch.tensor(agent_lut, device=dev),
        moving=C._premultiply_bank(banks["moving"]).to(dev),
        agent=C._premultiply_bank(banks["agent"]).to(dev))


def _pose(states: State):
    """The agent's pose int32 [N]: 0 stand, 1 jump, 2/3 the walk frames."""
    return torch.where(
        (torch.abs(states.vel[:, 0]) < 0.01) & states.on_ground, 0,
        torch.where(~states.on_ground, 1,
                    torch.where(states.anim_t > 0.5, 3, 2))).to(torch.int32)


def observe(cfg: Config, state: State, size: int = C.OBS):
    """Each env's frame at size x size by the exact render (climber.cpp:
    431-457): background, themed walls, crystals, swimming mobs and the
    agent over the whole frame, the camera spanning the same world at any
    size. uint8 [N, size, size, 3]."""
    R = _observe_assets(str(state.pos.device))
    atlas = R["atlas"]
    level = state.level
    N = state.pos.shape[0]
    dev = state.pos.device
    cam_x = torch.full((N,), MAP_W / 2.0, dtype=torch.float32,
                       device=dev)  # climber.cpp:464
    cam_y = state.pos[:, 1] - 8.5  # common_systems.cpp:259
    # window renders scale the zoom (render_game)
    wx, wy = C.camera_coords(PPU * (size / 64.0), cam_x, cam_y, size)
    # the crystals' and mobs' loops read the maps computed on their own
    lx, ly = C.camera_coords(PPU * (size / 64.0), cam_x, cam_y, size,
                             fused=False)

    img = C.clear(N, size, dev)
    img = C.draw_background(img, R["bgs"], level.bg_index, wx, wy)
    # out of bounds is a wall (tilemap.h:66-69)
    img = C.draw_tiles(img, level.grid, R["tile_lut"], atlas, wx, wy,
                       oob_tile=WALL_MID, theme=level.theme)
    # crystals: 1x1 at offset -0.5 (tilemap.cpp:68-69)
    img = C.draw_sprites(img, atlas, R["idx"]["crystal"],
                         level.point_pos[..., 0] - 0.5,
                         level.point_pos[..., 1] - 0.5, 1.0, 1.0, lx, ly,
                         alives=level.point_exists & ~state.point_taken)
    # swimming mobs: offset -0.4, anim rate 0.2 (tilemap.cpp:47-54)
    mob_sid = R["swim_frames"][((state.t // 5) % 2).long()]
    img = C.draw_sprites(img, atlas, mob_sid[:, None].expand(N, MAX_MOBS),
                         state.mob_pos[..., 0] - 0.4,
                         state.mob_pos[..., 1] - 0.4, 1.0, 1.0, lx, ly,
                         flips=state.mob_vx < 0.0,  # common_systems.cpp:164
                         alives=level.mob_alive)
    # the agent: 0.8 x 1.1 at (x - 0.5, y - 1) (common_systems.cpp:292-294)
    sid = R["agent_lut"][level.agent_theme.long(), _pose(state).long()]
    img = C.draw_sprite(img, atlas, sid, state.pos[:, 0] - 0.5,
                        state.pos[:, 1] - 1.0, 0.8, 1.1, wx, wy,
                        flip_x=~state.face_forward)
    return C.finalize(img)


def _observe_exact(cfg: Config, states: State):
    """The exact-camera batched render (`scene_phases=0`): the camera at
    (10, y - 8.5) unsnapped (climber.cpp:464, common_systems.cpp:259); the
    background, the themed walls from the kind field (out of bounds is a
    wall, tilemap.h:66-69), then the stamps of `_stamp_slots` by
    `compositor.composite_stamps`: crystals and mobs (K = 34, P = 8: B3 on
    the card), the agent (K = 1: the matmul semantics, no kernel)."""
    R = _observe_assets(str(states.pos.device))
    level = states.level
    N = states.pos.shape[0]
    cam_x = torch.full((N,), MAP_W / 2.0, dtype=torch.float32,
                       device=states.pos.device)
    cam_y = states.pos[:, 1] - 8.5
    wx, wy = C.camera_coords(PPU, cam_x, cam_y)
    img = C.draw_background_batch(R["bgs"], level.bg_index, wx, wy)
    sel = C.tile_selectors(wx, wy, MAP_H, MAP_W)
    G = C.kind_field(level.grid, sel, WALL_MID)
    atlas = R["atlas"]
    lut = torch.from_numpy(R["tile_lut"]).to(atlas.device)[
        level.theme.long()]  # [N, kinds]
    for kind in (WALL_TOP, WALL_MID):
        img = C.kind_layer(img, G == kind, atlas[lut[:, kind]], sel)
    (var, alive, r0, c0), (avar, ar0, ac0) = _stamp_slots(states, cam_x,
                                                          cam_y)
    img = C.composite_stamps(img, R["moving"], var, r0, c0, alives=alive)
    img = C.composite_stamps(img, R["agent"], avar, ar0, ac0)
    return torch.clamp(torch.round(img), 0, 255).to(torch.uint8)


def obs_space(cfg: Config):
    return spaces.Box(0, 255, (C.OBS, C.OBS, 3))


def action_space(cfg: Config):
    return spaces.MultiDiscrete((NUM_ACTIONS,))


def observe_batch(cfg: Config, states: State):
    """Planar uint8 [N, 3, 64, 64]: the quantized-phase scene render (the
    throughput path), or with `scene_phases=0` the exact-camera render."""
    if cfg.scene_phases > 0:
        return _observe_scene(cfg, states)
    return _observe_exact(cfg, states)


def _camera(cfg: Config, states: State):
    """The quantized render camera: x fixed at the map's centre
    (climber.cpp:464), y at the agent - 8.5 (common_systems.cpp:259),
    snapped to 1/qp units. Returns (cam_x, cam_y, ty0, tx0, jy, jx)."""
    qp = cfg.scene_phases
    N = states.pos.shape[0]
    i32 = torch.int32
    f32 = torch.float32
    cam_x = torch.full((N,), MAP_W / 2.0, dtype=f32, device=states.pos.device)
    my = torch.round((states.pos[:, 1] - 8.5) * qp).to(i32)
    cam_y = my.to(f32) / qp
    mx = torch.round(cam_x * qp).to(i32)
    _, _, t0_off = phases_lib.phase_tables(PPU, 64, qp)
    return (cam_x, cam_y, torch.floor(cam_y + t0_off).to(i32),
            torch.floor(cam_x + t0_off).to(i32), torch.remainder(my, qp),
            torch.remainder(mx, qp))


def _stamp_slots(states: State, cam_x, cam_y):
    """The render's stamps under the camera (cam_x, cam_y) [N], in painter
    order: the moving group (crystals, then mobs: var int32, alive bool,
    r0, c0 int32, [N, 34] each) and the agent ((var, r0, c0), [N, 1]
    each), P = 8 for both."""
    level = states.level
    N = states.pos.shape[0]
    dev = states.pos.device
    i32 = torch.int32
    live = level.point_exists & ~states.point_taken
    mob_frame = ((states.t // 5) % 2).to(i32)  # anim rate 0.2
    mob_var = (1 + mob_frame[:, None] * 2
               + (states.mob_vx < 0.0).to(i32))  # flipped, common_systems.cpp:164
    crys_var = torch.zeros((N, MAX_POINTS), dtype=i32, device=dev)
    # crystal centre = point_pos (1x1 at -0.5); mob centre = mob_pos + 0.1
    # (1x1 at -0.4, tilemap.cpp:47-54); agent 0.8 x 1.1 at (x-0.5, y-1.0)
    centers = torch.cat([level.point_pos, states.mob_pos + 0.1], dim=1)
    acenter = torch.stack([states.pos[:, 0] - 0.1, states.pos[:, 1] - 0.45],
                          dim=-1)[:, None, :]

    def pix(c):
        py, px = C.stamp_origin(c, cam_x, cam_y, PPU, 8)
        return torch.round(py).to(i32), torch.round(px).to(i32)
    avar = (level.agent_theme.to(i32) * 8 + _pose(states) * 2
            + (~states.face_forward).to(i32))[:, None]
    return ((torch.cat([crys_var, mob_var], dim=1).contiguous(),
             torch.cat([live, level.mob_alive], dim=1), *pix(centers)),
            (avar.contiguous(), *pix(acenter)))


def _stamp_group(states: State, cam_x, cam_y, bank):
    """The scene's one stamp group, painter order crystals, mobs, agent
    (the moving and agent banks merged): (bank, var, scale, r0, c0),
    [N, 35] each."""
    N = states.pos.shape[0]
    (var, alive, r0, c0), (avar, ar0, ac0) = _stamp_slots(states, cam_x,
                                                          cam_y)
    n_mv = _stamp_banks()["moving"].shape[0]
    ones = torch.ones((N, 1), dtype=torch.bool, device=var.device)
    return (bank, torch.cat([var, n_mv + avar], dim=1).contiguous(),
            torch.cat([alive, ones], dim=1).to(torch.float32),
            torch.cat([r0, ar0], dim=1), torch.cat([c0, ac0], dim=1))


def _padded_grid(level, W):
    """The kind grid padded to [N, GP, GP], GP = MAP_H + 2W, with wall
    (out of bounds is a wall, tilemap.h:66-69)."""
    GP = MAP_H + 2 * W
    return torch.nn.functional.pad(level.grid, (W, GP - W - MAP_W, W, W),
                                   value=WALL_MID)


def _scene_inputs(cfg: Config, states: State):
    """The scene kernel's arguments for a batch of states (as a tuple in
    `scene_kernel.scene_raw`'s order)."""
    qp = cfg.scene_phases
    ST = _scene_tensors(qp, str(states.pos.device))
    W = ST["win"]
    cam_x, cam_y, ty0, tx0, jy, jx = _camera(cfg, states)
    level = states.level
    i32 = torch.int32
    return (_padded_grid(level, W), ty0, tx0, jy, jx, level.bg_index.to(i32),
            level.theme.to(i32), ST["bg_bank"], ST["tr_tab"], ST["tile_bank"],
            ST["kinds"], ST["themes"],
            [_stamp_group(states, cam_x, cam_y, ST["stamps"])], C.OBS, qp, W)


def _scene_field(cfg: Config, states: State):
    """The expanded-field scene kernel's arguments for a batch of states
    (as a tuple in `scene_kernel.scene`'s order): the kind field and the
    background under every pixel, X bf16 [N, 4, 64, 64], gathered through
    the phase offset table from each env's W x W window. The window's
    origin is clamped into the padded grid and the background index into
    the bank, as `dynamic_slice` clamps them in the JAX package's CPU
    path (climber.py:594-611)."""
    qp = cfg.scene_phases
    ST = _scene_tensors(qp, str(states.pos.device))
    W = ST["win"]
    cam_x, cam_y, ty0, tx0, jy, jx = _camera(cfg, states)
    level = states.level
    gridp = _padded_grid(level, W)
    N, GP, _ = gridp.shape
    tr = ST["tr_tab"].reshape(qp, C.OBS).long()
    ys = (ty0.long() + W).clamp(0, GP - W)[:, None] + tr[jy.long()]  # [N, obs]
    xs = (tx0.long() + W).clamp(0, GP - W)[:, None] + tr[jx.long()]
    n = torch.arange(N, device=gridp.device)
    G = gridp[n[:, None, None], ys[:, :, None], xs[:, None, :]]
    bg_bank = ST["bg_bank"]
    b = level.bg_index.long().clamp(0, bg_bank.shape[0] - 1)
    bg = bg_bank[b[:, None, None, None],
                 torch.arange(3, device=gridp.device)[None, :, None, None],
                 ys[:, None, :, None], xs[:, None, None, :]]
    X = torch.cat([G[:, None].to(torch.bfloat16), bg], dim=1)
    p_joint = (jy * qp + jx).to(torch.int32)
    return (X, p_joint, level.theme.to(torch.int32), ST["tile_bank"],
            ST["kinds"], ST["themes"],
            [_stamp_group(states, cam_x, cam_y, ST["stamps"])], C.OBS)


def _observe_scene(cfg: Config, states: State):
    """Quantized-camera scene path: the render camera snaps to 1/qp world
    units (render only; physics is untouched); background, themed walls
    and one merged crystal/mob/agent stamp group are then one scene kernel
    pass."""
    img = scene_kernel.scene_raw(*_scene_inputs(cfg, states))
    return torch.clamp(torch.round(img), 0, 255).to(torch.uint8)
