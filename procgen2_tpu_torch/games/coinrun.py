"""Coinrun in PyTorch (procgen2_tpu/games/coinrun.py), batched.

The same game as the JAX package, which cites the reference engine
(Procgen2's `games/coinrun/`) line by line: difficulty-scaled platform
sections with pits, hazards, crates and a coin (tilemap.cpp:97-292);
platformer physics with one-way crates (common_systems.cpp:121-252);
patrolling mobs (common_systems.cpp:65-105); 4 physics sub-steps per env
step with early exit (coinrun.cpp:44-45, 357-371); and the quantized-
camera scene render through the scene kernel.

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
from ..physics.tiles import (
    DOWN_ONLY, FULL, NONE, fetch_window_patch, resolve_from_patch,
    resolve_tile_collisions,
)
from ..render import compositor as C
from ..render import scene_kernel
from ..render import atlas as atlas_lib
from ..render import phases as phases_lib

NAME = "coinrun"
NUM_ACTIONS = 15
WORLD = 64  # map is 64x64 tiles, tilemap.cpp:98-99
SUB_STEPS = 4  # coinrun.cpp:44
DT = 1.0 / SUB_STEPS
ZOOM = 0.3  # coinrun.cpp:32
PPU = 16.0 * ZOOM  # obs pixels per world unit (render_game, coinrun.cpp:454)

# Tile ids (tilemap.h:13-21)
EMPTY, WALL_TOP, WALL_MID, LAVA_TOP, LAVA_MID, CRATE = 0, 1, 2, 3, 4, 5
NUM_TILE_IDS = 6

# Agent physics (common_systems.cpp:126-130)
MAX_JUMP = 1.55
GRAVITY = 0.2
MAX_SPEED = 0.5
MIX = 0.2
AIR_CONTROL = 0.15

# Generation physics bounds (tilemap.cpp:100-146; gen uses max_jump=1.5)
GEN_MAX_DX = int(0.5 * 2.0 * 1.5 / 0.2 - 0.5)  # = 7
GEN_MAX_DY = int(1.5 * 1.5 / (2.0 * 0.2) - 0.5)  # = 5

MAX_SAWS = 40
MAX_MOBS = 40
MAX_SECTIONS = 5  # num_sections <= 2*difficulty - 1 <= 5 (tilemap.cpp:126)

NUM_BGS = 49  # coinrun.cpp:60-110
NUM_WALL_THEMES = len(atlas_lib.WALL_THEMES)
NUM_AGENT_THEMES = len(atlas_lib.AGENT_THEMES)
NUM_ENEMY_KINDS = len(atlas_lib.WALKING_ENEMIES)
NUM_CRATE_TYPES = len(atlas_lib.CRATE_TYPES)

# Collision LUTs (indexed by tile id)
_LUT_AGENT = (NONE, FULL, FULL, NONE, NONE, DOWN_ONLY)  # common_systems.cpp:176-178
_LUT_WALL = (NONE, FULL, FULL, NONE, NONE, NONE)  # mob wall sensor, :80-82
_LUT_EMPTY = (FULL, NONE, NONE, NONE, NONE, NONE)  # mob ledge sensor, :84-86
_LUT_LAVA = (NONE, NONE, NONE, FULL, FULL, NONE)  # common_systems.cpp:215-217

HAZARD_CULL = 16  # joint saw+mob stamp slots: the 13.3-unit visible window
#                   holds at most one 7-wide danger pit plus a few
#                   flat-section hazards (tilemap.cpp:174-257)


@dataclasses.dataclass(frozen=True)
class Config:
    # Runtime-exposed version of the compile-time Config struct
    # (tilemap.h:40-46).
    easy_mode: bool = False
    allow_pit: bool = True
    allow_crate: bool = True
    allow_dy: bool = True
    allow_mobs: bool = True
    # Render-only: camera phase quantization of the scene render
    # (render/phases.py); 0 = the exact, continuous camera.
    scene_phases: int = 4


@dataclasses.dataclass
class Level:
    """One level per row of the leading dimension."""
    grid: torch.Tensor  # int8 [L, 64, 64] render coords [y, x]
    crate_variant: torch.Tensor  # int8 [L, 64, 64]
    coin_pos: torch.Tensor  # f32 [L, 2]
    saw_pos: torch.Tensor  # f32 [L, MAX_SAWS, 2]
    saw_alive: torch.Tensor  # bool [L, MAX_SAWS]
    mob_pos0: torch.Tensor  # f32 [L, MAX_MOBS, 2]
    mob_vx0: torch.Tensor  # f32 [L, MAX_MOBS]
    mob_variant: torch.Tensor  # int8 [L, MAX_MOBS]
    mob_alive: torch.Tensor  # bool [L, MAX_MOBS]
    theme: torch.Tensor  # i32 [L] wall theme
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
    face_forward: torch.Tensor  # bool [N] (true at spawn, common_components.h:57)
    anim_t: torch.Tensor  # f32 [N], walk cycle (common_systems.cpp:242-243)
    mob_pos: torch.Tensor  # f32 [N, MAX_MOBS, 2]
    mob_vx: torch.Tensor  # f32 [N, MAX_MOBS]
    t: torch.Tensor  # i32 [N] env steps this episode
    rng: torch.Tensor  # int64 [N, 2] key words


# ---------------------------------------------------------------------------
# Assets (numpy, built by the port's asset modules)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _assets():
    names = []
    for th in atlas_lib.WALL_THEMES:
        names += [f"wall_top_{th}", f"wall_mid_{th}"]
    names += ["lava_top", "lava_mid"]
    names += list(atlas_lib.CRATE_TYPES)
    names += ["saw", "saw_move", "coin", "particle_circle"]
    for e in atlas_lib.WALKING_ENEMIES:
        names += [e, f"{e}_move"]
    for th in atlas_lib.AGENT_THEMES:
        names += [f"alien_{th}_{k}" for k in ("stand", "jump", "walk1", "walk2")]
    atlas, idx = atlas_lib.build_atlas(tuple(names))
    bgs = atlas_lib.build_backgrounds("sky", NUM_BGS)
    crate_lut = np.array([idx[c] for c in atlas_lib.CRATE_TYPES], np.int32)
    return dict(atlas_p=atlas.transpose(3, 0, 1, 2), idx=idx,
                bgs_p=bgs.transpose(3, 0, 1, 2), crate_lut=crate_lut)


@functools.lru_cache(maxsize=None)
def _stamp_banks():
    """Pixel-snapped patch banks u8 [V, 4, P, P]: moving (saws, coin, mobs
    with flipped twins; P=8) and agent (5 themes x 4 poses x flip; P=12)."""
    A = atlas_lib
    u = PPU  # 1 world unit in obs pixels (4.8)
    specs = [("saw", u, u), ("saw_move", u, u), ("coin", u, u)]
    for e in A.WALKING_ENEMIES:
        for f in (e, f"{e}_move"):
            specs.append((f, u, u))
            specs.append((f, u, u, 0.0, True))  # flipped
    moving = A.build_pixel_bank(tuple(specs), patch=8)
    aspecs = []
    for th in A.AGENT_THEMES:
        for k in ("stand", "jump", "walk1", "walk2"):
            aspecs.append((f"alien_{th}_{k}", u, 2 * u))
            aspecs.append((f"alien_{th}_{k}", u, 2 * u, 0.0, True))
    agent = A.build_pixel_bank(tuple(aspecs), patch=12)
    return dict(moving=moving, agent=agent)


@functools.lru_cache(maxsize=None)
def _scene_assets(qp):
    """Tile-entry phase bank, padded tile-resolution backgrounds and the
    phase offset table of the scene render (numpy)."""
    A = _assets()
    atlas_s = np.asarray(A["atlas_p"]).transpose(1, 0, 2, 3)  # [A, 4, S, S]
    idx = A["idx"]
    texs, kinds, themes = [], [], []
    for t, th in enumerate(atlas_lib.WALL_THEMES):
        texs += [atlas_s[idx[f"wall_top_{th}"]], atlas_s[idx[f"wall_mid_{th}"]]]
        kinds += [WALL_TOP, WALL_MID]
        themes += [t, t]
    texs += [atlas_s[idx["lava_top"]], atlas_s[idx["lava_mid"]]]
    kinds += [LAVA_TOP, LAVA_MID]
    themes += [-1, -1]
    for v in range(NUM_CRATE_TYPES):
        texs.append(atlas_s[A["crate_lut"][v]])
        kinds.append(CRATE + v * 8)  # crate cells carry CRATE + 8*variant
        themes.append(-1)
    bank = phases_lib.tile_phase_bank(np.stack(texs), PPU, 64, qp)
    # backgrounds cover 64 world units with 64 texels (atlas.BG_SIZE), so
    # the bg texel under a pixel is its tile coordinate: window-sliced and
    # phase-expanded like the kind field; zero padding is black
    bgs = np.asarray(A["bgs_p"])  # [3, NB, 64, 64] u8
    P = phases_lib.WIN
    bgpad = np.zeros((NUM_BGS, 3, 64 + 2 * P, 64 + 2 * P), np.uint8)
    bgpad[:, :, P:P + 64, P:P + 64] = bgs.transpose(1, 0, 2, 3)
    TR, _, _ = phases_lib.phase_tables(PPU, 64, qp)
    return dict(bank=bank, kinds=tuple(kinds), themes=tuple(themes),
                bgpad=bgpad, TRtab=TR[:, None, :].astype(np.int32))


@functools.lru_cache(maxsize=None)
def _scene_tensors(qp, device):
    """The scene render's constant tensors on `device` (built once per
    device): bf16 tile bank, bg bank, premultiplied stamp banks, TR."""
    SA = _scene_assets(qp)
    banks = _stamp_banks()
    dev = torch.device(device)
    return dict(
        tile_bank=torch.from_numpy(SA["bank"]).to(torch.bfloat16).to(dev),
        bg_bank=torch.from_numpy(SA["bgpad"]).to(torch.bfloat16).to(dev),
        tr_tab=torch.from_numpy(SA["TRtab"]).to(dev),
        moving=C._premultiply_bank(banks["moving"]).to(dev),
        agent=C._premultiply_bank(banks["agent"]).to(dev),
        kinds=SA["kinds"], themes=SA["themes"])


# ---------------------------------------------------------------------------
# Generation (tilemap.cpp:97-292), batched over levels
# ---------------------------------------------------------------------------

def _col(v):
    """[L] -> [L, 1, 1] for the [L, x, y] masks; numbers pass through."""
    return v[:, None, None] if isinstance(v, torch.Tensor) else v


def _set_area(grid, x0, y0, w, h, tile_id):
    """Masked rectangular fill in y-up coords; grid is [L, x, y_up]
    (set_area, tilemap.cpp:40-44; OOB writes are dropped, tilemap.h:67-72).
    x0/y0/w/h/tile_id: numbers or [L] tensors."""
    r = torch.arange(WORLD, device=grid.device)
    xs = r[None, :, None]
    ys = r[None, None, :]
    x0, y0, w, h = _col(x0), _col(y0), _col(w), _col(h)
    m = (xs >= x0) & (xs < x0 + w) & (ys >= y0) & (ys < y0 + h)
    val = torch.as_tensor(tile_id, dtype=grid.dtype, device=grid.device)
    return torch.where(m, _col(val) if val.ndim else val, grid)


def _set_area_with_top(grid, x0, y0, w, h, mid_id, top_id):
    """tilemap.cpp:46-49: body fill + distinct top row."""
    grid = _set_area(grid, x0, y0, w, h - 1, mid_id)
    return _set_area(grid, x0, y0 + h - 1, w, 1, top_id)


def _where(c, a, b):
    """Per-level select of [L, ...] tensors by c [L]."""
    return torch.where(c.reshape((-1,) + (1,) * (a.ndim - 1)), a, b)


def _ri(k, lo, hi):
    return prng.randint(k, (), lo, hi)


def generate(cfg: Config, keys: torch.Tensor) -> Level:
    """One level per key: keys int64 [L, 2] -> Level with leading dim L."""
    dev = keys.device
    L = keys.shape[0]
    i32 = torch.int32
    f32 = torch.float32
    ks = prng.split(keys, 8)
    grid = torch.zeros((L, WORLD, WORLD), dtype=torch.int8, device=dev)
    crate_g = torch.zeros_like(grid)

    # Floors and walls (tilemap.cpp:113-117)
    grid = _set_area(grid, 0, 0, WORLD, 1, WALL_TOP)
    grid = _set_area(grid, 0, 0, 1, WORLD, WALL_MID)
    grid = _set_area(grid, WORLD - 1, 0, 1, WORLD, WALL_MID)
    grid = _set_area(grid, 0, WORLD - 1, WORLD, 1, WALL_MID)

    difficulty = _ri(ks[:, 0], 1, 4)  # tilemap.cpp:122-124
    # section_dist(difficulty, 2*difficulty-1), tilemap.cpp:126-128
    num_sections = _ri(ks[:, 1], difficulty, 2 * difficulty)
    danger_type = _ri(ks[:, 2], 0, 3)  # tilemap.cpp:135-137
    pit_thresh = difficulty

    saw_pos = torch.zeros((L, MAX_SAWS, 2), dtype=f32, device=dev)
    saw_n = torch.zeros(L, dtype=i32, device=dev)
    mob_pos = torch.zeros((L, MAX_MOBS, 2), dtype=f32, device=dev)
    mob_vx = torch.zeros((L, MAX_MOBS), dtype=f32, device=dev)
    mob_var = torch.zeros((L, MAX_MOBS), dtype=torch.int8, device=dev)
    mob_n = torch.zeros(L, dtype=i32, device=dev)
    slots = torch.arange(MAX_SAWS, device=dev)

    def centre(x, y):
        """Tile (x, y_up) -> world centre [L, 2] in render coords."""
        ry = WORLD - 1.0 - y + 0.5
        if not isinstance(ry, torch.Tensor):
            ry = torch.full_like(x, ry)
        return torch.stack([x + 0.5, ry], dim=-1)

    def spawn_saw(saw_pos, saw_n, x, y, cond):
        p = centre(x, y)
        hit = cond[:, None] & (slots[None] == saw_n[:, None])  # OOB: no write
        saw_pos = torch.where(hit[..., None], p[:, None], saw_pos)
        return saw_pos, saw_n + cond.to(i32)

    def spawn_mob(mob, x, y, cond, k):
        # spawn_enemy_mob, tilemap.cpp:70-94: random kind, +-0.15 start dir
        mob_pos, mob_vx, mob_var, mob_n = mob
        kv, kd = prng.split(k).unbind(-2)
        p = centre(x, y)
        var = _ri(kv, 0, NUM_ENEMY_KINDS).to(torch.int8)
        vx = 0.15 * torch.where(prng.uniform(kd) < 0.5, 1.0, -1.0)
        hit = cond[:, None] & (slots[None] == mob_n[:, None])
        mob_pos = torch.where(hit[..., None], p[:, None], mob_pos)
        mob_vx = torch.where(hit, vx[:, None], mob_vx)
        mob_var = torch.where(hit, var[:, None], mob_var)
        return mob_pos, mob_vx, mob_var, mob_n + cond.to(i32)

    curr_x = torch.full((L,), 5, dtype=i32, device=dev)
    curr_y = torch.full((L,), 1, dtype=i32, device=dev)
    key = ks[:, 3]
    mob = (mob_pos, mob_vx, mob_var, mob_n)
    for i in range(MAX_SECTIONS):
        sp = prng.split(key, 17)
        key, sk = sp[:, 0], sp[:, 1:]
        act = (i < num_sections) & (curr_x + 15 < WORLD)  # tilemap.cpp:150-152

        do = difficulty // 3  # difficult_offset, tilemap.cpp:154
        dy = _ri(sk[:, 0], 1 + do, 5 + do)
        if not cfg.allow_dy:
            dy = torch.zeros_like(dy)
        dy = torch.clamp(dy, max=GEN_MAX_DY)
        flip = (curr_y >= 20) | ((curr_y >= 5)
                                 & (prng.uniform(sk[:, 1]) < 0.5))  # :163
        dy = torch.where(flip, -dy, dy)
        dx = _ri(sk[:, 2], 3 + do, 2 * difficulty + 3 + do)
        new_y = torch.clamp(curr_y + dy, min=1)

        use_pit = ((dx > 7) & (new_y > 3)
                   & (_ri(sk[:, 3], 0, 20) >= pit_thresh))  # tilemap.cpp:174
        if not cfg.allow_pit:
            use_pit = torch.zeros_like(use_pit)

        # ---- pit branch (tilemap.cpp:178-233) ----
        x1 = _ri(sk[:, 4], 1, 4)
        x2 = _ri(sk[:, 5], 1, 4)
        pit_w0 = dx - x1 - x2
        pit_w = torch.clamp(pit_w0, max=GEN_MAX_DX)
        x2 = torch.where(pit_w0 > GEN_MAX_DX, dx - x1 - pit_w, x2)

        pit_grid = _set_area_with_top(grid, curr_x, 0, x1, new_y,
                                      WALL_MID, WALL_TOP)
        pit_grid = _set_area_with_top(pit_grid, curr_x + dx - x2, 0, x2,
                                      new_y, WALL_MID, WALL_TOP)
        lava_h = _ri(sk[:, 6], 1, torch.clamp(new_y - 3, min=1) + 1)
        pit_grid = _where(
            use_pit & (danger_type == 0),
            _set_area_with_top(pit_grid, curr_x + x1, 1, pit_w, lava_h,
                               LAVA_MID, LAVA_TOP),
            pit_grid)
        # saws / mobs across the pit floor (tilemap.cpp:201-209)
        mobkeys = prng.split(sk[:, 7], GEN_MAX_DX)
        for pi in range(GEN_MAX_DX):
            in_pit = act & use_pit & (pi < pit_w)
            px = (curr_x + x1 + pi).to(f32)
            saw_pos, saw_n = spawn_saw(saw_pos, saw_n, px, 1.0,
                                       in_pit & (danger_type == 1))
            mob = spawn_mob(mob, px, 1.0, in_pit & (danger_type == 2),
                            mobkeys[:, pi])
        # mid-pit rescue platform (tilemap.cpp:212-232)
        d2a = _ri(sk[:, 8], 1, 3)
        d2b = _ri(sk[:, 9], 1, 3)
        x3 = torch.where(pit_w == 5, d2a, d2a + 1)
        w1 = torch.where(pit_w <= 6, d2b, pit_w - x3 - (d2b + 1))
        pit_grid = _where(
            use_pit & (pit_w > 4),
            _set_area_with_top(pit_grid, curr_x + x1 + x3, new_y - 1, w1, 1,
                               WALL_MID, WALL_TOP),
            pit_grid)

        # ---- flat branch (tilemap.cpp:234-274) ----
        flat_grid = _set_area_with_top(grid, curr_x, 0, dx, new_y,
                                       WALL_MID, WALL_TOP)
        saw_here = (_ri(sk[:, 10], 0, 10) < 2 * difficulty) & (dx > 3)
        saw_x = curr_x + _ri(sk[:, 11], 1, torch.clamp(dx - 1, min=2))
        saw_pos, saw_n = spawn_saw(saw_pos, saw_n, saw_x.to(f32),
                                   new_y.to(f32), act & ~use_pit & saw_here)
        mob_here = (_ri(sk[:, 12], 0, 10) < difficulty) & (dx > 3)
        if not cfg.allow_mobs:
            mob_here = torch.zeros_like(mob_here)
        mob_x = curr_x + _ri(sk[:, 13], 1, torch.clamp(dx - 1, min=2))
        mob = spawn_mob(mob, mob_x.to(f32), new_y.to(f32),
                        act & ~use_pit & mob_here, sk[:, 14])
        ob1_x = torch.where(mob_here, mob_x,
                            torch.where(saw_here, saw_x, -1))

        # crate piles (tilemap.cpp:258-273)
        ckeys = prng.split(sk[:, 15], 2)
        for ci in range(2):
            k1, k2, k3, k4 = prng.split(ckeys[:, ci], 4).unbind(-2)
            crate_x = curr_x + _ri(k1, 1, torch.clamp(dx - 1, min=2))
            ok = (act & ~use_pit & (prng.uniform(k2) < 0.5)
                  & (crate_x != ob1_x))
            if not cfg.allow_crate:
                ok = torch.zeros_like(ok)
            pile_h = _ri(k3, 1, 4)
            vkeys = prng.split(k4, 3)
            for j in range(3):
                put = ok & (j < pile_h)
                flat_grid = _where(
                    put, _set_area(flat_grid, crate_x, new_y + j, 1, 1, CRATE),
                    flat_grid)
                variant = _ri(vkeys[:, j], 0, NUM_CRATE_TYPES).to(torch.int8)
                crate_g = _where(
                    put, _set_area(crate_g, crate_x, new_y + j, 1, 1, variant),
                    crate_g)

        grid = _where(act, _where(use_pit, pit_grid, flat_grid), grid)
        curr_x = torch.where(act, curr_x + dx, curr_x)
        curr_y = torch.where(act, new_y, curr_y)

    mob_pos, mob_vx, mob_var, mob_n = mob
    # Coin + wall close-off (tilemap.cpp:279-291)
    coin_pos = torch.stack([curr_x + 0.5, WORLD - 1.0 - curr_y + 0.5],
                           dim=-1).to(f32)
    grid = _set_area_with_top(grid, curr_x, 0, 1, curr_y, WALL_MID, WALL_TOP)
    grid = _set_area(grid, curr_x + 1, 0, WORLD - curr_x, WORLD, WALL_MID)

    # y-up [x, y] -> render rows [ry, x]
    return Level(
        grid=torch.flip(grid.transpose(1, 2), dims=(1,)).contiguous(),
        crate_variant=torch.flip(crate_g.transpose(1, 2),
                                 dims=(1,)).contiguous(),
        coin_pos=coin_pos,
        saw_pos=saw_pos,
        saw_alive=slots[None] < saw_n[:, None],
        mob_pos0=mob_pos,
        mob_vx0=mob_vx,
        mob_variant=mob_var,
        mob_alive=slots[None] < mob_n[:, None],
        theme=_ri(ks[:, 4], 0, NUM_WALL_THEMES),
        agent_theme=_ri(ks[:, 5], 0, NUM_AGENT_THEMES),
        bg_index=_ri(ks[:, 6], 0, NUM_BGS),
        difficulty=difficulty,
    )


def reset(cfg: Config, level: Level, keys: torch.Tensor) -> State:
    """Fresh episodes on `level` (leading dim N) with keys [N, 2]."""
    N = keys.shape[0]
    dev = keys.device
    f32 = torch.float32
    return State(
        level=level,
        pos=torch.tensor([1.5, WORLD - 2.0], dtype=f32,
                         device=dev).expand(N, 2).clone(),  # coinrun.cpp:489
        vel=torch.zeros((N, 2), dtype=f32, device=dev),
        on_ground=torch.zeros(N, dtype=torch.bool, device=dev),
        face_forward=torch.ones(N, dtype=torch.bool, device=dev),
        anim_t=torch.zeros(N, dtype=f32, device=dev),
        mob_pos=level.mob_pos0,
        mob_vx=level.mob_vx0,
        t=torch.zeros(N, dtype=torch.int32, device=dev),
        rng=keys,
    )


# ---------------------------------------------------------------------------
# Step (coinrun.cpp:341-391)
# ---------------------------------------------------------------------------

def _mob_substep(patches, mob_pos, mob_vx, alive, active):
    """System_Mob_AI::update (common_systems.cpp:65-105). Mob y never
    changes and x moves <= 0.15 units per env step, so both sensors' 3x5
    window patches are fetched once per env step."""
    patch_wall, patch_ledge, lx0 = patches
    x = mob_pos[..., 0] + mob_vx * DT
    y = mob_pos[..., 1]
    # wall sensor: full vs walls
    wx, _, wcol = resolve_from_patch(patch_wall, lx0, _LUT_WALL, x - 0.5,
                                     y - 0.6, 1.0, 0.5, WALL_MID)
    # floor (ledge) sensor: "collides with empty"
    fx, _, fcol = resolve_from_patch(patch_ledge, lx0, _LUT_EMPTY, x - 0.5,
                                     y + 0.6, 1.0, 0.5, WALL_MID)
    new_x = torch.where(fcol, fx + 0.5, wx + 0.5)
    new_vx = torch.where(wcol | fcol, -mob_vx, mob_vx)
    upd = alive & active[:, None]
    new_pos = torch.stack([new_x, y], dim=-1)
    return (torch.where(upd[..., None], new_pos, mob_pos),
            torch.where(upd, new_vx, mob_vx))


def _agent_substep(cfg, level, pos, vel, on_ground, face_forward, a):
    """System_Agent::update (common_systems.cpp:121-252)."""
    f32 = torch.float32
    movement_x = (((a == 6) | (a == 7) | (a == 8)).to(f32)
                  - ((a == 0) | (a == 1) | (a == 2)).to(f32))
    jump = (a == 2) | (a == 5) | (a == 8)
    fallthrough = (a == 0) | (a == 3) | (a == 6)

    mix_x = torch.where(on_ground, MIX, MIX * AIR_CONTROL)
    vx = vel[:, 0] + mix_x * (MAX_SPEED * movement_x - vel[:, 0]) * DT
    vx = torch.where(torch.abs(vx) < mix_x * MAX_SPEED * DT, 0.0, vx)
    vy = torch.where(jump & on_ground, -MAX_JUMP, vel[:, 1])
    vy = vy + GRAVITY * DT
    vy = torch.clamp(vy, -MAX_JUMP, MAX_JUMP)  # common_systems.cpp:166-167

    x = pos[:, 0] + vx * DT
    y = pos[:, 1] + vy * DT

    # Collision box (-0.5, -1, 1, 1) (coinrun.cpp:492)
    rx, ry, col = resolve_tile_collisions(
        level.grid, _LUT_AGENT, x - 0.5, y - 1.0, 1.0, 1.0, WALL_MID,
        fallthrough=fallthrough, step_y=vy * DT)
    dx_moved = rx - (x - 0.5)
    dy_moved = ry - (y - 1.0)
    new_on_ground = (dy_moved < 0.0) & col
    x = rx + 0.5
    y = ry + 1.0
    vx = torch.where(dx_moved != 0.0, 0.0, vx)
    vy = torch.where(new_on_ground, 0.0, vy)

    # Hazards: saws (common_systems.cpp:199-212); agent box 1x1 above
    # the feet; saw bounds (-0.5, -0.5, 1, 1)
    ax, ay = x - 0.5, y - 1.0
    saw_hit = (level.saw_alive & check_collision(
        ax[:, None], ay[:, None], 1.0, 1.0,
        level.saw_pos[..., 0] - 0.5, level.saw_pos[..., 1] - 0.5, 1.0, 1.0,
    )).any(dim=1)

    # Lava (common_systems.cpp:215-220)
    _, _, lava = resolve_tile_collisions(level.grid, _LUT_LAVA, ax, ay,
                                         1.0, 1.0, WALL_MID)
    dead = saw_hit | lava

    # Coin (common_systems.cpp:223-235)
    achieved = check_collision(ax, ay, 1.0, 1.0, level.coin_pos[:, 0] - 0.5,
                               level.coin_pos[:, 1] - 0.5, 1.0, 1.0)

    face_forward = torch.where(
        movement_x > 0, True,
        torch.where(movement_x < 0, False, face_forward))
    return (torch.stack([x, y], dim=-1), torch.stack([vx, vy], dim=-1),
            new_on_ground, face_forward, dead, achieved)


def step(cfg: Config, state: State, action):
    """One env step for every env: (State, reward f32 [N], done bool [N],
    info {})."""
    level = state.level
    a = action.to(torch.int32)
    N = a.shape[0]
    dev = a.device
    pos, vel = state.pos, state.vel
    on_ground, face_forward = state.on_ground, state.face_forward
    anim_t = state.anim_t
    mob_pos, mob_vx = state.mob_pos, state.mob_vx
    done = torch.zeros(N, dtype=torch.bool, device=dev)
    reward = torch.zeros(N, dtype=torch.float32, device=dev)

    # Mob sensor patches: y is constant all step and x moves <= 0.15
    # units, so both sensors' 3x5 windows (one column of margin each
    # side) are fetched once per step.
    lx0 = torch.floor(mob_pos[..., 0] - 0.5).to(torch.int32) - 1
    patch_wall = fetch_window_patch(
        level.grid, lx0, torch.floor(mob_pos[..., 1] - 0.6).to(torch.int32),
        WALL_MID)
    patch_ledge = fetch_window_patch(
        level.grid, lx0, torch.floor(mob_pos[..., 1] + 0.6).to(torch.int32),
        WALL_MID)
    patches = (patch_wall, patch_ledge, lx0)

    for _ in range(SUB_STEPS):  # early exit by masking, coinrun.cpp:357-371
        active = ~done
        mob_pos, mob_vx = _mob_substep(patches, mob_pos, mob_vx,
                                       level.mob_alive, active)
        n_pos, n_vel, n_og, n_ff, dead, achieved = _agent_substep(
            cfg, level, pos, vel, on_ground, face_forward, a)
        # mob contact after the mobs moved (mob_ai updates first,
        # coinrun.cpp:359-360); mob bounds (-0.5, -0.48, 1, 0.98)
        mob_hit = (level.mob_alive & check_collision(
            n_pos[:, 0:1] - 0.5, n_pos[:, 1:2] - 1.0, 1.0, 1.0,
            mob_pos[..., 0] - 0.5, mob_pos[..., 1] - 0.48, 1.0, 0.98,
        )).any(dim=1)
        dead = dead | mob_hit

        act2 = active[:, None]
        pos = torch.where(act2, n_pos, pos)
        vel = torch.where(act2, n_vel, vel)
        on_ground = torch.where(active, n_og, on_ground)
        face_forward = torch.where(active, n_ff, face_forward)
        anim_t = torch.where(active, torch.remainder(anim_t + 0.1 * DT, 1.0),
                             anim_t)
        reward = torch.where(active, achieved.to(torch.float32) * 10.0,
                             reward)
        done = done | (active & (dead | achieved))

    new_state = State(level=level, pos=pos, vel=vel, on_ground=on_ground,
                      face_forward=face_forward, anim_t=anim_t,
                      mob_pos=mob_pos, mob_vx=mob_vx, t=state.t + 1,
                      rng=state.rng)
    return new_state, reward, done, {}


# ---------------------------------------------------------------------------
# Rendering
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _observe_assets(device: str):
    """The exact renders' atlas and backgrounds on `device` (`C.bank`) and
    the atlas tables: tile_lut [theme, kind] (-1 transparent; crates have
    their own layer), crate_lut, enemy_lut [variant, frame], saw_frames,
    agent_lut [theme, pose]."""
    A = _assets()
    idx = A["idx"]
    dev = torch.device(device)
    tile_lut = np.full((NUM_WALL_THEMES, NUM_TILE_IDS), -1, np.int64)
    for t, th in enumerate(atlas_lib.WALL_THEMES):
        tile_lut[t, WALL_TOP] = idx[f"wall_top_{th}"]
        tile_lut[t, WALL_MID] = idx[f"wall_mid_{th}"]
        tile_lut[t, LAVA_TOP] = idx["lava_top"]
        tile_lut[t, LAVA_MID] = idx["lava_mid"]
    poses = ("stand", "jump", "walk1", "walk2")
    return dict(
        atlas=C.bank(A["atlas_p"], device), bgs=C.bank(A["bgs_p"], device),
        idx=idx, tile_lut=tile_lut, crate_lut=A["crate_lut"],
        enemy_lut=torch.tensor([[idx[e], idx[f"{e}_move"]]
                                for e in atlas_lib.WALKING_ENEMIES],
                               device=dev),
        saw_frames=torch.tensor([idx["saw"], idx["saw_move"]], device=dev),
        agent_lut=torch.tensor([[idx[f"alien_{th}_{k}"] for k in poses]
                                for th in atlas_lib.AGENT_THEMES],
                               device=dev),
        moving=C._premultiply_bank(_stamp_banks()["moving"]).to(dev),
        agent=C._premultiply_bank(_stamp_banks()["agent"]).to(dev))


def _pose(states: State):
    """The agent's pose int32 [N] (common_systems.cpp:263-272): 1 in the
    air, 0 standing, else the walk frame 2/3."""
    return torch.where(
        ~states.on_ground, 1,
        torch.where(torch.abs(states.vel[:, 0]) < 0.01, 0,
                    torch.where(states.anim_t > 0.5, 3, 2))).to(torch.int32)


def observe(cfg: Config, state: State, size: int = C.OBS):
    """Each env's frame at size x size by the exact render (coinrun.cpp:
    443-470): background, themed walls and lava, crates, saws, mobs, the
    coin and the agent over the whole frame, the camera spanning the same
    world at any size. uint8 [N, size, size, 3]."""
    R = _observe_assets(str(state.pos.device))
    atlas = R["atlas"]
    level = state.level
    N = state.pos.shape[0]
    dev = state.pos.device
    cam_x = state.pos[:, 0]
    cam_y = state.pos[:, 1] - 0.5  # common_systems.cpp:238-239
    # window renders scale the zoom (coinrun.cpp:412)
    wx, wy = C.camera_coords(PPU * (size / 64.0), cam_x, cam_y, size)
    # the saws' and mobs' loops read the maps computed on their own
    lx, ly = C.camera_coords(PPU * (size / 64.0), cam_x, cam_y, size,
                             fused=False)

    img = C.clear(N, size, dev)
    img = C.draw_background(img, R["bgs"], level.bg_index, wx, wy)
    # out of bounds is a wall (tilemap.h:82-87)
    img = C.draw_tiles(img, level.grid, R["tile_lut"], atlas, wx, wy,
                       oob_tile=WALL_MID, theme=level.theme)
    crates = torch.where(level.grid == CRATE, level.crate_variant.to(
        torch.int32), -1)
    img = C.draw_tiles(img, crates, R["crate_lut"], atlas, wx, wy,
                       oob_tile=-1)
    # saws: z=1, animated every step (anim rate 1.0, tilemap.cpp:61)
    saw_sid = R["saw_frames"][(state.t % 2).long()]
    img = C.draw_sprites(img, atlas, saw_sid[:, None].expand(N, MAX_SAWS),
                         level.saw_pos[..., 0] - 0.5,
                         level.saw_pos[..., 1] - 0.5, 1.0, 1.0, lx, ly,
                         alives=level.saw_alive)
    # mobs: anim rate 0.2, a frame every 5 steps (tilemap.cpp:85)
    mob_sid = R["enemy_lut"][level.mob_variant.long(),
                             ((state.t // 5) % 2).long()[:, None]]
    img = C.draw_sprites(img, atlas, mob_sid, state.mob_pos[..., 0] - 0.5,
                         state.mob_pos[..., 1] - 0.5, 1.0, 1.0, lx, ly,
                         flips=state.mob_vx > 0.0,  # common_systems.cpp:100-103
                         alives=level.mob_alive)
    img = C.draw_sprite(img, atlas, R["idx"]["coin"],
                        level.coin_pos[:, 0] - 0.5, level.coin_pos[:, 1] - 0.5,
                        1.0, 1.0, wx, wy)
    # the agent: 1x2 units at (x - 0.5, y - 2)
    sid = R["agent_lut"][level.agent_theme.long(), _pose(state).long()]
    img = C.draw_sprite(img, atlas, sid, state.pos[:, 0] - 0.5,
                        state.pos[:, 1] - 2.0, 1.0, 2.0, wx, wy,
                        flip_x=~state.face_forward)  # common_systems.cpp:276
    return C.finalize(img)


def obs_space(cfg: Config):
    return spaces.Box(0, 255, (C.OBS, C.OBS, 3))


def action_space(cfg: Config):
    return spaces.MultiDiscrete((NUM_ACTIONS,))


def _cull(cam_x, pos, alive, k):
    """Indices [N, k] of the k alive entities nearest the camera in x,
    nearest first; equal scores keep index order, as lax.top_k does
    (the dead slots all tie at -1e30 and fill the tail)."""
    score = torch.where(alive, -torch.abs(pos[..., 0] - cam_x[:, None]),
                        -1e30)
    return torch.sort(score, dim=1, descending=True, stable=True)[1][:, :k]


def observe_batch(cfg: Config, states: State):
    """Planar uint8 [N, 3, 64, 64]: the quantized-phase scene render (the
    throughput path), or with `scene_phases=0` the exact-camera render."""
    if cfg.scene_phases > 0:
        return _observe_scene(cfg, states)
    return _observe_exact(cfg, states)


def _observe_exact(cfg: Config, states: State):
    """The exact-camera batched render (`scene_phases=0`): the camera at
    (x, y - 0.5) unsnapped (common_systems.cpp:238-239); the background,
    then the themed walls, the lava and the four crate kinds from one
    packed kind field (crates carry CRATE + 8 * variant); then the two
    stamp groups of `_stamp_slots` by `compositor.composite_stamps`, on
    the card B3 for each (both are on the stamp-kernel path)."""
    R = _observe_assets(str(states.pos.device))
    level = states.level
    i32 = torch.int32
    cam_x = states.pos[:, 0]
    cam_y = states.pos[:, 1] - 0.5
    wx, wy = C.camera_coords(PPU, cam_x, cam_y)
    img = C.draw_background_batch(R["bgs"], level.bg_index, wx, wy)

    sel = C.tile_selectors(wx, wy, WORLD, WORLD)
    packed = torch.where(level.grid == CRATE,
                         (CRATE + level.crate_variant.to(i32) * 8).to(
                             torch.int8), level.grid)
    G = C.kind_field(packed, sel, WALL_MID)  # out of bounds is a wall
    atlas = R["atlas"]
    lut = torch.from_numpy(R["tile_lut"]).to(atlas.device)[
        level.theme.long()]  # [N, kinds]
    for kind in (WALL_TOP, WALL_MID):  # themed: per-env textures
        img = C.kind_layer(img, G == kind, atlas[lut[:, kind]], sel)
    img = C.kind_layer(img, G == LAVA_TOP, atlas[R["idx"]["lava_top"]], sel)
    img = C.kind_layer(img, G == LAVA_MID, atlas[R["idx"]["lava_mid"]], sel)
    for v, sid in enumerate(R["crate_lut"]):
        img = C.kind_layer(img, G == CRATE + v * 8, atlas[int(sid)], sel)

    (var, alive, r0, c0), (avar, _, ar0, ac0) = _stamp_slots(
        states, cam_x, cam_y)
    img = C.composite_stamps(img, R["moving"], var, r0, c0, alives=alive)
    img = C.composite_stamps(img, R["agent"], avar, ar0, ac0)
    return torch.clamp(torch.round(img), 0, 255).to(torch.uint8)


def _stamp_slots(states: State, cam_x, cam_y):
    """The render's two stamp groups under the camera (cam_x, cam_y) [N],
    as (var int32, alive bool, r0, c0 int32), [N, K] each: the moving
    group (K = 17, P = 8) and the agent (K = 1, P = 12, alive None).

    The moving group is the joint saw + mob cull (HAZARD_CULL slots
    nearest the camera) with the coin last: slot order is painter order
    (saws and mobs, then the coin)."""
    level = states.level
    N = states.pos.shape[0]
    dev = states.pos.device
    i32 = torch.int32

    def pix(centers, P):
        py, px = C.stamp_origin(centers, cam_x, cam_y, PPU, P)
        return torch.round(py).to(i32), torch.round(px).to(i32)

    saw_frame = (states.t % 2).to(i32)  # anim rate 1.0
    mob_frame = ((states.t // 5) % 2).to(i32)  # anim rate 0.2
    saw_var_full = saw_frame[:, None].expand(N, MAX_SAWS)
    mob_var_full = (3 + level.mob_variant.to(i32) * 4
                    + mob_frame[:, None] * 2 + (states.mob_vx > 0.0).to(i32))
    all_pos = torch.cat([level.saw_pos, states.mob_pos], dim=1)
    all_alive = torch.cat([level.saw_alive, level.mob_alive], dim=1)
    all_var = torch.cat([saw_var_full, mob_var_full], dim=1)
    ids = _cull(cam_x, all_pos, all_alive, HAZARD_CULL)
    hz_pos = all_pos.gather(1, ids[..., None].expand(N, HAZARD_CULL, 2))
    hz_alive = all_alive.gather(1, ids)
    hz_var = all_var.gather(1, ids)

    centers = torch.cat([hz_pos, level.coin_pos[:, None, :]], dim=1)
    var = torch.cat([hz_var, torch.full((N, 1), 2, dtype=i32, device=dev)],
                    dim=1)
    alive = torch.cat([hz_alive, torch.ones((N, 1), dtype=torch.bool,
                                            device=dev)], dim=1)
    r0, c0 = pix(centers, 8)

    # the agent: 1x2 units, centred at pos - (0, 1)
    avar = (states.level.agent_theme.to(i32) * 8 + _pose(states) * 2
            + (~states.face_forward).to(i32))[:, None]
    acenter = torch.stack([states.pos[:, 0], states.pos[:, 1] - 1.0],
                          dim=-1)[:, None, :]
    ar0, ac0 = pix(acenter, 12)
    return ((var.contiguous(), alive, r0, c0),
            (avar.contiguous(), None, ar0, ac0))


def _scene_inputs(cfg: Config, states: State):
    """The scene kernel's arguments for a batch of states (as a tuple in
    `scene_kernel.scene_raw`'s order)."""
    qp = cfg.scene_phases
    dev = states.pos.device
    ST = _scene_tensors(qp, str(dev))
    level = states.level
    N = states.pos.shape[0]
    W = phases_lib.WIN
    i32 = torch.int32
    f32 = torch.float32

    mx = torch.round(states.pos[:, 0] * qp).to(i32)
    my = torch.round((states.pos[:, 1] - 0.5) * qp).to(i32)
    cam_x = mx.to(f32) / qp
    cam_y = my.to(f32) / qp
    jx = torch.remainder(mx, qp)
    jy = torch.remainder(my, qp)
    _, _, t0_off = phases_lib.phase_tables(PPU, 64, qp)
    tx0 = torch.floor(cam_x + t0_off).to(i32)
    ty0 = torch.floor(cam_y + t0_off).to(i32)

    # padded packed kind grid: crates carry CRATE + 8*variant; the pad is
    # wall, OOB is wall (tilemap.h:82-87)
    packed = torch.where(level.grid == CRATE,
                         (CRATE + level.crate_variant.to(i32) * 8).to(torch.int8),
                         level.grid)
    gridp = torch.nn.functional.pad(packed, (W, W, W, W), value=WALL_MID)

    (var, alive, r0, c0), (avar, _, ar0, ac0) = _stamp_slots(
        states, cam_x, cam_y)
    groups = [
        (ST["moving"], var, alive.to(f32), r0, c0),
        (ST["agent"], avar, torch.ones((N, 1), dtype=f32, device=dev), ar0,
         ac0),
    ]
    return (gridp, ty0, tx0, jy, jx, level.bg_index.to(i32),
            level.theme.to(i32), ST["bg_bank"], ST["tr_tab"],
            ST["tile_bank"], ST["kinds"], ST["themes"], groups, C.OBS, qp, W)


def _observe_scene(cfg: Config, states: State):
    """Quantized-camera scene path: the render camera snaps to 1/QP world
    units (render only; physics is untouched), which collapses tile and
    background sampling into QP^2 shared phases; tiles, background and
    stamps are then one scene kernel pass."""
    img = scene_kernel.scene_raw(*_scene_inputs(cfg, states))
    return torch.clamp(torch.round(img), 0, 255).to(torch.uint8)
