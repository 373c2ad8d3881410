"""Bossfight in PyTorch (procgen2_tpu/games/bossfight.py), batched.

The same game as the JAX package, which cites the reference engine
(Procgen2's `games/bossfight/`) line by line: a fixed 4x4-unit arena;
an agent ship with a player-bullet ring; a boss that alternates shielded
and unshielded phases over three rounds, fires four bullet-hell patterns
while shielded and a drizzle while not, and shows explosions as it loses
hit points; 1-4 meteor barriers; -10 for the agent's death and +10 for
the boss's, either of which ends the episode (bossfight.cpp:309-324).
Four physics sub-steps per env step, each committed only while the
episode runs; an agent hit by a boss bullet dies one sub-step late, as
in the reference (common_systems.cpp:322-329 vs bossfight.cpp:311-320).

Every function works on a batch: `generate` on a batch of keys [L, 2]
(one level each), `reset`/`step`/`observe_batch`/`observe` on a batch of
envs. The random draws are the JAX package's, key for key (`..random`),
and the arithmetic rounds where XLA CPU rounds: a multiply feeding an
add whose product is inexact is one fused multiply-add there
(`random._fma32`), and a division by a constant is a multiply by its f32
reciprocal. The bullet volley's cos/sin are XLA CPU's (glibc's
cosf/sinf, `..trig`), not correctly rounded but the same bits on the CPU
and the card.

The render is one launch of the stamp-over-frame kernel per
`observe_batch`: four stamp groups (barriers + boss bullets, the boss
with its pre-composed shield, damage explosions, player bullets + ship)
blended in painter order over the background.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from .. import random as prng
from ..core import spaces
from ..physics import bossfight_step
from ..physics.aabb import check_collision
from ..render import atlas as atlas_lib
from ..render import compositor as C
from ..render import stamp_kernel
from ..trig import sincos32
from ..utils import trace
from ..utils.consts import const
from ..utils.tree import key_field

NAME = "bossfight"
NUM_ACTIONS = 15
SUB_STEPS = 4  # bossfight.cpp:44
DT = 1.0 / SUB_STEPS
ZOOM = 1.0  # bossfight.cpp:32
PPU = 16.0 * ZOOM
HALF = 2.0  # screen rect (-2,-2,4,4): 64 obs px / 16 ppu / 2

# Agent (common_systems.cpp:495-501)
MOVE_MIX = 0.5
MOVE_SPEED = 0.1
A_BULLET_TIME = 5.0
A_BULLET_SPEED = 0.1
BOUNCE_SPEED = 0.05
BOUNCE_TIME = 10.0
EXPLOSION_RATE = 0.3

# Boss (common_systems.cpp:202-209)
UNSHIELDED_TIME = 300.0
NUM_WEAPONS = 4
MOVE_TIME = 70.0
BOSS_HP = 3
DAMAGE_TIME = 80.0

NUM_A_BULLETS = 32
NUM_B_BULLETS = 64
# Render-only slot compaction (_cull_alive), the JAX package's sizes:
# live boss bullets past 36 and player bullets past 12 are not drawn
# (physics keeps them all).
BB_CULL = 36
AB_CULL = 12
NUM_EXPLOSIONS = 8
MAX_BARRIERS = 4

NUM_BGS = 13  # bossfight.cpp:54-67
ROT_BINS = 16  # boss-bullet rotation variants in the stamp bank

_PI = float(np.float32(math.pi))
_HALF_PI = float(np.float32(math.pi * 0.5))  # the bullets draw rotated by +90 deg
_F32 = torch.float32
_I32 = torch.int32


def _f32(x: float) -> float:
    """A number rounded to f32, as XLA rounds a weak-typed constant."""
    return float(np.float32(x))


# XLA rewrites x / c as x * (1 / c) with the reciprocal rounded to f32
_INV_MOVE_TIME = _f32(np.float32(1.0) / np.float32(MOVE_TIME))
_INV_ROT_BIN = _f32(np.float32(1.0) / np.float32(2 * math.pi / ROT_BINS))


@dataclasses.dataclass(frozen=True)
class Config:
    mode: str = "hard"  # common_systems.h:64

    @property
    def bullet_speed(self):
        return 0.1 if self.mode == "hard" else 0.05  # common_systems.cpp:104

    @property
    def shield_jitter(self):
        return 80.0 if self.mode == "hard" else 30.0  # common_systems.cpp:202


@dataclasses.dataclass
class Level:
    """One level per row of the leading dimension."""
    agent_pos0: torch.Tensor  # f32 [L, 2]
    barrier_pos: torch.Tensor  # f32 [L, 4, 2]
    barrier_exists: torch.Tensor  # bool [L, 4]
    barrier_tex: torch.Tensor  # i32 [L, 4]
    boss_tex: torch.Tensor  # i32 [L]
    ship_tex: torch.Tensor  # i32 [L]
    bullet_tex: torch.Tensor  # i32 [L]
    bg_index: torch.Tensor  # i32 [L]


@dataclasses.dataclass
class State:
    """One env per row of the leading dimension."""
    level: Level
    pos: torch.Tensor  # f32 [N, 2] agent
    vel: torch.Tensor  # f32 [N, 2]
    alive: torch.Tensor  # bool [N]; a boss-bullet hit registers next sub-step
    a_bullet_timer: torch.Tensor  # f32 [N]
    ab_pos: torch.Tensor  # f32 [N, 32, 2]
    ab_vel: torch.Tensor  # f32 [N, 32, 2]
    ab_frame: torch.Tensor  # f32 [N, 32]
    ab_bouncing: torch.Tensor  # bool [N, 32]
    ab_bounce_timer: torch.Tensor  # f32 [N, 32]
    ab_num: torch.Tensor  # i32 [N]
    ab_next: torch.Tensor  # i32 [N]
    boss_pos: torch.Tensor  # f32 [N, 2]
    boss_vel: torch.Tensor  # f32 [N, 2]
    phase_timer: torch.Tensor  # f32 [N]
    phase_index: torch.Tensor  # i32 [N]
    weapon_index: torch.Tensor  # i32 [N]
    attack_timer: torch.Tensor  # f32 [N]
    hp: torch.Tensor  # i32 [N]
    move_timer: torch.Tensor  # f32 [N]
    explosion_timer: torch.Tensor  # f32 [N]
    damage_timer: torch.Tensor  # f32 [N]
    bb_pos: torch.Tensor  # f32 [N, 64, 2]
    bb_vel: torch.Tensor  # f32 [N, 64, 2]
    bb_rot: torch.Tensor  # f32 [N, 64]
    bb_frame: torch.Tensor  # f32 [N, 64]
    bb_num: torch.Tensor  # i32 [N]
    bb_next: torch.Tensor  # i32 [N]
    ex_pos: torch.Tensor  # f32 [N, 8, 2]
    ex_frame: torch.Tensor  # f32 [N, 8]
    ex_num: torch.Tensor  # i32 [N]
    ex_next: torch.Tensor  # i32 [N]
    t: torch.Tensor  # i32 [N]
    rng: torch.Tensor = key_field()  # int64 [N, 2] key words


# ---------------------------------------------------------------------------
# Assets (numpy)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _assets():
    """The sprite atlas (planar u8 [4, A, S, S], with its index) and the
    13 space backgrounds (planar u8 [3, NUM_BGS, 64, 64]). The batched
    render reaches the sprites through `_stamp_banks`; the exact render
    samples the atlas."""
    names = [f"boss_ship_{k}" for k in atlas_lib.BOSS_SHIP_COLORS]
    names += [f"pship_{k}" for k in atlas_lib.PLAYER_SHIP_COLORS]
    names += [f"bolt_{k}" for k in atlas_lib.LASER_COLORS]
    names += ["shield", "barrier0", "barrier1", "barrier2"]
    names += [f"explosion{i}" for i in range(5)]
    atlas, idx = atlas_lib.build_atlas(tuple(names))
    bgs = atlas_lib.build_backgrounds("space", NUM_BGS)
    return dict(atlas_p=atlas.transpose(3, 0, 1, 2), idx=idx,
                bgs_p=bgs.transpose(3, 0, 1, 2))


@functools.lru_cache(maxsize=None)
def _stamp_banks():
    """Pre-rasterized stamp banks u8 [V, 4, P, P] (atlas.build_pixel_bank):
    boss bullets in 16 rotation variants per bolt colour plus their
    explosions, player bullets, barriers, the boss with and without its
    shield, damage explosions and the player ship."""
    A = atlas_lib
    specs = []
    for k in A.LASER_COLORS:
        for t in range(ROT_BINS):
            specs.append(
                ("bolt_" + k, 0.3 * PPU, 0.3 * PPU, t * 2 * math.pi / ROT_BINS))
    for i in range(5):
        specs.append((f"explosion{i}", 0.38 * PPU, 0.38 * PPU))
    bb_bank = A.build_pixel_bank(tuple(specs), patch=8)

    ab_specs = tuple(
        [("bolt_" + k, 0.15 * PPU, 0.15 * PPU) for k in A.LASER_COLORS]
        + [(f"explosion{i}", 0.19 * PPU, 0.19 * PPU) for i in range(5)])
    ab_bank = A.build_pixel_bank(ab_specs, patch=8)

    bar_bank = A.build_pixel_bank(
        tuple((f"barrier{i}", 0.3 * PPU, 0.3 * PPU) for i in range(3)), patch=8)
    shield_bank = A.build_pixel_bank(
        (("shield", 2.234 * PPU, 1.86 * PPU),), patch=40)
    # Shield over boss, pre-composed: the shield is always drawn centred on
    # the boss at alpha 0.7 right after the ship, so the two collapse to one
    # P=40 variant per ship colour (alpha compositing is associative; exact
    # up to the bank's u8 rounding). 4 plain + 4 shielded variants.
    boss40 = A.build_pixel_bank(
        tuple((f"boss_ship_{k}", 1.66 * PPU, 1.25 * PPU)
              for k in A.BOSS_SHIP_COLORS),
        patch=40).astype(np.float32)
    sh = shield_bank[0].astype(np.float32)  # [4, 40, 40]
    a_s = sh[3:4] / 255.0 * 0.7
    a_b = boss40[:, 3:4] / 255.0
    out_a = a_s + a_b * (1.0 - a_s)
    out_rgb = np.where(
        out_a > 0,
        (sh[None, :3] * a_s + boss40[:, :3] * a_b * (1.0 - a_s))
        / np.maximum(out_a, 1e-6),
        0.0)
    shielded40 = np.concatenate([out_rgb, out_a * 255.0], axis=1)
    bosshield_bank = np.clip(
        np.round(np.concatenate([boss40, shielded40], axis=0)), 0, 255
    ).astype(np.uint8)
    dmg_bank = A.build_pixel_bank(
        tuple((f"explosion{i}", 1.125 * PPU, 1.125 * PPU) for i in range(5)),
        patch=20)
    ship_bank = A.build_pixel_bank(
        tuple((f"pship_{k}", 0.31 * PPU, 0.234 * PPU)
              for k in A.PLAYER_SHIP_COLORS),
        patch=8)
    # barriers + boss bullets are one z-adjacent P=8 group; player bullets
    # + ship likewise (the reference draws bullets, then the ship,
    # common_systems.cpp:695-720)
    return dict(bar=bar_bank, ab=ab_bank,
                barbb=np.concatenate([bar_bank, bb_bank], axis=0),
                bosshield=bosshield_bank, dmg=dmg_bank,
                abship=np.concatenate([ab_bank, ship_bank], axis=0))


@functools.lru_cache(maxsize=None)
def _bg_bank():
    """Backgrounds pre-sampled at obs resolution (the camera is fixed):
    u8 [NUM_BGS, 3, OBS, OBS]."""
    bgs_p = np.asarray(_assets()["bgs_p"])  # [3, B, H, W]
    _, B, H, W = bgs_p.shape
    c = np.arange(C.OBS) + 0.5 - C.OBS / 2
    w = c / PPU  # world coords of pixel centers
    u = (w + HALF) / (2 * HALF)
    ui = np.clip((u * W).astype(np.int32), 0, W - 1)
    vi = np.clip((u * H).astype(np.int32), 0, H - 1)
    return bgs_p[:, :, vi[:, None], ui[None, :]].transpose(1, 0, 2, 3).copy()


@functools.lru_cache(maxsize=None)
def _render_tensors(device):
    """The render's constant tensors on `device` (built once per device):
    bf16 backgrounds and premultiplied bf16 stamp banks."""
    dev = torch.device(device)
    banks = _stamp_banks()
    out = {name: C._premultiply_bank(banks[name]).to(dev)
           for name in ("barbb", "bosshield", "dmg", "abship")}
    out["bg"] = torch.from_numpy(_bg_bank()).to(torch.bfloat16).to(dev)
    return out


# ---------------------------------------------------------------------------
# Generation (bossfight.cpp:426-497 reset()), batched over levels
# ---------------------------------------------------------------------------

def generate(cfg: Config, keys: torch.Tensor) -> Level:
    """One level per key: keys int64 [L, 2] -> Level with leading dim L."""
    ks = prng.split(keys, 8)
    (k_agent, k_nbar, k_bars, k_btex, k_boss, k_ship, k_bullet,
     k_bg) = ks.unbind(-2)
    agent_x = (prng.uniform(k_agent) * 2.0 - 1.0) * HALF
    agent_pos0 = torch.stack([agent_x, torch.full_like(agent_x, HALF)], -1)

    num_barriers = prng.randint(k_nbar, (), 1, MAX_BARRIERS + 1)
    bkeys = prng.split(k_bars, MAX_BARRIERS)
    tkeys = prng.split(k_btex, MAX_BARRIERS)
    pos, exists, tex = [], [], []
    for i in range(MAX_BARRIERS):
        kx, ky = prng.split(bkeys[:, i]).unbind(-2)
        px = (prng.uniform(kx) * 2.0 - 1.0) * HALF * 0.9
        py = HALF - prng.uniform(ky, minval=0.7, maxval=1.2)
        # a candidate overlapping an existing barrier is skipped, not
        # re-drawn (bossfight.cpp:462-474); barriers are 0.2x0.2 centred
        clash = torch.zeros_like(num_barriers, dtype=torch.bool)
        for j in range(i):
            clash = clash | (exists[j] & check_collision(
                px - 0.1, py - 0.1, 0.2, 0.2,
                pos[j][:, 0] - 0.1, pos[j][:, 1] - 0.1, 0.2, 0.2))
        pos.append(torch.stack([px, py], -1))
        exists.append((i < num_barriers) & ~clash)
        tex.append(prng.randint(tkeys[:, i], (), 0, 3))

    return Level(
        agent_pos0=agent_pos0,
        barrier_pos=torch.stack(pos, 1),
        barrier_exists=torch.stack(exists, 1),
        barrier_tex=torch.stack(tex, 1),
        boss_tex=prng.randint(k_boss, (), 0, 4),
        ship_tex=prng.randint(k_ship, (), 0, 4),
        bullet_tex=prng.randint(k_bullet, (), 0, 3),
        bg_index=prng.randint(k_bg, (), 0, NUM_BGS),
    )


def reset(cfg: Config, level: Level, keys: torch.Tensor) -> State:
    """Fresh episodes on `level` (leading dim N) with keys [N, 2]."""
    N = keys.shape[0]
    dev = keys.device

    def zeros(*shape, dtype=_F32):
        return torch.zeros((N,) + shape, dtype=dtype, device=dev)

    def full(value, *shape, dtype=_F32):
        return torch.full((N,) + shape, value, dtype=dtype, device=dev)

    return State(
        level=level,
        pos=level.agent_pos0,
        vel=zeros(2),
        alive=full(True, dtype=torch.bool),
        a_bullet_timer=zeros(),
        ab_pos=zeros(NUM_A_BULLETS, 2),
        ab_vel=zeros(NUM_A_BULLETS, 2),
        ab_frame=full(-1.0, NUM_A_BULLETS),
        ab_bouncing=zeros(NUM_A_BULLETS, dtype=torch.bool),
        ab_bounce_timer=zeros(NUM_A_BULLETS),
        ab_num=zeros(dtype=_I32),
        ab_next=zeros(dtype=_I32),
        boss_pos=zeros(2),
        boss_vel=zeros(2),
        phase_timer=zeros(),
        phase_index=zeros(dtype=_I32),
        weapon_index=zeros(dtype=_I32),
        attack_timer=zeros(),
        hp=full(BOSS_HP, dtype=_I32),
        move_timer=zeros(),
        explosion_timer=zeros(),
        damage_timer=zeros(),
        bb_pos=zeros(NUM_B_BULLETS, 2),
        bb_vel=zeros(NUM_B_BULLETS, 2),
        bb_rot=zeros(NUM_B_BULLETS),
        bb_frame=full(-1.0, NUM_B_BULLETS),
        bb_num=zeros(dtype=_I32),
        bb_next=zeros(dtype=_I32),
        ex_pos=zeros(NUM_EXPLOSIONS, 2),
        ex_frame=full(-1.0, NUM_EXPLOSIONS),
        ex_num=zeros(dtype=_I32),
        ex_next=zeros(dtype=_I32),
        t=zeros(dtype=_I32),
        rng=keys,
    )


# ---------------------------------------------------------------------------
# Step (bossfight.cpp:308-325)
# ---------------------------------------------------------------------------

def _window(next_i, num, size):
    """Live slots of a ring [N, size]: the `num` slots before `next_i`
    (floor modulo, as jnp.mod)."""
    j = torch.arange(size, device=next_i.device)
    return torch.remainder(next_i[:, None] - 1 - j, size) < num[:, None]


def _count(mask):
    """Per-env number of set slots, as an int32 [N]."""
    return mask.sum(1, dtype=_I32)


def _ring_push(pos, vel, rot, frame, num, nxt, new_pos, new_vel, new_rot,
               cond, size):
    """fire() (common_systems.cpp:75-87): append where cond & num < size.
    The slot write is a one-hot mask (a batched where), not a scatter."""
    can = cond & (num < size)
    upd = can[:, None] & (torch.arange(size, device=num.device) == nxt[:, None])
    pos = torch.where(upd[..., None], new_pos[:, None, :], pos)
    vel = torch.where(upd[..., None], new_vel[:, None, :], vel)
    rot = torch.where(upd, new_rot[:, None], rot)
    frame = torch.where(upd, 0.0, frame)
    nxt = torch.where(can, torch.remainder(nxt + 1, size), nxt)
    num = num + can.to(_I32)
    return pos, vel, rot, frame, num, nxt


@functools.lru_cache(maxsize=None)
def _volley_arrays():
    """Constant rotations of patterns 0 and 1 (padded to 8 slots), and the
    radial offsets of pattern 2, numpy f32 [8] each, rounded op by op in
    f32 as XLA folds them."""
    f = np.float32
    pi = f(math.pi)
    fan = f(math.pi * 1.5) + (np.arange(5) - 2).astype(f) * pi * f(0.125)
    cross = f(math.pi * (1.25 + 8 * 0.0625)) + np.arange(4).astype(f) * pi * f(0.5)
    radial = f(math.pi * 0.25) * np.arange(8).astype(f)
    return tuple(np.pad(a, (0, 8 - len(a))) for a in (fan, cross, radial))


@functools.lru_cache(maxsize=None)
def _volley_tables(device):
    """`_volley_arrays` as f32 tensors on `device`."""
    return tuple(torch.from_numpy(a).to(device) for a in _volley_arrays())


def _fire_pattern(ring, boss_pos, pattern, attack_timer, key, bullet_speed):
    """fire_pattern (common_systems.cpp:103-185): at most one volley per
    sub-step; returns the updated boss-bullet ring and attack timer.
    Bullet velocity is (cos r, -sin r) * speed (angles are y-up,
    common_systems.cpp:80). Pattern 1's cross is fixed at 1.75pi + i*pi/2
    (its k is always 8, common_systems.cpp:137-139)."""
    bb_pos, bb_vel, bb_rot, bb_frame, bb_num, bb_next = ring
    k1, k2 = prng.split(key).unbind(-2)
    u1 = prng.uniform(k1)
    u2 = prng.uniform(k2)
    fan, cross, radial = _volley_tables(str(pattern.device))

    # passive (-1): p = 0.1*dt single aimed-down-random bullet
    passive_fire = (pattern == -1) & (u1 < 0.1 * DT)
    aimed_rot = _PI * (1.0 + u2)  # also the passive shot's rotation

    timer_done = torch.where(
        pattern == 0, attack_timer >= 8.0,
        torch.where(pattern == 1, attack_timer >= 5.0,
                    torch.where(pattern == 2, attack_timer >= 10.0,
                                attack_timer >= 4.0))) & (pattern >= 0)

    radial_rots = radial[None, :] + ((u2 * 2) * _PI)[:, None]
    n_per = torch.where(pattern == 0, 5,
                        torch.where(pattern == 1, 4,
                                    torch.where(pattern == 2, 8, 1)))
    idx = torch.arange(8, device=pattern.device)
    p = pattern[:, None]
    rots = torch.where(
        p == 0, fan, torch.where(p == 1, cross,
                                 torch.where(p == 2, radial_rots,
                                             aimed_rot[:, None])))
    fires = (idx < n_per[:, None]) & timer_done[:, None]
    fires = torch.where(p == -1, idx == 0, fires) & (
        ((pattern >= 0) & timer_done) | passive_fire)[:, None]
    rots = torch.where(p == -1, aimed_rot[:, None], rots)

    # XLA CPU's f32 cos/sin (glibc's), the same on the CPU and the card.
    # Where the radial volley's angle feeds cos/sin, XLA CPU fuses
    # pi/4 * i + (u * 2) * pi into one multiply-add (the stored rotation
    # is rounded twice)
    radial_fused = prng._fma32((u2 * 2)[:, None], _PI, radial[None, :])
    cos, sin = sincos32(torch.where(p == 2, radial_fused, rots))
    vels = torch.stack([cos, -sin], -1) * bullet_speed  # [N, 8, 2]
    for i in range(8):
        bb_pos, bb_vel, bb_rot, bb_frame, bb_num, bb_next = _ring_push(
            bb_pos, bb_vel, bb_rot, bb_frame, bb_num, bb_next,
            boss_pos, vels[:, i], rots[:, i], fires[:, i], NUM_B_BULLETS)

    attack_timer = torch.where(
        pattern >= 0, torch.where(timer_done, 0.0, attack_timer + DT),
        attack_timer)
    return (bb_pos, bb_vel, bb_rot, bb_frame, bb_num, bb_next), attack_timer


def _hits_barriers(level, x, y):
    """[N, M] bullets (0.02 wide, centred at x, y) against each env's
    barriers: bool [N, M]."""
    bx = (level.barrier_pos[..., 0] - 0.1)[:, None, :]
    by = (level.barrier_pos[..., 1] - 0.1)[:, None, :]
    return (level.barrier_exists[:, None, :] & check_collision(
        (x - 0.01)[..., None], (y - 0.01)[..., None], 0.02, 0.02,
        bx, by, 0.2, 0.2)).any(-1)


def step(cfg: Config, state: State, action):
    """One env step for every env: (State, reward f32 [N], done bool [N],
    info {}). On a CUDA device the whole step is one kernel launch
    (`physics/bossfight_step.py`); elsewhere `step_reference`, the plain
    torch step, which the kernel equals bit for bit."""
    if state.pos.device.type == "cuda":
        return _step_kernel(cfg, state, action)
    return step_reference(cfg, state, action)


@functools.lru_cache(maxsize=None)
def _step_consts(cfg: Config):
    """The kernel's constants: each the Python float that `step_reference`
    hands to torch (the mode's bullet speed and shield jitter among them),
    and the volley tables."""
    fan, cross, radial = _volley_arrays()
    return bossfight_step.Consts(
        dt=DT, move_mix=MOVE_MIX, move_speed=MOVE_SPEED,
        lo_x=-HALF + 0.15, hi_x=HALF - 0.15, lo_y=-HALF + 0.1,
        hi_y=HALF - 0.1, a_bullet_time=A_BULLET_TIME,
        a_bullet_vy=-A_BULLET_SPEED, bounce_speed=BOUNCE_SPEED,
        bounce_time=BOUNCE_TIME, explosion_dt=EXPLOSION_RATE * DT,
        agent_dx=0.15, agent_dy=0.1, agent_w=0.3, agent_h=0.2, boss_dx=0.6,
        boss_dy=0.4, boss_w=1.2, boss_h=0.8, bullet_half=0.01,
        bullet_size=0.02, barrier_half=0.1, barrier_size=0.2, half=HALF,
        unshielded_time=UNSHIELDED_TIME, damage_time=DAMAGE_TIME,
        move_time=MOVE_TIME, inv_move_time=_INV_MOVE_TIME,
        target_x_scale=0.7, target_y_shift=0.3, pi=_PI, passive_p=0.1 * DT,
        bullet_speed=cfg.bullet_speed, shield_jitter=cfg.shield_jitter,
        fan=tuple(fan.tolist()), cross=tuple(cross.tolist()),
        radial=tuple(radial.tolist()), boss_hp=BOSS_HP,
        num_weapons=NUM_WEAPONS)


_STEP_FIELDS = tuple(name for name, _, _ in bossfight_step.FIELDS)


def _step_kernel(cfg: Config, state: State, action):
    """`step` as one launch of the bossfight step kernel."""
    level = state.level
    fields, reward, done = bossfight_step.step(
        [getattr(state, name) for name in _STEP_FIELDS], level.barrier_pos,
        level.barrier_exists, action.to(_I32), consts=_step_consts(cfg),
        sub_steps=SUB_STEPS)
    return (State(level=level, **dict(zip(_STEP_FIELDS, fields))), reward,
            done, {})


def step_reference(cfg: Config, state: State, action):
    """The plain torch step (`step`'s result on any device)."""
    level = state.level
    a = action.to(_I32)
    N = a.shape[0]
    dev = a.device
    lo_x, hi_x = _f32(-HALF + 0.15), _f32(HALF - 0.15)
    lo_y, hi_y = _f32(-HALF + 0.1), _f32(HALF - 0.1)
    slots_a = torch.arange(NUM_A_BULLETS, device=dev)
    slots_e = torch.arange(NUM_EXPLOSIONS, device=dev)

    movement_x = (((a == 6) | (a == 7) | (a == 8)).to(_F32)
                  - ((a == 0) | (a == 1) | (a == 2)).to(_F32))
    movement_y = (((a == 2) | (a == 5) | (a == 8)).to(_F32)
                  - ((a == 0) | (a == 3) | (a == 6)).to(_F32))
    fire = a == 9

    s = state
    done = torch.zeros(N, dtype=torch.bool, device=dev)
    reward = torch.zeros(N, dtype=_F32, device=dev)
    rng = s.rng
    alive = s.alive
    pos, vel, a_btimer = s.pos, s.vel, s.a_bullet_timer
    ab_pos, ab_vel, ab_frame = s.ab_pos, s.ab_vel, s.ab_frame
    ab_bounc, ab_btime = s.ab_bouncing, s.ab_bounce_timer
    ab_num, ab_next = s.ab_num, s.ab_next
    boss_pos, boss_vel = s.boss_pos, s.boss_vel
    phase_timer, phase_index = s.phase_timer, s.phase_index
    weapon_index, attack_timer, hp = s.weapon_index, s.attack_timer, s.hp
    move_timer, explosion_timer = s.move_timer, s.explosion_timer
    damage_timer = s.damage_timer
    bb = (s.bb_pos, s.bb_vel, s.bb_rot, s.bb_frame, s.bb_num, s.bb_next)
    ex_pos, ex_frame, ex_num, ex_next = s.ex_pos, s.ex_frame, s.ex_num, s.ex_next

    for _ in range(SUB_STEPS):
        active = ~done
        sp = prng.split(rng, 7)
        rng = sp[:, 0]
        k_shield, k_weapon, k_pattern, k_move, k_damage, k_bounce = (
            sp[:, 1:].unbind(-2))

        # ================= System_Agent (common_systems.cpp:494-683) ====
        n_vel = torch.stack([
            vel[:, 0] + MOVE_MIX * (movement_x * MOVE_SPEED - vel[:, 0]) * DT,
            vel[:, 1] + MOVE_MIX * (-movement_y * MOVE_SPEED - vel[:, 1]) * DT,
        ], -1)
        n_pos = pos + n_vel * DT
        # screen-edge clamp, agent rect (-0.15,-0.1,0.3,0.2)
        clamped_x = torch.clamp(n_pos[:, 0], lo_x, hi_x)
        clamped_y = torch.clamp(n_pos[:, 1], lo_y, hi_y)
        n_vel = torch.stack([
            torch.where(clamped_x != n_pos[:, 0], 0.0, n_vel[:, 0]),
            torch.where(clamped_y != n_pos[:, 1], 0.0, n_vel[:, 1]),
        ], -1)
        n_pos = torch.stack([clamped_x, clamped_y], -1)
        px, py = n_pos[:, 0], n_pos[:, 1]

        # fire a player bullet (one-hot slot write, not a scatter)
        can_spawn = fire & (a_btimer == 0.0) & (ab_num < NUM_A_BULLETS)
        upd_ab = can_spawn[:, None] & (slots_a == ab_next[:, None])
        ab_vel_n = torch.where(
            upd_ab[..., None],
            const((0.0, -A_BULLET_SPEED), dev, _F32),
            ab_vel)
        ab_pos_n = torch.where(upd_ab[..., None], n_pos[:, None, :], ab_pos)
        ab_frame_n = torch.where(upd_ab, 0.0, ab_frame)
        ab_bounc_n = ab_bounc & ~upd_ab
        ab_btime_n = torch.where(upd_ab, 0.0, ab_btime)
        n_ab_next = torch.where(
            can_spawn, torch.remainder(ab_next + 1, NUM_A_BULLETS), ab_next)
        n_ab_num = ab_num + can_spawn.to(_I32)
        n_abtimer = torch.where(
            can_spawn, A_BULLET_TIME,
            torch.where(fire, torch.clamp(a_btimer - DT, min=0.0), a_btimer))

        # agent vs hazards: boss + barriers
        contact = check_collision(
            px - 0.15, py - 0.1, 0.3, 0.2,
            boss_pos[:, 0] - 0.6, boss_pos[:, 1] - 0.4, 1.2, 0.8,
        ) | (level.barrier_exists & check_collision(
            (px - 0.15)[:, None], (py - 0.1)[:, None], 0.3, 0.2,
            level.barrier_pos[..., 0] - 0.1, level.barrier_pos[..., 1] - 0.1,
            0.2, 0.2)).any(1)
        n_alive = alive & ~contact
        agent_alive_now = n_alive  # what this sub-step's reward sees

        # player bullets
        window = _window(n_ab_next, n_ab_num, NUM_A_BULLETS)
        live = window & (ab_frame_n == 0.0)
        bx, by = ab_pos_n[..., 0], ab_pos_n[..., 1]
        offscreen = live & ~check_collision(
            bx - 0.01, by - 0.01, 0.02, 0.02, -HALF, -HALF, 2 * HALF, 2 * HALF)
        shielded = torch.remainder(phase_index, 2) == 0
        boss_hit = live & ~offscreen & check_collision(
            bx - 0.01, by - 0.01, 0.02, 0.02,
            (boss_pos[:, 0] - 0.6)[:, None], (boss_pos[:, 1] - 0.4)[:, None],
            1.2, 0.8)
        bounce = boss_hit & shielded[:, None]
        damage = boss_hit & ~shielded[:, None]
        barrier_hit = live & ~offscreen & ~boss_hit & _hits_barriers(
            level, bx, by)

        bkeys = prng.uniform(k_bounce, (NUM_A_BULLETS,), minval=-1.0,
                             maxval=1.0)
        ab_vel_n = torch.where(
            bounce[..., None],
            torch.stack([bkeys * BOUNCE_SPEED,
                         torch.full_like(bkeys, BOUNCE_SPEED)], -1),
            ab_vel_n)
        ab_btime_n = torch.where(bounce, BOUNCE_TIME, ab_btime_n)
        ab_bounc_n = ab_bounc_n | bounce
        explode_now = damage | barrier_hit
        ab_vel_n = torch.where(explode_now[..., None], 0.0, ab_vel_n)
        ab_frame_n = torch.where(explode_now, 1.0, ab_frame_n)
        ab_frame_n = torch.where(offscreen, 5.0, ab_frame_n)
        ab_vel_n = torch.where(offscreen[..., None], 0.0, ab_vel_n)
        n_hp = torch.clamp(hp - _count(damage), min=0)

        ab_pos_n = torch.where(window[..., None], ab_pos_n + ab_vel_n * DT,
                               ab_pos_n)
        expired = window & (ab_frame_n >= 5.0)
        exploding = window & (ab_frame_n >= 1.0) & (ab_frame_n < 5.0)
        ab_frame_n = torch.where(exploding, ab_frame_n + EXPLOSION_RATE * DT,
                                 ab_frame_n)
        # a bounce timeout destroys the bullet (common_systems.cpp:666-676)
        ticking = window & ab_bounc_n & (ab_btime_n > 0.0)
        ab_btime_n = torch.where(ticking, torch.clamp(ab_btime_n - DT, min=0.0),
                                 ab_btime_n)
        bounce_out = window & ab_bounc_n & (ab_btime_n == 0.0) & ~ticking
        expired = expired | bounce_out
        ab_frame_n = torch.where(expired, -1.0, ab_frame_n)
        n_ab_num = n_ab_num - _count(expired)

        # ================= System_Mob_AI (boss) =========================
        shielded_phase_time = prng._fma32(prng.uniform(k_shield),
                                          cfg.shield_jitter, 180.0)
        # a phase start re-rolls the weapon and HP (common_systems.cpp:237-243)
        at_start = phase_timer == 0.0
        n_weapon = torch.where(
            at_start, prng.randint(k_weapon, (), 0, NUM_WEAPONS), weapon_index)
        n_attack = torch.where(at_start, 0.0, attack_timer)
        n_hp = torch.where(at_start, BOSS_HP, n_hp)

        adv = ((shielded & (phase_timer >= shielded_phase_time))
               | (~shielded & (phase_timer >= UNSHIELDED_TIME)))
        n_phase_timer = torch.where(adv, 0.0, phase_timer + DT)
        n_phase_index = phase_index + adv.to(_I32)

        pattern = torch.where(shielded, n_weapon, -1)
        bb, n_attack = _fire_pattern(bb, boss_pos, pattern, n_attack,
                                     k_pattern, cfg.bullet_speed)

        # HP depleted -> damage show + extra phase advance
        # (common_systems.cpp:271-282; phase_timer is NOT reset)
        depleted = ~shielded & (n_hp == 0)
        kx, ky = prng.split(k_damage).unbind(-2)
        show = depleted & (explosion_timer >= 8.0)
        n_expl_timer = torch.where(
            depleted, torch.where(show, 0.0, explosion_timer + DT),
            explosion_timer)
        epos = boss_pos + torch.stack([
            prng.uniform(kx, minval=-0.5, maxval=0.5),
            prng.uniform(ky, minval=-0.5, maxval=0.5)], -1)
        can_ex = show & (ex_num < NUM_EXPLOSIONS)
        upd_ex = can_ex[:, None] & (slots_e == ex_next[:, None])
        ex_pos_n = torch.where(upd_ex[..., None], epos[:, None, :], ex_pos)
        ex_frame_n = torch.where(upd_ex, 0.0, ex_frame)
        n_ex_next = torch.where(
            can_ex, torch.remainder(ex_next + 1, NUM_EXPLOSIONS), ex_next)
        n_ex_num = ex_num + can_ex.to(_I32)

        dmg_done = depleted & (damage_timer >= DAMAGE_TIME)
        n_damage_timer = torch.where(
            depleted, torch.where(dmg_done, 0.0, damage_timer + DT),
            damage_timer)
        n_phase_index = n_phase_index + dmg_done.to(_I32)
        n_hp = torch.where(dmg_done, BOSS_HP, n_hp)

        # boss movement (common_systems.cpp:286-298)
        kmx, kmy = prng.split(k_move).unbind(-2)
        retarget = move_timer >= MOVE_TIME
        n_move_timer = torch.where(retarget, 0.0, move_timer + DT)
        target = torch.stack([
            (prng.uniform(kmx) * 2.0 - 1.0) * 0.5 * (2 * HALF) * 0.7,
            ((prng.uniform(kmy) * 2.0 - 1.0) * 0.5 - 0.3) * (2 * HALF) * 0.5,
        ], -1)
        n_boss_vel = torch.where(retarget[:, None],
                                 (target - boss_pos) * _INV_MOVE_TIME, boss_vel)
        n_boss_pos = boss_pos + n_boss_vel * DT

        # boss bullets (common_systems.cpp:303-365); like the JAX package,
        # the ring runs on after the episode's end
        bb_pos, bb_vel, bb_rot, bb_frame, bb_num, bb_next = bb
        bwindow = _window(bb_next, bb_num, NUM_B_BULLETS)
        blive = bwindow & (bb_frame == 0.0)
        bbx, bby = bb_pos[..., 0], bb_pos[..., 1]
        boffscreen = blive & ~check_collision(
            bbx - 0.01, bby - 0.01, 0.02, 0.02, -HALF, -HALF, 2 * HALF, 2 * HALF)
        hit_agent = blive & ~boffscreen & check_collision(
            bbx - 0.01, bby - 0.01, 0.02, 0.02,
            (px - 0.15)[:, None], (py - 0.1)[:, None], 0.3, 0.2)
        n_alive = n_alive & ~hit_agent.any(1)  # registers next sub-step
        hit_barrier = (blive & ~boffscreen & ~hit_agent
                       & _hits_barriers(level, bbx, bby))
        bimpact = hit_agent | hit_barrier
        bb_vel = torch.where((bimpact | boffscreen)[..., None], 0.0, bb_vel)
        bb_frame = torch.where(bimpact, 1.0, bb_frame)
        bb_frame = torch.where(boffscreen, 5.0, bb_frame)
        bb_pos = torch.where(bwindow[..., None], bb_pos + bb_vel * DT, bb_pos)
        bexpired = bwindow & (bb_frame >= 5.0)
        bexploding = bwindow & (bb_frame >= 1.0) & (bb_frame < 5.0)
        bb_frame = torch.where(bexploding, bb_frame + EXPLOSION_RATE * DT,
                               bb_frame)
        bb_frame = torch.where(bexpired, -1.0, bb_frame)
        bb_num = bb_num - _count(bexpired)
        bb = (bb_pos, bb_vel, bb_rot, bb_frame, bb_num, bb_next)

        # explosion pool animation (common_systems.cpp:367-383)
        ewindow = _window(n_ex_next, n_ex_num, NUM_EXPLOSIONS)
        eexpired = ewindow & (ex_frame_n >= 4.0)
        ex_frame_n = torch.where(
            eexpired, -1.0,
            torch.where(ewindow & (ex_frame_n >= 0.0),
                        ex_frame_n + EXPLOSION_RATE * DT, ex_frame_n))
        n_ex_num = n_ex_num - _count(eexpired)

        boss_dead = n_phase_index >= 6  # common_systems.cpp:385-386
        sub_reward = ((~agent_alive_now).to(_F32) * -10.0
                      + boss_dead.to(_F32) * 10.0)

        # commit the sub-step where the episode still runs
        a1, a2 = active, active[:, None]
        a3 = active[:, None, None]
        alive = torch.where(a1, n_alive, alive)
        pos = torch.where(a2, n_pos, pos)
        vel = torch.where(a2, n_vel, vel)
        a_btimer = torch.where(a1, n_abtimer, a_btimer)
        ab_pos = torch.where(a3, ab_pos_n, ab_pos)
        ab_vel = torch.where(a3, ab_vel_n, ab_vel)
        ab_frame = torch.where(a2, ab_frame_n, ab_frame)
        ab_bounc = torch.where(a2, ab_bounc_n, ab_bounc)
        ab_btime = torch.where(a2, ab_btime_n, ab_btime)
        ab_num = torch.where(a1, n_ab_num, ab_num)
        ab_next = torch.where(a1, n_ab_next, ab_next)
        boss_pos = torch.where(a2, n_boss_pos, boss_pos)
        boss_vel = torch.where(a2, n_boss_vel, boss_vel)
        phase_timer = torch.where(a1, n_phase_timer, phase_timer)
        phase_index = torch.where(a1, n_phase_index, phase_index)
        weapon_index = torch.where(a1, n_weapon, weapon_index)
        attack_timer = torch.where(a1, n_attack, attack_timer)
        hp = torch.where(a1, n_hp, hp)
        move_timer = torch.where(a1, n_move_timer, move_timer)
        explosion_timer = torch.where(a1, n_expl_timer, explosion_timer)
        damage_timer = torch.where(a1, n_damage_timer, damage_timer)
        ex_pos = torch.where(a3, ex_pos_n, ex_pos)
        ex_frame = torch.where(a2, ex_frame_n, ex_frame)
        ex_num = torch.where(a1, n_ex_num, ex_num)
        ex_next = torch.where(a1, n_ex_next, ex_next)
        reward = torch.where(a1, sub_reward, reward)
        done = done | (active & (~agent_alive_now | boss_dead))

    bb_pos, bb_vel, bb_rot, bb_frame, bb_num, bb_next = bb
    new_state = State(
        level=level, pos=pos, vel=vel, alive=alive, a_bullet_timer=a_btimer,
        ab_pos=ab_pos, ab_vel=ab_vel, ab_frame=ab_frame,
        ab_bouncing=ab_bounc, ab_bounce_timer=ab_btime,
        ab_num=ab_num, ab_next=ab_next,
        boss_pos=boss_pos, boss_vel=boss_vel,
        phase_timer=phase_timer, phase_index=phase_index,
        weapon_index=weapon_index, attack_timer=attack_timer, hp=hp,
        move_timer=move_timer, explosion_timer=explosion_timer,
        damage_timer=damage_timer,
        bb_pos=bb_pos, bb_vel=bb_vel, bb_rot=bb_rot, bb_frame=bb_frame,
        bb_num=bb_num, bb_next=bb_next,
        ex_pos=ex_pos, ex_frame=ex_frame, ex_num=ex_num, ex_next=ex_next,
        t=state.t + 1, rng=rng,
    )
    return new_state, reward, done, {}


# ---------------------------------------------------------------------------
# Rendering: fixed camera, pixel-snapped stamp groups, one kernel launch
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _observe_assets(device: str):
    """The exact render's atlas and backgrounds on `device` (`C.bank`)
    and its atlas tables: boss_ships, pships, bolts, barriers and expl,
    each the atlas index of a texture choice."""
    A = _assets()
    idx = A["idx"]
    dev = torch.device(device)

    def table(names):
        return torch.tensor([idx[n] for n in names], device=dev)
    return dict(
        atlas=C.bank(A["atlas_p"], device), bgs=C.bank(A["bgs_p"], device),
        idx=idx,
        boss_ships=table([f"boss_ship_{k}" for k in atlas_lib.BOSS_SHIP_COLORS]),
        pships=table([f"pship_{k}" for k in atlas_lib.PLAYER_SHIP_COLORS]),
        bolts=table([f"bolt_{k}" for k in atlas_lib.LASER_COLORS]),
        barriers=table([f"barrier{i}" for i in range(3)]),
        expl=table([f"explosion{i}" for i in range(5)]))


def _bullets(img, R, atlas, bolt_sid, pos, rot, frame, window, sizes, wx,
             wy):
    """A bullet ring, slot by slot: live bullets (frame 0) as their bolt,
    exploding ones (frame >= 1) as explosion frame - 1, sizes (live,
    exploding) in world units, rotated by rot + pi/2 where rot is given."""
    for i in range(frame.shape[1]):
        f = frame[:, i]
        is_live = window[:, i] & (f == 0.0)
        is_expl = window[:, i] & (f >= 1.0)
        eidx = torch.clamp(f.to(torch.int32) - 1, 0, 4)
        sid = torch.where(is_live, bolt_sid, R["expl"][eidx.long()])
        w = torch.where(is_live, sizes[0], sizes[1])
        img = C.draw_sprite(
            img, atlas, sid, pos[:, i, 0] - w * 0.5, pos[:, i, 1] - w * 0.5,
            w, w, wx, wy,
            rotation=None if rot is None else rot[:, i] + _HALF_PI,
            alive=is_live | is_expl)
    return img


def observe(cfg: Config, state: State, size: int = C.OBS):
    """Each env's frame at size x size by the exact render (bossfight.cpp:
    400-424): the background over the whole screen, barriers, boss
    bullets (rotated) and their explosions, the boss, its shield (alpha
    0.7), damage explosions, player bullets and the player's ship; the
    fixed camera spans the same world at any size. Every bullet slot is a
    blend over the whole frame. uint8 [N, size, size, 3]."""
    R = _observe_assets(str(state.pos.device))
    atlas = R["atlas"]
    level = state.level
    N = state.pos.shape[0]
    dev = state.pos.device
    zero = torch.zeros(N, dtype=torch.float32, device=dev)
    # window renders scale the zoom (bossfight.cpp:412)
    wx, wy = C.camera_coords(PPU * (size / 64.0), zero, zero, size)
    # the barriers' loop reads the maps computed on their own
    lx, ly = C.camera_coords(PPU * (size / 64.0), zero, zero, size,
                             fused=False)

    img = C.clear(N, size, dev)
    # the background spans the screen (bossfight.cpp:416-418)
    img = C.draw_background(img, R["bgs"], level.bg_index, wx, wy,
                            origin=-HALF, size_units=2 * HALF)
    # barriers: offset -0.15, scale 0.3 (bossfight.cpp:480); the JAX
    # package passes the sizes as arrays, so the rects divide truly
    size_bar = torch.full((N, MAX_BARRIERS), 0.3, dtype=torch.float32,
                          device=dev)
    img = C.draw_sprites(img, atlas, R["barriers"][level.barrier_tex.long()],
                         level.barrier_pos[..., 0] - 0.15,
                         level.barrier_pos[..., 1] - 0.15, size_bar,
                         size_bar, lx, ly, alives=level.barrier_exists)
    # boss bullets and their explosions (size 0.1: the laser ~0.3 units,
    # explosions ~0.38)
    bolt_sid = R["bolts"][level.bullet_tex.long()]
    img = _bullets(img, R, atlas, bolt_sid, state.bb_pos, state.bb_rot,
                   state.bb_frame,
                   _window(state.bb_next, state.bb_num, NUM_B_BULLETS),
                   (0.3, 0.38), wx, wy)
    # the boss (size 0.25: 106x80 px, 1.66 x 1.25 units)
    img = C.draw_sprite(img, atlas, R["boss_ships"][level.boss_tex.long()],
                        state.boss_pos[:, 0] - 0.83,
                        state.boss_pos[:, 1] - 0.625, 1.66, 1.25, wx, wy)
    # the shield in a shielded phase (alpha 0.7; 143x119 px * 0.25)
    img = C.draw_sprite(img, atlas, R["idx"]["shield"],
                        state.boss_pos[:, 0] - 1.117,
                        state.boss_pos[:, 1] - 0.93, 2.234, 1.86, wx, wy,
                        alive=state.phase_index % 2 == 0, alpha=0.7)
    # damage explosions (size 0.3: ~1.1 units)
    ewindow = _window(state.ex_next, state.ex_num, NUM_EXPLOSIONS)
    for i in range(NUM_EXPLOSIONS):
        eidx = torch.clamp(state.ex_frame[:, i].to(torch.int32), 0, 4)
        img = C.draw_sprite(img, atlas, R["expl"][eidx.long()],
                            state.ex_pos[:, i, 0] - 0.56,
                            state.ex_pos[:, i, 1] - 0.56, 1.125, 1.125, wx,
                            wy, alive=ewindow[:, i] & (state.ex_frame[:, i]
                                                       >= 0.0))
    # player bullets (size 0.05: 0.15 units), then the ship (0.31 units)
    img = _bullets(img, R, atlas, bolt_sid, state.ab_pos, None,
                   state.ab_frame,
                   _window(state.ab_next, state.ab_num, NUM_A_BULLETS),
                   (0.15, 0.19), wx, wy)
    img = C.draw_sprite(img, atlas, R["pships"][level.ship_tex.long()],
                        state.pos[:, 0] - 0.155, state.pos[:, 1] - 0.117,
                        0.31, 0.234, wx, wy)
    return C.finalize(img)


def obs_space(cfg: Config):
    return spaces.Box(0, 255, (C.OBS, C.OBS, 3))


def action_space(cfg: Config):
    return spaces.MultiDiscrete((NUM_ACTIONS,))


def _r0c0(cx, cy, P):
    """Top-left obs pixel of a P-patch centred at world (cx, cy)."""
    c0 = torch.round((cx + HALF) * PPU - P / 2).to(_I32)
    r0 = torch.round((cy + HALF) * PPU - P / 2).to(_I32)
    return r0, c0


def _cull_alive(k, alive, var, x, y):
    """Compact a mostly-dead slot pool [N, M] to k slots: the alive ones
    first, in slot (painter) order, then dead ones in slot order. A stable
    descending sort of the 0/1 mask gives lax.top_k's order on ties, and a
    gather gives the values of the JAX package's one-hot f32 einsums (one
    non-zero term each). Returns (alive, var, x, y), [N, k] each."""
    ids = torch.sort(alive.to(_F32), dim=1, descending=True, stable=True)[1]
    ids = ids[:, :k]
    return (alive.gather(1, ids), var.gather(1, ids), x.gather(1, ids),
            y.gather(1, ids))


def _stamp_groups(cfg: Config, states: State):
    """The background frame and the four stamp groups of a batch of
    states, in painter order (the stamp kernel's arguments)."""
    RT = _render_tensors(str(states.pos.device))
    banks = _stamp_banks()
    level = states.level
    N = states.pos.shape[0]
    dev = states.pos.device

    img = RT["bg"][level.bg_index.long()]

    def group(name, var, cx, cy, alives=None):
        bank = RT[name]
        r0, c0 = _r0c0(cx, cy, bank.shape[-1])
        return C.stamp_group(bank, var, r0, c0, alives=alives)

    # barriers (sprite offset -0.15, scale 0.3, bossfight.cpp:480) and
    # boss bullets / their explosions in rotation-quantized variants
    bwin = _window(states.bb_next, states.bb_num, NUM_B_BULLETS)
    frame = states.bb_frame
    is_live = bwin & (frame == 0.0)
    is_expl = bwin & (frame >= 1.0)
    rot = states.bb_rot + math.pi * 0.5
    rbin = torch.remainder(torch.round(rot * _INV_ROT_BIN).to(_I32), ROT_BINS)
    eidx = torch.clamp(frame.to(_I32) - 1, 0, 4)
    var = torch.where(is_live,
                      level.bullet_tex[:, None].to(_I32) * ROT_BINS + rbin,
                      3 * ROT_BINS + eidx)
    n_bar = banks["bar"].shape[0]
    bb_alive, bb_var, bb_x, bb_y = _cull_alive(
        BB_CULL, is_live | is_expl, n_bar + var,
        states.bb_pos[..., 0], states.bb_pos[..., 1])
    barbb = group(
        "barbb",
        torch.cat([level.barrier_tex.to(_I32), bb_var], 1),
        torch.cat([level.barrier_pos[..., 0], bb_x], 1),
        torch.cat([level.barrier_pos[..., 1], bb_y], 1),
        alives=torch.cat([level.barrier_exists, bb_alive], 1))

    # the boss ship, with its shield pre-composed in shielded phases
    bvar = (level.boss_tex.to(_I32)
            + torch.where(torch.remainder(states.phase_index, 2) == 0, 4, 0)
            )[:, None]
    boss = group("bosshield", bvar, states.boss_pos[:, None, 0],
                 states.boss_pos[:, None, 1])

    # boss damage explosions (draw offset -0.56 vs 1.125/2: ~0.002u)
    ewin = _window(states.ex_next, states.ex_num, NUM_EXPLOSIONS)
    dmg = group("dmg", torch.clamp(states.ex_frame.to(_I32), 0, 4),
                states.ex_pos[..., 0] - 0.0025,
                states.ex_pos[..., 1] - 0.0025,
                alives=ewin & (states.ex_frame >= 0.0))

    # player bullets / explosions + the agent ship
    awin = _window(states.ab_next, states.ab_num, NUM_A_BULLETS)
    aframe = states.ab_frame
    a_live = awin & (aframe == 0.0)
    a_expl = awin & (aframe >= 1.0)
    avar = torch.where(a_live, level.bullet_tex[:, None].to(_I32),
                       3 + torch.clamp(aframe.to(_I32) - 1, 0, 4))
    ab_alive, ab_var, ab_x, ab_y = _cull_alive(
        AB_CULL, a_live | a_expl, avar,
        states.ab_pos[..., 0], states.ab_pos[..., 1])
    n_ab = banks["ab"].shape[0]
    abship = group(
        "abship",
        torch.cat([ab_var, n_ab + level.ship_tex.to(_I32)[:, None]], 1),
        torch.cat([ab_x, states.pos[:, None, 0]], 1),
        torch.cat([ab_y, states.pos[:, None, 1]], 1),
        alives=torch.cat([ab_alive, torch.ones((N, 1), dtype=torch.bool,
                                               device=dev)], 1))
    return img, [barbb, boss, dmg, abship]


def observe_batch(cfg: Config, states: State):
    """Planar uint8 [N, 3, 64, 64]: background, then the four stamp groups
    in one stamp-kernel launch on the card. Under a profiler the cull and
    the groups are the span `render.stamp_groups`."""
    with trace.span("render.stamp_groups"):
        img, groups = _stamp_groups(cfg, states)
    img = stamp_kernel.composite(img, groups)
    return torch.clamp(torch.round(img), 0, 255).to(torch.uint8)
