"""Independent per-step reward/termination predictors (second implementations)
(procgen2_tpu/tools/predict.py, the port's own copy).

The scripted parity suites (tests/test_torch_parity.py) compare
the port's engines against these scalar numpy re-derivations of the reference's
step loops — `games/coinrun/coinrun.cpp:341-391`,
`games/jumper/jumper.cpp:341-375`,
`games/bossfight/bossfight.cpp:308-325` and the System_* updates in each
game's `common_systems.cpp` — so a shared bug in the JAX formulation
cannot silently agree with itself. Everything here is deliberately the
*naive scalar transcription* of the cited C++ semantics (per-entity
Python loops, floats, mutation), the opposite of the engines' batched
masked-tensor style.

All arithmetic is float32 with the same operation order as the C++ (and
the engines), so the predicted reward sequences are compared with exact
f32 equality, not tolerances.

Bossfight is the one stochastic step loop (boss weapon choice, shield
jitter, volley offsets, move targets, shield bounces). The *draw
schedule* is this framework's design (a threefry key split per
sub-step) rather than reference semantics, so the predictor replays the
same keyed draws with the port's `random` — everything downstream of the
draws (phase machine, bullet kinematics, collisions, rewards,
common_systems.cpp:199-386) is re-derived in numpy.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from .. import random as prng
from .. import trig

f32 = np.float32

# Collision types (physics/tiles.py, tilemap.cpp:316-321)
NONE, FULL, DOWN_ONLY = 0, 1, 2


def _collides(ax, ay, aw, ah, bx, by, bw, bh) -> bool:
    """Strict AABB overlap (helpers.cpp:40-46); f32 inputs."""
    return (
        ax < bx + bw and ax + aw > bx and ay < by + bh and ay + ah > by
    )


class _TileResolver:
    """Scalar two-pass axis resolver (tilemap.cpp:323-396): pass 1
    resolves vertically over the 3x3 window for overlaps wider than
    tall (down_only honored), pass 2 horizontally, the rect mutating as
    the scan proceeds. Window bounds and rect center captured up-front
    (tilemap.cpp:326-331)."""

    def __init__(self, grid: np.ndarray, lut: Sequence[int], oob_id: int):
        self.grid = np.asarray(grid)
        self.H, self.W = self.grid.shape
        self.lut = list(lut)
        self.oob = oob_id

    def _type(self, tx: int, ty: int) -> int:
        if 0 <= tx < self.W and 0 <= ty < self.H:
            v = int(self.grid[ty, tx])
        else:
            v = self.oob
        return self.lut[v] if 0 <= v < len(self.lut) else NONE

    def resolve(self, x, y, w, h, fallthrough=False, step_y=f32(0.0)):
        x, y, w, h = f32(x), f32(y), f32(w), f32(h)
        lx = int(np.floor(x))
        ly = int(np.floor(y))
        ux = int(np.ceil(f32(x + w)))
        uy = int(np.ceil(f32(y + h)))
        cx = f32(x + f32(w * f32(0.5)))
        cy = f32(y + f32(h * f32(0.5)))
        collided = False

        ry = y
        for dy in range(3):
            for dx in range(3):
                tx, ty = lx + dx, ly + dy
                if tx > ux or ty > uy:
                    continue
                t = self._type(tx, ty)
                if t == NONE:
                    continue
                txf, tyf = f32(tx), f32(ty)
                oy = max(ry, tyf)
                ow = f32(min(f32(x + w), f32(txf + 1.0)) - max(x, txf))
                oh = f32(min(f32(ry + h), f32(tyf + 1.0)) - oy)
                if not (ow > 0 and oh > 0 and ow > oh):
                    continue
                if t == DOWN_ONLY:
                    inside = f32(f32(ry + h) - step_y) > tyf
                    if not (step_y > f32(0.01) and not fallthrough
                            and not inside):
                        continue
                oc_y = f32(oy + f32(oh * f32(0.5)))
                ry = f32(tyf - h) if oc_y > cy else f32(tyf + 1.0)
                collided = True

        rx = x
        for dy in range(3):
            for dx in range(3):
                tx, ty = lx + dx, ly + dy
                if tx > ux or ty > uy:
                    continue
                t = self._type(tx, ty)
                if t == NONE or t == DOWN_ONLY:
                    continue
                txf, tyf = f32(tx), f32(ty)
                ox = max(rx, txf)
                ow = f32(min(f32(rx + w), f32(txf + 1.0)) - ox)
                oh = f32(min(f32(ry + h), f32(tyf + 1.0)) - max(ry, tyf))
                if not (ow > 0 and oh > 0 and ow <= oh):
                    continue
                oc_x = f32(ox + f32(ow * f32(0.5)))
                rx = f32(txf - w) if oc_x > cx else f32(txf + 1.0)
                collided = True

        return rx, ry, collided


# ---------------------------------------------------------------------------
# coinrun (coinrun.cpp:341-391, common_systems.cpp:65-252)
# ---------------------------------------------------------------------------

_CR_WALL_MID = 2
_CR_LUT_AGENT = [NONE, FULL, FULL, NONE, NONE, DOWN_ONLY]
_CR_LUT_WALL = [NONE, FULL, FULL, NONE, NONE, NONE]
_CR_LUT_EMPTY = [FULL, NONE, NONE, NONE, NONE, NONE]
_CR_LUT_LAVA = [NONE, NONE, NONE, FULL, FULL, NONE]


class CoinrunSim:
    """Scalar mirror of the coinrun step: agent velocity mixing /
    jump / gravity / fall clamp (common_systems.cpp:126-167), two-pass
    tile collision with one-way crates (common_systems.cpp:176-196),
    patrol-mob AI with wall/ledge sensors (common_systems.cpp:65-105),
    saw/mob/lava death and the +10 coin (coinrun.cpp:357-371), 4
    sub-steps with the sub-step last-write-wins reward and early exit.
    Simulates the mobs too, so death steps predict exactly."""

    MAX_JUMP = f32(1.55)
    GRAVITY = f32(0.2)
    MAX_SPEED = f32(0.5)
    MIX = f32(0.2)
    MIX_AIR = f32(0.2 * 0.15)  # MIX * AIR_CONTROL, rounded like the engine
    DT = f32(0.25)
    WORLD = 64

    def __init__(self, level):
        grid = np.asarray(level.grid)
        self.agent_res = _TileResolver(grid, _CR_LUT_AGENT, _CR_WALL_MID)
        self.wall_res = _TileResolver(grid, _CR_LUT_WALL, _CR_WALL_MID)
        self.empty_res = _TileResolver(grid, _CR_LUT_EMPTY, _CR_WALL_MID)
        self.lava_res = _TileResolver(grid, _CR_LUT_LAVA, _CR_WALL_MID)
        self.pos = np.array([1.5, self.WORLD - 2.0], f32)  # coinrun.cpp:489
        self.vel = np.zeros(2, f32)
        self.on_ground = False
        self.coin = np.asarray(level.coin_pos, f32)
        self.saw_pos = np.asarray(level.saw_pos, f32)
        self.saw_alive = np.asarray(level.saw_alive)
        self.mob_pos = np.asarray(level.mob_pos0, f32).copy()
        self.mob_vx = np.asarray(level.mob_vx0, f32).copy()
        self.mob_alive = np.asarray(level.mob_alive)

    def _mob_substep(self) -> None:
        """System_Mob_AI::update (common_systems.cpp:65-105)."""
        for i in range(self.mob_pos.shape[0]):
            if not self.mob_alive[i]:
                continue
            x = f32(self.mob_pos[i, 0] + f32(self.mob_vx[i] * self.DT))
            y = self.mob_pos[i, 1]
            wx, _, wcol = self.wall_res.resolve(
                f32(x - f32(0.5)), f32(y - f32(0.6)), 1.0, 0.5)
            fx, _, fcol = self.empty_res.resolve(
                f32(x - f32(0.5)), f32(y + f32(0.6)), 1.0, 0.5)
            self.mob_pos[i, 0] = (
                f32(fx + f32(0.5)) if fcol else f32(wx + f32(0.5))
            )
            if wcol or fcol:
                self.mob_vx[i] = f32(-self.mob_vx[i])

    def _agent_substep(self, a: int):
        """System_Agent::update (common_systems.cpp:121-252)."""
        movement_x = f32((a in (6, 7, 8)) - (a in (0, 1, 2)))
        jump = a in (2, 5, 8)
        fallthrough = a in (0, 3, 6)

        mix_x = self.MIX if self.on_ground else self.MIX_AIR
        vx = f32(self.vel[0] + f32(
            f32(mix_x * f32(f32(self.MAX_SPEED * movement_x) - self.vel[0]))
            * self.DT))
        if abs(vx) < f32(f32(mix_x * self.MAX_SPEED) * self.DT):
            vx = f32(0.0)
        vy = -self.MAX_JUMP if (jump and self.on_ground) else self.vel[1]
        vy = f32(vy + f32(self.GRAVITY * self.DT))
        vy = f32(np.clip(vy, -self.MAX_JUMP, self.MAX_JUMP))

        x = f32(self.pos[0] + f32(vx * self.DT))
        y = f32(self.pos[1] + f32(vy * self.DT))

        rx, ry, col = self.agent_res.resolve(
            f32(x - f32(0.5)), f32(y - f32(1.0)), 1.0, 1.0,
            fallthrough=fallthrough, step_y=f32(vy * self.DT),
        )
        dx_moved = f32(rx - f32(x - f32(0.5)))
        dy_moved = f32(ry - f32(y - f32(1.0)))
        self.on_ground = bool(dy_moved < 0.0 and col)
        x = f32(rx + f32(0.5))
        y = f32(ry + f32(1.0))
        if dx_moved != 0.0:
            vx = f32(0.0)
        if self.on_ground:
            vy = f32(0.0)
        self.pos = np.array([x, y], f32)
        self.vel = np.array([vx, vy], f32)

        ax, ay = f32(x - f32(0.5)), f32(y - f32(1.0))
        dead = False
        for i in range(self.saw_pos.shape[0]):  # common_systems.cpp:199-212
            if self.saw_alive[i] and _collides(
                ax, ay, f32(1.0), f32(1.0),
                f32(self.saw_pos[i, 0] - f32(0.5)),
                f32(self.saw_pos[i, 1] - f32(0.5)), f32(1.0), f32(1.0),
            ):
                dead = True
        _, _, lava = self.lava_res.resolve(ax, ay, 1.0, 1.0)
        dead = dead or lava  # common_systems.cpp:215-220
        achieved = _collides(  # common_systems.cpp:223-235
            ax, ay, f32(1.0), f32(1.0),
            f32(self.coin[0] - f32(0.5)), f32(self.coin[1] - f32(0.5)),
            f32(1.0), f32(1.0),
        )
        return dead, achieved

    def step(self, a: int) -> Tuple[f32, bool]:
        """One env step = 4 sub-steps, mobs move first
        (coinrun.cpp:357-371); reward last-write-wins."""
        reward = f32(0.0)
        for _ in range(4):
            self._mob_substep()
            dead, achieved = self._agent_substep(a)
            ax, ay = f32(self.pos[0] - f32(0.5)), f32(self.pos[1] - f32(1.0))
            for i in range(self.mob_pos.shape[0]):
                if self.mob_alive[i] and _collides(
                    ax, ay, f32(1.0), f32(1.0),
                    f32(self.mob_pos[i, 0] - f32(0.5)),
                    f32(self.mob_pos[i, 1] - f32(0.48)),
                    f32(1.0), f32(0.98),
                ):
                    dead = True
            reward = f32(float(achieved) * 10.0)
            if dead or achieved:
                return reward, True
        return reward, False


def coinrun_predict(level, actions: Sequence[int]):
    """Exact per-step (reward, terminated) for `actions` on `level`;
    stops at the first terminal step."""
    sim = CoinrunSim(level)
    rewards, terms = [], []
    for a in actions:
        r, t = sim.step(int(a))
        rewards.append(r)
        terms.append(t)
        if t:
            break
    return np.asarray(rewards, f32), np.asarray(terms, bool)


# ---------------------------------------------------------------------------
# jumper (jumper.cpp:341-375, common_systems.cpp:57-201)
# ---------------------------------------------------------------------------

_JP_WALL_MID = 2
_JP_LUT_WALL = [NONE, FULL, FULL, NONE]


class JumperSim:
    """Scalar mirror of the jumper step: air-control velocity mixing,
    double jump with 3dt cooldown, ceiling-stop, spike death and the
    +10 carrot (common_systems.cpp:57-201, jumper.cpp:355-369)."""

    MAX_JUMP = f32(0.92)
    GRAVITY = f32(0.1)
    MAX_SPEED = f32(0.5)
    MIX = f32(0.2)
    MIX_AIR = f32(0.2 * 1.0)  # AIR_CONTROL = 1
    JUMP_COOLDOWN = f32(3.0)
    DT = f32(0.25)

    def __init__(self, level):
        grid = np.asarray(level.grid)
        self.res = _TileResolver(grid, _JP_LUT_WALL, _JP_WALL_MID)
        self.spikes = np.asarray(level.spike_grid)
        self.D = grid.shape[0]
        self.pos = np.asarray(level.agent_pos, f32).copy()
        self.vel = np.zeros(2, f32)
        self.on_ground = False
        self.jumps_left = 2
        self.jump_timer = f32(0.0)
        self.goal = np.asarray(level.goal_pos, f32)

    def _spike_hit(self, rx, ry) -> bool:
        """Agent rect vs spike rects over the 3x3 cell window
        (common_systems.cpp:149-162)."""
        cx = int(f32(rx + f32(0.25)))
        cy = int(f32(ry + f32(0.4)))
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                tx = min(max(cx + dx, 0), self.D - 1)
                ty = min(max(cy + dy, 0), self.D - 1)
                if self.spikes[ty, tx] and _collides(
                    rx, ry, f32(0.5), f32(0.8),
                    f32(tx + 0.25), f32(ty + 0.25), f32(0.5), f32(0.5),
                ):
                    return True
        return False

    def _substep(self, a: int):
        movement_x = f32((a in (6, 7, 8)) - (a in (0, 1, 2)))
        jump = a in (2, 5, 8)

        mix_x = self.MIX if self.on_ground else self.MIX_AIR
        vx = f32(self.vel[0] + f32(
            f32(mix_x * f32(f32(self.MAX_SPEED * movement_x) - self.vel[0]))
            * self.DT))
        if abs(vx) < f32(f32(mix_x * self.MAX_SPEED) * self.DT):
            vx = f32(0.0)

        if self.on_ground:
            self.jumps_left = 2
        do_jump = jump and self.jumps_left > 0 and self.jump_timer == 0.0
        vy = -self.MAX_JUMP if do_jump else self.vel[1]
        if do_jump:
            self.jumps_left -= 1
            self.jump_timer = self.JUMP_COOLDOWN
        self.jump_timer = f32(max(f32(0.0), f32(self.jump_timer - self.DT)))

        vy = f32(vy + f32(self.GRAVITY * self.DT))
        vy = f32(np.clip(vy, -self.MAX_JUMP, self.MAX_JUMP))

        x = f32(self.pos[0] + f32(vx * self.DT))
        y = f32(self.pos[1] + f32(vy * self.DT))

        # Collision bounds (-0.25, -0.8, 0.5, 0.8) (tilemap.cpp:233)
        rx, ry, col = self.res.resolve(
            f32(x - f32(0.25)), f32(y - f32(0.8)), 0.5, 0.8)
        dx_moved = f32(rx - f32(x - f32(0.25)))
        dy_moved = f32(ry - f32(y - f32(0.8)))
        self.on_ground = bool(dy_moved < 0.0 and col)
        hit_ceiling = bool(dy_moved > 0.0 and col)
        x = f32(rx + f32(0.25))
        y = f32(ry + f32(0.8))
        if dx_moved != 0.0:
            vx = f32(0.0)
        if hit_ceiling or self.on_ground:
            vy = f32(0.0)
        self.pos = np.array([x, y], f32)
        self.vel = np.array([vx, vy], f32)

        dead = self._spike_hit(f32(x - f32(0.25)), f32(y - f32(0.8)))
        achieved = _collides(
            f32(x - f32(0.25)), f32(y - f32(0.8)), f32(0.5), f32(0.8),
            f32(self.goal[0] - f32(0.5)), f32(self.goal[1] - f32(0.5)),
            f32(1.0), f32(1.0),
        )
        return dead, achieved

    def step(self, a: int) -> Tuple[f32, bool]:
        reward = f32(0.0)
        for _ in range(4):  # jumper.cpp:355-369
            dead, achieved = self._substep(a)
            reward = f32(float(achieved) * 10.0)
            if dead or achieved:
                return reward, True
        return reward, False


def jumper_predict(level, actions: Sequence[int]):
    """Exact per-step (reward, terminated); stops at the terminal step."""
    sim = JumperSim(level)
    rewards, terms = [], []
    for a in actions:
        r, t = sim.step(int(a))
        rewards.append(r)
        terms.append(t)
        if t:
            break
    return np.asarray(rewards, f32), np.asarray(terms, bool)


# ---------------------------------------------------------------------------
# bossfight (bossfight.cpp:308-325, common_systems.cpp:199-386, 494-683)
# ---------------------------------------------------------------------------


class BossfightDraws:
    """The keyed draws of bossfight's sub-steps for n keys at once.

    Each sub-step of the engine splits its key into 7 (the next key, then
    the shield, weapon, pattern, move, damage and bounce keys,
    games/bossfight.py) and draws from the sub-keys whether it uses the
    draw or not. The chain of keys depends on nothing else, so the draws
    of BLOCK sub-steps are made for every key at once, a few batched
    calls of the port's `random` per block (a threefry draw is ~160
    torch ops, too many to make one draw at a time in a 1,500-step
    duel), and each scalar sim reads its row."""

    BLOCK = 256  # sub-steps per batch of draws

    def __init__(self, rng_keys):
        self.key = torch.as_tensor(rng_keys).to("cpu", torch.int64)  # [n, 2]
        self.blocks = []

    def _extend(self):
        subs = []
        k = self.key
        for _ in range(self.BLOCK):
            ks = prng.split(k, 7)
            k = ks[:, 0]
            subs.append(ks[:, 1:])
        self.key = k
        shield, weapon, pattern, move, _damage, bounce = torch.stack(
            subs, dim=1).unbind(-2)  # each [n, BLOCK, 2]
        kp, km = prng.split(pattern), prng.split(move)
        self.blocks.append(tuple(x.numpy() for x in (
            prng.uniform(shield),
            prng.randint(weapon, (), 0, 4),
            prng.uniform(kp[..., 0, :]),
            prng.uniform(kp[..., 1, :]),
            prng.uniform(km[..., 0, :]),
            prng.uniform(km[..., 1, :]),
            prng.uniform(bounce, (BossfightSim.NUM_AB,), -1.0, 1.0))))

    def at(self, row: int, sub: int):
        """Sub-step `sub`'s draws for key `row`: (u_shield, weapon, u1, u2,
        umx, umy, bounce f32 [NUM_AB])."""
        b, j = divmod(sub, self.BLOCK)
        while len(self.blocks) <= b:
            self._extend()
        u_shield, weapon, u1, u2, umx, umy, bounce = (
            x[row, j] for x in self.blocks[b])
        return (f32(u_shield), int(weapon), f32(u1), f32(u2), f32(umx),
                f32(umy), bounce)


def _volley(pattern: int, u2, speed):
    """The boss volley's bullet velocities f32 [n, 2]
    (common_systems.cpp:103-185; pattern -1 is the unshielded single
    shot). The engine's angles are eager f32 ops, each rounded on its
    own (numpy f32 here), and its cos and sin are XLA CPU's (trig.py)."""
    pi = f32(np.pi)
    if pattern in (-1, 3):
        rots = np.array([pi * f32(f32(1.0) + u2)], f32)
    elif pattern == 0:
        rots = f32(np.pi * 1.5) + (np.arange(5, dtype=f32) - f32(2.0)) \
            * pi * f32(0.125)
    elif pattern == 1:
        rots = f32(np.pi * (1.25 + 8 * 0.0625)) \
            + np.arange(4, dtype=f32) * pi * f32(0.5)
    else:
        rots = f32(np.pi * 0.25) * np.arange(8, dtype=f32) \
            + f32(u2 * f32(2.0)) * pi
    r = torch.from_numpy(rots.astype(f32))
    v = np.stack([trig.cos32(r).numpy(), -trig.sin32(r).numpy()], axis=1)
    return v * f32(speed)


class BossfightSim:
    """Scalar mirror of the bossfight step loop: agent drift/clamp,
    player-bullet ring with shield bounces, the boss phase machine
    (shielded weapon volleys / unshielded vulnerability, 3 HP x 3
    damage rounds -> phase_index 6 = kill), boss-bullet kinematics and
    the one-sub-step-late death registration quirk
    (common_systems.cpp:322-329 vs bossfight.cpp:311-320).

    The stochastic draws (weapon, shield jitter, volley offsets, move
    targets, bounce velocities) replay the engine's keyed schedule from
    a `BossfightDraws` table (row `row`; made for `rng_key` alone when
    none is given); the volley angles round each f32 op on its own and
    take XLA CPU's cos and sin (`_volley`). Every dynamic rule downstream
    is the scalar numpy re-derivation of the cited C++.
    """

    DT = f32(0.25)
    HALF = f32(2.0)
    MOVE_MIX = f32(0.5)
    MOVE_SPEED = f32(0.1)
    NUM_AB = 32
    NUM_BB = 64

    def __init__(self, level, rng_key=None, mode: str = "hard",
                 draws=None, row: int = 0):
        if draws is None:
            draws = BossfightDraws(torch.as_tensor(rng_key)[None])
        self.draws, self.row, self.sub = draws, row, 0
        self.level = level
        self.bullet_speed = f32(0.1 if mode == "hard" else 0.05)
        self.shield_jitter = f32(80.0 if mode == "hard" else 30.0)
        self.barriers = [
            (f32(level.barrier_pos[i, 0]), f32(level.barrier_pos[i, 1]))
            for i in range(level.barrier_exists.shape[0])
            if level.barrier_exists[i]
        ]
        self.pos = np.asarray(level.agent_pos0, f32).copy()
        self.vel = np.zeros(2, f32)
        self.alive = True
        self.a_btimer = f32(0.0)
        self.ab_pos = np.zeros((self.NUM_AB, 2), f32)
        self.ab_vel = np.zeros((self.NUM_AB, 2), f32)
        self.ab_frame = np.full(self.NUM_AB, -1.0, f32)
        self.ab_bounc = np.zeros(self.NUM_AB, bool)
        self.ab_btime = np.zeros(self.NUM_AB, f32)
        self.ab_num = 0
        self.ab_next = 0
        self.boss_pos = np.zeros(2, f32)
        self.boss_vel = np.zeros(2, f32)
        self.phase_timer = f32(0.0)
        self.phase_index = 0
        self.weapon_index = 0
        self.attack_timer = f32(0.0)
        self.hp = 3
        self.move_timer = f32(0.0)
        self.damage_timer = f32(0.0)
        self.explosion_timer = f32(0.0)
        self.bb_pos = np.zeros((self.NUM_BB, 2), f32)
        self.bb_vel = np.zeros((self.NUM_BB, 2), f32)
        self.bb_frame = np.full(self.NUM_BB, -1.0, f32)
        self.bb_num = 0
        self.bb_next = 0

    # -- helpers -----------------------------------------------------------
    def _barrier_hit(self, x, y, w, h) -> bool:
        for bx, by in self.barriers:
            if _collides(x, y, w, h,
                         f32(bx - f32(0.1)), f32(by - f32(0.1)),
                         f32(0.2), f32(0.2)):
                return True
        return False

    def _window_ab(self, j) -> bool:
        return (self.ab_next - 1 - j) % self.NUM_AB < self.ab_num

    def _window_bb(self, j) -> bool:
        return (self.bb_next - 1 - j) % self.NUM_BB < self.bb_num

    def _push_bb(self, pos, velx, vely) -> None:
        """fire() (common_systems.cpp:75-87)."""
        if self.bb_num < self.NUM_BB:
            i = self.bb_next
            self.bb_pos[i] = pos
            self.bb_vel[i] = (velx, vely)
            self.bb_frame[i] = f32(0.0)
            self.bb_next = (i + 1) % self.NUM_BB
            self.bb_num += 1

    def _substep(self, movement_x, movement_y, fire):
        u_shield, weapon, u1, u2, umx, umy, bkeys = self.draws.at(
            self.row, self.sub)
        self.sub += 1

        # ============ System_Agent (common_systems.cpp:494-683) ==========
        nvx = f32(self.vel[0] + f32(f32(self.MOVE_MIX * f32(
            f32(movement_x * self.MOVE_SPEED) - self.vel[0])) * self.DT))
        nvy = f32(self.vel[1] + f32(f32(self.MOVE_MIX * f32(
            f32(-movement_y * self.MOVE_SPEED) - self.vel[1])) * self.DT))
        npx = f32(self.pos[0] + f32(nvx * self.DT))
        npy = f32(self.pos[1] + f32(nvy * self.DT))
        cx = f32(min(max(npx, f32(-self.HALF + 0.15)), f32(self.HALF - 0.15)))
        cy = f32(min(max(npy, f32(-self.HALF + 0.1)), f32(self.HALF - 0.1)))
        if cx != npx:
            nvx = f32(0.0)
        if cy != npy:
            nvy = f32(0.0)
        npx, npy = cx, cy
        self.pos = np.array([npx, npy], f32)
        self.vel = np.array([nvx, nvy], f32)

        # fire player bullet (timer gates as caveflyer's)
        can_spawn = fire and self.a_btimer == 0.0 and self.ab_num < self.NUM_AB
        if can_spawn:
            i = self.ab_next
            self.ab_pos[i] = (npx, npy)
            self.ab_vel[i] = (f32(0.0), f32(-0.1))
            self.ab_frame[i] = f32(0.0)
            self.ab_bounc[i] = False
            self.ab_btime[i] = f32(0.0)
            self.ab_next = (i + 1) % self.NUM_AB
            self.ab_num += 1
            self.a_btimer = f32(5.0)
        elif fire:
            self.a_btimer = f32(max(f32(0.0), f32(self.a_btimer - self.DT)))

        # agent vs boss body + barriers
        contact = _collides(
            f32(npx - f32(0.15)), f32(npy - f32(0.1)), f32(0.3), f32(0.2),
            f32(self.boss_pos[0] - f32(0.6)), f32(self.boss_pos[1] - f32(0.4)),
            f32(1.2), f32(0.8),
        ) or self._barrier_hit(
            f32(npx - f32(0.15)), f32(npy - f32(0.1)), f32(0.3), f32(0.2))
        n_alive = self.alive and not contact
        agent_alive_now = n_alive  # the value the terminated check sees

        # ============ player bullets (common_systems.cpp:600-683) ========
        shielded = self.phase_index % 2 == 0
        damage_count = 0
        for j in range(self.NUM_AB):
            if not self._window_ab(j):
                continue
            live = self.ab_frame[j] == 0.0
            bx, by = f32(self.ab_pos[j, 0]), f32(self.ab_pos[j, 1])
            offscreen = live and not _collides(
                f32(bx - f32(0.01)), f32(by - f32(0.01)), f32(0.02), f32(0.02),
                -self.HALF, -self.HALF, f32(4.0), f32(4.0))
            boss_hit = live and not offscreen and _collides(
                f32(bx - f32(0.01)), f32(by - f32(0.01)), f32(0.02), f32(0.02),
                f32(self.boss_pos[0] - f32(0.6)),
                f32(self.boss_pos[1] - f32(0.4)), f32(1.2), f32(0.8))
            barrier_hit = (live and not offscreen and not boss_hit
                           and self._barrier_hit(
                               f32(bx - f32(0.01)), f32(by - f32(0.01)),
                               f32(0.02), f32(0.02)))
            if boss_hit and shielded:  # bounce off the shield
                self.ab_vel[j] = (f32(bkeys[j] * f32(0.05)), f32(0.05))
                self.ab_btime[j] = f32(10.0)
                self.ab_bounc[j] = True
            if (boss_hit and not shielded) or barrier_hit:
                damage_count += int(boss_hit and not shielded)
                self.ab_vel[j] = (f32(0.0), f32(0.0))
                self.ab_frame[j] = f32(1.0)
            if offscreen:
                self.ab_frame[j] = f32(5.0)
                self.ab_vel[j] = (f32(0.0), f32(0.0))
        n_hp = max(0, self.hp - damage_count)
        expired_count = 0
        for j in range(self.NUM_AB):
            if not self._window_ab(j):
                continue
            self.ab_pos[j, 0] = f32(self.ab_pos[j, 0]
                                    + f32(self.ab_vel[j, 0] * self.DT))
            self.ab_pos[j, 1] = f32(self.ab_pos[j, 1]
                                    + f32(self.ab_vel[j, 1] * self.DT))
            expired = self.ab_frame[j] >= 5.0
            if 1.0 <= self.ab_frame[j] < 5.0:
                self.ab_frame[j] = f32(self.ab_frame[j]
                                       + f32(f32(0.3) * self.DT))
            ticking = self.ab_bounc[j] and self.ab_btime[j] > 0.0
            if ticking:
                self.ab_btime[j] = f32(max(f32(0.0),
                                           f32(self.ab_btime[j] - self.DT)))
            if self.ab_bounc[j] and self.ab_btime[j] == 0.0 and not ticking:
                expired = True  # bounce timeout (common_systems.cpp:666-676)
            if expired:
                self.ab_frame[j] = f32(-1.0)
                expired_count += 1
        self.ab_num -= expired_count

        # ============ System_Mob_AI: boss (common_systems.cpp:199-298) ===
        shielded_phase_time = f32(180.0 + f32(u_shield * self.shield_jitter))
        at_start = self.phase_timer == 0.0
        if at_start:  # phase start re-rolls weapon + HP
            self.weapon_index = weapon
            self.attack_timer = f32(0.0)
            n_hp = 3
        adv = (shielded and self.phase_timer >= shielded_phase_time) or (
            not shielded and self.phase_timer >= f32(300.0))
        if adv:
            self.phase_timer = f32(0.0)
            self.phase_index += 1
        else:
            self.phase_timer = f32(self.phase_timer + self.DT)

        # fire_pattern (common_systems.cpp:103-185)
        pattern = self.weapon_index if shielded else -1
        if pattern == -1:
            if u1 < f32(0.1 * 0.25):
                [v] = _volley(-1, u2, self.bullet_speed)
                self._push_bb(self.pos_boss_old, v[0], v[1])
        else:
            threshold = {0: f32(8.0), 1: f32(5.0), 2: f32(10.0),
                         3: f32(4.0)}[pattern]
            if self.attack_timer >= threshold:
                for v in _volley(pattern, u2, self.bullet_speed):
                    self._push_bb(self.pos_boss_old, v[0], v[1])
                self.attack_timer = f32(0.0)
            else:
                self.attack_timer = f32(self.attack_timer + self.DT)

        # HP depleted -> damage show + extra phase advance
        # (common_systems.cpp:271-282; phase_timer NOT reset)
        depleted = not shielded and n_hp == 0
        if depleted:
            if self.explosion_timer >= f32(8.0):
                self.explosion_timer = f32(0.0)
            else:
                self.explosion_timer = f32(self.explosion_timer + self.DT)
            if self.damage_timer >= f32(80.0):
                self.damage_timer = f32(0.0)
                self.phase_index += 1
                n_hp = 3
            else:
                self.damage_timer = f32(self.damage_timer + self.DT)
        self.hp = n_hp

        # boss movement (common_systems.cpp:286-298)
        if self.move_timer >= f32(70.0):
            self.move_timer = f32(0.0)
            tx = f32(f32(f32(f32(f32(umx * f32(2.0)) - f32(1.0)) * f32(0.5))
                         * f32(4.0)) * f32(0.7))
            ty = f32(f32(f32(f32(f32(f32(umy * f32(2.0)) - f32(1.0))
                                 * f32(0.5)) - f32(0.3)) * f32(4.0))
                     * f32(0.5))
            self.boss_vel = np.array(
                [f32(f32(tx - self.boss_pos[0]) / f32(70.0)),
                 f32(f32(ty - self.boss_pos[1]) / f32(70.0))], f32)
        else:
            self.move_timer = f32(self.move_timer + self.DT)
        self.boss_pos = np.array(
            [f32(self.boss_pos[0] + f32(self.boss_vel[0] * self.DT)),
             f32(self.boss_pos[1] + f32(self.boss_vel[1] * self.DT))], f32)

        # ============ boss bullets (common_systems.cpp:303-365) ==========
        bexpired_count = 0
        for j in range(self.NUM_BB):
            if not self._window_bb(j):
                continue
            live = self.bb_frame[j] == 0.0
            bx, by = f32(self.bb_pos[j, 0]), f32(self.bb_pos[j, 1])
            boffscreen = live and not _collides(
                f32(bx - f32(0.01)), f32(by - f32(0.01)), f32(0.02), f32(0.02),
                -self.HALF, -self.HALF, f32(4.0), f32(4.0))
            hit_agent = live and not boffscreen and _collides(
                f32(bx - f32(0.01)), f32(by - f32(0.01)), f32(0.02), f32(0.02),
                f32(npx - f32(0.15)), f32(npy - f32(0.1)), f32(0.3), f32(0.2))
            if hit_agent:
                n_alive = False  # registers NEXT sub-step (engine quirk)
            hit_barrier = (live and not boffscreen and not hit_agent
                           and self._barrier_hit(
                               f32(bx - f32(0.01)), f32(by - f32(0.01)),
                               f32(0.02), f32(0.02)))
            if hit_agent or hit_barrier:
                self.bb_vel[j] = (f32(0.0), f32(0.0))
                self.bb_frame[j] = f32(1.0)
            if boffscreen:
                self.bb_vel[j] = (f32(0.0), f32(0.0))
                self.bb_frame[j] = f32(5.0)
            self.bb_pos[j, 0] = f32(self.bb_pos[j, 0]
                                    + f32(self.bb_vel[j, 0] * self.DT))
            self.bb_pos[j, 1] = f32(self.bb_pos[j, 1]
                                    + f32(self.bb_vel[j, 1] * self.DT))
            if self.bb_frame[j] >= 5.0:
                self.bb_frame[j] = f32(-1.0)
                bexpired_count += 1
            elif 1.0 <= self.bb_frame[j] < 5.0:
                self.bb_frame[j] = f32(self.bb_frame[j]
                                       + f32(f32(0.3) * self.DT))
        self.bb_num -= bexpired_count

        self.alive = n_alive
        boss_dead = self.phase_index >= 6  # common_systems.cpp:385-386
        sub_reward = f32(
            f32(float(not agent_alive_now) * -10.0)
            + f32(float(boss_dead) * 10.0))
        return sub_reward, (not agent_alive_now) or boss_dead

    def step(self, a: int) -> Tuple[f32, bool]:
        movement_x = f32((a in (6, 7, 8)) - (a in (0, 1, 2)))
        movement_y = f32((a in (2, 5, 8)) - (a in (0, 3, 6)))
        fire = a == 9
        reward = f32(0.0)
        for _ in range(4):
            # the fire pattern spawns at the boss position from BEFORE
            # this sub-step's movement (the engine passes `boss_pos`
            # into _fire_pattern before committing n_boss_pos)
            self.pos_boss_old = self.boss_pos.copy()
            reward, term = self._substep(movement_x, movement_y, fire)
            if term:
                return reward, True
        return reward, False


def bossfight_predict(level, rng_key, actions: Sequence[int],
                      mode: str = "hard"):
    """Exact per-step (reward, terminated) given the reset key the
    engine's state carries (state.game.rng after reset_pinned: int64
    [2] words)."""
    [out] = bossfight_predict_many([level], torch.as_tensor(rng_key)[None],
                                   [actions], mode)
    return out


def bossfight_predict_many(levels, rng_keys, actions, mode: str = "hard"):
    """`bossfight_predict` of each (levels[i], rng_keys[i], actions[i]),
    the draws of all of them made together (one `BossfightDraws`):
    [(rewards, terminated)]."""
    draws = BossfightDraws(rng_keys)
    out = []
    for i, (level, acts) in enumerate(zip(levels, actions)):
        sim = BossfightSim(level, mode=mode, draws=draws, row=i)
        rewards, terms = [], []
        for a in acts:
            r, t = sim.step(int(a))
            rewards.append(r)
            terms.append(t)
            if t:
                break
        out.append((np.asarray(rewards, f32), np.asarray(terms, bool)))
    return out
