"""BossfightRefSim: predict the EXECUTED reference bossfight binary (the
port's copy of procgen2_tpu/tools/bossfight_ref.py).

The bossfight step loop consumes mt19937 draws *while stepping* (boss
AI), so the keyed BossfightSim predictor (tools/predict.py) can only
mirror our own engine's draw schedule. This module closes that gap: a
scalar f32 transcription of the reference's step loop that consumes the
REAL libstdc++ mt19937 stream (native/rng_oracle.cpp) in the binary's
exact draw order, so its per-step reward stream predicts `cenv_step` of
`native/build/ref_bossfight.so` bit-exactly.

Draw schedule per sub-step (hard mode, the compile-time default,
games/bossfight/common_systems.h:64):

  System_Agent::update (common_systems.cpp:494-683)
    - per player bullet, newest-first, on shield bounce:
      uniform_real(-1, 1)                       (cs.cpp:636-638)
  System_Mob_AI::update (common_systems.cpp:199-388)
    - uniform_real(0, 1) shielded_phase_time jitter, EVERY call
      (cs.cpp:202)
    - uniform_int(0, 3) weapon at phase start   (cs.cpp:237-240)
    - fire_pattern draws (cs.cpp:103-185): passive 1 (+1 when fired),
      pattern 2/3 one on volley, pattern 0/1 none
    - show_damage: 2x uniform_real(-0.5, 0.5) on trigger
      (cs.cpp:187-197)
    - move retarget: 2x uniform_real(0, 1)      (cs.cpp:286-291)

Reset draws (bossfight.cpp:426-503) replay via the same handle before
stepping; trigonometry calls libm's cosf/sinf directly so bullet
velocities match the compiled float math bit-for-bit.
"""
from __future__ import annotations

import ctypes as ct

import numpy as np

from .predict import _collides
from .rng_oracle import Mt19937

f32 = np.float32
f64 = np.float64
M_PI = 3.141592653589793  # double, matches C's M_PI

_libm = ct.CDLL("libm.so.6")
_libm.cosf.restype = ct.c_float
_libm.cosf.argtypes = [ct.c_float]
_libm.sinf.restype = ct.c_float
_libm.sinf.argtypes = [ct.c_float]


def _cosf(x) -> f32:
    return f32(_libm.cosf(ct.c_float(float(x))))


def _sinf(x) -> f32:
    return f32(_libm.sinf(ct.c_float(float(x))))


class _Bullet:
    __slots__ = ("px", "py", "vx", "vy", "frame", "bouncing", "btimer")

    def __init__(self):
        self.px = self.py = f32(0.0)
        self.vx = self.vy = f32(0.0)
        self.frame = f32(-1.0)
        self.bouncing = False
        self.btimer = f32(0.0)


DT = f32(0.25)  # bossfight.cpp: 4 sub-steps of dt = 1/4
HALF = f32(2.0)  # 64 px * pixels_to_unit(1/16) * 0.5 per axis


class BossfightRefSim:
    """Seed-for-seed replay of ref_bossfight.so's reward stream."""

    def __init__(self, seed: int):
        self.rng = Mt19937(seed)
        self._replay_reset()

    def close(self):
        self.rng.close()

    # -- reset (bossfight.cpp:426-503) ----------------------------------
    def _replay_reset(self):
        r = self.rng
        # player spawn: spawn_dist * 64 / 1 * (1/16) * 0.5 — all
        # power-of-two factors, exactly u * 2 in f32
        u = f32(r.uniform_float(-1.0, 1.0))
        self.apx = f32(u * f32(2.0))
        self.apy = HALF
        self.avx = self.avy = f32(0.0)
        self.agent_alive = True
        self.a_btimer = f32(0.0)
        self.ab = [_Bullet() for _ in range(32)]
        self.ab_num = 0
        self.ab_next = 0

        # barriers (bossfight.cpp:448-487): rejected candidates leave a
        # zero rect in the overlap chain and draw NO texture
        self.barriers = []
        rects = []
        nb = r.uniform_int(1, 4)
        for _ in range(nb):
            bx = f32(f32(f32(r.uniform_float(-1.0, 1.0)) * f32(2.0))
                     * f32(0.9))
            by = f32(HALF - f32(r.uniform_float(0.7, 1.2)))
            rect = (f32(bx - f32(0.1)), f32(by - f32(0.1)),
                    f32(0.2), f32(0.2))
            clash = any(_collides(*rect, *o) for o in rects)
            if not clash:
                r.uniform_int(0, 7)  # barrier texture
                self.barriers.append((bx, by))
                rects.append(rect)
            else:
                rects.append((f32(0.0), f32(0.0), f32(0.0), f32(0.0)))

        r.uniform_int(0, 12)  # background index
        r.uniform_float()  # bg offset x
        r.uniform_float()  # bg offset y
        r.uniform_int(0, 3)  # agent ship texture
        r.uniform_int(0, 2)  # agent bullet texture
        r.uniform_int(0, 3)  # boss ship texture
        r.uniform_int(0, 2)  # boss bullet texture

        # boss (Component defaults + Mob_AI::reset, cs.cpp:452-468)
        self.bpx = self.bpy = f32(0.0)
        self.bvx = self.bvy = f32(0.0)
        self.phase_timer = f32(0.0)
        self.phase_index = 0
        self.weapon_index = 0
        self.attack_timer = f32(0.0)
        self.hp = 0
        self.move_timer = f32(0.0)
        self.damage_timer = f32(0.0)
        self.explosion_timer = f32(0.0)
        self.bb = [_Bullet() for _ in range(64)]
        self.bb_num = 0
        self.bb_next = 0

    # -- helpers ---------------------------------------------------------
    def _boss_rect(self):
        return (f32(self.bpx - f32(0.6)), f32(self.bpy - f32(0.4)),
                f32(1.2), f32(0.8))

    def _agent_rect(self):
        return (f32(self.apx - f32(0.15)), f32(self.apy - f32(0.1)),
                f32(0.3), f32(0.2))

    def _hazard_hit(self, rect):
        """Hazard order: boss (entity id 1) then barriers in creation
        order (std::set<Entity> iteration). Returns 'boss'/'barrier'/
        None for the FIRST overlap (the C++ loops break)."""
        if _collides(*rect, *self._boss_rect()):
            return "boss"
        for bx, by in self.barriers:
            if _collides(*rect, f32(bx - f32(0.1)), f32(by - f32(0.1)),
                         f32(0.2), f32(0.2)):
                return "barrier"
        return None

    def _fire(self, rot32):
        """System_Mob_AI::fire (common_systems.cpp:75-87)."""
        if self.bb_num < 64:
            b = self.bb[self.bb_next]
            b.px, b.py = self.bpx, self.bpy
            b.vx = f32(_cosf(rot32) * f32(0.1))
            b.vy = f32(f32(-_sinf(rot32)) * f32(0.1))
            b.frame = f32(0.0)
            b.bouncing = False
            b.btimer = f32(0.0)
            self.bb_next = (self.bb_next + 1) % 64
            self.bb_num += 1

    # -- System_Agent::update (common_systems.cpp:494-683) --------------
    def _agent_update(self, action: int) -> bool:
        r = self.rng
        mx = f32((action in (6, 7, 8)) - (action in (0, 1, 2)))
        my = f32((action in (2, 5, 8)) - (action in (0, 3, 6)))
        fire = action == 9

        self.avx = f32(self.avx + f32(f32(f32(0.5) * f32(
            f32(mx * f32(0.1)) - self.avx)) * DT))
        self.avy = f32(self.avy + f32(f32(f32(0.5) * f32(
            f32(f32(-my) * f32(0.1)) - self.avy)) * DT))
        self.apx = f32(self.apx + f32(self.avx * DT))
        self.apy = f32(self.apy + f32(self.avy * DT))

        # screen-edge clamp via the C++ incremental rect shifts
        wx = f32(self.apx + f32(-0.15))
        if wx < -HALF:
            self.apx = f32(self.apx + f32(-HALF - wx))
            self.avx = f32(0.0)
        elif f32(wx + f32(0.3)) > HALF:
            self.apx = f32(self.apx + f32(HALF - f32(wx + f32(0.3))))
            self.avx = f32(0.0)
        wy = f32(self.apy + f32(-0.1))
        if wy < -HALF:
            self.apy = f32(self.apy + f32(-HALF - wy))
            self.avy = f32(0.0)
        elif f32(wy + f32(0.2)) > HALF:
            self.apy = f32(self.apy + f32(HALF - f32(wy + f32(0.2))))
            self.avy = f32(0.0)

        if fire:
            if self.a_btimer == 0.0 and self.ab_num < 32:
                self.a_btimer = f32(5.0)
                b = self.ab[self.ab_next]
                b.px, b.py = self.apx, self.apy
                b.vx, b.vy = f32(0.0), f32(-0.1)
                b.frame = f32(0.0)
                b.bouncing = False
                b.btimer = f32(0.0)
                self.ab_next = (self.ab_next + 1) % 32
                self.ab_num += 1
            else:
                self.a_btimer = f32(max(f32(0.0), f32(self.a_btimer - DT)))

        if self._hazard_hit(self._agent_rect()) is not None:
            self.agent_alive = False

        shielded = self.phase_index % 2 == 0
        # player bullets, newest-first; num_bullets shrinks mid-loop on
        # destroy (the C++ `for (i; i < num_bullets; i++)` re-reads it)
        i = 0
        while i < self.ab_num:
            b = self.ab[(32 + self.ab_next - 1 - i) % 32]
            i += 1
            if b.frame == -1.0:
                continue
            if b.frame == 0.0:
                rect = (f32(b.px - f32(0.01)), f32(b.py - f32(0.01)),
                        f32(0.02), f32(0.02))
                if not _collides(*rect, -HALF, -HALF, f32(4.0), f32(4.0)):
                    b.vx = b.vy = f32(0.0)
                    b.frame = f32(5.0)
                else:
                    hit = self._hazard_hit(rect)
                    if hit == "boss":
                        if shielded:
                            u = f32(r.uniform_float(-1.0, 1.0))
                            b.vx = f32(u * f32(0.05))
                            b.vy = f32(0.05)
                            b.btimer = f32(10.0)
                            b.bouncing = True
                        else:
                            b.vx = b.vy = f32(0.0)
                            b.frame = f32(1.0)
                            if self.hp > 0:
                                self.hp -= 1
                    elif hit == "barrier":
                        b.vx = b.vy = f32(0.0)
                        b.frame = f32(1.0)
            b.px = f32(b.px + f32(b.vx * DT))
            b.py = f32(b.py + f32(b.vy * DT))
            destroy = False
            if b.frame >= 5.0:
                destroy = True
            elif b.frame >= 1.0:
                b.frame = f32(b.frame + f32(f32(0.3) * DT))
            if b.bouncing:
                if b.btimer > 0.0:
                    b.btimer = f32(max(f32(0.0), f32(b.btimer - DT)))
                else:
                    destroy = True
            if destroy:
                self.ab_num -= 1
                b.frame = f32(-1.0)
        return self.agent_alive

    # -- fire_pattern (common_systems.cpp:103-185) -----------------------
    def _fire_pattern(self, pattern: int):
        r = self.rng
        if pattern == -1:
            u1 = f32(r.uniform_float())
            if u1 < f32(f32(0.1) * DT):
                u2 = f32(r.uniform_float())
                self._fire(f32(M_PI * f64(f32(f32(1.0) + u2))))
            return
        threshold = {0: f32(8.0), 1: f32(5.0), 2: f32(10.0),
                     3: f32(4.0)}[pattern]
        if self.attack_timer >= threshold:
            self.attack_timer = f32(0.0)
            if pattern == 0:
                for i in range(5):
                    self._fire(f32(M_PI * 1.5 + (i - 2) * M_PI * 0.125))
            elif pattern == 1:
                k = 8  # timer zeroed before the k computation, cs.cpp:136
                kf = f32(f32(1.25) + f32(k * 0.0625))
                for i in range(4):
                    self._fire(f32(M_PI * f64(kf) + i * M_PI * 0.5))
            elif pattern == 2:
                u = f32(r.uniform_float())
                offset = f32(f64(f32(u * f32(2.0))) * M_PI)
                for i in range(8):
                    self._fire(f32(M_PI * 0.25 * i + f64(offset)))
            else:
                u = f32(r.uniform_float())
                self._fire(f32(M_PI * f64(f32(f32(1.0) + u))))
        else:
            self.attack_timer = f32(self.attack_timer + DT)

    # -- System_Mob_AI::update (common_systems.cpp:199-388) --------------
    def _mob_update(self) -> bool:
        r = self.rng
        u_shield = f32(r.uniform_float())
        shielded_phase_time = f32(f32(180.0) + f32(u_shield * f32(80.0)))

        if self.phase_timer == 0.0:
            self.weapon_index = r.uniform_int(0, 3)
            self.attack_timer = f32(0.0)
            self.hp = 3

        shielded = self.phase_index % 2 == 0
        if shielded:
            if self.phase_timer >= shielded_phase_time:
                self.phase_timer = f32(0.0)
                self.phase_index += 1
            else:
                self.phase_timer = f32(self.phase_timer + DT)
            self._fire_pattern(self.weapon_index)
        else:
            if self.phase_timer >= f32(300.0):
                self.phase_timer = f32(0.0)
                self.phase_index += 1
            else:
                self.phase_timer = f32(self.phase_timer + DT)
            self._fire_pattern(-1)
            if self.hp == 0:
                # show_damage (cs.cpp:187-197)
                if self.explosion_timer >= f32(8.0):
                    self.explosion_timer = f32(0.0)
                    r.uniform_float(-0.5, 0.5)  # explosion x
                    r.uniform_float(-0.5, 0.5)  # explosion y
                else:
                    self.explosion_timer = f32(self.explosion_timer + DT)
                if self.damage_timer >= f32(80.0):
                    self.damage_timer = f32(0.0)
                    self.phase_index += 1
                    self.hp = 3
                else:
                    self.damage_timer = f32(self.damage_timer + DT)

        if self.move_timer >= f32(70.0):
            self.move_timer = f32(0.0)
            ux = f32(r.uniform_float())
            uy = f32(r.uniform_float())
            tx = f32(f32(f32(f32(f32(ux * f32(2.0)) - f32(1.0))
                             * f32(0.5)) * f32(4.0)) * f32(0.7))
            ty = f32(f32(f32(f32(f32(f32(uy * f32(2.0)) - f32(1.0))
                                 * f32(0.5)) - f32(0.3)) * f32(4.0))
                     * f32(0.5))
            self.bvx = f32(f32(tx - self.bpx) / f32(70.0))
            self.bvy = f32(f32(ty - self.bpy) / f32(70.0))
        else:
            self.move_timer = f32(self.move_timer + DT)
        self.bpx = f32(self.bpx + f32(self.bvx * DT))
        self.bpy = f32(self.bpy + f32(self.bvy * DT))

        # boss bullets, newest-first; agent hit breaks the whole loop
        # BEFORE moving that bullet (cs.cpp:311-329)
        agent_rect = self._agent_rect()
        i = 0
        while i < self.bb_num:
            b = self.bb[(64 + self.bb_next - 1 - i) % 64]
            i += 1
            if b.frame == -1.0:
                continue
            if b.frame == 0.0:
                rect = (f32(b.px - f32(0.01)), f32(b.py - f32(0.01)),
                        f32(0.02), f32(0.02))
                if not _collides(*rect, -HALF, -HALF, f32(4.0), f32(4.0)):
                    b.vx = b.vy = f32(0.0)
                    b.frame = f32(5.0)
                else:
                    if _collides(*rect, *agent_rect):
                        b.vx = b.vy = f32(0.0)
                        b.frame = f32(1.0)
                        self.agent_alive = False
                        break
                    for bx, by in self.barriers:
                        if _collides(*rect, f32(bx - f32(0.1)),
                                     f32(by - f32(0.1)), f32(0.2),
                                     f32(0.2)):
                            b.vx = b.vy = f32(0.0)
                            b.frame = f32(1.0)
                            break
            b.px = f32(b.px + f32(b.vx * DT))
            b.py = f32(b.py + f32(b.vy * DT))
            if b.frame >= 5.0:
                self.bb_num -= 1
                b.frame = f32(-1.0)
            elif b.frame >= 1.0:
                b.frame = f32(b.frame + f32(f32(0.3) * DT))

        return self.phase_index < 6  # cs.cpp:384-385

    # -- cenv_step (bossfight.cpp:293-325) -------------------------------
    def step(self, action: int):
        """One env step: 4 sub-steps with early exit; returns
        (reward f32, terminated) matching cenv_step's step_data."""
        reward, term = f32(0.0), False
        for _ in range(4):
            agent_alive = self._agent_update(action)
            boss_alive = self._mob_update()
            reward = f32(f32((not agent_alive) * -10.0)
                         + f32((not boss_alive) * 10.0))
            term = (not agent_alive) or (not boss_alive)
            if term:
                break
        return reward, term
