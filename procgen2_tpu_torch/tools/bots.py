"""Scripted bots + independent reward predictors for the parity suite
(procgen2_tpu/tools/bots.py, the port's own copy; numpy only).

BASELINE.md demands bit-exact fixed-seed *episode-return* parity. For
each game this module provides (a) a route/action planner that scripts a
scoring trajectory from the oracle-pinned reference layout alone, and
(b) where the game's kinematics allow it, an independent numpy
re-derivation of the reference's reward/termination rules
(games/<g>/<g>.cpp step loops) that predicts the exact per-step reward
sequence for those scripted actions — so the parity tests compare the
engine against a *second implementation* of the reference rules, not
against itself. The bots and predictors take numpy leaves
(`reference_levels.host_level`, and the state fields read back with
`.cpu().numpy()`).

All coordinates are render coords ([row, col]; row 0 at the top) unless
noted — the same frame the engine Levels use (tools/reference_levels.py).
"""
from __future__ import annotations

from collections import deque
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .scripted import (
    DOWN, LEFT, NOOP, RIGHT, UP, UP_LEFT, UP_RIGHT, bfs_cell_path,
)

f32 = np.float32


# ---------------------------------------------------------------------------
# coinrun (games/coinrun/coinrun.cpp:357-371, common_systems.cpp:121-252)
# ---------------------------------------------------------------------------


class CoinrunBot:
    """Run right to the coin, jumping elevation steps and pits.

    Terrain is pure elevation (sections, no overhangs) with crates
    standable from above (DOWN_ONLY) and lava/saw/mob hazards in pits
    (games/coinrun/tilemap.cpp:97-292), so a reactive right-runner with
    a two-column lookahead suffices; hazard-fatal seeds are filtered by
    the search (determinism makes the pinned set stable)."""

    SOLID = (1, 2, 5)  # WALL_TOP, WALL_MID, CRATE
    LAVA = (3, 4)

    def __init__(self, level):
        self.grid = np.asarray(level.grid)
        self.H, self.W = self.grid.shape
        self.coin_x = float(level.coin_pos[0])

    def _ground(self, col: int, y: float) -> Optional[int]:
        """Walking-surface row for `col` near height y: topmost solid in
        [y-6, bottom]; None for a pit floored by lava or nothing."""
        if col >= self.W:
            return None
        top = max(0, int(y) - 6)
        for r in range(top, self.H):
            t = self.grid[r, col]
            if t in self.SOLID:
                return r
            if t in self.LAVA:
                return None
        return None

    def act(self, pos, vel, on_ground, _unused=None) -> int:
        x, y = float(pos[0]), float(pos[1])
        if x >= self.coin_x - 0.6:
            return RIGHT  # touch-down on the coin column
        if not on_ground:
            return RIGHT  # carry every jump rightward
        c = int(x)
        g1 = self._ground(c + 1, y)
        g2 = self._ground(c + 2, y)
        # step up ahead: jump when close enough for the drift to carry
        if g1 is not None and g1 < int(round(y)) - 0:
            if x > c + 0.3:
                return JUMP_R
            return RIGHT
        # pit ahead (no ground / lava / drop > 2): running jump from the
        # edge once at speed
        drop1 = None if g1 is None else g1 - int(round(y))
        drop2 = None if g2 is None else g2 - int(round(y))
        pit = (g1 is None or (drop1 is not None and drop1 > 2)
               or g2 is None or (drop2 is not None and drop2 > 2))
        if pit:
            if vel[0] > 0.45 and x > c + 0.4:
                return JUMP_R
            return RIGHT
        return RIGHT


# ---------------------------------------------------------------------------
# bossfight (games/bossfight/bossfight.cpp:309-324, common_systems.cpp)
# ---------------------------------------------------------------------------


class BossfightBot:
    """Kill the boss through its full phase machine: hide in a barrier's
    shadow (barriers absorb boss bullets, common_systems.cpp:340-350)
    while shielded, step out and volley straight-up bullets while
    unshielded (3 HP per round, 3 rounds -> phase_index 6 = +10,
    common_systems.cpp:199-287), dodging incoming bullets throughout.
    Needs >=1 barrier; barrier-less seeds are filtered by the search."""

    FIRE = 9
    HALF = 2.0

    def __init__(self, level):
        self.barriers = [
            (float(level.barrier_pos[s, 0]), float(level.barrier_pos[s, 1]))
            for s in range(level.barrier_exists.shape[0])
            if level.barrier_exists[s]
        ]

    def _move_toward(self, pos, tx, ty, tol=0.06) -> int:
        dx, dy = tx - float(pos[0]), ty - float(pos[1])
        if abs(dx) < tol and abs(dy) < tol:
            return NOOP
        if abs(dx) >= abs(dy):
            return RIGHT if dx > 0 else LEFT
        return DOWN if dy > 0 else UP

    _DIRS = {NOOP: (0.0, 0.0), LEFT: (-1.0, 0.0), RIGHT: (1.0, 0.0),
             UP: (0.0, -1.0), DOWN: (0.0, 1.0), FIRE: (0.0, 0.0)}

    def _safety(self, a, pos, boss_pos, threats) -> float:
        """Score an action by the clearance its short-horizon position
        keeps from barriers, the boss hitbox, and incoming bullets."""
        dx, dy = self._DIRS[a]
        px = float(np.clip(pos[0] + 0.14 * dx, -self.HALF + 0.15,
                           self.HALF - 0.15))
        py = float(np.clip(pos[1] + 0.14 * dy, -self.HALF + 0.1,
                           self.HALF - 0.1))
        score = 0.0
        for hx, hy in self.barriers:
            d = max(abs(px - hx) - 0.25, abs(py - hy) - 0.2)
            if d < 0.06:
                score -= 1000.0
            elif d < 0.2:
                score -= (0.2 - d)
        bd = max(abs(px - float(boss_pos[0])) - 0.78,
                 abs(py - float(boss_pos[1])) - 0.55)
        if bd < 0.06:
            score -= 900.0
        mind = 10.0
        for bx, by, bvx, bvy in threats:
            # bullet two env steps ahead
            fx, fy = bx + bvx * 8.0, by + bvy * 8.0
            mind = min(mind,
                       float(np.hypot(px - bx, py - by)),
                       float(np.hypot(px - fx, py - fy)))
        return score + min(mind, 1.2)

    def _threats(self, pos, bb_pos, bb_vel, bb_frame):
        x, y = float(pos[0]), float(pos[1])
        out = []
        for i in range(bb_pos.shape[0]):
            if bb_frame[i] != 0.0:
                continue
            bx, by = float(bb_pos[i, 0]), float(bb_pos[i, 1])
            if np.hypot(bx - x, by - y) < 1.1:
                out.append((bx, by, float(bb_vel[i, 0]), float(bb_vel[i, 1])))
        return out

    def _shadow_point(self, boss_pos):
        """Stand on the boss->barrier ray, 0.45 past the barrier."""
        bx, by = float(boss_pos[0]), float(boss_pos[1])
        # pick the barrier most below the boss
        best = max(self.barriers, key=lambda b: b[1] - by)
        px, py = best
        vx, vy = px - bx, py - by
        n = float(np.hypot(vx, vy)) or 1.0
        sx = px + vx / n * 0.5
        sy = py + vy / n * 0.5
        sx = float(np.clip(sx, -self.HALF + 0.2, self.HALF - 0.2))
        sy = float(np.clip(sy, -self.HALF + 0.15, self.HALF - 0.15))
        return sx, sy

    def _clear_column(self, x, y, boss_pos) -> bool:
        """No barrier between the agent and the boss straight up
        (player bullets die on barriers, common_systems.cpp:620-630)."""
        for px, py in self.barriers:
            if abs(px - x) < 0.13 and py < y and py > float(boss_pos[1]):
                return False
        return True

    def act(self, pos, vel, boss_pos, phase_index, bb_pos, bb_vel,
            bb_frame) -> int:
        shielded = int(phase_index) % 2 == 0
        x, y = float(pos[0]), float(pos[1])
        if shielded:
            sx, sy = self._shadow_point(boss_pos)
            intended = self._move_toward(pos, sx, sy)
        else:
            # unshielded: align the column with the boss and fire
            tx = float(boss_pos[0])
            if abs(x - tx) < 0.3 and self._clear_column(x, y, boss_pos) \
                    and y > float(boss_pos[1]) + 0.7:
                intended = self.FIRE
            else:
                ty = min(self.HALF - 0.3, max(y, float(boss_pos[1]) + 1.2))
                intended = self._move_toward(pos, tx, ty, tol=0.15)
        # safety overlay: keep the intended action unless a clearly
        # safer move exists (bullets closing in, barrier/boss contact)
        threats = self._threats(pos, bb_pos, bb_vel, bb_frame)
        s_int = self._safety(intended, pos, boss_pos, threats)
        best_a, best_s = intended, s_int
        for a in (NOOP, LEFT, RIGHT, UP, DOWN):
            s = self._safety(a, pos, boss_pos, threats)
            if s > best_s + 1e-9:
                best_a, best_s = a, s
        if s_int >= best_s - 0.06:
            return intended
        return best_a


# ---------------------------------------------------------------------------
# caveflyer (games/caveflyer/caveflyer.cpp:317-332, common_systems.cpp)
# ---------------------------------------------------------------------------


def _wrap_angle(a: float) -> float:
    while a > np.pi:
        a -= 2 * np.pi
    while a < -np.pi:
        a += 2 * np.pi
    return a


class CaveflyerBot:
    """Shoot a line-of-sight red-UFO target (+3), then fly the BFS path
    to the green-UFO goal (+10). Ship dynamics: spin 0.05/step, thrust
    along heading with velocity decay (terminal speed 0.5 units/time),
    bullets 1.0 units/time dying on walls/meteors (games/caveflyer/
    common_systems.cpp:119-156, 216-280). Walls stop but don't kill;
    meteors/targets/enemies kill on contact, so the flight keeps off
    hazards and the pinned seeds exclude enemy ambushes."""

    FIRE = 9

    def __init__(self, level):
        self.wall = np.asarray(level.wall)
        self.D = self.wall.shape[0]
        self.goal = (float(level.goal_pos[0]), float(level.goal_pos[1]))
        self.obst = [
            (float(level.obst_pos[s, 0]), float(level.obst_pos[s, 1]))
            for s in range(level.obst_exists.shape[0])
            if level.obst_exists[s]
        ]
        self.targets = [
            (s, float(level.target_pos[s, 0]), float(level.target_pos[s, 1]))
            for s in range(level.target_exists.shape[0])
            if level.target_exists[s]
        ]
        self.mode = "travel"
        self.hunt_slot = None
        self.kills_done = False
        self.given_up = set()
        self.aim_steps = 0
        self.path = None
        self.k = 0

    @staticmethod
    def _bullet_flight(x, y, r, tx, ty):
        """Sub-steps until a bullet from (x, y) at heading r first
        overlaps the target's 0.5-box (probe 0.02, so |d| < 0.26 per
        axis — games/caveflyer.py bullet/target test). None if it never
        does within 60 sub-steps."""
        dx, dy = float(np.cos(r)) * 0.25, float(np.sin(r)) * 0.25
        bx, by = x, y
        for k in range(60):
            if abs(bx - tx) < 0.255 and abs(by - ty) < 0.255:
                return k
            bx += dx
            by += dy
        return None

    def _clear_ray(self, x0, y0, x1, y1, skip_slot=None) -> bool:
        """No wall cell or meteor rect on the segment (bullet survival)."""
        d = float(np.hypot(x1 - x0, y1 - y0))
        n = max(2, int(d / 0.1))
        for i in range(n + 1):
            t = i / n
            x, y = x0 + (x1 - x0) * t, y0 + (y1 - y0) * t
            cx, ry = int(x), int(y)
            if not (0 <= cx < self.D and 0 <= ry < self.D) \
                    or self.wall[ry, cx]:
                return False
            for ox, oy in self.obst:
                if abs(x - ox) < 0.3 and abs(y - oy) < 0.3:
                    return False
        return True

    def _pick_target(self, x, y, target_alive):
        best = None
        for s, tx, ty in self.targets:
            if not target_alive[s] or s in self.given_up:
                continue
            d = float(np.hypot(tx - x, ty - y))
            if d < 1.6 or d > 6.0 or not self._clear_ray(x, y, tx, ty):
                continue
            if best is None or d < best[0]:
                best = (d, s, tx, ty)
        return best

    def _ensure_path(self, x, y, target_alive):
        blocked = self.wall.copy()
        # keep the route off contact hazards (meteors + live targets,
        # _hazard_hit in games/caveflyer.py); enemies move, not mapped
        for ox, oy in self.obst:
            self._block_near(blocked, ox, oy)
        for s, tx, ty in self.targets:
            if target_alive[s]:
                self._block_near(blocked, tx, ty)
        start = (int(y), int(x))
        goal = (int(self.goal[1]), int(self.goal[0]))
        blocked[start] = False
        blocked[goal] = False
        self.path = bfs_cell_path(blocked.astype(np.int8), start, goal)
        if self.path is None:  # hazard-padded grid disconnected: raw walls
            self.path = bfs_cell_path(
                self.wall.astype(np.int8), start, goal
            )
        self.k = 0

    def _block_near(self, blocked, hx, hy):
        for rr in range(int(hy) - 1, int(hy) + 2):
            for cc in range(int(hx) - 1, int(hx) + 2):
                if 0 <= rr < self.D and 0 <= cc < self.D:
                    if abs(rr + 0.5 - hy) < 1.2 and abs(cc + 0.5 - hx) < 1.2:
                        blocked[rr, cc] = True

    def act(self, pos, vel, rot, target_alive) -> int:
        x, y = float(pos[0]), float(pos[1])
        r = float(rot)
        speed = float(np.hypot(vel[0], vel[1]))

        if self.mode == "aim":
            s = self.hunt_slot
            if s is None or not target_alive[s] or self.aim_steps > 120:
                if s is not None and target_alive[s]:
                    self.given_up.add(s)  # unkillable from here; move on
                self.kills_done = True
                self.mode = "travel"
                self.path = None
            else:
                self.aim_steps += 1
                tx, ty = self.hunt_xy
                want = float(np.arctan2(ty - y, tx - x))
                e = _wrap_angle(want - r)
                if abs(e) >= 0.035:
                    return RIGHT if e > 0 else LEFT  # pure rotation
                k = self._bullet_flight(x, y, r, tx, ty)
                # Fire only when the impact lands on sub-step 4: the
                # reference reassigns reward every sub-step
                # (caveflyer.cpp:330 last-write-wins), so a +3 landing
                # on sub-steps 1-3 is overwritten by 0.0 and never
                # observed. Impact sub-step is (k mod 4)+1 for a bullet
                # spawned on sub-step 1 after k flight sub-steps.
                if k is not None and k % 4 == 3:
                    return self.FIRE
                if speed < 0.06:
                    return UP  # creep forward into the visibility band
                return NOOP

        # travel mode: opportunistic hunt, then waypoint flight
        t = self._pick_target(x, y, target_alive)
        if t is not None:
            # brake only while actually moving along the heading —
            # reverse thrust accelerates backward otherwise
            vdoth = float(vel[0]) * np.cos(r) + float(vel[1]) * np.sin(r)
            if speed > 0.35 and vdoth > 0:
                return DOWN
            if speed > 0.15:
                return NOOP  # velocity decay bleeds the rest
            _, s, tx, ty = t
            self.hunt_slot, self.hunt_xy = s, (tx, ty)
            self.mode = "aim"
            self.aim_steps = 0
            return self.act(pos, vel, rot, target_alive)

        if self.path is None:
            self._ensure_path(x, y, target_alive)
            if self.path is None:
                return NOOP
        while self.k + 1 < len(self.path):
            wr, wc = self.path[self.k]
            if abs(x - (wc + 0.5)) < 0.8 and abs(y - (wr + 0.5)) < 0.8:
                self.k += 1
            else:
                break
        wr, wc = self.path[min(self.k + 2, len(self.path) - 1)]
        wx, wy = wc + 0.5, wr + 0.5
        want = float(np.arctan2(wy - y, wx - x))
        e = _wrap_angle(want - r)
        # brake if moving fast the wrong way
        if speed > 0.45 and abs(_wrap_angle(
                float(np.arctan2(vel[1], vel[0])) - want)) > 0.9:
            return DOWN  # reverse thrust, no rotation
        if abs(e) > 0.35:
            return RIGHT if e > 0 else LEFT
        if speed < 0.42:
            return UP_RIGHT if e > 0.05 else (UP_LEFT if e < -0.05 else UP)
        return RIGHT if e > 0.05 else (LEFT if e < -0.05 else NOOP)


# ---------------------------------------------------------------------------
# jumper (games/jumper/jumper.cpp:355-369, common_systems.cpp:57-201)
# ---------------------------------------------------------------------------


class JumperBot:
    """Waypoint-follower along the BFS agent->goal path (the generation
    keeps it open: room pruned to the path Moore-dilated 4x,
    games/jumper/tilemap.cpp:176-188). Full air control (air_control=1,
    common_systems.cpp:66) makes x track waypoints in flight; the double
    jump (jumps_left=2, cooldown 3 env steps) climbs shafts. Spike cells
    are excluded from the path (spikes terminate, jumper.cpp:362-364)."""

    def __init__(self, level):
        grid = np.asarray(level.grid)
        spikes = np.asarray(level.spike_grid)
        self.D = grid.shape[0]
        blocked = (grid != 0) | spikes
        a = (int(level.agent_pos[1]), int(level.agent_pos[0]))
        g = (int(level.goal_pos[1]), int(level.goal_pos[0]))
        self.path = bfs_cell_path(blocked.astype(np.int8), a, g)
        self.k = 0  # next waypoint index

    def act(self, pos, vel, on_ground, jumps_left, jump_timer) -> int:
        if self.path is None:
            return NOOP
        x, y = float(pos[0]), float(pos[1])
        # advance waypoints: take the furthest path cell we're inside
        while self.k + 1 < len(self.path):
            r, c = self.path[self.k]
            if abs(x - (c + 0.5)) < 0.6 and abs(y - (r + 0.5)) < 0.8:
                self.k += 1
            else:
                break
        r, c = self.path[min(self.k, len(self.path) - 1)]
        tx, ty = c + 0.5, r + 0.5
        dx = tx - x
        side = 0 if abs(dx) < 0.12 else (1 if dx > 0 else -1)
        need_up = ty < y - 0.3
        can_jump = int(jumps_left) > 0 and float(jump_timer) == 0.0
        rising = float(vel[1]) < -0.25
        if need_up and can_jump and (bool(on_ground) or not rising):
            return (JUMP_L, JUMP_N, JUMP_R)[side + 1]
        return (LEFT, NOOP, RIGHT)[side + 1]

CHASER_STEPS_PER_CELL = 5  # speed 0.2/env-step, 1 unit per cell


def _bfs_dist(free: np.ndarray, src: Tuple[int, int]) -> np.ndarray:
    H, W = free.shape
    dist = np.full((H, W), -1, np.int32)
    dist[src] = 0
    q = deque([src])
    while q:
        y, x = q.popleft()
        for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
            ny, nx = y + dy, x + dx
            if 0 <= ny < H and 0 <= nx < W and free[ny, nx] \
                    and dist[ny, nx] < 0:
                dist[ny, nx] = dist[y, x] + 1
                q.append((ny, nx))
    return dist


def chaser_full_route(level) -> List[Tuple[int, int]]:
    """Cell route visiting EVERY point (pellet + orb) cell.

    Nearest-unvisited chaining over BFS distances; cells crossed en
    route count as visited (the 0.8-unit pellet pickup fires for every
    cell entered, games/chaser/common_systems.cpp:88-101). Returns the
    full cell sequence starting at the agent spawn.
    """
    wall = np.asarray(level.wall)
    free = ~wall
    D = wall.shape[0]
    pellets = np.asarray(level.point_grid0)
    targets = {
        (r, c) for r in range(D) for c in range(D) if pellets[r, c]
    }
    for slot in range(level.orb_exists.shape[0]):
        if level.orb_exists[slot]:
            ox, oy = level.orb_pos[slot]
            targets.add((int(oy), int(ox)))

    cur = (int(level.agent_pos[1]), int(level.agent_pos[0]))
    route = [cur]
    targets.discard(cur)
    while targets:
        dist = _bfs_dist(free, cur)
        best = min(
            targets,
            key=lambda t: (int(dist[t]) if dist[t] >= 0 else 1 << 30, t),
        )
        if dist[best] < 0:  # unreachable point cell: generation bug
            raise AssertionError(f"unreachable point cell {best}")
        seg = bfs_cell_path((~free).astype(np.int8), cur, best)
        assert seg is not None
        for cell in seg[1:]:
            route.append(cell)
            targets.discard(cell)
        cur = best
    return route


def route_to_actions(route: Sequence[Tuple[int, int]],
                     steps_per_cell: int) -> List[int]:
    """Hold the segment direction for `steps_per_cell` env steps per
    transition (queued-turn movement engages at cell centers)."""
    acts: List[int] = []
    for (y0, x0), (y1, x1) in zip(route, route[1:]):
        if x1 > x0:
            a = RIGHT
        elif x1 < x0:
            a = LEFT
        elif y1 > y0:
            a = DOWN
        else:
            a = UP
        acts.extend([a] * steps_per_cell)
    return acts


class _ChaserSim:
    """Numpy f32 mirror of the engine's agent + point systems
    (games/chaser.py:_agent_substep/_collect_points, themselves cited
    line-by-line to games/chaser/common_systems.cpp). Enemies are NOT
    simulated — predictions are valid only for trajectories where no
    enemy contact occurs (the parity seeds are chosen so)."""

    SPEED = f32(0.2)  # common_systems.cpp:309
    DT = f32(0.25)  # chaser.cpp:44-45
    EPS = f32(0.2) * f32(0.25)
    INPUT_RESET = f32(2.5)  # common_systems.cpp:310

    def __init__(self, level):
        self.wall = np.asarray(level.wall)
        self.D = self.wall.shape[0]
        self.pos = np.asarray(level.agent_pos, f32).copy()
        self.vel = np.zeros(2, f32)
        self.next_vel = np.zeros(2, f32)
        self.input_timer = f32(0.0)
        self.pellets = np.asarray(level.point_grid0).copy()
        self.orb_pos = np.asarray(level.orb_pos, f32)
        self.orb_live = np.asarray(level.orb_exists).copy()

    def _wall_at(self, cx: int, ry: int) -> bool:
        if 0 <= cx < self.D and 0 <= ry < self.D:
            return bool(self.wall[ry, cx])
        return True

    def _agent_substep(self, a: int) -> None:
        mx = f32((a == 7) - (a == 1))
        my = f32((a == 3) - (a == 5))
        if mx != 0.0:
            my = f32(0.0)
        if mx != 0.0 or my != 0.0:
            self.next_vel = np.array([mx, my], f32)
            self.input_timer = f32(0.0)

        px, py = self.pos
        ix, iy = int(px), int(py)
        # The reference's centering gate calls the GLOBAL ::abs, which
        # binds to abs(int) (no float overload in scope at
        # common_systems.cpp:346-420): the float offset truncates to 0
        # and the gate is ALWAYS TRUE — turns/stops engage from
        # anywhere in the cell (see games/chaser.py:_agent_substep).
        nv = self.next_vel
        turn_x = (
            (nv[0] > 0 and not self._wall_at(ix + 1, iy))
            or (nv[0] < 0 and not self._wall_at(ix - 1, iy))
        )
        turn_y = (
            (nv[1] > 0 and not self._wall_at(ix, iy + 1))
            or (nv[1] < 0 and not self._wall_at(ix, iy - 1))
        )
        if turn_x:
            py = f32(iy + 0.5)
        if turn_y:
            px = f32(ix + 0.5)
        if turn_x or turn_y:
            self.vel = nv.copy()

        ix, iy = int(px), int(py)
        v = self.vel
        stop_x = (
            (v[0] < 0 and self._wall_at(ix - 1, iy))
            or (v[0] > 0 and self._wall_at(ix + 1, iy))
        )
        stop_y = (
            (v[1] < 0 and self._wall_at(ix, iy - 1))
            or (v[1] > 0 and self._wall_at(ix, iy + 1))
        )
        if stop_x:
            px = f32(ix + 0.5)
            self.vel = self.vel * np.array([0, 1], f32)
        if stop_y:
            py = f32(iy + 0.5)
            self.vel = self.vel * np.array([1, 0], f32)

        px = f32(px + f32(self.vel[0] * self.SPEED) * self.DT)
        py = f32(py + f32(self.vel[1] * self.SPEED) * self.DT)
        self.pos = np.array([px, py], f32)

        if self.input_timer >= self.INPUT_RESET:
            self.next_vel = np.zeros(2, f32)
        else:
            self.input_timer = f32(self.input_timer + self.DT)

    @staticmethod
    def _overlap(ax, ay, aw, ah, bx, by, bw, bh) -> bool:
        """check_collision's exact f32 expression (helpers.cpp:40-46);
        the algebraically-equal |center delta| form rounds differently
        at boundary events and shifts the collection sub-step (caught
        by executing the compiled reference engine)."""
        return bool(
            (ax < f32(bx + bw)) and (f32(ax + aw) > bx)
            and (ay < f32(by + bh)) and (f32(ay + ah) > by)
        )

    def _collect(self) -> Tuple[int, int]:
        ax = f32(self.pos[0] - f32(0.5))
        ay = f32(self.pos[1] - f32(0.5))
        delta = 0
        for r in range(self.D):
            for c in range(self.D):
                if self.pellets[r, c] and self._overlap(
                    ax, ay, f32(1.0), f32(1.0),
                    f32(f32(c + 0.5) - f32(0.3)), f32(f32(r + 0.5) - f32(0.3)),
                    f32(0.6), f32(0.6),
                ):
                    self.pellets[r, c] = False
                    delta += 1
        for s in range(self.orb_live.shape[0]):
            if self.orb_live[s] and self._overlap(
                ax, ay, f32(1.0), f32(1.0),
                f32(self.orb_pos[s, 0] - f32(0.5)),
                f32(self.orb_pos[s, 1] - f32(0.5)), f32(1.0), f32(1.0),
            ):
                self.orb_live[s] = False
                delta += 1
        available = int(self.pellets.sum()) + int(self.orb_live.sum())
        return delta, available

    def step(self, a: int) -> Tuple[f32, bool]:
        """One env step = 4 sub-steps, reward last-write-wins, break on
        terminal (chaser.cpp:296-312)."""
        reward = f32(0.0)
        for _ in range(4):
            self._agent_substep(a)
            delta, available = self._collect()
            reward = f32(
                f32(f32(delta) * f32(0.04)) + f32(available == 0) * f32(10.0)
            )
            if available == 0:
                return reward, True
        return reward, False


# ---------------------------------------------------------------------------
# climber (games/climber/climber.cpp:339-355, common_systems.cpp:184-269)
# ---------------------------------------------------------------------------

JUMP_L, JUMP_N, JUMP_R = 2, 5, 8  # jump bits of the 3x3 action grid


class ClimberBot:
    """Closed-loop ascent bot: walk to each platform's crystal, then to
    a launch cell, running-jump onto the next platform; repeat to the
    top. Reads only the engine state it is driving (pos/vel/on_ground/
    point_taken) — the reward assertions stay layout-derived."""

    def __init__(self, level):
        grid = np.asarray(level.grid)  # [64, 20] render rows
        H = grid.shape[0]
        # Platforms: WALL_TOP rows above the floor (row H-1); one per row
        # (generation increases curr_y by >=3 per platform).
        self.plat_rows: List[int] = []
        self.plat_cells = {}
        for r in range(H - 2, 0, -1):
            cols = np.nonzero(grid[r] == 1)[0]  # WALL_TOP == 1
            if len(cols) and not (grid[r][1:-1] == 2).any():
                self.plat_rows.append(r)
                self.plat_cells[r] = cols
        # crystal per platform row (crystal sits one unit above the row)
        self.crystals = {}
        pts = np.asarray(level.point_pos)
        for s in range(level.point_exists.shape[0]):
            if level.point_exists[s]:
                # crystal center y = plat_row - 0.5, so +0.5 -> plat row
                r = int(pts[s, 1] + 0.5)
                self.crystals[r] = (s, float(pts[s, 0]))
        self.stage = 0  # index into plat_rows (next platform to reach)
        self.phase = "climb"  # climb -> (crystal) -> climb ...
        self.floor_row = H - 1

    def _launch_plan(self, cur_row: int, nxt_row: int):
        """(launch_x, land_x): launch column on cur_row that is NOT
        covered by the next platform (tiles are FULL colliders — jumping
        from directly below bumps the head), as close as possible to a
        landing cell of nxt_row."""
        nxt = set(int(c) for c in self.plat_cells[nxt_row])
        if cur_row == self.floor_row:
            cur = list(range(1, 19))
        else:
            cur = [int(c) for c in self.plat_cells[cur_row]]
        best = None
        for xc in cur:
            if xc in nxt:
                continue
            for xn in nxt:
                d = abs(xc - xn)
                if best is None or d < best[0]:
                    best = (d, xc, xn)
        if best is None:  # fully covered (cannot happen: nxt excludes
            xc = cur[0]  # the previous curr_x) — fall back to the edge
            xn = min(nxt)
        else:
            _, xc, xn = best
        return float(xc) + 0.5, float(xn) + 0.5

    @staticmethod
    def _walk(x: float, vx: float, target: float,
              tol: float = 0.1) -> Optional[int]:
        """Proportional-speed ground controller: returns the action to
        approach `target` without overshoot-oscillation, or None once
        settled (|x-target| <= tol and nearly stopped)."""
        dx = target - x
        if abs(dx) <= tol:
            if vx > 0.06:
                return LEFT
            if vx < -0.06:
                return RIGHT
            return None
        desired = max(-0.5, min(0.5, dx * 0.7))
        if vx < desired - 0.04:
            return RIGHT
        if vx > desired + 0.04:
            return LEFT
        return NOOP

    def _standing_stage(self, y: float) -> Optional[int]:
        """Stage implied by the row being stood on (self-healing after a
        missed jump): index of the next platform above that row."""
        row = int(round(y))
        if row == self.floor_row:
            return 0
        for k, r in enumerate(self.plat_rows):
            if r == row:
                return k + 1
        return None

    def act(self, pos, vel, on_ground, point_taken) -> int:
        x, y = float(pos[0]), float(pos[1])
        if on_ground:
            st = self._standing_stage(y)
            if st is not None:
                self.stage = min(st, len(self.plat_rows))
                # collect this platform's crystal before climbing on
                if st >= 1:
                    row = self.plat_rows[st - 1]
                    crys = self.crystals.get(row)
                    if crys is not None and not point_taken[crys[0]]:
                        a = self._walk(x, float(vel[0]), crys[1], tol=0.3)
                        return NOOP if a is None else a
        if self.stage >= len(self.plat_rows):
            return NOOP
        target_row = self.plat_rows[self.stage]
        cur_row = self.floor_row if self.stage == 0 \
            else self.plat_rows[self.stage - 1]
        launch_x, land_x = self._launch_plan(cur_row, target_row)
        # aim just past the landing cell's near edge (enough rect overlap
        # for the two-pass resolver to land the fall)
        aim_x = land_x + (0.25 if launch_x > land_x else -0.25)
        if on_ground:
            a = self._walk(x, float(vel[0]), launch_x)
            if a is not None:
                return a
            return JUMP_N  # settled on the launch column: straight up
        # airborne: hold the (clear) launch column while the body is
        # below the platform top — drifting early bumps the tile side —
        # then steer over the landing cell
        if y >= target_row - 0.05:  # feet not yet above the top surface
            if abs(x - launch_x) > 0.1:
                return RIGHT if launch_x > x else LEFT
            return NOOP
        if abs(x - aim_x) > 0.1:
            return RIGHT if aim_x > x else LEFT
        return NOOP


def chaser_predict(level, actions: Sequence[int]):
    """Predict the exact per-step (reward, terminated) sequence for
    `actions` on `level`, independent of the engine. Valid only
    while no enemy contact occurs. Returns (rewards f32[T],
    terminated bool[T]); stops early at completion."""
    sim = _ChaserSim(level)
    rewards, terms = [], []
    for a in actions:
        r, t = sim.step(int(a))
        rewards.append(r)
        terms.append(t)
        if t:
            break
    return np.asarray(rewards, f32), np.asarray(terms, bool)
