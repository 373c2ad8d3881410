"""Bossfight rings crafted past the render's 36-bullet cull, for the
benchmark's reference tests (`crowd`), and the count of the boss bullets
the render would draw with no cull (`drawn_bullets`). Each takes a
bossfight State of either package (the port's or
`benchmark/reference/games/bossfight.py`'s: the same fields).

And crafted lanes for the game step's tests (`crafted`): every lane's
agent, boss, rings and barriers set by hand, lane group by lane group,
where a case of the step shows. The plain step covers the cases on the
CPU (tests/test_torch_bossfight_step.py) and the step kernel is held
against it on the card (tests/test_torch_cuda.py). Positions are y down;
the agent sits at (0, 1.5), the boss at (0, -1), nothing moves unless a
group says so, no barrier exists and the boss is shielded (phase 0,
weapon 0, 1.0 into its phase) unless a group says otherwise.

Lane groups, each GROUP lanes (j = 0..7):
  death      the agent dies in sub-step 1 (j = 0: a hit registered in the
             last step; 5: on the boss; 6: on a barrier) or k + 1 (j = k
             = 1..3: a boss bullet, falling, reaches it in sub-step k);
             j = 4 and 7 are hit in sub-step 4 and die next step; boss
             bullet slot 1 moves on through every sub-step;
  bounce     a player bullet (slot 1) on the shielded boss bounces; the
             older slot 0 has bounced, its timer at 0.25 (j % 4) runs out;
  damage     the unshielded boss at 1 HP is hit: HP 0, the damage show
             pushes an explosion into the pool (empty, 7 and full by j %
             3), the show ends in sub-step j % 4 + 1; in phase 5 (j >= 6)
             the boss dies, +10;
  barrier    player and boss bullets on the barriers and off screen; j =
             7's agent on a barrier; an absent barrier under the agent;
  boss_ring  a volley of 8 (j < 4) or 5 into a ring holding 64 - 2 (j %
             4) live bullets, its next slot at (61 + 3 j) mod 64: the
             pushes past 64 are refused;
  agent_ring the agent fires into a ring of 32 - (j % 3) live bullets,
             its next slot at (31 + j) mod 32 (j >= 6: its timer at
             0.25, the shot one sub-step late);
  volley     weapons 0, 1, 2, 3 (j = 0..3) fire in sub-step 1; j = 4 at a
             phase start (the weapon re-rolled); 5 at the end of its
             shielded phase; 6 unshielded, its key drawing the passive
             shot in sub-step 1; 7 at the end of its unshielded phase,
             the boss retargeting.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from procgen2_tpu_torch import random as prng
from procgen2_tpu_torch.games import bossfight

RING, CULL = bossfight.NUM_B_BULLETS, bossfight.BB_CULL
SPEED = bossfight.Config(mode="easy").bullet_speed


def crowd(gs, rows, live=50, exploding=4, seed=0):
    """`rows`' boss-bullet rings filled with `live` live bullets (frame 0)
    in slots [0, live) and `exploding` exploding ones (frames 1 to 4.75)
    after them, scattered over the arena with easy-mode velocities along
    their rotations: live + exploding > CULL, so the render drops some.
    The values come from a CPU generator, the same on any device."""
    n = live + exploding
    if not CULL < n <= RING:
        raise ValueError(f"{live} + {exploding} bullets do not pass the cull")
    rows = torch.as_tensor(rows, dtype=torch.long)
    g = torch.Generator().manual_seed(seed)
    pos = torch.rand((rows.numel(), n, 2), generator=g) * 3.8 - 1.9
    rot = torch.rand((rows.numel(), n), generator=g) * (2 * math.pi)
    vel = torch.stack([torch.cos(rot), -torch.sin(rot)], -1) * SPEED
    vel[:, live:] = 0.0
    frame = torch.full((rows.numel(), RING), -1.0)
    frame[:, :live] = 0.0
    frame[:, live:n] = torch.linspace(1.0, 4.75, exploding)
    dev = gs.bb_pos.device
    rows = rows.to(dev)
    out = {f: getattr(gs, f).clone()
           for f in ("bb_pos", "bb_vel", "bb_rot", "bb_frame", "bb_num",
                     "bb_next")}
    out["bb_pos"][rows, :n] = pos.to(dev)
    out["bb_vel"][rows, :n] = vel.to(dev)
    out["bb_rot"][rows, :n] = rot.to(dev)
    out["bb_frame"][rows] = frame.to(dev)
    out["bb_num"][rows] = n
    out["bb_next"][rows] = n % RING
    return dataclasses.replace(gs, **out)


def drawn_bullets(gs):
    """Per row, the boss-bullet slots the render would draw with no cull:
    live or exploding in the ring's window (int [N])."""
    window = bossfight._window(gs.bb_next, gs.bb_num, RING)
    f = gs.bb_frame
    return (window & ((f == 0.0) | (f >= 1.0))).sum(1)


GROUP = 8
GROUPS = ("death", "bounce", "damage", "barrier", "boss_ring", "agent_ring",
          "volley")
N = GROUP * len(GROUPS)
AGENT = (0.0, 1.5)
BOSS = (0.0, -1.0)
FAR_BULLET = (-1.5, 0.0)  # boss bullet slot 1 of the death lanes
BARRIERS = ((1.0, 0.5), (-1.0, 0.5))
PASSIVE_SEED = 7


def group(name):
    """The lanes of a group, a slice of [N]."""
    i = GROUPS.index(name)
    return slice(i * GROUP, (i + 1) * GROUP)


def passive_key():
    """A key whose first sub-step draws the passive shot: the first of
    fold_in(key(PASSIVE_SEED), i) whose volley draw u1 is below 0.1 * DT,
    as `bossfight.step_reference` splits it."""
    keys = prng.fold_in(prng.key(PASSIVE_SEED), torch.arange(4096))
    k_pattern = prng.split(keys, 7)[:, 3]
    u1 = prng.uniform(prng.split(k_pattern)[:, 0])
    return keys[int(torch.nonzero(u1 < 0.1 * bossfight.DT)[0, 0])]


def crafted(gs):
    """The crafted lanes over a bossfight State of N lanes (its level
    textures and t kept). Returns (state, actions int32 [N])."""
    if gs.pos.shape[0] != N:
        raise ValueError(f"crafted takes a state of {N} lanes")
    f32, i32 = torch.float32, torch.int32
    A, B, E = bossfight.NUM_A_BULLETS, RING, bossfight.NUM_EXPLOSIONS
    speed = SPEED * bossfight.DT  # a boss bullet's move a sub-step

    def full(shape, value, dtype=f32):
        return torch.full((N,) + shape, value, dtype=dtype)

    s = dict(
        pos=torch.tensor(AGENT).repeat(N, 1), vel=full((2,), 0.0),
        alive=full((), True, torch.bool), a_bullet_timer=full((), 1.0),
        ab_pos=full((A, 2), 0.0), ab_vel=full((A, 2), 0.0),
        ab_frame=full((A,), -1.0), ab_bouncing=full((A,), False, torch.bool),
        ab_bounce_timer=full((A,), 0.0), ab_num=full((), 0, i32),
        ab_next=full((), 0, i32), boss_pos=torch.tensor(BOSS).repeat(N, 1),
        boss_vel=full((2,), 0.0), phase_timer=full((), 1.0),
        phase_index=full((), 0, i32), weapon_index=full((), 0, i32),
        attack_timer=full((), 0.0), hp=full((), bossfight.BOSS_HP, i32),
        move_timer=full((), 0.0), explosion_timer=full((), 0.0),
        damage_timer=full((), 0.0), bb_pos=full((B, 2), 0.0),
        bb_vel=full((B, 2), 0.0), bb_rot=full((B,), 0.0),
        bb_frame=full((B,), -1.0), bb_num=full((), 0, i32),
        bb_next=full((), 0, i32), ex_pos=full((E, 2), 0.0),
        ex_frame=full((E,), -1.0), ex_num=full((), 0, i32),
        ex_next=full((), 0, i32))
    bar_pos = full((bossfight.MAX_BARRIERS, 2), 0.0)
    bar_exists = full((bossfight.MAX_BARRIERS,), False, torch.bool)
    actions = full((), 4, i32)
    rng = gs.rng.cpu().clone()

    def lanes(name):
        return range(group(name).start, group(name).stop)

    def bullet(e, slot, x, y, vx=0.0, vy=0.0, frame=0.0, ring="bb"):
        s[ring + "_pos"][e, slot] = torch.tensor([x, y])
        s[ring + "_vel"][e, slot] = torch.tensor([vx, vy])
        s[ring + "_frame"][e, slot] = frame

    for j, e in enumerate(lanes("death")):
        if j == 0:
            s["alive"][e] = False
        elif j == 5:
            s["pos"][e] = torch.tensor(BOSS)
        elif j == 6:
            bar_pos[e, 0] = torch.tensor(AGENT)
            bar_exists[e, 0] = True
        else:  # the bullet's box reaches the agent's in sub-step k
            k = min(j, 4)
            bullet(e, 0, AGENT[0], AGENT[1] - 0.11 + 0.006 - speed * (k - 1),
                   vy=SPEED)
        bullet(e, 1, *FAR_BULLET, vx=SPEED)
        s["bb_num"][e] = s["bb_next"][e] = 2

    for j, e in enumerate(lanes("bounce")):
        bullet(e, 0, 1.5, 1.0, ring="ab")
        s["ab_bouncing"][e, 0] = True
        s["ab_bounce_timer"][e, 0] = 0.25 * (j % 4)
        bullet(e, 1, BOSS[0] + 0.1 * (j - 4), BOSS[1] + 0.3, vy=-0.1,
               ring="ab")
        s["ab_num"][e] = s["ab_next"][e] = 2

    for j, e in enumerate(lanes("damage")):
        s["phase_index"][e] = 5 if j >= 6 else 1
        s["hp"][e] = 1
        s["explosion_timer"][e] = 8.0
        s["damage_timer"][e] = bossfight.DAMAGE_TIME - 0.25 * (j % 4)
        bullet(e, 0, BOSS[0], BOSS[1] + 0.3, vy=-0.1, ring="ab")
        s["ab_num"][e] = s["ab_next"][e] = 1
        num, nxt = ((0, 0), (7, 3), (8, 5))[j % 3]
        for i in range(num):  # the pool's live slots, frames up to 3.95
            slot = (nxt - 1 - i) % E
            s["ex_pos"][e, slot] = torch.tensor([0.1 * i, -1.0])
            s["ex_frame"][e, slot] = 3.95 - 0.5 * i
        s["ex_num"][e], s["ex_next"][e] = num, nxt

    for j, e in enumerate(lanes("barrier")):
        bar_pos[e, :2] = torch.tensor(BARRIERS)
        bar_exists[e, :2] = True
        bar_pos[e, 2] = torch.tensor(AGENT)  # absent: no contact
        bullet(e, 0, BARRIERS[0][0], BARRIERS[0][1] + 0.01 * j, vy=-0.1,
               ring="ab")
        bullet(e, 1, 0.5 * (j % 3) - 0.5, -2.05, vy=-0.1, ring="ab")
        s["ab_num"][e] = s["ab_next"][e] = 2
        bullet(e, 0, BARRIERS[1][0], BARRIERS[1][1] - 0.05, vy=SPEED)
        bullet(e, 1, 2.05, 0.1 * j, vx=SPEED)
        s["bb_num"][e] = s["bb_next"][e] = 2
        if j == 7:
            s["pos"][e] = torch.tensor(BARRIERS[1])

    for j, e in enumerate(lanes("boss_ring")):
        s["weapon_index"][e] = 2 if j < 4 else 0
        s["attack_timer"][e] = 10.0
        num, nxt = B - 2 * (j % 4), (61 + 3 * j) % B
        for i in range(num):  # live and still, above the agent
            slot = (nxt - 1 - i) % B
            bullet(e, slot, -1.8 + 0.45 * (i % 8), -1.8 + 0.3 * (i // 8))
        s["bb_num"][e], s["bb_next"][e] = num, nxt

    for j, e in enumerate(lanes("agent_ring")):
        actions[e] = 9
        s["a_bullet_timer"][e] = 0.25 if j >= 6 else 0.0
        num, nxt = A - j % 3, (31 + j) % A
        for i in range(num):
            slot = (nxt - 1 - i) % A
            bullet(e, slot, -1.8 + 0.45 * (i % 8), 0.0 + 0.2 * (i // 8),
                   ring="ab")
        s["ab_num"][e], s["ab_next"][e] = num, nxt

    for j, e in enumerate(lanes("volley")):
        if j < 4:
            s["weapon_index"][e] = j
            s["attack_timer"][e] = (8.0, 5.0, 10.0, 4.0)[j]
        elif j == 4:
            s["phase_timer"][e] = 0.0
        elif j == 5:
            s["phase_timer"][e] = 250.0
        else:
            s["phase_index"][e] = 1
            if j == 6:
                rng[e] = passive_key()
            else:
                s["phase_timer"][e] = bossfight.UNSHIELDED_TIME
                s["move_timer"][e] = bossfight.MOVE_TIME

    dev = gs.pos.device
    level = dataclasses.replace(gs.level, barrier_pos=bar_pos.to(dev),
                                barrier_exists=bar_exists.to(dev))
    state = dataclasses.replace(
        gs, level=level, rng=rng.to(dev),
        **{k: v.to(dev) for k, v in s.items()})
    return state, actions.to(dev)


def active_sub_steps(gs0, gs1):
    """The sub-steps each lane ran in a step from gs0 to gs1, where its
    phase neither started nor ended: each adds DT to its phase timer."""
    return torch.round((gs1.phase_timer - gs0.phase_timer)
                       / bossfight.DT).to(torch.int32)
