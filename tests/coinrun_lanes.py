"""Crafted coinrun lanes for the game step's tests: one hand-made level in
every lane and the agent placed, lane group by lane group, where a case
of the step shows (`crafted`). The plain step covers the cases on the
CPU (tests/test_torch_coinrun_step.py) and the step kernel is held
against it on the card (tests/test_torch_cuda.py).

The level (render coords, y down; a tile (row, col) spans [col, col + 1)
x [row, row + 1)): walls round the map, a floor on row 60, a one-way
crate at (55, 20), lava on row 60 at cols 40-42, a wall block at col 30
on rows 57-59, a ledge on row 50 at cols 8-12, a saw at (25.5, 59.5),
another at (45.5, 50.5) in slot 39, the coin at (50.5, 59.5). Mob slot 0
walks right into the wall block, slot 1 right off the ledge, slot 35
left along the floor; slot 2 is dead (with a position and a speed that
must come back unchanged).

Lane groups, each GROUP lanes whose start varies by lane:
  coin      walking right into the coin from 49.5 - 0.03 j: done in
            sub-step 1, 2, 3 or 4, or not yet;
  saw       walking right into the saw;
  lava      falling into the lava;
  land      falling onto the crate, no fallthrough: lands on it;
  through   falling onto the crate pressing down: falls through it;
  below     rising into the crate from under it: passes up through it;
  jump      standing under the crate and jumping;
  mob       walking right into mob slot 0.
"""
from __future__ import annotations

import dataclasses

import torch

from procgen2_tpu_torch.games import coinrun

GROUP = 12
GROUPS = ("coin", "saw", "lava", "land", "through", "below", "jump", "mob")
N = GROUP * len(GROUPS)

CRATE_ROW, CRATE_COL = 55, 20
COIN = (50.5, 59.5)
SAW = (25.5, 59.5)
WALL_COL = 30
LEDGE_ROW, LEDGE_COLS = 50, (8, 12)
# (x, y, vx) of mob slots 0, 1, 35 in lane e: x + dx * (e % GROUP)
MOBS = {0: (28.6, 59.5, 0.15, 0.07), 1: (11.6, 49.5, 0.15, 0.08),
        35: (2.0, 59.5, -0.15, 0.02)}
DEAD_MOB = 2


def level_grid():
    """The crafted tile grid, int8 [64, 64]."""
    g = torch.zeros((coinrun.WORLD, coinrun.WORLD), dtype=torch.int8)
    g[:, 0] = g[:, -1] = g[-1, :] = coinrun.WALL_MID
    g[60, 1:-1] = coinrun.WALL_TOP
    g[61:63, 1:-1] = coinrun.WALL_MID
    g[CRATE_ROW, CRATE_COL] = coinrun.CRATE
    g[60, 40:43] = coinrun.LAVA_TOP
    g[61:63, 40:43] = coinrun.LAVA_MID
    g[57:60, WALL_COL] = coinrun.WALL_MID
    g[LEDGE_ROW, LEDGE_COLS[0]:LEDGE_COLS[1] + 1] = coinrun.WALL_TOP
    return g


def _lane(group, j):
    """(x, feet y, vx, vy, on_ground, action) of lane j of a group."""
    floor = 60.0
    if group == "coin":
        return (COIN[0] - 1.0 - 0.03 * j, floor, 0.5, 0.0, True, 7)
    if group == "saw":
        return (SAW[0] - 1.0 - 0.03 * j, floor, 0.5, 0.0, True, 7)
    if group == "lava":
        return (41.5, 59.2 + 0.06 * j, 0.0, 0.5, False, 4)
    if group in ("land", "through"):
        return (CRATE_COL + 0.3 + 0.04 * j, CRATE_ROW - 0.6 + 0.04 * j,
                0.0, 0.6, False, 4 if group == "land" else 3)
    if group == "below":
        return (CRATE_COL + 0.5, 57.2 + 0.05 * j, 0.0, -1.2 - 0.02 * j,
                False, 4)
    if group == "jump":
        return (CRATE_COL + 0.2 + 0.05 * j, floor, 0.0, 0.0, True, 5)
    if group == "mob":
        return (MOBS[0][0] - 1.2 - 0.03 * j, floor, 0.5, 0.0, True, 7)
    raise ValueError(group)


def crafted(gs):
    """The crafted level and lanes over a coinrun State of N lanes (its
    keys and episode counters kept). Returns (state, actions int32 [N])."""
    if gs.pos.shape[0] != N:
        raise ValueError(f"crafted takes a state of {N} lanes")
    dev = gs.pos.device
    f32 = torch.float32
    lv = gs.level
    M, S = lv.mob_alive.shape[1], lv.saw_alive.shape[1]
    mob_pos = torch.zeros((N, M, 2), dtype=f32)
    mob_vx = torch.zeros((N, M), dtype=f32)
    mob_alive = torch.zeros((N, M), dtype=torch.bool)
    for e in range(N):
        for k, (x, y, vx, dx) in MOBS.items():
            mob_pos[e, k] = torch.tensor([x + dx * (e % GROUP), y])
            mob_vx[e, k] = vx
            mob_alive[e, k] = True
        mob_pos[e, DEAD_MOB] = torch.tensor([33.25, 40.5])
        mob_vx[e, DEAD_MOB] = -0.15
    saw_pos = torch.zeros((N, S, 2), dtype=f32)
    saw_alive = torch.zeros((N, S), dtype=torch.bool)
    saw_pos[:, 0] = torch.tensor(SAW)
    saw_pos[:, S - 1] = torch.tensor([45.5, 50.5])
    saw_alive[:, [0, S - 1]] = True

    lanes = [_lane(g, j) for g in GROUPS for j in range(GROUP)]
    cols = list(zip(*lanes))
    pos = torch.tensor(list(zip(cols[0], cols[1])), dtype=f32)
    vel = torch.tensor(list(zip(cols[2], cols[3])), dtype=f32)
    level = dataclasses.replace(
        lv, grid=level_grid().expand(N, -1, -1).contiguous().to(dev),
        coin_pos=torch.tensor(COIN, dtype=f32).expand(N, 2).contiguous().to(
            dev),
        saw_pos=saw_pos.to(dev), saw_alive=saw_alive.to(dev),
        mob_pos0=mob_pos.to(dev), mob_vx0=mob_vx.to(dev),
        mob_alive=mob_alive.to(dev))
    state = dataclasses.replace(
        gs, level=level, pos=pos.to(dev), vel=vel.to(dev),
        on_ground=torch.tensor(cols[4], device=dev),
        face_forward=torch.ones(N, dtype=torch.bool, device=dev),
        anim_t=torch.zeros(N, dtype=f32, device=dev),
        mob_pos=mob_pos.to(dev), mob_vx=mob_vx.to(dev))
    actions = torch.tensor(cols[5], dtype=torch.int32, device=dev)
    return state, actions


def group(name):
    """The lanes of a group, a slice of [N]."""
    i = GROUPS.index(name)
    return slice(i * GROUP, (i + 1) * GROUP)


def active_sub_steps(anim_t):
    """The sub-steps an env ran in its first step from anim_t = 0: each
    running sub-step adds 0.1 * DT to anim_t."""
    return torch.round(anim_t / (0.1 * coinrun.DT)).to(torch.int32)
