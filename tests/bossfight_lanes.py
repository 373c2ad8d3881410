"""Bossfight rings crafted past the render's 36-bullet cull, for the
benchmark's reference tests (`crowd`), and the count of the boss bullets
the render would draw with no cull (`drawn_bullets`). Each takes a
bossfight State of either package (the port's or
`benchmark/reference/games/bossfight.py`'s: the same fields).
"""
from __future__ import annotations

import dataclasses
import math

import torch

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
