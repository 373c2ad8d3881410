"""AABB helpers (procgen2_tpu/physics/aabb.py), the reference's
raylib-style math (`games/coinrun/helpers.cpp:40-108`)."""
from __future__ import annotations

import torch


def check_collision(ax, ay, aw, ah, bx, by, bw, bh):
    """Strict AABB overlap test (helpers.cpp:40-46)."""
    return (ax < bx + bw) & (ax + aw > bx) & (ay < by + bh) & (ay + ah > by)


def overlap_extent(ax, ay, aw, ah, bx, by, bw, bh):
    """Overlap rect (ox, oy, ow, oh); ow/oh <= 0 when not colliding
    (helpers.cpp:48-108)."""
    ox = torch.maximum(ax, bx)
    oy = torch.maximum(ay, by)
    ow = torch.minimum(ax + aw, bx + bw) - ox
    oh = torch.minimum(ay + ah, by + bh) - oy
    return ox, oy, ow, oh
