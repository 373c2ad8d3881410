"""AABB helpers (procgen2_tpu/physics/aabb.py), the reference's
raylib-style math (`games/coinrun/helpers.cpp:40-108`)."""
from __future__ import annotations


def check_collision(ax, ay, aw, ah, bx, by, bw, bh):
    """Strict AABB overlap test (helpers.cpp:40-46)."""
    return (ax < bx + bw) & (ax + aw > bx) & (ay < by + bh) & (ay + ah > by)


