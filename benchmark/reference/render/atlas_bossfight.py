"""Bossfight's sprites and space backgrounds, registered into the
reference's atlas (`atlas.py`, cut to maze and coinrun): a frozen copy of
the program's `render/atlas.py` painters of the 4 boss ships, 4 player
ships, 3 laser colours, the shield, 3 meteor barriers and 5 explosion
frames, and of its "space" backgrounds, unchanged. Importing this module
registers the sprites, so `atlas.build_pixel_bank` rasterizes them.
"""
from __future__ import annotations

import functools

import numpy as np

from .atlas import (BG_SIZE, S, _REGISTRY, _blank, _box, _disc, _fill,
                    _grid, _rng, _stable_seed)

# ---------------------------------------------------------------------------
# Bossfight (games/bossfight/common_systems.cpp:48-72, bossfight.cpp:70-73):
# 4 boss ships, 4 player ships, 3 laser colors, shield, 3 meteor barriers,
# 5 explosion frames
# ---------------------------------------------------------------------------

BOSS_SHIP_COLORS = {  # enemyShip{Black1,Blue2,Green3,Red4}
    "black": (0.25, 0.25, 0.3),
    "blue": (0.3, 0.45, 0.85),
    "green": (0.3, 0.75, 0.35),
    "red": (0.85, 0.3, 0.3),
}
PLAYER_SHIP_COLORS = {  # playerShip{1_blue,1_green,2_orange,3_red}
    "blue": (0.3, 0.5, 0.9),
    "green": (0.35, 0.8, 0.4),
    "orange": (0.95, 0.6, 0.2),
    "red": (0.85, 0.2, 0.2),
}
LASER_COLORS = {  # laser{Green14,Red11,Blue09}
    "green": (0.4, 1.0, 0.4),
    "red": (1.0, 0.35, 0.3),
    "blue": (0.35, 0.7, 1.0),
}


def _register_explosions():
    # Stand-ins for assets/misc_assets/explosion{1..5}.png
    for i in range(5):
        def expl(k=i):
            img = _blank()
            r = 0.18 + 0.07 * k
            img = _fill(img, _disc(0.5, 0.5, r, soft=3.0), (1.0, 0.55 - 0.08 * k, 0.1))
            img = _fill(img, _disc(0.5, 0.5, r * 0.55, soft=3.0), (1.0, 0.9, 0.4))
            x, y = _grid()
            ang = np.arctan2(y - 0.5, x - 0.5)
            spikes = (np.sin(ang * 7 + k) * 0.5 + 0.5) * 0.1
            ring = np.clip((r + spikes - np.hypot(x - 0.5, y - 0.5)) * S / 2.0, 0, 1)
            img = _fill(img, ring * 0.6, (1.0, 0.4, 0.05))
            return img

        _REGISTRY[f"explosion{i}"] = expl


def _register_bossfight():
    for name, c in BOSS_SHIP_COLORS.items():
        def boss_ship(c=c):
            img = _blank()
            x, y = _grid()
            hull = np.clip(
                (0.4 - (np.abs(x - 0.5) * (1.8 - y) + np.abs(y - 0.5) * 0.5))
                * S / 1.2, 0, 1)
            img = _fill(img, hull, c)
            img = _fill(img, _disc(0.5, 0.55, 0.12), tuple(min(v * 1.6, 1.0) for v in c))
            img = _fill(img, _box(0.05, 0.4, 0.25, 0.6, soft=1.5), tuple(v * 0.7 for v in c))
            img = _fill(img, _box(0.75, 0.4, 0.95, 0.6, soft=1.5), tuple(v * 0.7 for v in c))
            return img

        _REGISTRY[f"boss_ship_{name}"] = boss_ship

    for name, c in PLAYER_SHIP_COLORS.items():
        def pship(c=c):
            img = _blank()
            x, y = _grid()
            nose = np.clip((0.3 - np.abs(x - 0.5) * (0.4 + y * 1.6)) * S / 1.2, 0, 1) * (y < 0.85)
            img = _fill(img, nose, c)
            wings = np.clip((0.45 - np.abs(x - 0.5)) * S / 1.2, 0, 1) * ((y > 0.55) & (y < 0.85))
            img = _fill(img, wings * 0.9, tuple(v * 0.8 for v in c))
            img = _fill(img, _disc(0.5, 0.4, 0.09), (0.7, 0.9, 1.0))
            return img

        _REGISTRY[f"pship_{name}"] = pship

    for name, c in LASER_COLORS.items():
        def bolt(c=c):
            img = _blank()
            img = _fill(img, _disc(0.5, 0.5, 0.3, soft=3.0), c)
            img = _fill(img, _disc(0.5, 0.5, 0.15, soft=3.0), (1.0, 1.0, 1.0))
            return img

        _REGISTRY[f"bolt_{name}"] = bolt

    def shield():
        # Stand-in for assets/misc_assets/shield2.png (drawn at alpha 0.7)
        img = _blank()
        x, y = _grid()
        d = np.hypot(x - 0.5, y - 0.5)
        ring = np.clip((0.48 - d) * S / 1.5, 0, 1) * np.clip((d - 0.38) * S / 1.5, 0, 1)
        img = _fill(img, ring, (0.4, 0.75, 1.0))
        glow = np.clip((0.45 - d) * S / 6.0, 0, 0.35)
        img = _fill(img, glow, (0.5, 0.8, 1.0))
        return img

    _REGISTRY["shield"] = shield

    for i in range(3):
        def barrier(k=i):
            img = _blank()
            rng = _rng(f"barrier{k}")
            img = _fill(img, _disc(0.5, 0.5, 0.42), (0.5 - 0.05 * k, 0.38, 0.3))
            for _ in range(4):
                cx, cy, r = rng.uniform(0.3, 0.7), rng.uniform(0.3, 0.7), rng.uniform(0.04, 0.1)
                img = _fill(img, _disc(cx, cy, r), (0.38, 0.28, 0.22))
            return img

        _REGISTRY[f"barrier{i}"] = barrier


_register_explosions()
_register_bossfight()


@functools.lru_cache(maxsize=None)
def build_space_backgrounds(n: int) -> np.ndarray:
    """Bossfight's procedural space backgrounds, `uint8[n, BG_SIZE,
    BG_SIZE, 3]`: `build_backgrounds("space", n)` of the program's atlas
    (stand-ins for the 13 PNGs of games/bossfight/bossfight.cpp:54-67)."""
    out = np.zeros((n, BG_SIZE, BG_SIZE, 3), np.uint8)
    c = (np.arange(BG_SIZE) + 0.5) / BG_SIZE
    x, y = np.meshgrid(c, c, indexing="xy")
    for i in range(n):
        rng = np.random.default_rng(_stable_seed(("space", i)))
        img = np.zeros((BG_SIZE, BG_SIZE, 3)) + rng.uniform(0.0, 0.06, 3)
        stars = rng.random((BG_SIZE, BG_SIZE)) > 0.985
        img = np.where(stars[..., None], rng.uniform(0.7, 1.0, 3)[None, None], img)
        # nebula blob
        cx, cy = rng.uniform(0.2, 0.8, 2)
        d = np.hypot(x - cx, y - cy)
        img += np.clip(0.35 - d, 0, 1)[..., None] * rng.uniform(0.0, 0.25, 3)
        img = np.clip(img, 0, 1)
        out[i] = np.clip(np.round(img * 255), 0, 255).astype(np.uint8)
    return out
