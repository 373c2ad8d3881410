"""Procedural sprite atlas, backgrounds and pixel banks (numpy), for the
games the port has: coinrun, bossfight, climber, caveflyer, jumper,
chaser and maze.

The port's own copy of the JAX package's `procgen2_tpu/render/atlas.py`,
cut to the sprites those games draw; everything kept is unchanged, so
the arrays are identical (tests/test_torch_assets.py). Every sprite is
generated deterministically in numpy from a seed that depends only on
its name, and packed into one `uint8[N, S, S, 4]` array; games name
sprites and get atlas indices back. The reference ships PNG art instead
(`Asset_Manager`, `games/maze/asset_manager.h:7-37`); the overlay of real
PNGs that the JAX package offers is not ported.
"""
from __future__ import annotations

import functools
import zlib
from typing import Callable, Dict, Tuple

import numpy as np

SPRITE_SIZE = 32
S = SPRITE_SIZE

_REGISTRY: Dict[str, Callable[[], np.ndarray]] = {}


def sprite(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def _stable_seed(name) -> int:
    """Process-independent seed for a painter name (not Python's salted
    `hash()`, which would change the art from one process to the next)."""
    return zlib.crc32(repr(name).encode())


def _rng(name: str) -> np.random.Generator:
    return np.random.default_rng(_stable_seed(name))


def _grid() -> Tuple[np.ndarray, np.ndarray]:
    """Pixel-center coordinates in [0, 1)."""
    c = (np.arange(S) + 0.5) / S
    return np.meshgrid(c, c, indexing="xy")  # x, y


def _blank() -> np.ndarray:
    return np.zeros((S, S, 4), np.float32)


def _fill(img, mask, color):
    color = np.asarray(color, np.float32)
    m = np.clip(mask, 0.0, 1.0)[..., None]
    rgb = img[..., :3] * (1 - m) + color[None, None, :3] * m
    a = np.maximum(img[..., 3], np.clip(mask, 0, 1) * (color[3] if len(color) > 3 else 1.0))
    return np.concatenate([rgb, a[..., None]], -1)


def _disc(cx, cy, r, soft=1.5):
    x, y = _grid()
    d = np.hypot(x - cx, y - cy)
    return np.clip((r - d) * S / soft, 0, 1)


def _box(x0, y0, x1, y1, soft=1.0):
    x, y = _grid()
    m = (
        np.clip((x - x0) * S / soft, 0, 1)
        * np.clip((x1 - x) * S / soft, 0, 1)
        * np.clip((y - y0) * S / soft, 0, 1)
        * np.clip((y1 - y) * S / soft, 0, 1)
    )
    return m


def _noise(name, lo=0.85, hi=1.15, blur=1):
    n = _rng(name).uniform(lo, hi, (S, S)).astype(np.float32)
    for _ in range(blur):
        n = 0.25 * (np.roll(n, 1, 0) + np.roll(n, -1, 0) + np.roll(n, 1, 1) + np.roll(n, -1, 1))
    return n


def _to_u8(img: np.ndarray) -> np.ndarray:
    return np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)


def sprite_rgba(name: str) -> np.ndarray:
    """Raw registered sprite texels, uint8 [S, S, 4] (host-side helper
    for pre-rasterized overlays, e.g. jumper's screen-space compass)."""
    return _to_u8(_REGISTRY[name]())


def _textured_tile(name: str, base, border=None, border_px=2) -> np.ndarray:
    """Opaque tile: base color modulated by noise, optional darker border."""
    img = _blank()
    img = _fill(img, np.ones((S, S)), base)
    img[..., :3] *= _noise(name)[..., None]
    if border is not None:
        x, y = _grid()
        b = border_px / S
        edge = (x < b) | (x > 1 - b) | (y < b) | (y > 1 - b)
        img[..., :3] = np.where(edge[..., None], np.asarray(border, np.float32)[:3], img[..., :3])
    img[..., 3] = 1.0
    return img


# ---------------------------------------------------------------------------
# Maze (games/maze/tilemap.cpp:12-15, common_systems.cpp:66): sand wall
# tile, cheese goal, mouse agent
# ---------------------------------------------------------------------------

@sprite("maze_wall")
def _maze_wall():
    # Stand-in for assets/kenney/Ground/Sand/sandCenter.png (maze tilemap.cpp:12)
    return _textured_tile("maze_wall", (0.91, 0.76, 0.43), border=(0.72, 0.57, 0.28))


@sprite("cheese")
def _cheese():
    # Stand-in for assets/misc_assets/cheese.png (maze tilemap.cpp:15)
    img = _blank()
    x, y = _grid()
    wedge = np.clip(((y - 0.12) - 0.75 * np.abs(x - 0.5) * 0) * S / 2, 0, 1)
    tri = np.clip((y - (1.0 - x) * 0.85) * S / 1.5 + 1.0, 0, 1) * _box(0.05, 0.1, 0.95, 0.95)
    img = _fill(img, tri, (0.98, 0.83, 0.22))
    for (hx, hy, r) in [(0.62, 0.55, 0.07), (0.42, 0.75, 0.06), (0.78, 0.8, 0.05)]:
        hole = _disc(hx, hy, r) * tri
        img = _fill(img, hole, (0.85, 0.65, 0.1))
    return img


@sprite("mouse")
def _mouse():
    # Stand-in for assets/kenney/Enemies/mouse_move.png (maze common_systems.cpp:66)
    img = _blank()
    img = _fill(img, _disc(0.55, 0.62, 0.3), (0.62, 0.62, 0.68))  # body
    img = _fill(img, _disc(0.3, 0.45, 0.16), (0.62, 0.62, 0.68))  # head
    img = _fill(img, _disc(0.22, 0.3, 0.1), (0.8, 0.6, 0.65))  # ear
    img = _fill(img, _disc(0.2, 0.47, 0.035), (0.05, 0.05, 0.08))  # eye
    img = _fill(img, _disc(0.13, 0.52, 0.03), (0.95, 0.5, 0.55))  # nose
    x, y = _grid()
    tail = np.clip((0.04 - np.abs(y - (0.75 + 0.15 * np.sin(x * 6)))) * S, 0, 1) * (x > 0.75)
    img = _fill(img, tail, (0.8, 0.6, 0.65))
    return img


# ---------------------------------------------------------------------------
# Coinrun (games/coinrun/tilemap.h:29-31: 6 wall themes, 9 walking enemies,
# 4 crate types; common_systems.h:62: 5 agent themes x 4 poses)
# ---------------------------------------------------------------------------

WALL_THEMES = ("dirt", "grass", "planet", "sand", "snow", "stone")
_WALL_COLORS = {
    "dirt": (0.55, 0.38, 0.22),
    "grass": (0.45, 0.33, 0.2),
    "planet": (0.45, 0.3, 0.5),
    "sand": (0.9, 0.78, 0.45),
    "snow": (0.85, 0.88, 0.95),
    "stone": (0.55, 0.55, 0.58),
}
_WALL_TOP_COLORS = {
    "dirt": (0.62, 0.45, 0.25),
    "grass": (0.35, 0.72, 0.25),
    "planet": (0.65, 0.45, 0.75),
    "sand": (0.97, 0.87, 0.55),
    "snow": (0.97, 0.98, 1.0),
    "stone": (0.7, 0.7, 0.72),
}

WALKING_ENEMIES = (
    "slime_block", "slime_purple", "slime_blue", "slime_green", "mouse_w",
    "snail", "ladybug", "worm_green", "worm_pink",
)
_ENEMY_COLORS = {
    "slime_block": (0.55, 0.55, 0.55),
    "slime_purple": (0.65, 0.35, 0.8),
    "slime_blue": (0.3, 0.5, 0.9),
    "slime_green": (0.35, 0.8, 0.3),
    "mouse_w": (0.62, 0.62, 0.68),
    "snail": (0.8, 0.6, 0.3),
    "ladybug": (0.9, 0.2, 0.2),
    "worm_green": (0.5, 0.85, 0.4),
    "worm_pink": (0.95, 0.6, 0.75),
}

CRATE_TYPES = ("crate", "crate_double", "crate_single", "crate_warning")
AGENT_THEMES = ("beige", "blue", "green", "pink", "yellow")
_AGENT_COLORS = {
    "beige": (0.93, 0.85, 0.68),
    "blue": (0.35, 0.55, 0.95),
    "green": (0.4, 0.8, 0.4),
    "pink": (0.95, 0.55, 0.75),
    "red": (0.9, 0.3, 0.3),
    "grey": (0.6, 0.6, 0.65),
    "yellow": (0.95, 0.85, 0.3),
}


def _register_wall_tiles():
    for theme in WALL_THEMES:
        mid_c = _WALL_COLORS[theme]
        top_c = _WALL_TOP_COLORS[theme]

        def mid(th=theme, c=mid_c):
            return _textured_tile(f"wall_mid_{th}", c, border=tuple(v * 0.8 for v in c))

        def top(th=theme, c=mid_c, tc=top_c):
            img = _textured_tile(f"wall_top_{th}", c, border=tuple(v * 0.8 for v in c))
            x, y = _grid()
            band = y < 0.3
            img[..., :3] = np.where(
                band[..., None],
                np.asarray(tc, np.float32) * _noise(f"wt_{th}", 0.9, 1.1)[..., None],
                img[..., :3],
            )
            return img

        _REGISTRY[f"wall_mid_{theme}"] = mid
        _REGISTRY[f"wall_top_{theme}"] = top


def _register_lava():
    def lava_mid():
        img = _textured_tile("lava_mid", (0.9, 0.25, 0.05))
        img[..., :3] *= _noise("lava_mid2", 0.7, 1.3)[..., None]
        return img

    def lava_top():
        img = _textured_tile("lava_top", (0.95, 0.45, 0.08))
        x, y = _grid()
        waves = (np.sin(x * 18) * 0.5 + 0.5) * 0.25
        img[..., :3] = np.where(
            (y < 0.25 + waves * 0.3)[..., None], np.asarray((0.99, 0.75, 0.2)), img[..., :3]
        )
        return img

    _REGISTRY["lava_mid"] = lava_mid
    _REGISTRY["lava_top"] = lava_top


def _register_crates():
    for i, name in enumerate(CRATE_TYPES):
        def crate(nm=name, k=i):
            base = (0.75 - 0.06 * k, 0.55 - 0.04 * k, 0.3)
            img = _textured_tile(nm, base, border=(0.45, 0.32, 0.18), border_px=3)
            x, y = _grid()
            diag = np.abs(x - y) < 0.06
            img[..., :3] = np.where(diag[..., None], np.asarray((0.5, 0.36, 0.2)), img[..., :3])
            if nm == "crate_warning":
                stripe = np.abs(x + y - 1.0) < 0.12
                img[..., :3] = np.where(stripe[..., None], np.asarray((0.9, 0.8, 0.1)), img[..., :3])
            return img

        _REGISTRY[name] = crate


def _register_enemies():
    for name in WALKING_ENEMIES:
        color = _ENEMY_COLORS[name]

        def enemy(nm=name, c=color, squish=0.0):
            img = _blank()
            body = _disc(0.5, 0.62 + squish * 0.06, 0.34)
            img = _fill(img, body, c)
            img = _fill(img, _disc(0.36, 0.55, 0.05), (0.05, 0.05, 0.08))
            img = _fill(img, _disc(0.64, 0.55, 0.05), (0.05, 0.05, 0.08))
            return img

        def enemy_move(nm=name, c=color):
            img = _blank()
            body = _disc(0.5, 0.68, 0.36)
            img = _fill(img, body, tuple(v * 0.92 for v in c))
            img = _fill(img, _disc(0.35, 0.6, 0.05), (0.05, 0.05, 0.08))
            img = _fill(img, _disc(0.65, 0.6, 0.05), (0.05, 0.05, 0.08))
            return img

        _REGISTRY[name] = enemy
        _REGISTRY[f"{name}_move"] = enemy_move


def _register_saw():
    def saw(move=False):
        img = _blank()
        x, y = _grid()
        ang = np.arctan2(y - 0.65, x - 0.5)
        teeth = (np.sin(ang * 8 + (0.4 if move else 0.0)) * 0.5 + 0.5) * 0.06
        disc = _disc(0.5, 0.65, 0.3)
        ring = np.clip((0.36 + teeth - np.hypot(x - 0.5, y - 0.65)) * S / 1.5, 0, 1)
        img = _fill(img, ring, (0.6, 0.6, 0.65))
        img = _fill(img, disc, (0.75, 0.75, 0.8))
        img = _fill(img, _disc(0.5, 0.65, 0.06), (0.3, 0.3, 0.35))
        return img

    _REGISTRY["saw"] = lambda: saw(False)
    _REGISTRY["saw_move"] = lambda: saw(True)


def _register_agents(themes=AGENT_THEMES, prefix="alien"):
    """1x2-unit player sprites (drawn into a square cell; the compositor
    stretches to the 1x2 world rect the reference uses,
    common_systems.cpp:274-276: 128x256 textures at 1 unit wide)."""
    for theme in themes:
        c = _AGENT_COLORS[theme]

        def pose(kind, th=theme, c=c):
            img = _blank()
            # body occupies lower 60%, head upper
            img = _fill(img, _box(0.3, 0.42, 0.7, 0.95, soft=2.0), c)
            img = _fill(img, _disc(0.5, 0.3, 0.2), c)
            img = _fill(img, _disc(0.58, 0.27, 0.05), (0.05, 0.05, 0.1))  # eye
            if kind == "jump":
                img = _fill(img, _box(0.05, 0.45, 0.3, 0.58, soft=2.0), c)  # arm up
                img = _fill(img, _box(0.7, 0.45, 0.95, 0.58, soft=2.0), c)
            elif kind == "walk1":
                img = _fill(img, _box(0.25, 0.9, 0.45, 1.0, soft=2.0), tuple(v * 0.8 for v in c))
            elif kind == "walk2":
                img = _fill(img, _box(0.55, 0.9, 0.75, 1.0, soft=2.0), tuple(v * 0.8 for v in c))
            else:  # stand
                img = _fill(img, _box(0.35, 0.9, 0.65, 1.0, soft=2.0), tuple(v * 0.8 for v in c))
            return img

        for kind in ("stand", "jump", "walk1", "walk2"):
            _REGISTRY[f"{prefix}_{theme}_{kind}"] = (lambda k=kind, p=pose: p(k))


@sprite("coin")
def _coin():
    img = _blank()
    img = _fill(img, _disc(0.5, 0.5, 0.4), (0.98, 0.8, 0.15))
    img = _fill(img, _disc(0.5, 0.5, 0.28), (0.85, 0.65, 0.1))
    return img


@sprite("particle_circle")
def _particle():
    img = _blank()
    img = _fill(img, _disc(0.5, 0.5, 0.45, soft=6.0), (1.0, 1.0, 1.0))
    return img


# ---------------------------------------------------------------------------
# Climber (games/climber/tilemap.cpp:10-25: 4 tile themes Blue/Green/Yellow/
# Brown; common_systems.h:61: agent themes Blue/Green/Grey/Red; swimming
# enemy + yellow crystal)
# ---------------------------------------------------------------------------

CLIMBER_TILE_THEMES = ("blue", "green", "yellow", "brown")
_CLIMBER_TILE_COLORS = {
    "blue": (0.35, 0.5, 0.85),
    "green": (0.35, 0.75, 0.35),
    "yellow": (0.9, 0.8, 0.3),
    "brown": (0.6, 0.42, 0.25),
}
CLIMBER_AGENT_THEMES = ("blue", "green", "grey", "red")


def _register_climber_tiles():
    for theme in CLIMBER_TILE_THEMES:
        c = _CLIMBER_TILE_COLORS[theme]

        def mid(th=theme, c=c):
            return _textured_tile(
                f"ctile_mid_{th}", c, border=tuple(v * 0.75 for v in c)
            )

        def top(th=theme, c=c):
            img = _textured_tile(
                f"ctile_top_{th}", c, border=tuple(v * 0.75 for v in c)
            )
            x, y = _grid()
            band = y < 0.28
            img[..., :3] = np.where(
                band[..., None],
                np.asarray(tuple(min(v * 1.35, 1.0) for v in c), np.float32)
                * _noise(f"ct_{th}", 0.92, 1.08)[..., None],
                img[..., :3],
            )
            return img

        _REGISTRY[f"ctile_mid_{theme}"] = mid
        _REGISTRY[f"ctile_top_{theme}"] = top


@sprite("crystal")
def _crystal():
    # Stand-in for assets/misc_assets/yellowCrystal.png (climber tilemap.cpp:25)
    img = _blank()
    x, y = _grid()
    diamond = np.clip((0.38 - (np.abs(x - 0.5) + np.abs(y - 0.5))) * S / 1.5, 0, 1)
    img = _fill(img, diamond, (0.95, 0.85, 0.2))
    facet = np.clip((0.2 - (np.abs(x - 0.5) + np.abs(y - 0.45))) * S / 1.5, 0, 1)
    img = _fill(img, facet, (1.0, 0.95, 0.55))
    return img


def _register_swimmer():
    # Stand-in for assets/platformer/enemySwimming_{1,2}.png (tilemap.cpp:21-22)
    def swim(phase):
        img = _blank()
        img = _fill(img, _disc(0.5, 0.5, 0.3), (0.85, 0.4, 0.75))
        # fin flaps between frames
        img = _fill(img, _box(0.1, 0.35 + phase * 0.15, 0.3, 0.6 + phase * 0.1), (0.7, 0.3, 0.6))
        img = _fill(img, _disc(0.62, 0.44, 0.05), (0.05, 0.05, 0.08))
        return img

    _REGISTRY["swimmer"] = lambda: swim(0.0)
    _REGISTRY["swimmer_move"] = lambda: swim(1.0)


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


# ---------------------------------------------------------------------------
# Caveflyer (games/caveflyer/tilemap.cpp:10-19, common_systems.cpp:77-88):
# cave wall, green/red UFOs, meteor, enemy ship, laser, player ship, thrust
# smoke (the explosion frames are bossfight's)
# ---------------------------------------------------------------------------

@sprite("cave_wall")
def _cave_wall():
    # Stand-in for assets/misc_assets/groundA.png
    return _textured_tile("cave_wall", (0.5, 0.36, 0.28), border=(0.36, 0.26, 0.2))


def _ufo(color):
    img = _blank()
    x, y = _grid()
    body = np.clip((0.42 - np.hypot((x - 0.5) * 1.0, (y - 0.6) * 2.2)) * S / 1.5, 0, 1)
    img = _fill(img, body, color)
    dome = _disc(0.5, 0.42, 0.2)
    img = _fill(img, dome, (0.75, 0.9, 0.95))
    for lx in (0.25, 0.5, 0.75):
        img = _fill(img, _disc(lx, 0.62, 0.045), (1.0, 1.0, 0.6))
    return img


_REGISTRY["ufo_green"] = lambda: _ufo((0.3, 0.8, 0.35))
_REGISTRY["ufo_red"] = lambda: _ufo((0.85, 0.25, 0.25))


@sprite("meteor")
def _meteor():
    img = _blank()
    img = _fill(img, _disc(0.5, 0.5, 0.4), (0.55, 0.4, 0.3))
    for (cx, cy, r) in [(0.4, 0.38, 0.09), (0.65, 0.6, 0.07), (0.35, 0.68, 0.06)]:
        img = _fill(img, _disc(cx, cy, r), (0.42, 0.3, 0.22))
    return img


@sprite("enemy_ship")
def _enemy_ship():
    img = _blank()
    x, y = _grid()
    hull = np.clip((0.36 - (np.abs(x - 0.5) * 1.3 + np.abs(y - 0.5) * 0.8)) * S / 1.2, 0, 1)
    img = _fill(img, hull, (0.3, 0.45, 0.85))
    img = _fill(img, _disc(0.5, 0.45, 0.1), (0.7, 0.85, 0.95))
    return img


@sprite("laser")
def _laser():
    # Vertical blue bolt (laserBlue02.png is 13x37); drawn rotated
    img = _blank()
    x, y = _grid()
    bolt = np.clip((0.16 - np.abs(x - 0.5)) * S / 2.0, 0, 1) * ((y > 0.05) & (y < 0.95))
    img = _fill(img, bolt, (0.3, 0.75, 1.0))
    core = np.clip((0.07 - np.abs(x - 0.5)) * S / 2.0, 0, 1) * ((y > 0.12) & (y < 0.88))
    img = _fill(img, core, (0.85, 0.97, 1.0))
    return img


@sprite("ship_red")
def _ship_red():
    # Stand-in for assets/misc_assets/playerShip1_red.png (nose points up;
    # the renderer adds rotation + pi/2, common_systems.cpp:323)
    img = _blank()
    x, y = _grid()
    nose = np.clip((0.3 - np.abs(x - 0.5) * (0.4 + y * 1.6)) * S / 1.2, 0, 1) * (y < 0.85)
    img = _fill(img, nose, (0.85, 0.2, 0.2))
    wings = np.clip((0.45 - np.abs(x - 0.5)) * S / 1.2, 0, 1) * ((y > 0.55) & (y < 0.85))
    img = _fill(img, wings * 0.9, (0.7, 0.15, 0.15))
    img = _fill(img, _disc(0.5, 0.4, 0.09), (0.7, 0.9, 1.0))
    return img


@sprite("smoke")
def _smoke():
    # Stand-in for assets/misc_assets/towerDefense_tile295.png (thrust puff)
    img = _blank()
    img = _fill(img, _disc(0.5, 0.5, 0.4, soft=8.0), (0.85, 0.85, 0.85))
    return img


# ---------------------------------------------------------------------------
# Chaser (games/chaser/tilemap.cpp:10-15, common_systems.cpp:108-115:
# stone wall tile, point dot, spikey egg, 3-frame flyer, fleeing walker,
# floating agent; orb reuses the crystal sprite)
# ---------------------------------------------------------------------------

@sprite("stone_wall")
def _stone_wall():
    # Stand-in for assets/misc_assets/tileStone_slope.png (chaser tilemap.cpp:10)
    return _textured_tile("stone_wall", (0.45, 0.45, 0.5), border=(0.3, 0.3, 0.34))


@sprite("chaser_point")
def _chaser_point():
    # Stand-in for assets/custom/chaser_point.png — small pellet dot
    img = _blank()
    img = _fill(img, _disc(0.5, 0.5, 0.12), (0.98, 0.93, 0.6))
    return img


@sprite("egg_spikey")
def _egg_spikey():
    # Stand-in for assets/misc_assets/enemySpikey_1b.png (unhatched enemy)
    img = _blank()
    x, y = _grid()
    ang = np.arctan2(y - 0.55, x - 0.5)
    spikes = (np.sin(ang * 9) * 0.5 + 0.5) * 0.08
    ring = np.clip((0.3 + spikes - np.hypot(x - 0.5, y - 0.55)) * S / 1.5, 0, 1)
    img = _fill(img, ring, (0.75, 0.45, 0.85))
    img = _fill(img, _disc(0.5, 0.55, 0.22), (0.85, 0.6, 0.9))
    return img


def _register_flyers():
    # Stand-ins for assets/misc_assets/enemyFlying_{1,2,3}.png +
    # enemyWalking_1b.png (chaser common_systems.cpp:111-114)
    def flyer(phase):
        img = _blank()
        img = _fill(img, _disc(0.5, 0.55, 0.26), (0.9, 0.35, 0.3))
        wing_y = 0.42 + 0.12 * phase
        img = _fill(img, _box(0.05, wing_y, 0.3, wing_y + 0.14, soft=2.0), (0.95, 0.6, 0.55))
        img = _fill(img, _box(0.7, wing_y, 0.95, wing_y + 0.14, soft=2.0), (0.95, 0.6, 0.55))
        img = _fill(img, _disc(0.42, 0.5, 0.045), (0.05, 0.05, 0.08))
        img = _fill(img, _disc(0.58, 0.5, 0.045), (0.05, 0.05, 0.08))
        return img

    for i in range(3):
        _REGISTRY[f"flyer{i}"] = (lambda p=i / 2.0: flyer(p))

    def walker_flee():
        img = _blank()
        img = _fill(img, _disc(0.5, 0.6, 0.28), (0.4, 0.5, 0.95))
        img = _fill(img, _disc(0.42, 0.52, 0.05), (1.0, 1.0, 1.0))
        img = _fill(img, _disc(0.58, 0.52, 0.05), (1.0, 1.0, 1.0))
        return img

    _REGISTRY["walker_flee"] = walker_flee


@sprite("floater")
def _floater():
    # Stand-in for assets/misc_assets/enemyFloating_1b.png (the chaser agent,
    # common_systems.cpp:302)
    img = _blank()
    img = _fill(img, _disc(0.5, 0.5, 0.32), (0.95, 0.8, 0.25))
    img = _fill(img, _disc(0.4, 0.44, 0.05), (0.05, 0.05, 0.08))
    img = _fill(img, _disc(0.6, 0.44, 0.05), (0.05, 0.05, 0.08))
    x, y = _grid()
    mouth = (np.hypot(x - 0.5, y - 0.58) < 0.14) & (y > 0.6)
    img = _fill(img, mouth.astype(np.float32), (0.4, 0.2, 0.1))
    return img


# ---------------------------------------------------------------------------
# Jumper (games/jumper/tilemap.cpp:24-25, common_systems.cpp:50-54,
# jumper.cpp:297-299): bunny agent, carrot goal, spike-man hazard, compass
# HUD textures
# ---------------------------------------------------------------------------

@sprite("carrot")
def _carrot():
    # Stand-in for assets/misc_assets/carrot.png
    img = _blank()
    x, y = _grid()
    cone = np.clip(((1.0 - y) * 0.35 - np.abs(x - 0.5)) * S / 1.5, 0, 1) * (y > 0.25)
    img = _fill(img, cone, (0.95, 0.5, 0.15))
    leaf = _disc(0.42, 0.2, 0.1) + _disc(0.58, 0.2, 0.1) + _disc(0.5, 0.14, 0.1)
    img = _fill(img, np.clip(leaf, 0, 1), (0.35, 0.75, 0.25))
    return img


@sprite("spikeman")
def _spikeman():
    # Stand-in for assets/misc_assets/spikeMan_stand.png. The reference
    # draws it offset (-0.25,-0.25), scale 0.4 from the cell center
    # (tilemap.cpp:49); we bake that sub-cell placement into the tile art
    # (body occupies [0.25, 0.65]^2 of the cell).
    img = _blank()
    x, y = _grid()
    ang = np.arctan2(y - 0.45, x - 0.45)
    spikes = (np.sin(ang * 10) * 0.5 + 0.5) * 0.05
    ring = np.clip((0.17 + spikes - np.hypot(x - 0.45, y - 0.45)) * S / 1.2, 0, 1)
    img = _fill(img, ring, (0.85, 0.55, 0.15))
    img = _fill(img, _disc(0.45, 0.45, 0.12), (0.95, 0.7, 0.25))
    img = _fill(img, _disc(0.41, 0.42, 0.025), (0.05, 0.05, 0.08))
    img = _fill(img, _disc(0.49, 0.42, 0.025), (0.05, 0.05, 0.08))
    return img


def _register_bunny():
    # Stand-in for assets/misc_assets/bunny2_{ready,jump,walk1,walk2}.png
    def bunny(kind):
        img = _blank()
        c = (0.92, 0.88, 0.85)
        img = _fill(img, _disc(0.5, 0.62, 0.24), c)  # body
        img = _fill(img, _disc(0.5, 0.34, 0.16), c)  # head
        # ears
        x, y = _grid()
        for ex in (0.42, 0.58):
            ear = (np.abs(x - ex) < 0.05) & (y > 0.02) & (y < 0.3)
            img = _fill(img, ear.astype(np.float32), c)
        img = _fill(img, _disc(0.56, 0.32, 0.035), (0.1, 0.05, 0.08))
        if kind == "jump":
            img = _fill(img, _box(0.2, 0.75, 0.45, 0.9, soft=2.0), tuple(v * 0.85 for v in c))
            img = _fill(img, _box(0.55, 0.75, 0.8, 0.9, soft=2.0), tuple(v * 0.85 for v in c))
        elif kind == "walk1":
            img = _fill(img, _box(0.3, 0.82, 0.5, 0.95, soft=2.0), tuple(v * 0.85 for v in c))
        elif kind == "walk2":
            img = _fill(img, _box(0.5, 0.82, 0.7, 0.95, soft=2.0), tuple(v * 0.85 for v in c))
        return img

    for kind in ("stand", "jump", "walk1", "walk2"):
        _REGISTRY[f"bunny_{kind}"] = (lambda k=kind: bunny(k))


@sprite("compass_circle")
def _compass_circle():
    # Stand-in for assets/custom/jumper_compass_circle.png: an opaque grey
    # disc (verified alpha=255 inside) with a darker rim.
    img = _blank()
    img = _fill(img, _disc(0.5, 0.5, 0.5, soft=1.2), (0.63, 0.63, 0.6))
    x, y = _grid()
    d = np.hypot(x - 0.5, y - 0.5)
    rim = np.clip((0.5 - d) * S / 1.2, 0, 1) * np.clip((d - 0.44) * S / 1.2, 0, 1)
    img = _fill(img, rim, (0.45, 0.45, 0.42))
    return img


@sprite("solid_yellow")
def _solid_yellow():
    # Needle/bar texture (fully opaque yellow, like the reference PNGs)
    img = _blank()
    img = _fill(img, np.ones((S, S)), (0.99, 1.0, 0.01))
    return img


_register_wall_tiles()
_register_lava()
_register_crates()
_register_enemies()
_register_saw()
_register_agents()
_register_climber_tiles()
_register_swimmer()
_register_flyers()
_register_explosions()
_register_bunny()
_register_bossfight()
_register_agents(themes=CLIMBER_AGENT_THEMES, prefix="climber")


# ---------------------------------------------------------------------------
# Atlas builders
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def build_atlas(names: Tuple[str, ...]) -> Tuple[np.ndarray, Dict[str, int]]:
    """Pack named sprites into `uint8[N, S, S, 4]` + name->index map."""
    imgs = []
    index = {}
    for i, name in enumerate(names):
        if name not in _REGISTRY:
            raise KeyError(f"unknown sprite {name!r}; registered: {sorted(_REGISTRY)}")
        imgs.append(_to_u8(_REGISTRY[name]()))
        index[name] = i
    return np.stack(imgs), index


BG_SIZE = 64  # matches the obs resolution: backgrounds are sampled at
#               most once per obs pixel


@functools.lru_cache(maxsize=None)
def build_backgrounds(kind: str, n: int) -> np.ndarray:
    """Procedural episode backgrounds, `uint8[n, BG_SIZE, BG_SIZE, 3]`:
    stand-ins for the per-game background PNG lists (the ~50 coinrun
    backgrounds in games/coinrun/coinrun.cpp:60-110, bossfight's 13 space
    backgrounds in games/bossfight/bossfight.cpp:54-67, the 9 topdown
    backgrounds of maze and chaser in games/maze/maze.cpp:62-72)."""
    out = np.zeros((n, BG_SIZE, BG_SIZE, 3), np.uint8)
    c = (np.arange(BG_SIZE) + 0.5) / BG_SIZE
    x, y = np.meshgrid(c, c, indexing="xy")
    for i in range(n):
        rng = np.random.default_rng(_stable_seed((kind, i)))
        if kind == "topdown":
            base = rng.uniform(0.25, 0.55, 3)
            img = np.ones((BG_SIZE, BG_SIZE, 3)) * base
            # soft checker variation
            per = rng.integers(8, 24)
            checker = ((x * per).astype(int) + (y * per).astype(int)) % 2
            img *= (0.92 + 0.12 * checker)[..., None]
            img *= rng.uniform(0.92, 1.08, (BG_SIZE, BG_SIZE, 1))
        elif kind == "sky":
            top = rng.uniform([0.2, 0.4, 0.7], [0.5, 0.7, 1.0])
            bot = rng.uniform([0.6, 0.75, 0.85], [0.95, 1.0, 1.0])
            img = top[None, None] * (1 - y[..., None]) + bot[None, None] * y[..., None]
            for _ in range(rng.integers(3, 8)):  # clouds
                cx, cy, r = rng.uniform(0, 1), rng.uniform(0.05, 0.5), rng.uniform(0.04, 0.12)
                d = np.hypot((x - cx) * 1.8, y - cy)
                img += np.clip(r - d, 0, r)[..., None] * 2.5
            img = np.clip(img, 0, 1)
        elif kind == "space":
            img = np.zeros((BG_SIZE, BG_SIZE, 3)) + rng.uniform(0.0, 0.06, 3)
            stars = rng.random((BG_SIZE, BG_SIZE)) > 0.985
            img = np.where(stars[..., None], rng.uniform(0.7, 1.0, 3)[None, None], img)
            # nebula blob
            cx, cy = rng.uniform(0.2, 0.8, 2)
            d = np.hypot(x - cx, y - cy)
            img += np.clip(0.35 - d, 0, 1)[..., None] * rng.uniform(0.0, 0.25, 3)
            img = np.clip(img, 0, 1)
        else:
            raise ValueError(f"unknown background kind {kind!r}")
        out[i] = np.clip(np.round(img * 255), 0, 255).astype(np.uint8)
    return out


def rasterize_patch(name: str, w_px: float, h_px: float, rot: float = 0.0,
                    patch: int = 8, flip_x: bool = False) -> np.ndarray:
    """Pre-rasterize a sprite to a P x P pixel patch (uint8 [P, P, 4]).

    Nearest-neighbor sampling of the registered sprite scaled to
    (w_px, h_px) screen pixels, optionally rotated by `rot` radians
    (screen-clockwise, matching SDL_RenderTextureRotated's positive
    angles — games/caveflyer/renderer.cpp:84-101). The sprite quad is
    centered in the patch so a rotated quad's overhang stays inside.
    Rotation becomes a variant index of a pixel bank instead of a
    per-pixel gather.
    """
    src = _to_u8(_REGISTRY[name]()).astype(np.float32)
    P = patch
    # patch pixel centers relative to the sprite center
    c = np.arange(P) + 0.5 - P / 2
    px, py = np.meshgrid(c, c, indexing="xy")
    cosr, sinr = np.cos(rot), np.sin(rot)
    # inverse-rotate the pixel into sprite space
    u_f = (cosr * px + sinr * py) / w_px + 0.5
    v_f = (-sinr * px + cosr * py) / h_px + 0.5
    inside = (u_f >= 0) & (u_f < 1) & (v_f >= 0) & (v_f < 1)
    ui = np.clip((u_f * S).astype(np.int32), 0, S - 1)
    if flip_x:
        ui = S - 1 - ui
    vi = np.clip((v_f * S).astype(np.int32), 0, S - 1)
    out = src[vi, ui] * inside[..., None]
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def build_pixel_bank(specs: Tuple[tuple, ...], patch: int = 8) -> np.ndarray:
    """Stack rasterize_patch results: specs of (name, w_px, h_px[, rot
    [, flip_x]]) -> uint8 [V, 4, P, P] (planar: a stamp bank)."""
    imgs = []
    for spec in specs:
        name, w_px, h_px = spec[0], spec[1], spec[2]
        rot = spec[3] if len(spec) > 3 else 0.0
        flip = spec[4] if len(spec) > 4 else False
        imgs.append(rasterize_patch(name, w_px, h_px, rot, patch, flip))
    return np.stack(imgs).transpose(0, 3, 1, 2)
