"""Procedural sprite atlas, backgrounds and pixel banks (numpy) of maze
and coinrun: a frozen copy of the port's `render/atlas.py`, cut to the
sprites and backgrounds those two games draw; everything kept is
unchanged. Every sprite is generated deterministically in numpy from a
seed that depends only on its name, and packed into one
`uint8[N, S, S, 4]` array; games name sprites and get atlas indices back.
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


_register_wall_tiles()
_register_lava()
_register_crates()
_register_enemies()
_register_saw()
_register_agents()


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
    backgrounds in games/coinrun/coinrun.cpp:60-110, the 9 topdown
    backgrounds of maze in games/maze/maze.cpp:62-72)."""
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
