"""Quantized-camera texel phases of the scene render (numpy).

The port's own copy of what the ported games use from the JAX package's
`procgen2_tpu/render/phases.py`: the phase tables, the window span, the
expansion tables and the tile phase bank, unchanged, so the arrays are
identical (tests/test_torch_assets.py).

The render camera is quantized to 1/QP world units (render only; physics
never sees it). With cam = m/QP the world x under obs pixel c is

    wx(c) = m/QP + (c + 0.5 - OBS/2) / ppu

whose fractional structure (which tile column each pixel hits relative
to the leftmost visible tile, and which texel inside it) depends only on
m mod QP. So every quantity the renderer needs is a table lookup:

  * TR[j][pix]  tile offset from the window origin,
  * VV[j][pix]  texel row/col inside the tile,
  * per-phase 0/1 expansion matrices Ey [OBS, WIN] / Ex [WIN, OBS] that
    lift a WIN x WIN tile-resolution window to pixel resolution,
  * a pre-pixelized [QP*QP, kinds, 4, OBS, OBS] premultiplied tile bank,
    one entry per joint phase (the nearest-sampled image of an infinite
    plane of that kind).

All tables are exact: the math runs in `fractions.Fraction`.
"""
from __future__ import annotations

import functools
from fractions import Fraction

import numpy as np

from .atlas import SPRITE_SIZE

S = SPRITE_SIZE
WIN = 16  # tile-window size for ppu >= 4.8 games (<= 14 visible tiles
#           + phase); wider views compute their own via `win()`


def _frac_ppu(ppu: float) -> Fraction:
    f = Fraction(ppu).limit_denominator(10000)
    if abs(float(f) - ppu) >= 1e-9:
        raise ValueError(f"ppu {ppu} is not a small fraction")
    return f


@functools.lru_cache(maxsize=None)
def phase_tables(ppu: float, obs: int = 64, qp: int = 4):
    """Per-phase pixel->tile maps.

    Returns (TR, VV, t0_off) with TR int32 [qp, obs] (tile index offset
    from the window origin tile), VV int32 [qp, obs] (texel row in
    [0, S)), and t0_off: float world offset such that the window origin
    tile of an env is floor(camq + t0_off). x and y share tables (the
    camera transform is the same affine map per axis,
    renderer.cpp:13-27).
    """
    fppu = _frac_ppu(ppu)
    q = Fraction(1, qp)
    t0_off = Fraction(1 - obs, 2) / fppu  # = (0.5 - obs/2)/ppu
    TR = np.zeros((qp, obs), np.int32)
    VV = np.zeros((qp, obs), np.int32)
    for j in range(qp):
        camq = j * q
        t0 = (camq + t0_off).__floor__()
        for c in range(obs):
            wx = camq + Fraction(2 * c + 1 - obs, 2) / fppu
            t = wx.__floor__()
            TR[j, c] = t - t0
            VV[j, c] = ((wx - t) * S).__floor__()
    return TR, VV, float(t0_off)


@functools.lru_cache(maxsize=None)
def _tile_phase_bank_cached(tex_bytes, shape, ppu, obs, qp):
    textures = np.frombuffer(tex_bytes, np.uint8).reshape(shape)
    TR, VV, _ = phase_tables(ppu, obs, qp)
    K = textures.shape[0]
    bank = np.zeros((qp * qp, K, 4, obs, obs), np.float32)
    for jy in range(qp):
        vv = VV[jy]
        for jx in range(qp):
            uu = VV[jx]
            # the pixelized infinite plane of each kind at this joint
            # phase (the kind mask supplies placement)
            px = textures[:, :, vv][:, :, :, uu].astype(np.float32)
            a = px[:, 3:4] / 255.0
            bank[jy * qp + jx, :, :3] = px[:, :3] * a  # premultiplied
            bank[jy * qp + jx, :, 3:4] = a
    return bank


def tile_phase_bank(textures: np.ndarray, ppu: float, obs: int = 64,
                    qp: int = 4) -> np.ndarray:
    """Pre-pixelized premultiplied tile bank, f32
    [qp*qp, K, 4, obs, obs] (rgb * a, a in [0, 1]).

    textures: uint8 [K, 4, S, S] tile RGBA textures (kind order = the
    scene kernel's entry order).
    """
    t = np.ascontiguousarray(np.asarray(textures, np.uint8))
    return _tile_phase_bank_cached(t.tobytes(), t.shape, ppu, obs, qp)
