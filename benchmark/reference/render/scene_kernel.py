"""The scene render (B1, `scene_raw`) of the quantized camera: tile layer,
background and painter-order stamps. The program runs it as a
hand-written kernel; this frozen copy keeps only the port's plain torch
version, `scene_raw_reference`, and `scene_raw` runs it on every device.
`OBSERVERS` are called with each `scene_raw` call's arguments (the
benchmark's roofline reader counts B1's work from them).

Semantics, per env and output pixel (r, c):
  * the kind G and the background rgb under the pixel: y = ty0 + pad +
    TR[jy][r], x = tx0 + pad + TR[jx][c]; G and rgb are grid[y, x] and
    bg_bank[bg_i, :, y, x], 0 where (y, x) lies outside the padded grid
    or bg_i outside the bank; jy and jx are clamped to [0, qp), the phase
    is jy * qp + jx;
  * each tile entry i in order, where G == entry_kind[i] and entry_theme[i]
    is -1 or the env's theme: frame = frame * (1 - a) + rgb from
    tile_bank[phase, i];
  * each stamp group (bank [V, 4, P, P], var, scale, r0, c0 [N, K]) in
    order, each slot in order: a slot with scale == 0 or var outside
    [0, V) is skipped; bank[var] is placed at (r0, c0) clipped to
    [-P, obs]; under it contrib = bf16(texel * scale) and
    frame = frame * (1 - a) + rgb.
  Every bf16 multiply, subtract and add rounds on its own (RNE).
"""
from __future__ import annotations

import torch

from .. import precision
from .stamp_kernel import blend_groups_reference

_BF16 = torch.bfloat16


def _blend_tiles(frame, G, ph, theme, tile_bank, entry_kind, entry_theme):
    """The tile entries in order over `frame` bf16 [N, 3, obs, obs], where
    the kind field G [N, obs, obs] matches the entry's kind (and the env's
    theme its theme), from tile_bank[ph] (ph int [N] in range)."""
    for i, (kv, tv) in enumerate(zip(entry_kind, entry_theme)):
        m = G == int(kv)
        if tv >= 0:
            m = m & (theme == int(tv))[:, None, None]
        t = tile_bank[ph, i].to(_BF16)  # [N, 4, obs, obs]
        frame = torch.where(
            m[:, None], precision.blend(frame * (1.0 - t[:, 3:4]) + t[:, :3]),
            frame)
    return frame


def scene_raw_reference(gridp, ty0, tx0, jy, jx, bg_i, theme, bg_bank,
                        tr_tab, tile_bank, entry_kind, entry_theme, groups,
                        obs, qp, pad):
    """Plain torch version of the scene kernel (see the module docstring).

    gridp i8 [N, GP, GP]; ty0/tx0/jy/jx/bg_i/theme int [N]; bg_bank bf16
    [NB, 3, GP, GP]; tr_tab int [qp, 1, obs]; tile_bank bf16
    [qp*qp, NE, 4, obs, obs]; entry_kind/entry_theme int sequences of NE;
    groups [(bank bf16 [V, 4, P, P], var int [N, K], scale f32 [N, K],
    r0 int [N, K], c0 int [N, K])]. Returns bf16 [N, 3, obs, obs]."""
    N, GP, _ = gridp.shape
    dev = gridp.device
    NB = bg_bank.shape[0]
    tr = tr_tab.reshape(qp, obs).long()
    py = jy.long().clamp(0, qp - 1)
    px = jx.long().clamp(0, qp - 1)
    ys = ty0.long()[:, None] + pad + tr[py]  # [N, obs]
    xs = tx0.long()[:, None] + pad + tr[px]
    inb = (((ys >= 0) & (ys < GP))[:, :, None]
           & ((xs >= 0) & (xs < GP))[:, None, :])  # [N, obs, obs]
    yc = ys.clamp(0, GP - 1)
    xc = xs.clamp(0, GP - 1)
    n = torch.arange(N, device=dev)
    G = gridp[n[:, None, None], yc[:, :, None], xc[:, None, :]].long()
    G = torch.where(inb, G, torch.zeros_like(G))
    b = bg_i.long()
    bg_ok = inb & ((b >= 0) & (b < NB))[:, None, None]
    bg = bg_bank[b.clamp(0, NB - 1)[:, None, None, None],
                 torch.arange(3, device=dev)[None, :, None, None],
                 yc[:, None, :, None], xc[:, None, None, :]].to(_BF16)
    frame = torch.where(bg_ok[:, None], bg, torch.zeros_like(bg))

    frame = _blend_tiles(frame, G, py * qp + px, theme, tile_bank,
                         entry_kind, entry_theme)
    return blend_groups_reference(frame, groups)


OBSERVERS: list = []  # callables given each scene_raw call's arguments


def scene_raw(*args):
    """`scene_raw_reference(*args)` on any device; each of `OBSERVERS`
    sees the arguments first."""
    for fn in OBSERVERS:
        fn(args)
    return scene_raw_reference(*args)


