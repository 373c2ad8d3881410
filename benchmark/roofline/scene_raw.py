"""The work of one scene-kernel call (B1, `scene_raw`), counted from its
inputs. Frozen copy of chip_smoke.py's `scene_work` and its helpers.

Bytes: every element the kernel reads, counted once, and the output
written once. Of the grid and the background bank that is only the cells
under some env's camera window, of the tile bank only the texels some
tile blend reads; the per-env inputs, tr_tab and the stamp groups whole.
Operations: the tile and stamp blends this data needs, 7 f32 operations a
tile blend (1 - a, 3 multiplies, 3 adds) and 11 a stamp blend (4 texel *
scale, 1 - a, 3 multiplies, 3 adds).
"""
from __future__ import annotations

import torch

STAMP_OPS, TILE_OPS = 11, 7


def tensor_bytes(*trees):
    """Bytes of every tensor in (nested lists/tuples of) tensors."""
    n = 0
    for t in trees:
        if isinstance(t, torch.Tensor):
            n += t.numel() * t.element_size()
        elif isinstance(t, (list, tuple)):
            n += tensor_bytes(*t)
    return n


def stamp_blends(groups, obs):
    """Number of (pixel, stamp) blends the groups' data needs: each live
    slot blends over the part of its P x P patch inside the frame."""
    n = 0
    for bank, var, scale, r0, c0 in groups:
        V, P = bank.shape[0], bank.shape[-1]
        live = (scale != 0) & (var >= 0) & (var < V)

        def span(x0):
            x0 = x0.long().clamp(-P, obs)
            return (x0 + P).clamp(max=obs) - x0.clamp(min=0)

        n += int((live * span(r0).clamp(min=0) * span(c0).clamp(min=0)).sum())
    return n


def distinct(idx, valid, size):
    """Number of distinct values in idx[valid], all in [0, size)."""
    used = torch.zeros(size, dtype=torch.bool, device=idx.device)
    used[idx[valid]] = True
    return int(used.sum())


def tile_work(G, ph, theme, npix, nph, kinds, themes):
    """(tile blends, distinct tile-bank texels read) of the tile entries
    over kind field G [N, obs, obs] at phases ph int [N] (in range)."""
    N = G.shape[0]
    texel = (ph.long()[:, None] * npix
             + torch.arange(npix, device=G.device)).expand(N, npix)
    tiles = texels = 0
    for k, th in zip(kinds, themes):
        m = G == int(k)
        if th >= 0:
            m = m & (theme == int(th))[:, None, None]
        tiles += int(m.sum())
        texels += distinct(texel, m.reshape(N, npix), nph * npix)
    return tiles, texels


def work(args):
    """(bytes, f32 operations) that one scene_raw call needs on these
    inputs (the call's arguments in `scene_raw`'s order)."""
    (gridp, ty0, tx0, jy, jx, bg_i, theme, bg_bank, tr_tab, tile_bank,
     kinds, themes, groups, obs, qp, pad) = args
    N, GP, _ = gridp.shape
    NB, dev = bg_bank.shape[0], gridp.device
    tr = tr_tab.reshape(qp, obs).long()
    py, px = jy.long().clamp(0, qp - 1), jx.long().clamp(0, qp - 1)
    ys = ty0.long()[:, None] + pad + tr[py]
    xs = tx0.long()[:, None] + pad + tr[px]
    inb = (((ys >= 0) & (ys < GP))[:, :, None]
           & ((xs >= 0) & (xs < GP))[:, None, :])           # [N, obs, obs]
    cell = (ys.clamp(0, GP - 1)[:, :, None] * GP
            + xs.clamp(0, GP - 1)[:, None, :])
    ncell = torch.arange(N, device=dev)[:, None, None] * GP * GP + cell
    b = bg_i.long()[:, None, None]
    bg_ok = inb & (b >= 0) & (b < NB)
    grid_cells = distinct(ncell, inb, N * GP * GP)
    bg_cells = distinct(b.clamp(0, NB - 1) * GP * GP + cell, bg_ok,
                        NB * GP * GP)
    G = torch.where(inb, gridp.reshape(-1)[ncell].long(), 0)
    npix = obs * obs
    tiles, texels = tile_work(G, py * qp + px, theme, npix, qp * qp, kinds,
                              themes)
    nbytes = (grid_cells * gridp.element_size()
              + bg_cells * 3 * bg_bank.element_size()
              + texels * 4 * tile_bank.element_size()
              + tensor_bytes(ty0, tx0, jy, jx, bg_i, theme, tr_tab, groups)
              + N * 3 * npix * 2)
    return nbytes, TILE_OPS * tiles + STAMP_OPS * stamp_blends(groups, obs)
