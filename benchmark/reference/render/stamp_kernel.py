"""The stamp loop of the scene render's plain version: K premultiplied
stamps per env, from one or more stamp groups, alpha-blended over a
frame in slot (painter) order. A frozen copy of the port's
`blend_groups_reference`, which the plain scene render runs, so the
benchmark's reference launches no kernel of the program.

Per env and output pixel (r, c), for each stamp group (bank [V, 4, P, P],
var, scale, r0, c0 [N, K]) in order and each slot in order: a slot with
scale == 0 or var outside [0, V) is skipped; bank[var] is placed at
(r0, c0) clipped to [-P, obs]; under it contrib = bf16(texel * scale),
and frame = frame * (1 - a) + rgb, every bf16 multiply, subtract and add
rounded on its own (RNE).
"""
from __future__ import annotations

import torch

from .. import precision

_BF16 = torch.bfloat16


def blend_groups_reference(frame, groups):
    """Plain torch painter-order blend of stamp groups over `frame` bf16
    [N, 3, obs, obs] (the semantics above); returns the new frame. Each
    slot reads and writes only the P x P window under its stamp, in a copy
    of the frame padded by the largest P (so no window leaves it)."""
    if not groups:
        return frame
    N, _, obs, _ = frame.shape
    pad = max(g[0].shape[-1] for g in groups)
    fp = torch.nn.functional.pad(frame, (pad, pad, pad, pad))
    for bank, var, scale, r0, c0 in groups:
        bank = bank.to(_BF16)
        for k in range(var.shape[1]):
            idx, contrib, live = _window(bank, var[:, k], scale[:, k],
                                         r0[:, k], c0[:, k], obs, pad)
            win = fp[idx]
            blended = precision.blend(
                win * (1.0 - contrib[:, 3:4]) + contrib[:, :3])
            fp[idx] = torch.where(live[:, None, None, None], blended, win)
    return fp[:, :, pad:pad + obs, pad:pad + obs]


def _window_index(r0, c0, obs, pad, P, channels):
    """Index of the P x P windows at (r0, c0) int [N] in frames
    [N, >= channels, obs + 2 * pad, obs + 2 * pad] padded by `pad` >= P:
    each window starts at (r0, c0) clipped to [-P, obs], so its pixels
    outside [0, obs) fall in the padding."""
    N = r0.shape[0]
    dev = r0.device
    ii = torch.arange(P, device=dev)
    rows = r0.long().clamp(-P, obs)[:, None] + pad + ii  # [N, P]
    cols = c0.long().clamp(-P, obs)[:, None] + pad + ii
    return (torch.arange(N, device=dev)[:, None, None, None],
            torch.arange(channels, device=dev)[None, :, None, None],
            rows[:, None, :, None], cols[:, None, None, :])


def _window(bank, v, s, r0, c0, obs, pad, channels=3):
    """Slot k's stamp for every env, over its P x P window of a frame padded
    by `pad` >= P: (index of the window [N, channels, P, P], contrib bf16
    [N, 4, P, P] = bf16(texel * scale), live bool [N]: the slots not
    skipped); the window as `_window_index` places it."""
    V, _, P, _ = bank.shape
    s = s.to(torch.float32)
    v = v.long()
    live = (s != 0) & (v >= 0) & (v < V)
    idx = _window_index(r0, c0, obs, pad, P, channels)
    patch = bank[v.clamp(0, V - 1)]  # [N, 4, P, P]
    contrib = (patch.to(torch.float32) * s[:, None, None, None]).to(_BF16)
    return idx, contrib, live


