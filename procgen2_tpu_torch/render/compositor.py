"""Compositor pieces of the port (procgen2_tpu/render/compositor.py):
the stamp banks and pixel-snapped stamp groups that the scene kernel and
the stamp kernels blend or sum.

Stamps are blended in painter order on every device, which is the TPU's
semantics (`compositor.composite_stamps` on the TPU kernel path). The JAX
package's CPU path sums the premultiplied stamps of a group by matmul
instead, which only approximates overlapping stamps; that backend
difference is not carried over. The exact (per-env camera) paths are not
ported yet."""
from __future__ import annotations

import numpy as np
import torch

from . import stamp_kernel

OBS = 64  # observation width/height, games/maze/maze.cpp:26-27


def _premultiply_bank(pbank) -> torch.Tensor:
    """u8 [V, 4, P, P] -> premultiplied bf16 bank: rgb * a and a, with
    a = alpha / 255, computed in f32 and rounded to bf16 (RNE)."""
    pbank = torch.from_numpy(np.ascontiguousarray(pbank)).to(torch.float32)
    a_tex = pbank[:, 3:4] * (1.0 / 255.0)
    return torch.cat([pbank[:, :3] * a_tex, a_tex], dim=1).to(torch.bfloat16)


def _stamp_scale(N, K, alives=None, alpha=None, device=None):
    """Per-slot weight f32 [N, K]: alive * alpha (0 skips the slot)."""
    scale = torch.ones((N, K), dtype=torch.float32, device=device)
    if alives is not None:
        scale = scale * alives.to(torch.float32)
    if alpha is not None:
        scale = scale * torch.as_tensor(alpha, dtype=torch.float32,
                                        device=device)
    return scale


def stamp_group(prem_bank, var_idx, r0, c0, alives=None, alpha=None):
    """One stamp group as the kernels take it: (bank, var i32, scale f32,
    r0 i32, c0 i32), [N, K] each. prem_bank: premultiplied bf16
    [V, 4, P, P] on the device of var_idx; r0/c0: top-left obs pixel."""
    N, K = var_idx.shape
    i32 = torch.int32
    return (prem_bank, var_idx.to(i32).contiguous(),
            _stamp_scale(N, K, alives, alpha, var_idx.device),
            r0.to(i32).contiguous(), c0.to(i32).contiguous())


def composite_stamps(img, prem_bank, var_idx, r0, c0, alives=None,
                     alpha=None):
    """Alpha-blend K pixel-snapped stamps per env OVER `img` bf16
    [N, 3, OBS, OBS], in slot (painter) order: one stamp-kernel launch on
    the card. Unlike the JAX function, the bank comes premultiplied
    (`_premultiply_bank`, once per bank and device)."""
    return stamp_kernel.composite(
        img, [stamp_group(prem_bank, var_idx, r0, c0, alives, alpha)])


def stamps_from_pixel_bank(prem_bank, var_idx, r0, c0, alives=None,
                           alpha=None):
    """Sum K pixel-snapped stamps per env into a zeroed frame, in slot
    order: one stamp-sum kernel launch on the card. Returns premultiplied
    (rgbp bf16 [N, 3, OBS, OBS], a bf16 [N, 1, OBS, OBS]). Unlike the JAX
    function, the bank comes premultiplied (`_premultiply_bank`), and the
    sum is the TPU kernel's ordered bf16 sum on every device (the JAX CPU
    path sums by matmul, in another order)."""
    return stamp_kernel.stamps(
        *stamp_group(prem_bank, var_idx, r0, c0, alives, alpha), OBS)
