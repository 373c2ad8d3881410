"""Compositor pieces of the port (procgen2_tpu/render/compositor.py):
the stamp banks and pixel-snapped stamp groups that the scene kernel and
the stamp kernels blend or sum.

A stamp group of patch size P and K slots is drawn with one of two
semantics, chosen per (P, K) by `stamp_kernel_ok` as the reference
chooses on the TPU:
  * on the kernel path, the TPU kernels' semantics, computed by the port's
    kernels B3 (`composite_stamps`: painter order) and B4
    (`stamps_from_pixel_bank`: an ordered sum, each add rounded to bf16);
  * off it, the reference's matmul semantics (`_stamps_matmul`,
    `blend_premul`) on every device and backend: the premultiplied stamps
    summed in f32 and rounded once to bf16, then one blend over the
    frame. No TPU kernel runs there, and the port runs plain torch ops.
The exact (per-env camera) paths are not ported yet."""
from __future__ import annotations

import numpy as np
import torch

from .. import random as prng
from . import stamp_kernel

OBS = 64  # observation width/height, games/maze/maze.cpp:26-27
_BF16 = torch.bfloat16


def _premultiply_bank(pbank) -> torch.Tensor:
    """u8 [V, 4, P, P] -> premultiplied bf16 bank: rgb * a and a, with
    a = alpha / 255, computed in f32 and rounded to bf16 (RNE)."""
    pbank = torch.from_numpy(np.ascontiguousarray(pbank)).to(torch.float32)
    a_tex = pbank[:, 3:4] * (1.0 / 255.0)
    return torch.cat([pbank[:, :3] * a_tex, a_tex], dim=1).to(_BF16)


def _win(P):
    """The TPU kernels' aligned row window: P rows at any offset within a
    tile of 8 rows fit in it (procgen2_tpu/render/stamp_kernel.py::_win)."""
    return ((P + 7) // 8 + 1) * 8


def stamp_kernel_ok(P, K):
    """True where the reference draws a stamp group of patch size P and K
    slots with its TPU stamp kernels, False where it takes the matmul
    path (`procgen2_tpu/render/compositor.py::_stamp_kernel_ok`, as it
    evaluates on the TPU at OBS = 64).

    The bounds are the reference's speed choice on a TPU v5e at 4096 envs
    (the kernel pays per live slot, the matmuls per slot and per band of
    P rows), plus the kernel's row window fitting the frame. Because the
    two paths round differently, here they also fix what the port
    computes, on every device: the port follows the reference's choice,
    not the H100's speed."""
    return ((P >= 12 or (P >= 6 and K * P >= 96) or (P <= 6 and K >= 16))
            and _win(P) <= OBS)


def stamp_origin(centres, cam_x, cam_y, ppu, P):
    """The top-left obs pixel of P x P stamps centred at centres
    [N, K, 2] under the camera (cam_x, cam_y) [N], at ppu obs pixels per
    world unit: (c - cam) * ppu + OBS/2 - P/2, as f32 (y, x) before
    rounding. The JAX renders write ((c - cam) * ppu + OBS/2) - P/2; XLA
    CPU folds the two constants into one and fuses the multiply-add, so
    the sum is rounded once (`random._fma32`; where the product is exact,
    as at ppu = 8, that is the plain sum)."""
    c = OBS / 2 - P / 2
    return (prng._fma32(centres[..., 1] - cam_y[:, None], ppu, c),
            prng._fma32(centres[..., 0] - cam_x[:, None], ppu, c))


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


def _stamps_matmul(prem_bank, var_idx, r0, c0, alives=None, alpha=None):
    """The reference's matmul semantics of a stamp group
    (`_stamps_matmul` + `place_stamps`), as plain torch ops on any device.
    Per slot, the weight is bf16(bf16(alive) * bf16(alpha)) (the
    reference scales its bf16 one-hot rows), the stamp is
    bf16(weight * texel); the stamps are added in f32 over their windows,
    and the sum is rounded once to bf16. Returns premultiplied
    (rgbp bf16 [N, 3, OBS, OBS], a bf16 [N, 1, OBS, OBS])."""
    N, K = var_idx.shape
    dev = var_idx.device
    bank = prem_bank.to(_BF16)
    P = bank.shape[-1]
    w = torch.ones((N, K), dtype=_BF16, device=dev)
    if alives is not None:
        w = w * alives.to(_BF16)
    if alpha is not None:
        w = w * torch.as_tensor(alpha, device=dev).to(_BF16)
    acc = torch.zeros((N, 4, OBS + 2 * P, OBS + 2 * P), dtype=torch.float32,
                      device=dev)
    for k in range(K):
        idx, contrib, live = stamp_kernel._window(
            bank, var_idx[:, k], w[:, k], r0[:, k], c0[:, k], OBS, P,
            channels=4)
        acc[idx] += torch.where(live[:, None, None, None], contrib.float(),
                                0.0)
    acc = acc[:, :, P:P + OBS, P:P + OBS].to(_BF16)
    return acc[:, :3], acc[:, 3:4]


def blend_premul(img, rgbp, a):
    """img [N, 3, OBS, OBS] under premultiplied stamps, all bf16:
    img * (1 - a) + rgbp, each op rounded to bf16."""
    return img * (1.0 - a) + rgbp


def composite_stamps(img, prem_bank, var_idx, r0, c0, alives=None,
                     alpha=None):
    """Alpha-blend K pixel-snapped stamps per env OVER `img` bf16
    [N, 3, OBS, OBS]. On the kernel path (`stamp_kernel_ok`) in slot
    (painter) order, one B3 launch on the card; off it, the group's
    matmul sum blended once (`_stamps_matmul`, `blend_premul`). Unlike
    the JAX function, the bank comes premultiplied (`_premultiply_bank`,
    once per bank and device)."""
    if stamp_kernel_ok(prem_bank.shape[-1], var_idx.shape[1]):
        return stamp_kernel.composite(
            img, [stamp_group(prem_bank, var_idx, r0, c0, alives, alpha)])
    rgbp, a = _stamps_matmul(prem_bank, var_idx, r0, c0, alives, alpha)
    return blend_premul(img, rgbp, a)


def stamps_from_pixel_bank(prem_bank, var_idx, r0, c0, alives=None,
                           alpha=None):
    """Sum K pixel-snapped stamps per env into a zeroed frame. On the
    kernel path (`stamp_kernel_ok`) the TPU kernel's ordered bf16 sum, one
    B4 launch on the card; off it, the matmul sum (`_stamps_matmul`).
    Returns premultiplied (rgbp bf16 [N, 3, OBS, OBS], a bf16
    [N, 1, OBS, OBS]). Unlike the JAX function, the bank comes
    premultiplied (`_premultiply_bank`)."""
    if stamp_kernel_ok(prem_bank.shape[-1], var_idx.shape[1]):
        return stamp_kernel.stamps(
            *stamp_group(prem_bank, var_idx, r0, c0, alives, alpha), OBS)
    return _stamps_matmul(prem_bank, var_idx, r0, c0, alives, alpha)
