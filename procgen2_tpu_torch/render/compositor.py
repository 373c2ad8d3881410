"""Compositor pieces of the port (procgen2_tpu/render/compositor.py):
the stamp banks and pixel-snapped stamp groups that the scene kernel and
the stamp kernels blend or sum, and the kind-field helpers of the fixed
and cell-quantized cameras (maze, chaser).

The JAX package samples textures and kind grids with bf16 one-hot
matmuls (`_onehot`, `_sep_sample`, `draw_background_batch`): every output
element has exactly one nonzero product, a 0/1 selector times a texel
<= 255 or a kind <= 6, so the product is exact. Here they are index
gathers, with the `valid` masks as zeroed rows: the same values on every
device, without a matmul.

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
from .atlas import SPRITE_SIZE

OBS = 64  # observation width/height, games/maze/maze.cpp:26-27
S = SPRITE_SIZE
_BF16 = torch.bfloat16


def camera_coords(ppu, cam_x, cam_y):
    """Separable world coords of the obs pixel centres under a camera at
    (cam_x, cam_y), ppu obs pixels per world unit: (wx, wy) f32
    [..., OBS], cam + c / ppu with c = arange(OBS) + 0.5 - OBS/2 (the JAX
    package's `camera_coords`). cam_x, cam_y: f32 tensors of any batch
    shape. The offsets c / ppu are a true f32 division taken on the CPU
    (CUDA divides by a host scalar as a multiply by its reciprocal), so
    every device gets the same coords."""
    c = np.arange(OBS, dtype=np.float32) + np.float32(0.5 - OBS / 2)
    offs = torch.from_numpy(c / np.float32(ppu))
    offs_x = offs.to(cam_x.device)
    offs_y = offs.to(cam_y.device)
    return cam_x[..., None] + offs_x, cam_y[..., None] + offs_y


def texel_index(x, n):
    """The index of fraction x in n texels, clip(int(x * n), 0, n - 1),
    the int cast truncating toward zero (as `astype(int32)`), and
    whether x lies in [0, 1): (int64, bool) of x's shape."""
    return ((x * n).to(torch.int32).clamp(0, n - 1).long(),
            (x >= 0) & (x < 1))


def sep_sample(tex, rows, cols, row_ok=None, col_ok=None):
    """tex [..., H, W] sampled at rows [R] x cols [C] -> [..., R, C],
    zero in a row or column that is not ok: `_sep_sample(tex,
    _onehot(rows, H, row_ok), _onehot(cols, W, col_ok))` of the JAX
    package, as a gather."""
    out = tex[..., rows, :][..., cols]
    if row_ok is not None:
        out = out * row_ok[:, None].to(out.dtype)
    if col_ok is not None:
        out = out * col_ok.to(out.dtype)
    return out


def draw_background_batch(bgs, bg_index, wx_b, wy_b):
    """Per-env (moving) cameras' backgrounds, the JAX package's
    `draw_background_batch` as maze calls it: background `bg_index` of
    bgs u8 [B, 3, H, W] (env-major, on the device) spans 64 world units
    from the origin, sampled nearest at the pixel centres wx_b / wy_b f32
    [N, OBS], over a black clear colour: bf16 [N, 3, OBS, OBS], 0 off the
    background. (The JAX package's base * (1 - a) + rgb * a, each op
    rounded, gives these values for the black base.) XLA CPU divides by
    64 as a multiply by its reciprocal, which is exact."""
    _, _, H, W = bgs.shape
    N = bg_index.shape[0]
    ui, in_u = texel_index(wx_b * (1 / 64.0), W)  # [N, OBS]
    vi, in_v = texel_index(wy_b * (1 / 64.0), H)
    flat = (vi[:, :, None] * W + ui[:, None, :]).reshape(N, 1, -1)
    tex = bgs[bg_index.long()].reshape(N, 3, H * W)
    ok = in_v[:, :, None] & in_u[:, None, :]  # [N, OBS, OBS]
    rgb = tex.gather(2, flat.expand(N, 3, flat.shape[-1])).reshape(
        N, 3, ok.shape[1], ok.shape[2]).to(_BF16)
    return rgb * ok[:, None].to(_BF16)


def blend_kind(img, mask, kimg_rgb, kimg_a):
    """One kind layer over img bf16 [N, 3, OBS, OBS], as the JAX package's
    kind-field renders blend (maze.py:341-349, chaser.py:697-707):
    a = bf16(mask) * kimg_a, then img + a * (kimg_rgb - img), every bf16
    op rounded on its own. mask bool [N, 1, OBS, OBS]; kimg_rgb bf16
    [3, OBS, OBS]; kimg_a bf16 [OBS, OBS], the kind image's alpha times
    bf16(1/255) (a constant product, rounded to bf16)."""
    a = mask.to(_BF16) * kimg_a
    return img + a * (kimg_rgb - img)


def kind_image(tex, rows, cols, row_ok=None, col_ok=None):
    """A kind's texel image under the fixed camera: tex u8 [4, S, S]
    (planar RGBA) sampled by `sep_sample` in bf16, split into (rgb bf16
    [3, R, C], alpha * bf16(1/255) bf16 [R, C]) as `blend_kind` takes
    them."""
    k = sep_sample(torch.from_numpy(np.ascontiguousarray(tex)).to(_BF16),
                   torch.as_tensor(rows).long(), torch.as_tensor(cols).long(),
                   None if row_ok is None else torch.as_tensor(row_ok),
                   None if col_ok is None else torch.as_tensor(col_ok))
    return k[:3], k[3] * torch.tensor(1 / 255.0, dtype=_BF16)


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
