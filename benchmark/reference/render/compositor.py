"""The compositor pieces that maze's and coinrun's main paths use: a
frozen copy of the port's `render/compositor.py` (the kind-field blends
and texel images of maze's fixed camera, the premultiplied stamp banks
and the stamps' pixel origin of coinrun's scene render).

The JAX package samples textures and kind grids with bf16 one-hot
matmuls; every output element has exactly one nonzero product, so the
product is exact, and here they are index gathers with the `valid` masks
as zeroed rows: the same values on every device, without a matmul."""
from __future__ import annotations

import numpy as np
import torch

from .. import precision
from .. import random as prng
from .atlas import SPRITE_SIZE

OBS = 64  # observation width/height, games/maze/maze.cpp:26-27
S = SPRITE_SIZE
_BF16 = torch.bfloat16


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


def blend_kind(img, mask, kimg_rgb, kimg_a):
    """One kind layer over img bf16 [N, 3, OBS, OBS], as the JAX package's
    kind-field renders blend (maze.py:341-349, chaser.py:697-707):
    a = bf16(mask) * kimg_a, then img + a * (kimg_rgb - img), every bf16
    op rounded on its own. mask bool [N, 1, OBS, OBS]; kimg_rgb bf16
    [3, OBS, OBS]; kimg_a bf16 [OBS, OBS], the kind image's alpha times
    bf16(1/255) (a constant product, rounded to bf16); or, per env,
    kimg_rgb [N, 3, OBS, OBS] and kimg_a [N, 1, OBS, OBS]."""
    a = mask.to(_BF16) * kimg_a
    return precision.blend(img + a * (kimg_rgb - img))


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
