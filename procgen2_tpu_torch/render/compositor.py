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

The exact renders (each game's `observe` at any size, the batched
`scene_phases=0` paths) draw a frame layer by layer: a background, tile
layers and sprites, each a blend over the whole frame. Their sprites are
sampled by the same index gathers, and a rotated sprite by a 2-D gather.
Every function takes a batch (leading N) and the target size as an
argument (`size`, 64 for the obs); nothing is module state."""
from __future__ import annotations

import numpy as np
import torch

from .. import random as prng
from .. import trig
from . import stamp_kernel
from .atlas import SPRITE_SIZE

OBS = 64  # observation width/height, games/maze/maze.cpp:26-27
S = SPRITE_SIZE
_BF16 = torch.bfloat16


def recip32(w):
    """f32(1 / f32(w)) of a host number w: XLA CPU rewrites a division by
    a constant, x / w, as x * (1 / w), the reciprocal folded in f32."""
    return float(np.float32(1.0) / np.float32(w))


def camera_coords(ppu, cam_x, cam_y, size=OBS, fused=True):
    """Separable world coords of the pixel centres of a size x size frame
    under a camera at (cam_x, cam_y), ppu pixels per world unit: (wx, wy)
    f32 [N, size], the JAX package's cam + c / ppu with c = arange(size)
    + 0.5 - size/2, as XLA CPU computes it: c / ppu is a multiply by the
    f32 reciprocal, fused with the add of the camera, so each coord is
    fma(c, f32(1/ppu), cam), rounded once. That holds where a render
    computes the coords inside the fusion that uses them (every render
    here, single-env and batched). The pixel maps that a `draw_sprites`
    loop reads are computed on their own before the loop, where LLVM
    folds c * f32(1/ppu) into rounded constants: cam + f32(c / ppu)
    there, two roundings (`fused=False`). The two differ only where the
    reciprocal is inexact (ppu 4.8: coinrun, jumper). cam_x, cam_y: f32
    [N]."""
    c = (torch.arange(size, dtype=torch.float32, device=cam_x.device)
         + (0.5 - size / 2))
    r = recip32(ppu)
    if not fused:
        return cam_x[:, None] + c * r, cam_y[:, None] + c * r
    return (prng._fma32(c, r, cam_x[:, None]),
            prng._fma32(c, r, cam_y[:, None]))


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
    bf16(1/255) (a constant product, rounded to bf16); or, per env,
    kimg_rgb [N, 3, OBS, OBS] and kimg_a [N, 1, OBS, OBS]."""
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


# ---------------------------------------------------------------------------
# Exact renders: background, tile layers and sprites, each blended over the
# whole frame (the JAX package's compositor.py:86-320, 622-709)
# ---------------------------------------------------------------------------

def bank(planar, device):
    """A planar u8 asset stack [C, A, H, W] (the atlas, the backgrounds)
    as u8 [A, C, H, W] on `device`, the layout the exact render gathers
    from."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(planar).transpose(1, 0, 2, 3))).to(device)


def pixel_coords(n, size=OBS, device=None):
    """Identity screen-space maps for HUD overlays drawn in pixels: the
    pixel centres arange(size) + 0.5, f32 [n, size]."""
    c = torch.arange(size, dtype=torch.float32, device=device) + 0.5
    return c.expand(n, size), c.expand(n, size)


def clear(n, size=OBS, device=None):
    """Black frames, bf16 [n, 3, size, size] (maze.cpp:390-391). The JAX
    package carries a fourth, dead plane that `finalize` drops; no blend
    reads it, so the port leaves it out."""
    return torch.zeros((n, 3, size, size), dtype=_BF16, device=device)


def _inv255(device):
    return torch.tensor(1 / 255.0, dtype=_BF16, device=device)


def _blend(img, rgb, a):
    """img, rgb bf16 [N, 3, H, W]; a bf16 [N, H, W]: img * (1 - a) +
    rgb * a, each op rounded (the JAX package's `_blend`). Where a is 0
    the frame is unchanged."""
    a = a[:, None]
    return img * (1.0 - a) + rgb * a


def _texels(tex, vi, ui):
    """tex [N, C, S, S] (per env) or [C, S, S] (shared) at rows vi [N, R]
    and columns ui [N, W]: [N, C, R, W], each pixel's texel (the one-hot
    contraction `_sep_sample` of the JAX package, as a gather)."""
    N = vi.shape[0]
    C = tex.shape[-3]
    n = torch.arange(N, device=vi.device)[:, None, None, None]
    c = torch.arange(C, device=vi.device)[None, :, None, None]
    r, w = vi[:, None, :, None], ui[:, None, None, :]
    return tex[c, r, w] if tex.ndim == 3 else tex[n, c, r, w]


def draw_background(img, bgs, bg_index, wx, wy, origin=0.0,
                    size_units=64.0):
    """Background `bg_index` [N] of bgs u8 [B, 3, H, W] (env-major),
    spanning `size_units` world units from (origin, origin), sampled
    nearest at the pixel centres wx, wy [N, size] (maze.cpp:403-408). The
    JAX package's blend by a 0/1 mask is this select; its division by
    the constant size is a multiply by the reciprocal."""
    _, _, H, W = bgs.shape
    r = recip32(size_units)
    ui, in_u = texel_index((wx - origin) * r, W)
    vi, in_v = texel_index((wy - origin) * r, H)
    rgb = _texels(bgs[bg_index.long()], vi, ui).to(_BF16)
    ok = in_v[:, None, :, None] & in_u[:, None, None, :]
    return torch.where(ok, rgb, img)


def tile_selectors(wx, wy, H, W):
    """The tile under each pixel and the texel inside it, for pixel
    centres wx, wy f32 [N, size] over an H x W grid: (ty, tx) int64
    clipped into the grid, (v, u) int64 texel rows / columns, and inb
    bool [N, size, size] where the pixel lies on the grid (the JAX
    package's `tile_onehots` as indices)."""
    tx = torch.floor(wx).to(torch.int32)
    ty = torch.floor(wy).to(torch.int32)
    in_x = (tx >= 0) & (tx < W)
    in_y = (ty >= 0) & (ty < H)
    # wx - floor(wx) is exact, and so is the product by S
    u = torch.clamp(((wx - tx.to(torch.float32)) * S).to(torch.int32), 0,
                    S - 1)
    v = torch.clamp(((wy - ty.to(torch.float32)) * S).to(torch.int32), 0,
                    S - 1)
    inb = in_y[:, :, None] & in_x[:, None, :]
    return (ty.clamp(0, H - 1).long(), tx.clamp(0, W - 1).long(),
            v.long(), u.long(), inb)


def kind_field(grid, sel, oob):
    """The tile kind under each pixel, int8 [N, 1, size, size]: grid
    [N, H, W] at the selectors of `tile_selectors`, `oob` off the grid."""
    ty, tx, _, _, inb = sel
    n = torch.arange(grid.shape[0], device=grid.device)[:, None, None]
    G = grid[n, ty[:, :, None], tx[:, None, :]].to(torch.int8)
    return torch.where(inb, G, torch.tensor(oob, dtype=torch.int8,
                                            device=G.device))[:, None]


def kind_layer(img, mask, tex, sel):
    """One tile kind over img bf16 [N, 3, size, size] as the batched
    renders blend it (`draw_tiles_batch`, the games' `blend_kind`):
    kimg = tex u8/bf16 ([N, 4, S, S] per env, or [4, S, S]) at the
    texels of `sel`, a = bf16(mask) * (kimg alpha * bf16(1/255)), then
    img + a * (kimg rgb - img), each bf16 op rounded. mask bool
    [N, 1, size, size]."""
    _, _, v, u, _ = sel
    k = _texels(tex, v, u).to(_BF16)
    return blend_kind(img, mask, k[:, :3], k[:, 3:4] * _inv255(img.device))


def draw_tiles_batch(img, grids, lut, atlas, wx, wy, oob_tile):
    """A tile layer for per-env cameras (the JAX package's
    `draw_tiles_batch`): grids int [N, H, W] of kinds, `lut` a host
    sequence of atlas indices per kind (-1 transparent), atlas u8
    [A, 4, S, S] on the device."""
    _, H, W = grids.shape
    sel = tile_selectors(wx, wy, H, W)
    G = kind_field(grids, sel, oob_tile)
    for k, sid in enumerate(lut):
        if sid >= 0:
            img = kind_layer(img, G == k, atlas[sid], sel)
    return img


def draw_tiles(img, grid, lut, atlas, wx, wy, oob_tile, theme=None):
    """A tile layer in the single-env renders' form (the JAX package's
    `draw_tiles`): grid int [N, H, W]; lut a host int table [T, K] of
    atlas indices per kind (-1 transparent) with the env's row `theme`
    int [N] (None: T = 1); atlas u8 [A, 4, S, S] on the device. Each kind
    k blends its texel image where the field is k, a = texel alpha *
    bf16(1/255), by `_blend`. A kind transparent in every row is
    skipped (its blend leaves the frame as it is)."""
    N, H, W = grid.shape
    lut = np.asarray(lut, np.int64).reshape(-1, np.shape(lut)[-1])
    sel = tile_selectors(wx, wy, H, W)
    _, _, v, u, _ = sel
    G = kind_field(grid, sel, oob_tile)[:, 0]
    dev = img.device
    row = (torch.zeros(N, dtype=torch.int64, device=dev) if theme is None
           else theme.long())
    inv = _inv255(dev)
    for k in range(lut.shape[1]):
        if (lut[:, k] < 0).all():
            continue
        col = torch.from_numpy(lut[:, k]).to(dev)[row]  # [N]
        tex = atlas[col.clamp(min=0)]
        k_img = _texels(tex, v, u).to(_BF16)
        mask = (G == k) & (col >= 0)[:, None, None]
        a = torch.where(mask, k_img[:, 3], 0.0) * inv
        img = _blend(img, k_img[:, :3], a)
    return img


def _rect_frac(p, pos, w):
    """(p - pos) / w per pixel, f32 [N, size], p [N, size], pos [N]: a
    host-number w divides as XLA CPU does it for a constant, by a
    multiply with its f32 reciprocal; a tensor w [N] by a true division."""
    d = p - pos[:, None]
    if isinstance(w, torch.Tensor):
        return d / w[:, None]
    return d if w == 1.0 else d * recip32(w)


def rect_texels(x, y, w, h, wx, wy, flip_x=False):
    """The texels of an axis-aligned rect (x, y, w, h) in world units under
    the pixel centres wx, wy [N, size] (the JAX package's
    `_rect_onehots` as indices): (ui, in_u, vi, in_v), the column texel
    int64 [N, size] (mirrored where flip_x), whether the column lies on
    the rect, and the same for rows."""
    ui, in_u = texel_index(_rect_frac(wx, x, w), S)
    vi, in_v = texel_index(_rect_frac(wy, y, h), S)
    if isinstance(flip_x, torch.Tensor):
        ui = torch.where(flip_x[:, None], S - 1 - ui, ui)
    elif flip_x:
        ui = S - 1 - ui
    return ui, in_u, vi, in_v


def _draw_tex(img, tex, x, y, w, h, wx, wy, flip_x, alive, alpha):
    """Blend texture tex ([N, 4, S, S] or [4, S, S]) as the axis-aligned
    rect (x, y, w, h) in world units (x, y f32 [N]), sampled nearest at
    the pixel centres wx, wy [N, size] (the JAX package's `_draw_tex`):
    a = texel alpha * bf16(1/255) * bf16(alive) * bf16(alpha), rounded
    in that order."""
    ui, in_u, vi, in_v = rect_texels(x, y, w, h, wx, wy, flip_x)
    rgba = _texels(tex, vi, ui).to(_BF16)
    ok = in_v[:, None, :, None] & in_u[:, None, None, :]
    rgba = torch.where(ok, rgba, torch.zeros((), dtype=_BF16,
                                              device=img.device))
    return _blend(img, rgba[:, :3], _weigh(
        rgba[:, 3] * _inv255(img.device), alive, alpha))


def _weigh(a, alive, alpha):
    """A sprite's alpha a (bf16 [N, H, W]) times bf16(alive), then times
    bf16(alpha), each product rounded; alive a bool or bool [N], alpha a
    number or f32 [N]."""
    if isinstance(alive, torch.Tensor):
        a = a * alive.to(_BF16)[:, None, None]
    elif not alive:
        a = a * 0.0
    if isinstance(alpha, torch.Tensor):
        a = a * alpha.to(_BF16)[:, None, None]
    elif alpha != 1.0:
        a = a * torch.tensor(alpha, dtype=_BF16, device=a.device)
    return a


def draw_sprite(img, atlas, sid, x, y, w, h, wx, wy, flip_x=False,
                alive=True, rotation=None, alpha=1.0, centre=None):
    """Alpha-blend one sprite per env, top-left at world (x, y) f32 [N],
    size (w, h) (host numbers or f32 [N]), texture `sid` (a host int or
    int [N]) of atlas u8 [A, 4, S, S] (the JAX package's `draw_sprite`,
    renderer.cpp:5-101, nearest sampling). flip_x and alive: bools or
    bool [N] (a sprite dead in every env is skipped: its blend would
    change nothing); alpha a number or f32 [N]. `rotation` f32 [N] (radians,
    clockwise on screen) samples the rotated rect by a 2-D gather at
    the fractions of `rotated_frac`, about its centre (x + w/2, y + h/2),
    or `centre` (cx, cy) where x holds a constant that XLA folds with w/2
    ((p - c1) + c2 is p + (c2 - c1); x and y are then not read)."""
    if isinstance(alive, torch.Tensor) and not bool(alive.any()):
        return img  # a blend with a = 0 leaves every pixel as it is
    tex = atlas[sid] if isinstance(sid, int) else atlas[sid.long()]
    if rotation is None:
        return _draw_tex(img, tex, x, y, w, h, wx, wy, flip_x, alive, alpha)
    cx, cy = centre or (x + (0.5 * w), y + (0.5 * h))
    cosr, sinr = trig.sincos32(rotation)
    cosr, sinr = cosr[:, None, None], sinr[:, None, None]
    rx = wx[:, None, :] - cx[:, None, None]  # [N, 1, size]
    ry = wy[:, :, None] - cy[:, None, None]  # [N, size, 1]
    u_f, v_f = rotated_frac(cosr, sinr, rx, ry, w, h)
    inside = (u_f >= 0) & (u_f < 1) & (v_f >= 0) & (v_f < 1)
    ui = torch.clamp((u_f * S).to(torch.int32), 0, S - 1).long()
    if isinstance(flip_x, torch.Tensor):
        ui = torch.where(flip_x[:, None, None], S - 1 - ui, ui)
    elif flip_x:
        ui = S - 1 - ui
    vi = torch.clamp((v_f * S).to(torch.int32), 0, S - 1).long()
    c = torch.arange(4, device=vi.device)[None, :, None, None]
    if tex.ndim == 3:
        ch = tex[c, vi[:, None], ui[:, None]]
    else:
        n = torch.arange(vi.shape[0], device=vi.device)[:, None, None, None]
        ch = tex[n, c, vi[:, None], ui[:, None]]
    ch = ch.to(_BF16)
    a = ch[:, 3] * _inv255(img.device) * inside.to(_BF16)
    return _blend(img, ch[:, :3], _weigh(a, alive, alpha))


def rotated_frac(cosr, sinr, rx, ry, w, h):
    """The rotated rect's texel fractions (the JAX package's
    compositor.py:290-291), u_f = (cosr * rx + sinr * ry) / w + 0.5 and
    v_f = (-sinr * rx + cosr * ry) / h + 0.5, as XLA CPU computes them:
    the first product of each sum fused into its add; a division by a
    constant a multiply by its reciprocal, fused with the add of 0.5; a
    division by a traced size a true division."""
    tu = prng._fma32(cosr, rx, sinr * ry)
    tv = prng._fma32(-sinr, rx, cosr * ry)

    def scale(t, s):
        if isinstance(s, torch.Tensor):
            return t / s[:, None, None] + 0.5
        return prng._fma32(t, recip32(s), 0.5)
    return scale(tu, w), scale(tv, h)


def draw_sprites(img, atlas, sids, xs, ys, ws, hs, wx, wy, flips=None,
                 alives=None):
    """K sprites per env back to front (the JAX package's `draw_sprites`):
    sids int [N, K] (or a host int), xs, ys f32 [N, K], ws, hs host
    numbers or f32 [N, K], flips and alives bool [N, K] or None; wx, wy
    the pixel maps as the JAX loop reads them (`camera_coords(...,
    fused=False)`)."""
    K = xs.shape[1]
    # a slot dead in every env blends nothing (one host read for all)
    live = [True] * K if alives is None else alives.any(0).tolist()
    for k in range(K):
        if not live[k]:
            continue
        sid = sids if isinstance(sids, int) else sids[:, k]
        img = _draw_tex(
            img, atlas[sid] if isinstance(sid, int) else atlas[sid.long()],
            xs[:, k], ys[:, k],
            ws if not isinstance(ws, torch.Tensor) else ws[:, k],
            hs if not isinstance(hs, torch.Tensor) else hs[:, k], wx, wy,
            False if flips is None else flips[:, k],
            True if alives is None else alives[:, k], 1.0)
    return img


def finalize(img):
    """bf16 [N, 3, size, size] in [0, 255] -> uint8 [N, size, size, 3]
    (round half to even, clip; exact in bf16)."""
    return torch.clamp(torch.round(img), 0, 255).to(torch.uint8).permute(
        0, 2, 3, 1)
