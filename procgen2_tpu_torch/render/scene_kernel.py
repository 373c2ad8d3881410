"""Scene kernel: tile layer + background + painter-order stamps of the
quantized-camera scene render, for every game on the scene path.

`scene_raw` is the one entry point. A CUDA tensor goes to the hand-written
Hopper kernel in `csrc/scene_kernel.cu` (it replaces the Pallas kernel
`procgen2_tpu/render/scene_kernel.py::_scene_kernel_raw`, with its stamp
loop `_blend_stamps_ref`); a CPU tensor goes to `scene_raw_reference`,
the plain torch version with the same semantics. There is no fallback
between the two: on a CUDA tensor the kernel builds and launches, or the
call raises.

Semantics (shared by both), per env and output pixel (r, c):
  * y = ty0 + pad + TR[jy][r], x = tx0 + pad + TR[jx][c]; the kind G and
    the background rgb are grid[y, x] and bg_bank[bg_i, :, y, x], 0 where
    (y, x) lies outside the padded grid or bg_i outside the bank; jy and
    jx are clamped to [0, qp);
  * each tile entry i in order, where G == entry_kind[i] and entry_theme[i]
    is -1 or the env's theme: frame = frame * (1 - a) + rgb from
    tile_bank[jy * qp + jx, i];
  * each stamp group (bank [V, 4, P, P], var, scale, r0, c0 [N, K]) in
    order, each slot in order: a slot with scale == 0 or var outside
    [0, V) is skipped; bank[var] is placed at (r0, c0) clipped to
    [-P, obs]; under it contrib = bf16(texel * scale) and
    frame = frame * (1 - a) + rgb.
  Every bf16 multiply, subtract and add rounds on its own (RNE).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .stamp_kernel import blend_groups_reference, check, check_groups

_BF16 = torch.bfloat16


def _blend(frame, rgb, a):
    return frame * (1.0 - a) + rgb


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

    ph = py * qp + px
    for i, (kv, tv) in enumerate(zip(entry_kind, entry_theme)):
        m = G == int(kv)
        if tv >= 0:
            m = m & (theme == int(tv))[:, None, None]
        t = tile_bank[ph, i].to(_BF16)  # [N, 4, obs, obs]
        frame = torch.where(m[:, None], _blend(frame, t[:, :3], t[:, 3:4]),
                            frame)

    return blend_groups_reference(frame, groups)


# ---------------------------------------------------------------------------
# CUDA kernel binding
# ---------------------------------------------------------------------------

_MAX_ENTRIES = 32  # kMaxEntries in csrc/scene_kernel.cu
_P = ctypes.c_void_p
_I = ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)
_PP = ctypes.POINTER(ctypes.c_void_p)


@functools.lru_cache(maxsize=None)
def _kernel():
    """Build (or find) and load the kernel once per process. Returns
    (launch, build record); `launch` takes inputs `scene_raw` has checked
    and writes `out`. Needs nvcc."""
    from . import _build

    lib, record = _build.load("scene_kernel")
    fn = lib.scene_raw_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([_P] * 10 + [_IP, _IP, _I, _I] + [_PP] * 5
                   + [_IP, _IP, _IP, _P] + [_I] * 6 + [_P])

    def launch(gridp, ty0, tx0, jy, jx, bg_i, theme, bg_bank, tr_tab,
               tile_bank, entry_kind, entry_theme, banks, var, scale, r0,
               c0, pad, out):
        ng, ne = len(banks), len(entry_kind)

        def ptrs(ts):
            return (ctypes.c_void_p * max(ng, 1))(*[t.data_ptr() for t in ts])

        def ints(vs, n):
            return (ctypes.c_int * max(n, 1))(*vs)

        stream = torch.cuda.current_stream(gridp.device).cuda_stream
        rc = fn(gridp.data_ptr(), ty0.data_ptr(), tx0.data_ptr(),
                jy.data_ptr(), jx.data_ptr(), bg_i.data_ptr(),
                theme.data_ptr(), bg_bank.data_ptr(), tr_tab.data_ptr(),
                tile_bank.data_ptr(), ints(entry_kind, ne),
                ints(entry_theme, ne), ne, ng, ptrs(banks), ptrs(var),
                ptrs(scale), ptrs(r0), ptrs(c0),
                ints([b.shape[0] for b in banks], ng),
                ints([b.shape[-1] for b in banks], ng),
                ints([v.shape[1] for v in var], ng), out.data_ptr(),
                gridp.shape[0], gridp.shape[1], bg_bank.shape[0],
                tr_tab.shape[0], out.shape[-1], pad, stream)
        if rc != 0:
            raise RuntimeError(f"scene kernel launch failed: code {rc}")

    return launch, record


def build():
    """Build (or find) and load the kernel; returns the build record
    (seconds, compiler output). Needs nvcc."""
    return _kernel()[1]


def scene_raw(gridp, ty0, tx0, jy, jx, bg_i, theme, bg_bank, tr_tab,
              tile_bank, entry_kind, entry_theme, groups, obs, qp, pad):
    """Render the scene (arguments and result as `scene_raw_reference`).
    CUDA tensors launch the kernel (dtypes and shapes are checked, nothing
    is converted); CPU tensors run the plain version."""
    if gridp.device.type == "cpu":
        return scene_raw_reference(gridp, ty0, tx0, jy, jx, bg_i, theme,
                                   bg_bank, tr_tab, tile_bank, entry_kind,
                                   entry_theme, groups, obs, qp, pad)
    if gridp.device.type != "cuda":
        raise ValueError(f"scene_raw runs on cpu or cuda, not {gridp.device}")
    dev = gridp.device
    N, GP, _ = gridp.shape
    ne = len(entry_kind)
    i32 = torch.int32
    check(gridp, torch.int8, (N, GP, GP), dev, "grid")
    for name, t in zip(("ty0", "tx0", "jy", "jx", "bg_i", "theme"),
                       (ty0, tx0, jy, jx, bg_i, theme)):
        check(t, i32, (N,), dev, name)
    check(bg_bank, _BF16, (bg_bank.shape[0], 3, GP, GP), dev, "bg_bank")
    check(tr_tab, i32, (qp, 1, obs), dev, "tr_tab")
    check(tile_bank, _BF16, (qp * qp, ne, 4, obs, obs), dev, "tile_bank")
    if len(entry_theme) != ne:
        raise ValueError("entry_kind and entry_theme differ in length")
    if ne > _MAX_ENTRIES:
        raise ValueError(f"the kernel takes at most {_MAX_ENTRIES} tile "
                         "entries")
    check_groups(groups, N, dev)
    launch, _ = _kernel()
    out = torch.empty((N, 3, obs, obs), dtype=_BF16, device=dev)
    banks, var, scale, r0, c0 = (list(x) for x in zip(*groups)) if groups \
        else ([], [], [], [], [])
    launch(
        gridp, ty0, tx0, jy, jx, bg_i, theme, bg_bank, tr_tab, tile_bank,
        [int(k) for k in entry_kind], [int(t) for t in entry_theme],
        banks, var, scale, r0, c0, int(pad), out)
    scene_raw.launches += 1
    return out


scene_raw.launches = 0  # kernel launches; the CPU path does not count
