"""Stamp kernels: K premultiplied stamps per env, from one or more stamp
groups, either alpha-blended OVER a given frame in slot (painter) order
(B3, `composite`) or summed into a zeroed 4-channel frame (B4, `stamps`).

A CUDA tensor goes to the hand-written Hopper kernels in
`csrc/stamp_kernel.cu`: `composite` replaces the Pallas kernel
`procgen2_tpu/render/stamp_kernel.py::_kernel_blend` (entry
`composite_tpu`) and `stamps` replaces `_kernel` (entry `stamps_tpu`). A
CPU tensor goes to `composite_reference` / `stamps_reference`, the plain
torch versions with the same semantics. There is no fallback between the
two: on a CUDA tensor the kernel builds and launches, or the call raises.

Semantics (shared by all), per env and output pixel (r, c), for each
stamp group (bank [V, 4, P, P], var, scale, r0, c0 [N, K]) in order and
each slot in order: a slot with scale == 0 or var outside [0, V) is
skipped; bank[var] is placed at (r0, c0) clipped to [-P, obs]; under it
contrib = bf16(texel * scale), and
  * composite: frame = frame * (1 - a) + rgb, every bf16 multiply,
    subtract and add rounded on its own (RNE). One call over several
    groups equals one call per group in order;
  * stamps (one group): acc = acc + contrib on all four channels, from
    zero, each add rounded to bf16 on its own.
"""
from __future__ import annotations

import ctypes
import functools

import torch

_BF16 = torch.bfloat16
MAX_GROUPS = 4  # stamps::kMaxGroups in csrc/stamps.cuh
TILE_COLS = 8  # stamps::kTileCols: the kernels move frame rows 8 bf16 at a time


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
            blended = win * (1.0 - contrib[:, 3:4]) + contrib[:, :3]
            fp[idx] = torch.where(live[:, None, None, None], blended, win)
    return fp[:, :, pad:pad + obs, pad:pad + obs]


def _window(bank, v, s, r0, c0, obs, pad, channels=3):
    """Slot k's stamp for every env, over its P x P window of a frame padded
    by `pad` >= P: (index of the window [N, channels, P, P], contrib bf16
    [N, 4, P, P] = bf16(texel * scale), live bool [N]: the slots not
    skipped). The window starts at (r0, c0) clipped to [-P, obs]; its
    pixels outside [0, obs) fall in the padding."""
    N = v.shape[0]
    V, _, P, _ = bank.shape
    dev = v.device
    s = s.to(torch.float32)
    v = v.long()
    live = (s != 0) & (v >= 0) & (v < V)
    ii = torch.arange(P, device=dev)
    rows = r0.long().clamp(-P, obs)[:, None] + pad + ii  # [N, P]
    cols = c0.long().clamp(-P, obs)[:, None] + pad + ii
    idx = (torch.arange(N, device=dev)[:, None, None, None],
           torch.arange(channels, device=dev)[None, :, None, None],
           rows[:, None, :, None], cols[:, None, None, :])
    patch = bank[v.clamp(0, V - 1)]  # [N, 4, P, P]
    contrib = (patch.to(torch.float32) * s[:, None, None, None]).to(_BF16)
    return idx, contrib, live


def stamps_reference(prem_bank, var, scale, r0, c0, obs):
    """Plain torch version of the stamp-sum kernel (B4): prem_bank bf16
    [V, 4, P, P]; var int [N, K]; scale f32 [N, K]; r0/c0 int [N, K].
    Returns (rgbp bf16 [N, 3, obs, obs], a bf16 [N, 1, obs, obs]), the
    slot-ordered bf16 sums (the semantics above)."""
    bank = prem_bank.to(_BF16)
    N = var.shape[0]
    P = bank.shape[-1]
    acc = torch.zeros((N, 4, obs + 2 * P, obs + 2 * P), dtype=_BF16,
                      device=var.device)
    for k in range(var.shape[1]):
        idx, contrib, live = _window(bank, var[:, k], scale[:, k], r0[:, k],
                                     c0[:, k], obs, P, channels=4)
        win = acc[idx]
        acc[idx] = torch.where(live[:, None, None, None], win + contrib, win)
    acc = acc[:, :, P:P + obs, P:P + obs]
    return acc[:, :3], acc[:, 3:4]


def composite_reference(img, groups):
    """Plain torch version of the kernel: img bf16 [N, 3, obs, obs];
    groups [(bank bf16 [V, 4, P, P], var int [N, K], scale f32 [N, K],
    r0 int [N, K], c0 int [N, K])]. Returns bf16 [N, 3, obs, obs]."""
    return blend_groups_reference(img.to(_BF16), groups)


# ---------------------------------------------------------------------------
# CUDA kernel binding
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)
_PP = ctypes.POINTER(ctypes.c_void_p)


def _ints(vs):
    return (ctypes.c_int * max(len(vs), 1))(*vs)


def group_args(groups):
    """The stamp groups as the C entry points take them: (count, then host
    arrays of the banks', var's, scale's, r0's and c0's pointers, and of
    each group's V, P and K)."""
    banks, var, scale, r0, c0 = (list(x) for x in zip(*groups)) if groups \
        else ([], [], [], [], [])

    def ptrs(ts):
        return (ctypes.c_void_p * max(len(ts), 1))(*[t.data_ptr() for t in ts])

    return (len(groups), ptrs(banks), ptrs(var), ptrs(scale), ptrs(r0),
            ptrs(c0), _ints([b.shape[0] for b in banks]),
            _ints([b.shape[-1] for b in banks]),
            _ints([v.shape[1] for v in var]))


@functools.lru_cache(maxsize=None)
def _kernels():
    """Build (or find) and load both kernels once per process. Returns
    ({"composite": launch, "stamps": launch}, build record); each launch
    takes inputs its wrapper has checked and writes `out`. Needs nvcc."""
    from . import _build

    lib, record = _build.load("stamp_kernel")
    fn = lib.stamp_composite_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [_P, _I] + [_PP] * 5 + [_IP] * 3 + [_P, _I, _I, _P]
    sum_fn = lib.stamp_sum_launch
    sum_fn.restype = ctypes.c_int
    sum_fn.argtypes = [_P] * 5 + [_I] * 3 + [_P, _I, _I, _P]

    def composite_launch(img, groups, out):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        rc = fn(img.data_ptr(), *group_args(groups), out.data_ptr(),
                img.shape[0], img.shape[-1], stream)
        if rc != 0:
            raise RuntimeError(f"stamp kernel launch failed: code {rc}")

    def stamps_launch(group, out):
        bank, var, scale, r0, c0 = group
        stream = torch.cuda.current_stream(out.device).cuda_stream
        rc = sum_fn(bank.data_ptr(), var.data_ptr(), scale.data_ptr(),
                    r0.data_ptr(), c0.data_ptr(), bank.shape[0],
                    bank.shape[-1], var.shape[1], out.data_ptr(),
                    out.shape[0], out.shape[-1], stream)
        if rc != 0:
            raise RuntimeError(f"stamp-sum kernel launch failed: code {rc}")

    return dict(composite=composite_launch, stamps=stamps_launch), record


def build():
    """Build (or find) and load the kernels; returns the build record
    (seconds, compiler output). Needs nvcc."""
    return _kernels()[1]


def check_groups(groups, N, device):
    """Raise unless `groups` are 0 to MAX_GROUPS stamp groups of the
    kernels' dtypes and shapes for N envs, contiguous, on `device`."""
    if len(groups) > MAX_GROUPS:
        raise ValueError(f"the kernels take at most {MAX_GROUPS} stamp groups, "
                         f"got {len(groups)}")
    for gi, (bank, var, scale, r0, c0) in enumerate(groups):
        V, _, P, _ = bank.shape
        K = var.shape[1]
        check(bank, _BF16, (V, 4, P, P), device, f"groups[{gi}].bank")
        check(var, torch.int32, (N, K), device, f"groups[{gi}].var")
        check(scale, torch.float32, (N, K), device, f"groups[{gi}].scale")
        check(r0, torch.int32, (N, K), device, f"groups[{gi}].r0")
        check(c0, torch.int32, (N, K), device, f"groups[{gi}].c0")


def check(t, dtype, shape, device, name):
    """Raise unless tensor `t` has this dtype, shape and device and is
    contiguous."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_tiles(obs, *tensors):
    """Raise ValueError unless the kernels' 16-byte row accesses fit: obs
    a multiple of TILE_COLS and every tensor in `tensors` (name, tensor)
    starting on a 16-byte boundary."""
    if obs % TILE_COLS:
        raise ValueError(f"the kernels take obs a multiple of {TILE_COLS}, "
                         f"got {obs}")
    for name, t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


def composite(img, groups):
    """Blend the stamp groups over `img` (arguments and result as
    `composite_reference`). CUDA tensors launch the kernel, once for all
    groups (dtypes, shapes and devices are checked, nothing is converted);
    CPU tensors run the plain version."""
    if img.device.type == "cpu":
        return composite_reference(img, groups)
    if img.device.type != "cuda":
        raise ValueError(f"composite runs on cpu or cuda, not {img.device}")
    dev = img.device
    N, _, obs, _ = img.shape
    check(img, _BF16, (N, 3, obs, obs), dev, "img")
    check_tiles(obs, ("img", img))
    if not groups:
        raise ValueError("composite needs at least one stamp group")
    check_groups(groups, N, dev)
    out = torch.empty_like(img)
    _kernels()[0]["composite"](img, groups, out)
    composite.launches += 1
    return out


composite.launches = 0  # kernel launches; the CPU path does not count


def stamps(prem_bank, var, scale, r0, c0, obs):
    """Sum the stamps of one group into a zeroed frame (arguments and
    result as `stamps_reference`). CUDA tensors launch the kernel
    (dtypes, shapes and devices are checked, nothing is converted); CPU
    tensors run the plain version."""
    if var.device.type == "cpu":
        return stamps_reference(prem_bank, var, scale, r0, c0, obs)
    if var.device.type != "cuda":
        raise ValueError(f"stamps runs on cpu or cuda, not {var.device}")
    group = (prem_bank, var, scale, r0, c0)
    check_groups([group], var.shape[0], var.device)
    out = torch.empty((var.shape[0], 4, obs, obs), dtype=_BF16,
                      device=var.device)
    check_tiles(obs, ("out", out))
    _kernels()[0]["stamps"](group, out)
    stamps.launches += 1
    return out[:, :3], out[:, 3:4]


stamps.launches = 0  # kernel launches; the CPU path does not count
