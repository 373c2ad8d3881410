"""The stamp-over-frame render (B3, `composite`) of bossfight, plain: stamp
groups as the program's compositor builds them (`stamp_group`, a frozen
copy of `render/compositor.py::stamp_group` and its `_stamp_scale`) and
their painter-order blend over a frame. The program runs the blend as a
hand-written kernel; this copy keeps only the port's plain torch version
(`render/stamp_kernel.py::composite_reference`, through the frozen
`blend_groups_reference`), and `composite` runs it on every device.
`OBSERVERS` are called with each `composite` call's arguments (the
benchmark's roofline reader counts B3's work from them).
"""
from __future__ import annotations

import torch

from ..utils.consts import as_tensor
from .stamp_kernel import blend_groups_reference

_BF16 = torch.bfloat16


def _stamp_scale(N, K, alives=None, alpha=None, device=None):
    """Per-slot weight f32 [N, K]: alive * alpha (0 skips the slot)."""
    scale = torch.ones((N, K), dtype=torch.float32, device=device)
    if alives is not None:
        scale = scale * alives.to(torch.float32)
    if alpha is not None:
        scale = scale * as_tensor(alpha, device, torch.float32)
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


def composite_reference(img, groups):
    """img bf16 [N, 3, obs, obs]; groups [(bank bf16 [V, 4, P, P], var int
    [N, K], scale f32 [N, K], r0 int [N, K], c0 int [N, K])]: the groups
    blended over img in painter order (`blend_groups_reference`). Returns
    bf16 [N, 3, obs, obs]."""
    return blend_groups_reference(img.to(_BF16), groups)


OBSERVERS: list = []  # callables given each composite call's (img, groups)


def composite(img, groups):
    """`composite_reference(img, groups)` on any device; each of
    `OBSERVERS` sees the arguments first."""
    for fn in OBSERVERS:
        fn((img, groups))
    return composite_reference(img, groups)
