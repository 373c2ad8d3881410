"""Peaks of one NVIDIA H100 SXM (data sheet, at 700 W), and the least
time a kernel could take. Frozen copy of chip_smoke.py's constants and
`bound`.

The sheet's 67 TFLOP/s of float32 outside the tensor cores counts a fused
multiply-add as two operations; the port's kernels are built with
--fmad=false and issue each multiply and add on its own, so they can do
at most half as many.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12 / 2


def bound(nbytes, nops):
    """Least time in ms the card could take: the larger of the bytes over
    the memory rate and the f32 operations over the f32 peak, and which
    of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
