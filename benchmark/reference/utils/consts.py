"""Small tensors made from host values once per device.

A step that builds a tensor from host data on every call
(`torch.tensor([...], device="cuda")`) copies it from the host each time,
and a CUDA graph cannot record that copy. `const` makes such a tensor
the first time it is asked for on a device and hands out the same one
after that, so a step that has run once builds nothing from host data
(`rollout` captures the steps after such a warm-up). The tensor is made
exactly as the call it replaces made it (`torch.as_tensor(value, dtype,
device)`), so its bits are the same. Callers never write into it.
"""
from __future__ import annotations

import numpy as np
import torch

_CONSTS: dict = {}


def const(value, device, dtype=None) -> torch.Tensor:
    """`torch.as_tensor(value, dtype=dtype, device=device)`, made once per
    (value, dtype, device). `value` is a number, a bool, a (nested) tuple
    or list of them, or a numpy array (keyed by its dtype, shape and
    bytes); numbers are keyed by `repr`, which tells 0.0 from -0.0 and
    1 from 1.0 and True."""
    if isinstance(value, np.ndarray):
        key = (value.dtype.str, value.shape, value.tobytes())
    else:
        key = repr(value)
    key = (key, dtype, torch.device(device))
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.as_tensor(value, dtype=dtype, device=device)
    return t


def as_tensor(value, device, dtype=None) -> torch.Tensor:
    """`torch.as_tensor(value, dtype=dtype, device=device)` that copies
    nothing from the host once it has been called for a host value: a
    tensor is moved or converted on its device, a host value comes from
    `const`."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=dtype)
    return const(value, device, dtype)
