"""The work of one stamp-over-frame call (B3, `composite`), counted from
its inputs: chip_smoke.py's `stamp_bound` arithmetic, on the frozen
`stamp_blends` and `tensor_bytes` of `scene_raw.py`.

Bytes: the frame and the stamp groups read once (the banks whole), the
frame written once. Operations: 11 f32 operations a stamp blend (4 texel
* scale, 1 - a, 3 multiplies, 3 adds), one blend for each pixel of a live
slot's P x P patch inside the frame.
"""
from __future__ import annotations

from .scene_raw import STAMP_OPS, stamp_blends, tensor_bytes


def work(img, groups):
    """(bytes, f32 operations) that one composite call needs on these
    inputs: img bf16 [N, 3, obs, obs] and its stamp groups."""
    nbytes = tensor_bytes(img, groups) + img.numel() * img.element_size()
    return nbytes, STAMP_OPS * stamp_blends(groups, img.shape[-1])
