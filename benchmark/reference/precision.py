"""The control's lower precision (off unless `lowered()` is active).

The configurations state float32 game state and bfloat16 render blends.
The control is this reference computed one step below both: every
float32 leaf of the game state rounded to bfloat16 after each game step
(`state`), and every blended frame rounded to float8 e4m3 (`blend`).
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

_LOW = [False]


@contextlib.contextmanager
def lowered():
    """Run the reference at the control's precision inside the block."""
    _LOW.append(True)
    try:
        yield
    finally:
        _LOW.pop()


def blend(frame):
    """A blended bf16 frame, through float8 e4m3 under `lowered`."""
    if not _LOW[-1]:
        return frame
    return frame.to(torch.float8_e4m3fn).to(frame.dtype)


def state(tree):
    """A game state whose float32 leaves went through bfloat16 under
    `lowered` (nested dataclasses of tensors)."""
    if not _LOW[-1]:
        return tree
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: state(getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, torch.Tensor) and tree.dtype == torch.float32:
        return tree.to(torch.bfloat16).to(torch.float32)
    return tree
