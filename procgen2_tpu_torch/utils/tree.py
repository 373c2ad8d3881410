"""State-tree helpers over dataclasses of tensors (the port's pytrees)."""
from __future__ import annotations

import dataclasses

import torch


def tree_map(fn, tree, *rest):
    """Apply `fn` to every tensor leaf of a tree of (nested) dataclasses,
    and to the matching leaves of `rest`; the result has `tree`'s shape."""
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    return fn(tree, *rest)


def tree_select(pred, on_true, on_false):
    """Per-leaf `torch.where(pred, a, b)`, `pred` broadcast over each
    leaf's trailing dims (auto-reset lane merging)."""

    def _sel(a, b):
        p = pred.reshape(tuple(pred.shape) + (1,) * (a.ndim - pred.ndim))
        return torch.where(p, a, b)

    return tree_map(_sel, on_true, on_false)


def bank_gather(bank, idx):
    """Rows `idx` of a stacked level bank: `leaf[idx]` on every leaf.
    `idx` is an int tensor of any shape with values in [0, num_levels)."""
    return tree_map(lambda x: x[idx], bank)
