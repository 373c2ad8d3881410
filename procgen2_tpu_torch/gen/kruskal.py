"""Level-generation helpers of procgen2_tpu/gen/kruskal.py, batched over
levels. Only `masked_uniform_cell` so far (caveflyer's placements); the
maze generators come with the games that use them."""
from __future__ import annotations

import torch

from .. import random as prng


def masked_uniform_cell(keys, mask):
    """One True cell of each level's mask bool [L, H, W], uniformly, with
    keys [L, 2]: `jax.random.categorical` over the flat mask (0 where
    True, -inf elsewhere), as the JAX package draws it. Returns (i, j)
    int64 [L]. Stands in for the reference's rejection-sampled
    `place_object` (maze_generator.cpp:183-195)."""
    L, H, W = mask.shape
    logits = torch.where(mask.reshape(L, H * W), 0.0, float("-inf"))
    flat = prng.categorical(keys, logits.to(torch.float32))
    return flat // W, flat % W
