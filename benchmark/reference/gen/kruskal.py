"""Maze carving of procgen2_tpu/gen/kruskal.py, batched over levels.

The reference's Maze_Generator (`games/maze/maze_generator.cpp:55-139`)
erases a uniformly random remaining wall each iteration, which is a visit
of the wall list in a random permutation; it merges room sets with a
union-find. The JAX package visits a static wall list of the largest maze
in `jax.random.permutation` order and masks walls outside a (traced) maze
size. Here every level of a batch takes one step of that visit at a time:
the union-find lives in int tensors [L, max_dim**2], and the loops run
over walls and cells, not over levels.

Grid convention: maze coordinates (i, j) in [0, max_dim)**2, rooms at
even-even cells, walls between them; `wall` is bool [L, max_dim, max_dim]
indexed [l, i, j]. Cells outside a level's `dim` x `dim` region stay
walls.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import random as prng


@functools.lru_cache(maxsize=None)
def _wall_list(max_dim: int):
    """Static wall list of a max_dim x max_dim maze, (e1, e2, ce) int32
    [n_walls, 2] each: the two rooms a wall joins and its centre cell.
    Mirrors maze_generator.cpp:89-101: vertical walls at (odd i, even j)
    joining (i-1, j)-(i+1, j); horizontal walls at (even i, odd j) joining
    (i, j-1)-(i, j+1)."""
    e1, e2, ce = [], [], []
    for i in range(1, max_dim - 1, 2):
        for j in range(0, max_dim, 2):
            e1.append((i - 1, j))
            e2.append((i + 1, j))
            ce.append((i, j))
    for i in range(0, max_dim, 2):
        for j in range(1, max_dim - 1, 2):
            e1.append((i, j - 1))
            e2.append((i, j + 1))
            ce.append((i, j))
    return (np.asarray(e1, np.int32).reshape(-1, 2),
            np.asarray(e2, np.int32).reshape(-1, 2),
            np.asarray(ce, np.int32).reshape(-1, 2))


FIND_DEPTH = 12  # the JAX package's bound: union by rank keeps a tree's
#                  height at most log2 of its size (<= 10 at max_dim 45)


def _find(parent, c):
    """Root of cell c int64 [L] in each level's forest parent [L, n]: a
    fixed chase of FIND_DEPTH steps, which reaches the root (the JAX
    package's `_find`)."""
    c = c[:, None]
    for _ in range(FIND_DEPTH):
        c = parent.gather(1, c)
    return c[:, 0]


def _dims(dim, L, device):
    """`dim` (an int, or an int tensor [L]) as int64 [L, 1]."""
    return torch.as_tensor(dim, dtype=torch.int64,
                           device=device).expand(L).reshape(L, 1)


def kruskal_maze(keys, dim, max_dim: int):
    """Carve one maze per key: keys int64 [L, 2]; `dim` an int or an int
    tensor [L] (odd, 3 <= dim <= max_dim). Returns wall bool [L, max_dim,
    max_dim], equal to the JAX package's `kruskal_maze` vmapped over
    (key, dim)."""
    dev = keys.device
    L = keys.shape[0]
    D = max_dim
    e1, e2, ce = (torch.from_numpy(a).long().to(dev)
                  for a in _wall_list(max_dim))
    n_walls = e1.shape[0]
    c1 = e1[:, 1] + D * e1[:, 0]  # j + D*i, maze_generator.h:43-45
    c2 = e2[:, 1] + D * e2[:, 0]
    c0 = ce[:, 1] + D * ce[:, 0]
    # a wall takes part only if it lies wholly inside the dim x dim region
    far = torch.maximum(e1, torch.maximum(e2, ce))  # [n_walls, 2]
    d = _dims(dim, L, dev)
    valid = (far[None, :, 0] < d) & (far[None, :, 1] < d)  # [L, n_walls]

    order = prng.permutation(keys, n_walls)  # [L, n_walls]
    lv = torch.arange(L, device=dev)
    parent = torch.arange(D * D, device=dev).expand(L, D * D).clone()
    rank = torch.zeros((L, D * D), dtype=torch.int64, device=dev)
    carved = torch.zeros((L, n_walls), dtype=torch.bool, device=dev)
    # The reference also checks that the wall is still standing; its
    # centre cell belongs to it alone, so it is, at its own turn (the JAX
    # package drops the check for the same reason).
    for k in range(n_walls):
        w = order[:, k]
        ra = _find(parent, c1[w])
        rb = _find(parent, c2[w])
        can = valid[lv, w] & (ra != rb)
        carved[lv, w] = can
        # union by rank; the wall's centre cell joins the root too
        # (maze_generator.cpp:125-134)
        rank_a, rank_b = rank[lv, ra], rank[lv, rb]
        a_bigger = rank_a > rank_b
        root = torch.where(a_bigger, ra, rb)
        child = torch.where(a_bigger, rb, ra)
        parent[lv, child] = torch.where(can, root, parent[lv, child])
        m = c0[w]
        parent[lv, m] = torch.where(can, root, parent[lv, m])
        rank[lv, root] += (can & ~a_bigger & (rank_a == rank_b)).long()

    return _walls(carved, (c1, c2, c0), D)


def _walls(carved, cells, D):
    """The wall grid bool [L, D, D] after the carve: every cell of a
    carved wall (carved bool [L, n_walls]; cells: the flat cells of each
    wall's two rooms and centre, int64 [n_walls] each) opens, and so does
    the corner room (maze_generator.cpp:71)."""
    L = carved.shape[0]
    opened = torch.zeros((L, D * D), dtype=torch.int64, device=carved.device)
    for c in cells:
        opened.index_add_(1, c, carved.long())
    wall = opened == 0
    wall[:, 0] = False
    return wall.reshape(L, D, D)


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
