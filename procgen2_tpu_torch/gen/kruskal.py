"""Maze carving of procgen2_tpu/gen/kruskal.py, batched over levels.

The reference's Maze_Generator (`games/maze/maze_generator.cpp:55-139`)
erases a uniformly random remaining wall each iteration, which is a visit
of the wall list in a random permutation; it merges room sets with a
union-find. The JAX package visits a static wall list of the largest maze
in `jax.random.permutation` order and masks walls outside a (traced) maze
size. Here every level of a batch takes one step of that visit at a time:
the union-find lives in int tensors [L, max_dim**2], and the loops run
over walls and cells, not over levels. `boruvka_maze` carves the same
maze in a fixed number of parallel rounds (no game calls it, in either
package).

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


def boruvka_maze(keys, dim, max_dim: int):
    """Carve the same maze as `kruskal_maze`, key for key, in
    ceil(log2 R) + 1 parallel rounds over the R rooms (the JAX package's
    `boruvka_maze`). Random-order Kruskal accepts exactly the minimum
    spanning tree of the room graph under weight = a wall's position in
    the visit permutation: the weights are distinct, so the tree is
    unique, and Boruvka's algorithm on them carves it too.

    Per round every component takes its least crossing wall (a min over
    the walls of both endpoint labels), the walls that are some
    component's minimum are carved, and each component hooks to the one
    across its chosen wall (a 2-cycle broken toward the smaller id), then
    the labels contract by pointer jumping. The round count is fixed, as
    in the JAX package's `fori_loop`, so nothing is read back to the host
    and the carve can run inside a CUDA graph.

    keys int64 [L, 2]; `dim` an int or an int tensor [L] (odd, 3 <= dim
    <= max_dim). Returns wall bool [L, max_dim, max_dim]."""
    dev = keys.device
    L = keys.shape[0]
    D = max_dim
    RD = (D + 1) // 2
    R = RD * RD  # rooms at even-even cells
    e1, e2, ce = (torch.from_numpy(a).long().to(dev)
                  for a in _wall_list(max_dim))
    E = e1.shape[0]
    u = (e1[:, 1] // 2 + RD * (e1[:, 0] // 2)).expand(L, E)
    v = (e2[:, 1] // 2 + RD * (e2[:, 0] // 2)).expand(L, E)
    far = torch.maximum(e1, torch.maximum(e2, ce))
    d = _dims(dim, L, dev)
    valid = (far[None, :, 0] < d) & (far[None, :, 1] < d)  # [L, E]

    order = prng.permutation(keys, E)  # [L, E]
    # weight of wall w = its rank in the visit order (inverse permutation)
    weight = torch.empty_like(order).scatter_(
        1, order, torch.arange(E, device=dev).expand(L, E))
    big = torch.full((L, R), E, dtype=torch.int64, device=dev)
    rooms = torch.arange(R, device=dev).expand(L, R)
    labels = rooms.clone()
    carved = torch.zeros((L, E), dtype=torch.bool, device=dev)
    jumps = int(np.ceil(np.log2(max(R, 2))))
    for _ in range(jumps + 1):
        lu, lv = labels.gather(1, u), labels.gather(1, v)
        active = valid & (lu != lv)
        keyw = torch.where(active, weight, E)
        # the least crossing weight of each component (E where none)
        emin = big.scatter_reduce(1, torch.cat([lu, lv], 1),
                                  torch.cat([keyw, keyw], 1), "amin")
        carved |= active & ((keyw == emin.gather(1, lu))
                            | (keyw == emin.gather(1, lv)))
        # hook each component to the one across its chosen wall, break
        # 2-cycles toward the smaller id, then pointer-jump to the root
        eidx = order.gather(1, emin.clamp(0, E - 1))  # weight rank -> wall
        p = torch.where(emin < E, labels.gather(1, u.gather(1, eidx))
                        + labels.gather(1, v.gather(1, eidx)) - rooms, rooms)
        p = torch.where((p.gather(1, p) == rooms) & (rooms < p), rooms, p)
        for _ in range(jumps):
            p = p.gather(1, p)
        labels = p.gather(1, labels)

    return _walls(carved, [p[:, 1] + D * p[:, 0] for p in (e1, e2, ce)], D)


def open_dead_ends(keys, wall, dim):
    """The no-dead-end pass (generate_maze_no_dead_ends,
    `games/jumper/maze_generator.cpp:132-173`), as the JAX package's
    `open_dead_ends`: cells are scanned in x-major order, and every open
    cell with exactly one open neighbour and at least one wall around it
    opens a random neighbouring wall; later cells see the openings. The
    reference's quirks stay: neighbours in the order (x-1, x+1, y-1, y+1);
    the random start taken modulo the number of walls around, but indexing
    the whole neighbour array; neighbours outside the maze count as walls
    and are never opened.

    keys int64 [L, 2]; wall bool [L, D, D]; dim an int or an int tensor
    [L] (cells at i or j >= dim are padding walls). Each cell draws from
    its own key, `key, k = split(key)`; the chain does not depend on the
    grid, so it is walked before the scan (`prng.split_chain`) and all the
    draws are made at once (`prng.randint_bits`); the scan does only
    integer work."""
    L, D, _ = wall.shape
    dev = wall.device
    d = _dims(dim, L, dev)[:, 0]
    higher, lower = prng.randint_bits(
        prng.split_chain(keys, D * D)[:, :, 0])  # [L, D*D] each

    # per cell, its four neighbours: flat index (clipped into the grid),
    # and whether each lies inside the level's maze
    nb = np.array([[(x - 1, y), (x + 1, y), (x, y - 1), (x, y + 1)]
                   for x in range(D) for y in range(D)])  # [D*D, 4, 2]
    cells = torch.from_numpy(np.clip(nb, 0, D - 1) @ np.array([D, 1])).to(dev)
    lo = torch.from_numpy(nb.min(-1)).to(dev)
    hi = torch.from_numpy(nb.max(-1)).to(dev)
    inside = (lo >= 0) & (hi < d[:, None, None])  # [L, D*D, 4]
    xy = torch.arange(D * D, device=dev)
    in_dim = torch.maximum(xy // D, xy % D) < d[:, None]  # [L, D*D]

    w = wall.reshape(L, D * D).clone()
    lv = torch.arange(L, device=dev)
    four = torch.arange(4, device=dev)
    for idx in range(D * D):
        ninb = inside[:, idx]
        nwall = torch.where(ninb, w[:, cells[idx]], True)  # [L, 4]
        n_walls = nwall.sum(1)
        span = torch.clamp(n_walls, min=1)
        do = in_dim[:, idx] & ~w[:, idx] & (n_walls == 3)  # one open neighbour
        n_sel = prng.randint_from_bits(higher[:, idx], lower[:, idx], 0, span)
        # the first openable neighbour of (n_sel + n) % span, n = 0..3
        cand = (n_sel[:, None] + four) % span[:, None]  # [L, 4]
        ok = (ninb & nwall).gather(1, cand) & (four < n_walls[:, None])
        first = torch.argmax(ok.to(torch.int8), dim=1)
        target = cells[idx][cand[lv, first]]
        w[lv, target] &= ~(do & ok.any(1))
    return w.reshape(L, D, D)


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
