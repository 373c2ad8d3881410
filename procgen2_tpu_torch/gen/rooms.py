"""Cellular-automata caves, connected rooms and BFS paths
(procgen2_tpu/gen/rooms.py), batched over levels.

The reference's Room_Generator (`games/jumper/room_generator.{h,cpp}`,
vendored in caveflyer) as array stencils, each on masks [L, H, W] (one
level per row of the leading dimension):

* `ca_smooth`: Moore-9 wall count >= 5 -> wall, out of bounds a wall
  (room_generator.cpp:21-36, room_generator.h:40-44);
* `largest_room`: every open cell adopts the least flat index of its
  4-connected component (label propagation), then the most frequent label
  wins, the least on ties (find_best_room, room_generator.cpp:143-164);
* `bfs_dist`: breadth-first distance by relaxation over the
  4-neighbourhood (find_path, room_generator.cpp:80-141);
* `shortest_path_mask`: the walk back from the destination along strictly
  decreasing distances, neighbours tried in the order (x-1, x+1, y-1, y+1);
* `dilate_in`: n Moore-8 dilations kept to open cells (expand_room,
  room_generator.cpp:166-202).

The JAX package runs label propagation and relaxation for a fixed number
of iterations. Both reach a fixed point, after which an iteration changes
nothing, so these stop at the fixed point (tested every few iterations)
or at the same bound, whichever comes first: the result is the same.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_CHECK_EVERY = 8  # iterations between fixed-point tests (one host sync each)


def _shift(a, dx, dy, fill):
    """a [L, H, W] moved by (dx, dy) in (row, col): out[i, j] =
    a[i - dx, j - dy], `fill` where that lies outside."""
    L, H, W = a.shape
    p = F.pad(a, (1, 1, 1, 1), value=fill)
    return p[:, 1 - dx:1 - dx + H, 1 - dy:1 - dy + W]


def ca_smooth(wall):
    """One cellular-automata pass on bool [L, H, W]: Moore-9 wall count
    (the cell itself included, out of bounds a wall) >= 5 -> wall."""
    w = F.pad(wall.to(torch.int32), (1, 1, 1, 1), value=1)
    L, H, W = wall.shape
    total = sum(w[:, 1 + dx:1 + dx + H, 1 + dy:1 + dy + W]
                for dx in (-1, 0, 1) for dy in (-1, 0, 1))
    return total >= 5


def _fixed_point(body, x, iters):
    """x after `iters` applications of body, or fewer once body(x) == x."""
    done = 0
    while done < iters:
        n = min(_CHECK_EVERY, iters - done)
        prev = x
        for _ in range(n):
            x = body(x)
        done += n
        if torch.equal(prev, x):
            break
    return x


def largest_room(open_mask, iters: int):
    """Mask of the largest 4-connected component of each level's
    `open_mask` bool [L, H, W]; `iters` bounds the propagation (the JAX
    package's H*W//2 covers any path shape)."""
    L, H, W = open_mask.shape
    dev = open_mask.device
    big = H * W
    idx = torch.arange(H * W, dtype=torch.int32, device=dev).reshape(1, H, W)
    lbl = torch.where(open_mask, idx, big)

    def body(lbl):
        m = lbl
        for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            m = torch.minimum(m, _shift(lbl, dx, dy, big))
        return torch.where(open_mask, m, big)

    lbl = _fixed_point(body, lbl, iters)
    sizes = torch.zeros((L, H * W + 1), dtype=torch.int32, device=dev)
    sizes.scatter_add_(1, lbl.reshape(L, -1).long(),
                       torch.ones((L, H * W), dtype=torch.int32, device=dev))
    sizes[:, H * W] = 0  # the closed cells' bucket
    best = torch.argmax(sizes, dim=1)  # the least label on ties
    return lbl == best[:, None, None]


def bfs_dist(open_mask, src_y, src_x, iters: int):
    """4-connected BFS distance int32 [L, H, W] from (src_y[l], src_x[l])
    over each level's open cells; unreachable and closed cells H*W."""
    L, H, W = open_mask.shape
    dev = open_mask.device
    inf = H * W
    ys = torch.arange(H, device=dev)[None, :, None]
    xs = torch.arange(W, device=dev)[None, None, :]
    src = (ys == src_y[:, None, None]) & (xs == src_x[:, None, None])
    dist = torch.where(src, 0, inf).to(torch.int32)

    def body(dist):
        m = dist
        for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            m = torch.minimum(m, _shift(dist, dx, dy, inf) + 1)
        return torch.where(open_mask, m, inf)

    return _fixed_point(body, dist, iters)


def shortest_path_mask(dist, dst_y, dst_x):
    """Bool [L, H, W]: one shortest path per level, from (dst_y, dst_x)
    back along strictly decreasing distances to distance 0, each step to
    the first of (x-1, x+1, y-1, y+1) one closer. The JAX package walks
    each level in a while loop; here every level takes a step per
    iteration until all walks have ended (a finished level stands still).
    A walk that finds no closer neighbour stands still until the bound of
    H*W steps (the JAX loop would not end; no caller's level has one)."""
    L, H, W = dist.shape
    dev = dist.device
    flat = dist.reshape(L, H * W)
    n = torch.arange(L, device=dev)
    inf = H * W

    def dist_at(y, x):
        inb = (y >= 0) & (y < H) & (x >= 0) & (x < W)
        d = flat[n, (y.clamp(0, H - 1) * W + x.clamp(0, W - 1)).long()]
        return torch.where(inb, d, inf)

    y = dst_y.to(torch.int64)
    x = dst_x.to(torch.int64)
    mask = torch.zeros((L, H * W), dtype=torch.bool, device=dev)
    for it in range(H * W):
        if it % _CHECK_EVERY == 0 and not bool((dist_at(y, x) > 0).any()):
            break
        d = dist_at(y, x)
        walking = d > 0
        cell = (y.clamp(0, H - 1) * W + x.clamp(0, W - 1)).long()
        mask[n, cell] |= walking
        ny, nx = y, x
        found = torch.zeros_like(walking)
        for cy, cx in ((y, x - 1), (y, x + 1), (y - 1, x), (y + 1, x)):
            ok = ~found & (dist_at(cy, cx) == d - 1)
            ny = torch.where(ok, cy, ny)
            nx = torch.where(ok, cx, nx)
            found = found | ok
        y = torch.where(walking, ny, y)
        x = torch.where(walking, nx, x)
    mask[n, (y.clamp(0, H - 1) * W + x.clamp(0, W - 1)).long()] = True
    return mask.reshape(L, H, W)


def dilate_in(mask, open_mask, n: int):
    """n Moore-8 dilations of `mask` bool [L, H, W], kept to open cells."""
    for _ in range(n):
        g = mask
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                g = g | _shift(mask, dx, dy, False)
        mask = g & open_mask
    return mask
