"""Two-pass axis-resolving tilemap collision
(procgen2_tpu/physics/tiles.py), System_Tilemap::get_collision of the
reference (`games/coinrun/tilemap.cpp:323-396`).

Batched: `grid` is [N, H, W] (one tile grid per env) and every position
tensor carries the env dimension first. The JAX package fetched tile
windows with one-hot contractions to stay off the TPU's slow gather path;
here a tile read is plain indexing, with out-of-bounds reads folded to
the caller's `oob_id` (tilemap.h:79-84) and every index kept in range.
"""
from __future__ import annotations

import torch

NONE, FULL, DOWN_ONLY = 0, 1, 2

_WINDOW = 3  # floor(x)..ceil(x+w) spans <= 3 tiles for w <= 1


def _gather(table, iy, ix):
    """table [N, H, W]; iy, ix int [N, ...] already in range -> [N, ...]."""
    N, H, W = table.shape
    flat = (iy.long() * W + ix.long()).reshape(N, -1)
    return table.reshape(N, H * W).gather(1, flat).reshape(iy.shape)


def tile_at(grid, tx, ty, oob_id):
    """Tile id at (tx, ty) in render coords, int32; `oob_id` outside the
    grid. grid [N, H, W]; tx, ty int [N, ...]."""
    _, H, W = grid.shape
    inb = (tx >= 0) & (tx < W) & (ty >= 0) & (ty < H)
    v = _gather(grid, ty.clamp(0, H - 1), tx.clamp(0, W - 1)).to(torch.int32)
    return torch.where(inb, v, torch.full_like(v, oob_id))


def aabb_overlap(ax, ay, aw, ah, bx, by, ax_hi=None, ay_hi=None):
    """Overlap of rect (a) with the 1x1 tile at (bx, by); ax_hi/ay_hi, if
    given, stand in for ax + aw / ay + ah."""
    ox = torch.maximum(ax, bx)
    oy = torch.maximum(ay, by)
    ow = torch.minimum(ax + aw if ax_hi is None else ax_hi, bx + 1.0) - ox
    oh = torch.minimum(ay + ah if ay_hi is None else ay_hi, by + 1.0) - oy
    return ox, oy, ow, oh


def _apply_lut(vals, coll_lut):
    """Tile ids -> collision types by equality masks; ids beyond the LUT
    are NONE, as in the JAX package's static-LUT path."""
    t = torch.zeros_like(vals, dtype=torch.int32)
    for tile_id, ctype in enumerate(list(coll_lut)):
        if ctype != NONE:
            t = torch.where(vals == tile_id, torch.full_like(t, int(ctype)), t)
    return t


def resolve_tile_collisions(grid, coll_lut, x, y, w, h, oob_id,
                            fallthrough=False, step_y=0.0, edges=None):
    """(new_x, new_y, collided) for rect (x, y, w, h); x, y f32 [N, ...]
    against grid [N, H, W]. `coll_lut` maps tile id -> NONE/FULL/DOWN_ONLY;
    `fallthrough`/`step_y` drive one-way platforms (tilemap.cpp:352-360).

    `edges` = (x + w, y + h, x + w / 2, y + h / 2) of the rect as the
    caller's JAX counterpart has XLA compute them, where they differ from
    the sums taken here: XLA folds (a - c1) + c2 into a + (c2 - c1), so a
    rect given by its centre a and half-size c1 has x + w = a + c1, one
    rounding, and x + w / 2 = a. The far edges stand in for x + w and
    y + h wherever the resolver adds them to the unmoved x and y."""
    lx = torch.floor(x).to(torch.int32)
    ly = torch.floor(y).to(torch.int32)
    d3 = torch.arange(_WINDOW, dtype=torch.int32, device=x.device)
    ys = (ly[..., None] + d3)[..., :, None]  # [..., 3(dy), 1]
    xs = (lx[..., None] + d3)[..., None, :]  # [..., 1, 3(dx)]
    ys, xs = torch.broadcast_tensors(ys, xs)
    vals = tile_at(grid, xs, ys, oob_id)
    return _resolve_core(_apply_lut(vals, coll_lut), lx, ly, x, y, w, h,
                         fallthrough, step_y, edges)


def fetch_window_rows(grid, ly, oob_id):
    """The 3 window rows starting at `ly` for K probes: grid [N, H, W],
    ly int [N, K] -> int8 [N, K, 3, W], rows outside the grid = oob_id."""
    N, H, W = grid.shape
    ys = ly[..., None] + torch.arange(_WINDOW, dtype=ly.dtype,
                                      device=ly.device)  # [N, K, 3]
    rows = grid[torch.arange(N, device=grid.device)[:, None, None],
                ys.clamp(0, H - 1).long()]  # [N, K, 3, W]
    iny = ((ys >= 0) & (ys < H))[..., None]
    return torch.where(iny, rows, torch.full_like(rows, oob_id))


def fetch_window_patch(grid, lx0, ly, oob_id, width=5):
    """Tile values of the 3 x `width` window at (lx0, ly) for K probes:
    int8 [N, K, 3, width], cells outside the grid = oob_id."""
    rows = fetch_window_rows(grid, ly, oob_id)  # [N, K, 3, W]
    W = grid.shape[2]
    xs = lx0[..., None] + torch.arange(width, dtype=lx0.dtype,
                                       device=lx0.device)  # [N, K, width]
    idx = xs.clamp(0, W - 1).long()[..., None, :].expand(
        *rows.shape[:-1], width)
    vals = rows.gather(-1, idx)
    inx = ((xs >= 0) & (xs < W))[..., None, :]
    return torch.where(inx, vals, torch.full_like(vals, oob_id))


def resolve_from_patch(patch, lx0, coll_lut, x, y, w, h, oob_id,
                       fallthrough=False, step_y=0.0):
    """resolve_tile_collisions for probes whose 3 x width window was
    fetched with `fetch_window_patch` at column origin `lx0`. The probe's
    3x3 window starts at clip(floor(x) - lx0, 0, width - 3) in the patch.
    `oob_id` is unused: the patch already holds it."""
    lx = torch.floor(x).to(torch.int32)
    ly = torch.floor(y).to(torch.int32)
    width = patch.shape[-1]
    d = (lx - lx0).clamp(0, width - _WINDOW)
    cols = d[..., None] + torch.arange(_WINDOW, dtype=d.dtype,
                                       device=d.device)  # [..., 3(dx)]
    idx = cols.long()[..., None, :].expand(*patch.shape[:-1], _WINDOW)
    vals = patch.gather(-1, idx)  # [..., 3(dy), 3(dx)]
    return _resolve_core(_apply_lut(vals, coll_lut), lx, ly, x, y, w, h,
                         fallthrough, step_y)


def _resolve_core(types, lx, ly, x, y, w, h, fallthrough, step_y,
                  edges=None):
    """The reference's two passes over the 3x3 window `types`
    [..., 3(dy), 3(dx)] whose top-left tile is (lx, ly)."""
    if edges is None:
        edges = (x + w, y + h, x + w * 0.5, y + h * 0.5)
    x_hi, y_hi, cx, cy = edges
    ux = torch.ceil(x_hi).to(torch.int32)
    uy = torch.ceil(y_hi).to(torch.int32)
    fallthrough = torch.as_tensor(fallthrough, device=x.device)
    step_y = torch.as_tensor(step_y, dtype=torch.float32, device=x.device)
    collided = torch.zeros(x.shape, dtype=torch.bool, device=x.device)

    # ---- Pass 1: vertical resolution (tilemap.cpp:337-368) ----
    ry = y
    for dy in range(_WINDOW):
        for dx in range(_WINDOW):
            tx = lx + dx
            ty = ly + dy
            valid = (tx <= ux) & (ty <= uy)
            t = types[..., dy, dx]
            txf = tx.to(torch.float32)
            tyf = ty.to(torch.float32)
            ox, oy, ow, oh = aabb_overlap(x, ry, w, h, txf, tyf,
                                          x_hi, y_hi if dy + dx == 0 else None)
            hit = valid & (t != NONE) & (ow > 0) & (oh > 0) & (ow > oh)
            # down_only: solid only when landing from above while moving
            # down without fallthrough (tilemap.cpp:353-360)
            inside = (ry + h - step_y) > tyf
            allowed = torch.where(
                t == DOWN_ONLY, (step_y > 0.01) & ~fallthrough & ~inside,
                torch.ones_like(hit))
            hit = hit & allowed
            oc_y = oy + oh * 0.5
            new_y = torch.where(oc_y > cy, tyf - h, tyf + 1.0)
            ry = torch.where(hit, new_y, ry)
            collided = collided | hit

    # ---- Pass 2: horizontal resolution (tilemap.cpp:370-393) ----
    rx = x
    for dy in range(_WINDOW):
        for dx in range(_WINDOW):
            tx = lx + dx
            ty = ly + dy
            valid = (tx <= ux) & (ty <= uy)
            t = types[..., dy, dx]
            txf = tx.to(torch.float32)
            tyf = ty.to(torch.float32)
            ox, oy, ow, oh = aabb_overlap(rx, ry, w, h, txf, tyf,
                                          x_hi if dy + dx == 0 else None)
            hit = (valid & (t != NONE) & (t != DOWN_ONLY)
                   & (ow > 0) & (oh > 0) & (ow <= oh))
            oc_x = ox + ow * 0.5
            new_x = torch.where(oc_x > cx, txf - w, txf + 1.0)
            rx = torch.where(hit, new_x, rx)
            collided = collided | hit

    return rx, ry, collided


def probe_any_solid(solid, xs, ys):
    """Does each rect overlap a solid tile or cross the map's edge? solid
    bool [N, H, W] (render coords); the rects by their edges, xs = (x_lo,
    x_hi) and ys = (y_lo, y_hi), f32 [N, K] each, as the caller's JAX
    counterpart has XLA compute them (its x + w folds; see
    `resolve_tile_collisions`). Returns bool [N, K].

    A rect hits where some solid tile overlaps it strictly, on both axes
    (the resolver's hit test), which for rects under a tile wide is its
    `collided` flag; the JAX package counts the overlapping solid tiles
    with two bf16 contractions (no more than 4 tiles for such rects, so
    exact), here one f32 batched product of 0/1 values, exact too. Out of
    bounds is solid (the JAX function's `oob_solid=True`, the only value
    the games use)."""
    N, H, W = solid.shape
    dev = solid.device
    (x, x_hi), (y, y_hi) = xs, ys
    tiles_x = torch.arange(W, dtype=torch.float32, device=dev)
    tiles_y = torch.arange(H, dtype=torch.float32, device=dev)
    ovx = ((x[..., None] < tiles_x + 1.0)
           & (x_hi[..., None] > tiles_x))  # [N, K, W]
    ovy = ((y[..., None] < tiles_y + 1.0)
           & (y_hi[..., None] > tiles_y))  # [N, K, H]
    rows = torch.bmm(ovy.to(torch.float32), solid.to(torch.float32))
    hit = (rows * ovx).sum(-1) > 0.5
    return hit | (x < 0.0) | (x_hi > W) | (y < 0.0) | (y_hi > H)
