"""The port's tile physics (procgen2_tpu_torch/physics) against the JAX
package's (procgen2_tpu/physics), on random grids and rects made with
numpy: results must be identical (f32 bit for bit)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procgen2_tpu.physics import aabb as jaabb
from procgen2_tpu.physics import tiles as jt
from procgen2_tpu_torch.physics import aabb as taabb
from procgen2_tpu_torch.physics import tiles as tt
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N, H, W = 48, 16, 16
OOB = 2
LUT_AGENT = (0, 1, 1, 0, 0, 2)  # walls full, crates one-way
LUT_LAVA = (0, 0, 0, 1, 1, 0)
LUT_EMPTY = (1, 0, 0, 0, 0, 0)


def _grid(rng):
    return rng.choice(6, size=(N, H, W), p=[0.5, 0.15, 0.15, 0.05, 0.05, 0.1]
                      ).astype(np.int8)


def _coord(rng, shape, lo, hi):
    """Positions with many on the 1/8 lattice: exact tile-edge contacts."""
    x = rng.uniform(lo, hi, shape).astype(np.float32)
    snap = rng.random(shape) < 0.5
    return np.where(snap, np.round(x * 8) / 8, x).astype(np.float32)


def same(a, b):
    a = np.asarray(a)
    b = b.numpy()
    assert a.shape == b.shape
    if a.dtype == np.float32:
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    else:
        np.testing.assert_array_equal(a, b)


def test_tile_at_with_oob():
    rng = np.random.default_rng(0)
    g = _grid(rng)
    tx = rng.integers(-3, W + 3, (N, 9)).astype(np.int32)
    ty = rng.integers(-3, H + 3, (N, 9)).astype(np.int32)
    want = jax.vmap(lambda gg, x, y: jt.tile_at(gg, x, y, OOB))(g, tx, ty)
    got = tt.tile_at(torch.from_numpy(g), torch.from_numpy(tx),
                     torch.from_numpy(ty), OOB)
    same(want, got)


@pytest.mark.parametrize("lut", [LUT_AGENT, LUT_LAVA, LUT_EMPTY])
@pytest.mark.parametrize("size", [(1.0, 1.0), (1.0, 0.5)])
def test_resolve_tile_collisions(lut, size):
    rng = np.random.default_rng(hash((lut, size)) % 2 ** 32)
    g = _grid(rng)
    w, h = size
    x = _coord(rng, (N,), -1.5, W + 0.5)
    y = _coord(rng, (N,), -1.5, H + 0.5)
    fall = rng.random(N) < 0.3
    step_y = _coord(rng, (N,), -0.4, 0.4)
    want = jax.vmap(lambda gg, a, b, f, s: jt.resolve_tile_collisions(
        gg, np.array(lut, np.int32), a, b, w, h, OOB, fallthrough=f,
        step_y=s))(g, x, y, fall, step_y)
    got = tt.resolve_tile_collisions(
        torch.from_numpy(g), lut, torch.from_numpy(x), torch.from_numpy(y),
        w, h, OOB, fallthrough=torch.from_numpy(fall),
        step_y=torch.from_numpy(step_y))
    for a, b in zip(want, got):
        same(a, b)
    assert got[2].any() and not got[2].all()


def test_fetch_window_rows_and_patch():
    rng = np.random.default_rng(1)
    g = _grid(rng)
    K = 7
    ly = rng.integers(-4, H + 2, (N, K)).astype(np.int32)
    lx0 = rng.integers(-6, W + 2, (N, K)).astype(np.int32)
    tg = torch.from_numpy(g)
    same(jax.vmap(lambda gg, a: jt.fetch_window_rows(gg, a, OOB))(g, ly),
         tt.fetch_window_rows(tg, torch.from_numpy(ly), OOB))
    same(jax.vmap(lambda gg, a, b: jt.fetch_window_patch(gg, a, b, OOB))(
        g, lx0, ly),
        tt.fetch_window_patch(tg, torch.from_numpy(lx0),
                              torch.from_numpy(ly), OOB))


@pytest.mark.parametrize("lut", [LUT_AGENT, LUT_EMPTY])
def test_resolve_from_patch(lut):
    """Mob-sensor style probes: the patch is fetched around the start
    position and the probe moves a little (including past the patch's
    clip range)."""
    rng = np.random.default_rng(2)
    g = _grid(rng)
    K = 9
    x0 = _coord(rng, (N, K), -1.0, W)
    y = _coord(rng, (N, K), -1.0, H)
    lx0 = (np.floor(x0 - 0.5).astype(np.int32) - 1)
    ly = np.floor(y - 0.6).astype(np.int32)
    x = (x0 + rng.choice([-1.2, -0.15, 0.0, 0.15, 1.3], (N, K))).astype(np.float32)

    def one(gg, l0, yy, xx, yv):
        patch = jt.fetch_window_patch(gg, l0, yy, OOB)
        return jt.resolve_from_patch(patch, l0, np.array(lut, np.int32),
                                     xx - 0.5, yv - 0.6, 1.0, 0.5, OOB)

    want = jax.vmap(one)(g, lx0, ly, x, y)
    tpatch = tt.fetch_window_patch(torch.from_numpy(g), torch.from_numpy(lx0),
                                   torch.from_numpy(ly), OOB)
    got = tt.resolve_from_patch(tpatch, torch.from_numpy(lx0), lut,
                                torch.from_numpy(x) - 0.5,
                                torch.from_numpy(y) - 0.6, 1.0, 0.5, OOB)
    for a, b in zip(want, got):
        same(a, b)


def test_aabb_helpers():
    rng = np.random.default_rng(3)
    r = [_coord(rng, (256,), -2.0, 2.0) for _ in range(8)]
    r[2], r[3], r[6], r[7] = (np.abs(v) + 0.125 for v in (r[2], r[3], r[6], r[7]))
    t = [torch.from_numpy(v) for v in r]
    same(jaabb.check_collision(*r), taabb.check_collision(*t))
    for a, b in zip(jaabb.overlap_extent(*r), taabb.overlap_extent(*t)):
        same(a, b)
    jo = jt.aabb_overlap(*(jnp.asarray(v) for v in r[:4]), r[4], r[5])
    to = tt.aabb_overlap(*t[:4], t[4], t[5])
    for a, b in zip(jo, to):
        same(a, b)


@pytest.mark.parametrize("lut", [LUT_AGENT, LUT_LAVA])
@pytest.mark.parametrize("centred", [False, True])
def test_resolve_from_rows_matches_jitted_jax(lut, centred):
    """Probes resolved from rows fetched beforehand (rows above and below
    the grid folded to OOB, columns off both sides), with fallthrough and
    step_y, against the jitted JAX function. `centred`: the rect given by
    its centre less its half size inside the jit, as the games give it,
    where XLA folds the constants into the rect's edges (the port's
    `edges=`); else x and y come in as they are."""
    rng = np.random.default_rng(40 + centred + 2 * lut[3])
    g = _grid(rng)
    K = 9
    w, h = 1.0, 0.5
    cx = _coord(rng, (N, K), -2.0, W + 1.0)
    cy = _coord(rng, (N, K), -2.0, H + 1.0)
    fall = rng.random((N, K)) < 0.3
    step_y = _coord(rng, (N, K), -0.4, 0.4)
    if centred:
        tx = torch.from_numpy(cx) - 0.5 * w
        ty = torch.from_numpy(cy) - 0.5 * h
        edges = (torch.from_numpy(cx) + 0.5 * w,
                 torch.from_numpy(cy) + 0.5 * h,
                 torch.from_numpy(cx), torch.from_numpy(cy))
    else:
        tx, ty, edges = torch.from_numpy(cx), torch.from_numpy(cy), None
    ly = torch.floor(ty).to(torch.int32)
    trows = tt.fetch_window_rows(torch.from_numpy(g), ly, OOB)
    jrows = jax.vmap(lambda gg, a: jt.fetch_window_rows(gg, a, OOB))(
        g, ly.numpy())
    same(jrows, trows)

    def one(rows, a, b, f, s):
        if centred:
            a, b = a - 0.5 * w, b - 0.5 * h
        return jt.resolve_from_rows(rows, np.array(lut, np.int32), a, b, w,
                                    h, W, OOB, fallthrough=f, step_y=s)

    want = jax.jit(jax.vmap(one))(jrows, cx, cy, fall, step_y)
    got = tt.resolve_from_rows(trows, lut, tx, ty, w, h, W, OOB,
                               fallthrough=torch.from_numpy(fall),
                               step_y=torch.from_numpy(step_y), edges=edges)
    for a, b in zip(want, got):
        same(a, b)
    assert got[2].any() and not got[2].all()
    # the rows of the grid itself: the resolver that reads the grid
    grid = tt.resolve_tile_collisions(
        torch.from_numpy(g), lut, tx, ty, w, h, OOB,
        fallthrough=torch.from_numpy(fall), step_y=torch.from_numpy(step_y),
        edges=edges)
    for a, b in zip(grid, got):
        assert torch.equal(a, b)
