"""The port's exact-render compositor (procgen2_tpu_torch/render/
compositor.py: backgrounds, tile layers, sprites axis-aligned and
rotated, `finalize`) against the JAX package's, bitwise, on inputs made
from a numpy seed: sprites partly off the frame, dead ones, fractional
alpha (a host number and a traced one), flipped ones, sizes as host
numbers (XLA divides by their reciprocal) and as traced values (a true
division), rotated ones at every angle.

The JAX functions draw one env; they run here under `jax.vmap`, jitted,
at the obs size of 64. Their frames carry a fourth, dead plane, which
the port leaves out; the three colour planes are compared."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procgen2_tpu.games import coinrun as jcoin
from procgen2_tpu.render import compositor as jC
from procgen2_tpu_torch.games import coinrun as tcoin
from procgen2_tpu_torch.render import compositor as tC
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N = 6


@functools.lru_cache(maxsize=None)
def assets():
    A = jcoin._assets()
    return A, tcoin._observe_assets("cpu")


def frames(rng):
    """Random frames of whole values in [0, 255], (JAX bf16 [N, 4, 64, 64],
    port bf16 [N, 3, 64, 64])."""
    img = rng.integers(0, 256, (N, 3, 64, 64)).astype(np.float32)
    j = jnp.concatenate([jnp.asarray(img), jnp.zeros((N, 1, 64, 64))], 1)
    return j.astype(jnp.bfloat16), torch.from_numpy(img).to(torch.bfloat16)


def coords(rng, lo, hi):
    """Per-env pixel-centre maps as a camera makes them, f32 [N, 64] each
    (numpy and torch)."""
    cam = rng.uniform(lo, hi, (2, N)).astype(np.float32)
    wx, wy = tC.camera_coords(4.8, torch.from_numpy(cam[0]),
                              torch.from_numpy(cam[1]))
    return (wx.numpy(), wy.numpy()), (wx, wy)


def same_frame(want, got):
    want = np.asarray(jnp.asarray(want)[:, :3].astype(jnp.float32))
    np.testing.assert_array_equal(want, got.to(torch.float32).numpy())


def test_draw_background_matches_jax():
    """Both origins the games use (0 over 64 units; bossfight's -2 over
    4), with pixels off the background on every side."""
    rng = np.random.default_rng(0)
    A, R = assets()
    (wx, wy), (twx, twy) = coords(rng, -8.0, 72.0)
    b = rng.integers(0, A["bgs_p"].shape[1], N).astype(np.int32)
    for origin, units, scale in ((0.0, 64.0, 1.0), (-2.0, 4.0, 0.0625)):
        jimg, timg = frames(rng)
        want = jax.jit(jax.vmap(lambda im, i, x, y: jC.draw_background(
            im, jnp.asarray(A["bgs_p"]), i, x, y, origin, origin, units)))(
                jimg, b, wx * scale, wy * scale)
        got = tC.draw_background(timg, R["bgs"], torch.from_numpy(b),
                                 twx * scale, twy * scale, origin, units)
        same_frame(want, got)


def test_draw_tiles_matches_jax():
    """A per-env lut row (a theme), a transparent kind, kinds beyond the
    lut, the grid's edge and an out-of-bounds kind."""
    rng = np.random.default_rng(1)
    A, R = assets()
    (wx, wy), (twx, twy) = coords(rng, -4.0, 20.0)
    grid = rng.integers(-1, 7, (N, 16, 16)).astype(np.int8)
    theme = rng.integers(0, 6, N)
    table = np.asarray(A["tile_lut"], np.int64)  # [themes, 6], -1 some
    jimg, timg = frames(rng)
    want = jax.jit(jax.vmap(lambda im, g, lut, x, y: jC.draw_tiles(
        im, g, lut, A["atlas_p"], x, y, oob_tile=2)))(
            jimg, grid, jnp.asarray(table[theme], jnp.int32), wx, wy)
    got = tC.draw_tiles(timg, torch.from_numpy(grid), table, R["atlas"], twx,
                        twy, oob_tile=2, theme=torch.from_numpy(theme))
    same_frame(want, got)


def test_draw_tiles_batch_matches_jax():
    rng = np.random.default_rng(2)
    A, R = assets()
    (wx, wy), (twx, twy) = coords(rng, -4.0, 20.0)
    grid = rng.integers(0, 3, (N, 16, 16)).astype(np.int8)
    lut = [-1, int(A["tile_lut"][0, 1]), int(A["crate_lut"][2])]
    jimg, timg = frames(rng)
    want = jax.jit(lambda im, g, x, y: jC.draw_tiles_batch(
        im[:, :3], g, lut, A["atlas_p"], x, y, oob_tile=1))(
            jimg, grid, wx, wy)
    got = tC.draw_tiles_batch(timg, torch.from_numpy(grid), lut, R["atlas"],
                              twx, twy, oob_tile=1)
    np.testing.assert_array_equal(
        np.asarray(want.astype(jnp.float32)), got.to(torch.float32).numpy())


# (w, h): host numbers, or "traced" (per-env values of a select, as the
# games' bullets pass them); rotation: None or per-env angles
SPRITES = {
    "axis": dict(w=0.95, h=1.1),
    "axis_exact_size": dict(w=1.0, h=2.0),
    "axis_traced_size": dict(w="traced", h="traced"),
    "axis_alpha": dict(w=0.8, h=0.8 * 84 / 101, alpha=0.7),
    "axis_traced_alpha": dict(w="traced", h=0.6, alpha="traced"),
    "rotated": dict(w=0.928, h=0.703, rotation=True),
    "rotated_traced_size": dict(w="traced", h="traced", rotation=True,
                                alpha="traced"),
    "rotated_alpha": dict(w=30.0 / 64, h=6.0 / 64, rotation=True, alpha=0.7),
}


@pytest.mark.parametrize("case", sorted(SPRITES))
def test_draw_sprite_matches_jax(case):
    """One sprite per env over a frame: some envs' sprites dead, some
    flipped, some partly or wholly off the frame; the texture a traced
    id."""
    spec = SPRITES[case]
    rng = np.random.default_rng(sorted(SPRITES).index(case) + 10)
    A, R = assets()
    (wx, wy), (twx, twy) = coords(rng, 10.0, 14.0)
    cam = wx[:, 32], wy[:, 32]
    # sprite corners around the camera, some well off the 13.3-unit view
    x = (cam[0] + rng.uniform(-8.0, 6.0, N)).astype(np.float32)
    y = (cam[1] + rng.uniform(-8.0, 6.0, N)).astype(np.float32)
    sid = rng.integers(0, A["atlas_p"].shape[1], N).astype(np.int32)
    flip = rng.random(N) < 0.5
    alive = np.array([True, True, False, True, True, True])
    traced = rng.choice(np.float32([0.3, 0.38, 1.7, 2.25]), (2, N))
    rot = rng.uniform(-7.0, 7.0, N).astype(np.float32)
    alpha_t = rng.uniform(0.0, 1.0, N).astype(np.float32)

    def pick(k, i):
        v = spec.get(k, 1.0)
        if v == "traced":
            return ((traced[i], torch.from_numpy(traced[i])) if k != "alpha"
                    else (alpha_t, torch.from_numpy(alpha_t)))
        return None, v
    (jw, tw), (jh, th), (ja, ta) = pick("w", 0), pick("h", 1), pick("alpha", 0)
    rotated = spec.get("rotation", False)

    def one(im, s, x_, y_, f, al, r, w_, h_, a_, wx_, wy_):
        return jC.draw_sprite(
            im, A["atlas_p"], s, x_, y_, tw if jw is None else w_,
            th if jh is None else h_, wx_, wy_, flip_x=f, alive=al,
            rotation=r if rotated else None, alpha=ta if ja is None else a_)
    jimg, timg = frames(rng)
    dummy = np.zeros(N, np.float32)
    f = jax.jit(one)  # one env at a time, as the single-env renders draw
    want = jnp.stack([f(
        jimg[e], sid[e], x[e], y[e], flip[e], alive[e], rot[e],
        (dummy if jw is None else jw)[e], (dummy if jh is None else jh)[e],
        (dummy if ja is None else ja)[e], wx[e], wy[e]) for e in range(N)])
    got = tC.draw_sprite(
        timg, R["atlas"], torch.from_numpy(sid), torch.from_numpy(x),
        torch.from_numpy(y), tw, th, twx, twy,
        flip_x=torch.from_numpy(flip), alive=torch.from_numpy(alive),
        rotation=torch.from_numpy(rot) if rotated else None, alpha=ta)
    same_frame(want, got)


def test_draw_sprites_matches_jax():
    """K sprites per env in a loop, some dead, some flipped, overlapping."""
    rng = np.random.default_rng(3)
    A, R = assets()
    (wx, wy), (twx, twy) = coords(rng, 10.0, 14.0)
    K = 5
    x = (wx[:, 32:33] + rng.uniform(-7.0, 6.0, (N, K))).astype(np.float32)
    y = (wy[:, 32:33] + rng.uniform(-7.0, 6.0, (N, K))).astype(np.float32)
    sid = rng.integers(0, A["atlas_p"].shape[1], (N, K)).astype(np.int32)
    flip = rng.random((N, K)) < 0.5
    alive = rng.random((N, K)) < 0.7
    jimg, timg = frames(rng)
    want = jax.jit(jax.vmap(lambda im, s, x_, y_, f, al, wx_, wy_:
                            jC.draw_sprites(im, A["atlas_p"], s, x_, y_,
                                            jnp.ones(K), jnp.ones(K), wx_,
                                            wy_, flips=f, alives=al)))(
        jimg, sid, x, y, flip, alive, wx, wy)
    t = torch.from_numpy
    got = tC.draw_sprites(timg, R["atlas"], t(sid), t(x), t(y),
                          torch.ones((N, K)), torch.ones((N, K)), twx, twy,
                          flips=t(flip), alives=t(alive))
    same_frame(want, got)


def test_finalize_matches_jax():
    """Round half to even and clip, from bf16, to uint8 HWC."""
    rng = np.random.default_rng(4)
    v = np.concatenate([rng.uniform(-20, 280, 3 * 64 * 64 - 8),
                        [0.5, 1.5, 2.5, 254.5, 255.5, -0.5, 256.0, -0.0]])
    img = v.reshape(1, 3, 64, 64).astype(np.float32)
    j = jnp.concatenate([jnp.asarray(img), jnp.zeros((1, 1, 64, 64))], 1)
    want = jax.jit(jax.vmap(jC.finalize))(j.astype(jnp.bfloat16))
    got = tC.finalize(torch.from_numpy(img).to(torch.bfloat16))
    assert got.dtype == torch.uint8 and got.shape == (1, 64, 64, 3)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("size", [64, 128, 512])
def test_camera_coords_are_the_fused_multiply_add(size):
    """cam + c / ppu as the JAX renders compute it: c times the f32
    reciprocal of ppu, added to the camera with one rounding."""
    rng = np.random.default_rng(size)
    cam = torch.from_numpy(rng.uniform(-40, 40, 5).astype(np.float32))
    ppu = 4.8 * size / 64
    wx, _ = tC.camera_coords(ppu, cam, cam, size)
    c = np.arange(size, dtype=np.float64) + 0.5 - size / 2
    r = np.float64(np.float32(1) / np.float32(ppu))
    want = (c * r + cam.numpy().astype(np.float64)[:, None]).astype(
        np.float32)
    np.testing.assert_array_equal(want, wx.numpy())


# ---- the compositor's remaining helpers (planar, planar_stack,
# select_tex(s), place_stamps, sprite_stamps) against the JAX functions ----

def test_planar_and_planar_stack_match_jax():
    rng = np.random.default_rng(20)
    img = rng.integers(0, 256, (5, 7, 4)).astype(np.uint8)
    stack = rng.integers(0, 256, (3, 5, 7, 4)).astype(np.uint8)
    np.testing.assert_array_equal(np.asarray(jC.planar(img)),
                                  tC.planar(img).numpy())
    np.testing.assert_array_equal(np.asarray(jC.planar_stack(stack)),
                                  tC.planar_stack(stack).numpy())
    assert tC.planar_stack(torch.from_numpy(stack)).shape == (4, 3, 5, 7)


def test_select_tex_matches_jax():
    """Ids inside the atlas, and outside it on both sides (zeros)."""
    A, _ = assets()
    atlas_p = np.asarray(A["atlas_p"])  # [4, A, S, S] u8
    n = atlas_p.shape[1]
    sids = np.array([0, 3, n - 1, -1, n, 7], np.int32)
    want = np.asarray(jax.jit(jC.select_texs)(atlas_p, sids).astype(
        jnp.float32))
    got = tC.select_texs(torch.from_numpy(atlas_p), torch.from_numpy(sids))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    np.testing.assert_array_equal(want, got.float().numpy())
    for s in (2, n + 3):
        one = np.asarray(jax.jit(jC.select_tex)(atlas_p, np.int32(s)).astype(
            jnp.float32))
        np.testing.assert_array_equal(
            one, tC.select_tex(torch.from_numpy(atlas_p), s).float().numpy())


def _prem_patches(rng, n, k, P):
    """Premultiplied bf16 patches [n, k, 4, P, P] as a bank makes them:
    whole texels in [0, 255] times a fractional alpha, some fully clear."""
    rgb = rng.integers(0, 256, (n, k, 3, P, P)).astype(np.float32)
    a = rng.integers(0, 256, (n, k, 1, P, P)).astype(np.float32) / 255.0
    a[rng.random((n, k, 1, P, P)) < 0.2] = 0.0
    prem = np.concatenate([rgb * a, a], 2)
    return jnp.asarray(prem).astype(jnp.bfloat16), torch.from_numpy(
        prem).to(torch.bfloat16)


@pytest.mark.parametrize("P", [4, 8, 20])
def test_place_stamps_matches_jax(P):
    """Overlapping stamps (an f32 sum rounded once) and stamps off every
    edge, partly and wholly, at 64 px."""
    rng = np.random.default_rng(P)
    K = 9
    jprem, tprem = _prem_patches(rng, N, K, P)
    r0 = rng.integers(-P - 6, 64 + 6, (N, K)).astype(np.int32)
    c0 = rng.integers(-P - 6, 64 + 6, (N, K)).astype(np.int32)
    r0[:, :3], c0[:, :3] = 30, 28  # three on one spot
    jr, ja = jax.jit(jC.place_stamps)(jprem, r0, c0)
    tr, ta = tC.place_stamps(tprem, torch.from_numpy(r0),
                             torch.from_numpy(c0))
    assert tr.dtype == torch.bfloat16 and tr.shape == (N, 3, 64, 64)
    np.testing.assert_array_equal(np.asarray(jr.astype(jnp.float32)),
                                  tr.float().numpy())
    np.testing.assert_array_equal(np.asarray(ja.astype(jnp.float32)),
                                  ta.float().numpy())


@pytest.mark.parametrize("P", [8, 12])
def test_sprite_stamps_matches_jax(P):
    """K sprites per env on a moving camera: sizes up to the patch, some
    dead, flipped, off the frame, with variants outside the bank."""
    A, _ = assets()
    atlas_p = np.asarray(A["atlas_p"])
    bank = np.ascontiguousarray(atlas_p[:, :6].transpose(1, 0, 2, 3))
    V = bank.shape[0]
    rng = np.random.default_rng(30 + P)
    K = 7
    (wx, wy), (twx, twy) = coords(rng, 4.0, 12.0)
    var = rng.integers(-1, V + 1, (N, K)).astype(np.int32)
    xs = (wx[:, :1] + rng.uniform(-3, 14, (N, K))).astype(np.float32)
    ys = (wy[:, :1] + rng.uniform(-3, 14, (N, K))).astype(np.float32)
    ws = rng.uniform(0.3, (P - 1) / 4.8, (N, K)).astype(np.float32)
    hs = rng.uniform(0.3, (P - 1) / 4.8, (N, K)).astype(np.float32)
    flips = rng.random((N, K)) < 0.5
    alives = rng.random((N, K)) < 0.8
    fn = jax.jit(functools.partial(jC.sprite_stamps, patch=P))
    jr, ja = fn(bank, var, xs, ys, ws, hs, wx, wy, flips, alives)
    t = torch.from_numpy
    tr, ta = tC.sprite_stamps(t(bank), t(var), t(xs), t(ys), t(ws), t(hs),
                              twx, twy, t(flips), t(alives), patch=P)
    np.testing.assert_array_equal(np.asarray(jr.astype(jnp.float32)),
                                  tr.float().numpy())
    np.testing.assert_array_equal(np.asarray(ja.astype(jnp.float32)),
                                  ta.float().numpy())
    assert float(ta.float().sum()) > 0
