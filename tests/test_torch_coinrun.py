"""The port's coinrun (procgen2_tpu_torch/games/coinrun.py) against the
JAX package's: level generation, reset and the 4-sub-step physics must be
identical, given the same keys, states and actions."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_capture import render_inputs
from procgen2_tpu.games import coinrun as jcoin
from procgen2_tpu_torch import random as R
from procgen2_tpu_torch.games import coinrun as tcoin
from procgen2_tpu_torch.utils import convert
import render_parity as RP

NUM_LEVELS, N, T = 64, 8, 6
LEVEL_FIELDS = [f.name for f in dataclasses.fields(tcoin.Level)]
STATE_FIELDS = [f.name for f in dataclasses.fields(tcoin.State)
                if f.name != "level"]


def np_tree(tree):
    return jax.tree.map(
        lambda a: (np.asarray(jax.random.key_data(a))
                   if jnp.issubdtype(a.dtype, jax.dtypes.prng_key)
                   else np.asarray(a)), tree)


def same(want, got):
    want = np.asarray(want)
    got = got.numpy()
    if want.dtype == np.uint32:
        want = want.astype(np.int64)
    assert want.shape == got.shape and want.dtype == got.dtype, (
        want.shape, want.dtype, got.shape, got.dtype)
    if want.dtype == np.float32:
        np.testing.assert_array_equal(want.view(np.int32), got.view(np.int32))
    else:
        np.testing.assert_array_equal(want, got)


def _keys(n, seed=7):
    return jax.vmap(lambda i: jax.random.fold_in(jax.random.key(seed), i))(
        jnp.arange(n, dtype=jnp.uint32))


def _generate_both(cfg_kw, n):
    jl = jax.jit(jax.vmap(functools.partial(jcoin.generate,
                                            jcoin.Config(**cfg_kw))))(_keys(n))
    tl = tcoin.generate(tcoin.Config(**cfg_kw),
                        R.fold_in(R.key(7), torch.arange(n)))
    return np_tree(jl), tl


@pytest.fixture(scope="module")
def banks():
    return _generate_both({}, NUM_LEVELS)


@pytest.mark.parametrize("field", LEVEL_FIELDS)
def test_generate_matches(banks, field):
    jl, tl = banks
    same(getattr(jl, field), getattr(tl, field))


def test_generate_covers_the_branches(banks):
    """The bank exercises pits, every danger type and crates."""
    _, tl = banks
    g = tl.grid
    assert (g == tcoin.LAVA_TOP).any() and (g == tcoin.CRATE).any()
    assert tl.saw_alive.any() and tl.mob_alive.any()
    assert len(set(tl.difficulty.tolist())) == 3


def test_generate_with_features_off():
    jl, tl = _generate_both(dict(allow_pit=False, allow_crate=False,
                                 allow_dy=False, allow_mobs=False), 16)
    for f in LEVEL_FIELDS:
        same(getattr(jl, f), getattr(tl, f))
    assert not (tl.grid == tcoin.CRATE).any()


def place_on_hazards(st):
    """Lane 0 on its coin, and the first lanes whose levels have one on a
    live saw and in lava; velocities zeroed. numpy State in, out."""
    lv = st.level
    pos, vel = st.pos.copy(), st.vel.copy()
    pos[0] = lv.coin_pos[0] + np.float32([0.0, 0.5])
    saws = [i for i in range(1, len(pos)) if lv.saw_alive[i].any()]
    if saws:
        i = saws[0]
        pos[i] = lv.saw_pos[i, int(np.argmax(lv.saw_alive[i]))] + np.float32([0.0, 0.5])
    lava = [i for i in range(1, len(pos)) if i not in saws[:1]
            and (lv.grid[i] == jcoin.LAVA_TOP).any()]
    if lava:
        i = lava[0]
        ry, x = np.argwhere(lv.grid[i] == jcoin.LAVA_TOP)[0]
        pos[i] = np.float32([x + 0.5, ry + 1.0])
    vel[[0] + saws[:1] + lava[:1]] = 0.0
    return st.replace(pos=pos, vel=vel)


def random_states(bank, seed):
    """States on the bank's first N levels with the agent anywhere (in
    walls, on crates, mid-air), random velocities and poses."""
    rng = np.random.default_rng(seed)
    lv = jax.tree.map(lambda a: a[:N], bank)
    f32 = np.float32
    return jcoin.State(
        level=lv,
        pos=np.stack([rng.uniform(1.0, 63.0, N), rng.uniform(1.5, 63.0, N)],
                     -1).astype(f32),
        vel=rng.uniform(-0.6, 0.6, (N, 2)).astype(f32),
        on_ground=rng.random(N) < 0.5,
        face_forward=rng.random(N) < 0.5,
        anim_t=rng.random(N).astype(f32),
        mob_pos=lv.mob_pos0.copy(),
        mob_vx=lv.mob_vx0.copy(),
        t=rng.integers(0, 20, N).astype(np.int32),
        rng=np.zeros((N, 2), np.uint32),
    )


def test_reset_matches(banks):
    jl, _ = banks
    lv = jax.tree.map(lambda a: jnp.asarray(a[:N]), jl)
    keys = jax.random.split(jax.random.key(8), N)
    want = np_tree(jax.vmap(functools.partial(jcoin.reset, jcoin.Config()))(
        lv, keys))
    got = tcoin.reset(tcoin.Config(), convert.level(tcoin, jax.tree.map(
        np.asarray, lv), "cpu"), torch.from_numpy(np_tree(keys).astype(np.int64)))
    for f in STATE_FIELDS:
        same(getattr(want, f), getattr(got, f))


@pytest.fixture(scope="module")
def trajectories(banks):
    """T game-level steps (no auto-reset) from random states, with lanes
    on the coin, a saw and lava: JAX and port results per step."""
    jl, _ = banks
    st = place_on_hazards(random_states(jl, 0))
    actions = np.random.default_rng(1).integers(0, 15, (T, N)).astype(np.int32)
    jstep = jax.jit(jax.vmap(functools.partial(jcoin.step, jcoin.Config())))
    jst = jax.tree.map(jnp.asarray, st.replace(rng=jax.random.wrap_key_data(st.rng)))
    tst = convert.state(tcoin, st, "cpu")
    out = []
    for t in range(T):
        jst, jr, jd, _ = jstep(jst, jnp.asarray(actions[t]))
        tst, tr, td, _ = tcoin.step(tcoin.Config(), tst,
                                    torch.from_numpy(actions[t]))
        out.append((np_tree(jst), np.asarray(jr), np.asarray(jd), tst, tr, td))
    return out


@pytest.mark.parametrize("t", range(T))
def test_step_matches(trajectories, t):
    jst, jr, jd, tst, tr, td = trajectories[t]
    for f in STATE_FIELDS:
        same(getattr(jst, f), getattr(tst, f))
    same(jr, tr)
    same(jd, td)


def test_hazards_end_episodes(trajectories):
    _, jr, jd, _, tr, td = trajectories[0]
    assert tr[0] == 10.0 and td[0]  # lane 0 stood on its coin
    assert int(td.sum()) >= 2  # and at least one saw or lava lane died


def test_cull_keeps_top_k_order_on_ties():
    """Equal scores (dead slots at -1e30, hazards symmetric about the
    camera) keep index order, as lax.top_k does."""
    rng = np.random.default_rng(4)
    M = 80
    pos = np.zeros((6, M, 2), np.float32)
    pos[..., 0] = rng.choice(np.float32([8.5, 11.5, 10.0, 9.25, 10.75]), (6, M))
    alive = rng.random((6, M)) < 0.2
    cam = np.full(6, 10.0, np.float32)
    score = jnp.where(alive, -jnp.abs(pos[..., 0] - cam[:, None]), -1e30)
    want = np.asarray(jax.lax.top_k(score, tcoin.HAZARD_CULL)[1])
    got = tcoin._cull(torch.from_numpy(cam), torch.from_numpy(pos),
                      torch.from_numpy(alive), tcoin.HAZARD_CULL)
    np.testing.assert_array_equal(want, got.numpy())


def _near_half(cam, rng, ppu, c):
    """f32 centres, one per camera coordinate of cam, whose pixel
    (centre - cam) * ppu + c lies within a few ulp of a half."""
    off = (rng.integers(0, 60, cam.shape) + 0.5 - c) / ppu
    v = np.float32(cam + off)
    return (v + rng.integers(-6, 7, v.shape) * np.spacing(v)).astype(
        np.float32)


def _split_roundings(d, ppu, c):
    """bool: (d * ppu + 32) rounded, then - (32 - c) rounded, gives another
    pixel than d * ppu + c rounded once (f32 d)."""
    f32 = np.float32
    once = np.round((np.float64(d) * np.float64(f32(ppu)) + c).astype(f32))
    twice = np.round((d * f32(ppu) + f32(32)) - f32(32 - c))
    return once != twice


def test_stamp_placement_matches_xla_near_half_pixels(banks):
    """XLA CPU folds the stamp placement (c - cam) * 4.8 + 32 - P / 2
    (coinrun.py:770-773) into one multiply-add with the constant 32 - P/2
    and fuses it, so a placement is rounded once; rounding the sum with 32
    first, then subtracting P/2, gives another pixel near half pixels. On
    64 states (a batch XLA runs in its vector loop) whose coin lies within
    a few ulp of half a pixel, where the two differ, the port's pixels
    equal those the JAX render hands its scene kernel (jax_capture)."""
    rng = np.random.default_rng(40)
    f32 = np.float32
    st = random_states(banks[0], 30)
    st = jax.tree.map(lambda a: np.resize(a, (16384,) + a.shape[1:]), st)
    cam = np.stack([np.round(st.pos[:, 0] * f32(4)),
                    np.round((st.pos[:, 1] - f32(0.5)) * f32(4))],
                   -1).astype(f32) * f32(0.25)
    coin = _near_half(cam, rng, 4.8, 28.0)
    split = _split_roundings(coin - cam, 4.8, 28.0).any(1)
    pick = np.flatnonzero(split)[:64]
    assert pick.size == 64
    st = jax.tree.map(lambda a: a[pick], st)
    st = st.replace(level=st.level.replace(coin_pos=coin[pick]))
    want = render_inputs(jcoin, jcoin.Config(), jax.tree.map(
        jnp.asarray, st.replace(rng=jax.random.wrap_key_data(st.rng))))
    got = tcoin._scene_inputs(tcoin.Config(), convert.state(tcoin, st, "cpu"))
    for w, g in zip(want["groups"], got[12]):
        for a, b in zip(w, g[1:]):
            same(a, b)


# ---------------------------------------------------------------------------
# The exact renders (tests/render_parity.py): observe at 64 and 128 px,
# Environment.render, the selectors against the JAX render's `_onehot`
# arguments, the scene_phases=0 render on the TPU's stamp path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [64, 128])
def test_observe_matches_jax(size):
    st = RP.check_observe("coinrun", size=size)
    assert st.game.level.mob_alive.any() and st.game.level.saw_alive.any()


def test_observe_selectors_match_the_jax_render():
    RP.check_selectors("coinrun")


@pytest.mark.parametrize("env_index", [0, 1])
def test_render_matches_jax(env_index):
    RP.check_render("coinrun", env_index=env_index)


def test_observe_exact_matches_jax():
    RP.check_exact("coinrun")


def test_observe_exact_selectors_match_the_jax_render():
    RP.check_exact_selectors("coinrun")


@pytest.mark.parametrize("size", [64, 128])
def test_observe_matches_jax_near_texel_edges(size):
    """Cameras that put pixel centres within 2 ulp of texel edges, where
    XLA CPU's camera coords differ by fusion: fused (c * f32(1/4.8) +
    cam, one rounding) in the layers that compute them, cam + f32(c *
    f32(1/4.8)) in the maps the saws' and mobs' loops read. Each form
    alone fails here."""
    RP.check_near_edges("coinrun", 0.5, tcoin.PPU, size)


def test_observe_exact_matches_jax_near_texel_edges():
    RP.check_near_edges("coinrun", 0.5, tcoin.PPU, exact=True)
