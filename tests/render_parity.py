"""The port's exact renders held against the JAX package's, bitwise: each
game's single-env `observe` at any size, the batched `scene_phases=0`
render (`observe_batch` with the TPU's stamp semantics: the JAX stamp
kernel in interpret mode), `Environment.render`, and the selector
indices of the renders against those the JAX render hands `_onehot`.

The states come from a short random rollout of the JAX package's
Environment (`rollout`), carried across with `utils.convert`. The JAX
`observe` is jitted on one env, as `Environment.render` runs it, under
`compositor.resolution(size)`."""
import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax_reference as JR
from jax_capture import onehot_inputs
from jax_reference import np_tree
from procgen2_tpu.render import compositor as jC
from procgen2_tpu_torch import make
from procgen2_tpu_torch.render import compositor as tC
from procgen2_tpu_torch.utils import convert

FIRE = 9  # the fire action of caveflyer and bossfight


def games(name):
    return (importlib.import_module(f"procgen2_tpu.games.{name}"),
            importlib.import_module(f"procgen2_tpu_torch.games.{name}"))


@functools.lru_cache(maxsize=None)
def rollout(name, kw=(), n=8, steps=24, fire=0.0, seed=3):
    """(JAX EnvState, its numpy tree) after `steps` random actions of n
    envs on an 8-level bank; a share `fire` of the actions fires. The
    reset's frames are not kept: they render on the JAX CPU path."""
    env = JR.env(name, kw)
    bank = env.generate_bank(jax.random.key(seed), num_levels=8)
    state, _ = env.reset(bank, jax.random.key(seed + 1), num_envs=n)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        a = np.where(rng.random(n) < fire, FIRE, rng.integers(0, 15, n))
        state, _ = env.step(bank, state, jnp.asarray(a, jnp.int32),
                            render=False)
    return state, np_tree(state)


def port_state(name, np_state):
    return convert.state(games(name)[1], np_state.game, "cpu")


def check_observe(name, kw=(), size=64, **roll):
    """The port's observe of a rolled-out batch equals the JAX package's,
    bit for bit. Returns the numpy state for coverage checks."""
    jst, nst = rollout(name, kw, **roll)
    _, tg = games(name)
    want = JR.observe_each(name, kw, jst.game, size)
    got = tg.observe(tg.Config(**dict(kw)), port_state(name, nst), size)
    assert got.dtype == torch.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(want, got.numpy())
    return nst


@functools.lru_cache(maxsize=None)
def exact_frames(name, kw, **roll):
    """The JAX package's `observe_batch` of `rollout(name, kw, **roll)` on
    its TPU stamp path: computed once per process for every test that
    holds the port's exact render against it."""
    jst, _ = rollout(name, kw, **roll)
    return np.asarray(JR.observe_batch(name, kw)(jst.game))


def check_exact(name, kw=(), **roll):
    """The port's `scene_phases=0` render equals the JAX package's on its
    TPU stamp path, bit for bit."""
    kw = tuple(sorted(dict(kw, scene_phases=0).items()))
    jst, nst = rollout(name, kw, **roll)
    jg, tg = games(name)
    want = exact_frames(name, kw, **roll)
    got = tg.observe_batch(tg.Config(**dict(kw)), port_state(name, nst))
    assert got.dtype == torch.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(want, got.numpy())
    return nst


def check_render(name, kw=(), env_index=0, size=128, **roll):
    """`Environment.render` of the port equals the JAX package's, for
    both obs formats."""
    jst, nst = rollout(name, kw, **roll)
    want = np.asarray(JR.env(name, kw).render(jst, size, env_index))
    for fmt in ("hwc", "chw"):
        env = make(name, device="cpu", obs_format=fmt, **dict(kw))
        got = env.render(convert.env_state(env.game, nst, "cpu"), size,
                         env_index)
        assert got.dtype == torch.uint8 and got.shape == (size, size, 3)
        np.testing.assert_array_equal(want, got.numpy())


def port_selectors(fn, *args):
    """[(idx, ok) or ("tiles", (ty, tx, v, u))] of the selectors the
    port's render `fn(*args)` takes, in call order: each background's
    texel columns and rows, each axis-aligned sprite's (`rect_texels`,
    also of a sprite the port skips as dead in every env, but not those of
    `draw_sprites`, whose JAX counterparts run in a loop), each tile
    layer's selectors."""
    out, depth = [], [0]
    rect, tex, tiles, sprites = (tC.rect_texels, tC.texel_index,
                                 tC.tile_selectors, tC.draw_sprites)

    def nested(f, record=None):
        def g(*a, **k):
            depth[0] += 1
            try:
                r = f(*a, **k)
            finally:
                depth[0] -= 1
            if record and depth[0] == 0:
                record(r)
            return r
        return g

    def tex_rec(x, n):
        r = tex(x, n)
        if depth[0] == 0:
            out.append(r)
        return r
    sprite = tC.draw_sprite

    def drawing(img, atlas, sid, x, y, w, h, wx, wy, flip_x=False,
                alive=True, rotation=None, **kw):
        # the port skips a sprite dead in every env; the JAX render still
        # samples its rect
        if (rotation is None and isinstance(alive, torch.Tensor)
                and not bool(alive.any())):
            tC.rect_texels(x, y, w, h, wx, wy, flip_x)
        return sprite(img, atlas, sid, x, y, w, h, wx, wy, flip_x, alive,
                      rotation, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tC, "draw_sprite", drawing)
        mp.setattr(tC, "rect_texels", nested(rect, lambda r: out.extend(
            [(r[0], r[1]), (r[2], r[3])])))
        mp.setattr(tC, "texel_index", tex_rec)
        mp.setattr(tC, "tile_selectors", nested(tiles, lambda r: out.append(
            ("tiles", r[:4]))))
        mp.setattr(tC, "draw_sprites", nested(sprites))
        fn(*args)
    return out


def same_selectors(jax_calls, port, env):
    """The JAX render's `_onehot` calls (one env's) hold the port's
    selectors of row `env`: every masked selector in order, and each
    tile layer's four (tx, ty, u, v) in order. Returns how many were
    compared."""
    masked = [(i, v) for i, _, v in jax_calls if v is not None]
    plain = [(i, n) for i, n, v in jax_calls if v is None]
    pm = [p for p in port if p[0] != "tiles"]
    assert len(masked) == len(pm)
    for (i, v), (pi, pok) in zip(masked, pm):
        np.testing.assert_array_equal(i, pi[env].numpy())
        np.testing.assert_array_equal(v, pok[env].numpy())
    k = 0
    for p in port:
        if p[0] != "tiles":
            continue
        ty, tx, v, u = (t[env].numpy() for t in p[1])
        while not (np.array_equal(plain[k][0], tx)
                   and np.array_equal(plain[k + 1][0], ty)):
            k += 1  # the atlas and background selections in between
        assert np.array_equal(plain[k + 2][0], u)
        assert np.array_equal(plain[k + 3][0], v)
        k += 4
    return len(masked) + 4 * sum(p[0] == "tiles" for p in port)


def check_selectors(name, kw=(), size=64, envs=(0, 1), **roll):
    """The single-env observe's selectors, port against the JAX render's
    `_onehot` arguments, for the given envs of a rollout."""
    jst, nst = rollout(name, kw, **roll)
    jg, tg = games(name)
    cfg = jg.Config(**dict(kw))
    port = port_selectors(tg.observe, tg.Config(**dict(kw)),
                          port_state(name, nst), size)
    n = 0
    for e in envs:
        with jC.resolution(size):
            calls = onehot_inputs(functools.partial(jg.observe, cfg),
                                  jax.tree.map(lambda x: x[e], jst.game))
        n += same_selectors(calls, port, e)
    assert n > 0


def check_exact_selectors(name, kw=(), **roll):
    """The `scene_phases=0` render's selectors (its background's and its
    tile field's), port against the JAX render's `_onehot` arguments."""
    kw = tuple(sorted(dict(kw, scene_phases=0).items()))
    jst, nst = rollout(name, kw, **roll)
    jg, tg = games(name)
    port = port_selectors(tg.observe_batch, tg.Config(**dict(kw)),
                          port_state(name, nst))
    with JR.tpu_kernels():
        calls = onehot_inputs(functools.partial(
            jg.observe_batch, jg.Config(**dict(kw))), jst.game)
    n = jax.tree.leaves(jst.game)[0].shape[0]
    for e in range(n):
        one = [(i[e], k, None if v is None else v[e]) for i, k, v in calls
               if i.ndim == 2]
        assert same_selectors(one, port, e) > 0


def near_edges(name, kw, camdy, ppu, size=64, reps=24, seed=0):
    """States of a rollout whose camera puts a random column's and row's
    pixel centre within 2 ulp of a texel edge (of 32, 16, 8 or 1 per
    unit, in turn): the camera (x, y - camdy) at edge - c / ppu for a
    pixel offset c, where the JAX render's fused or unfused camera coords
    (XLA decides per fusion) land on either side. Yields (JAX game state,
    numpy game state), `reps` batches."""
    jst, nst = rollout(name, kw)
    rng = np.random.default_rng(seed)
    n = nst.game.pos.shape[0]
    r = np.float64(np.float32(1) / np.float32(ppu))
    c = np.arange(size) + 0.5 - size / 2
    for rep in range(reps):
        den = (32, 1, 16, 8)[rep % 4]
        at = rng.integers(0, size, (n, 2))
        x0 = nst.game.pos - [0, camdy] + rng.uniform(-2, 2, (n, 2))
        cam = (np.round(x0 * den) / den - c[at] * r).astype(np.float32)
        cam += rng.integers(-2, 3, cam.shape) * np.spacing(cam)
        pos = (cam + np.float32([0, camdy])).astype(np.float32)
        yield (dataclasses.replace(jst.game, pos=jnp.asarray(pos)),
               dataclasses.replace(nst.game, pos=pos))


def check_near_edges(name, camdy, ppu, size=64, exact=False, reps=24):
    """The port's observe (or, `exact`, its scene_phases=0 render) equal
    to the JAX package's on `near_edges` states, every batch."""
    kw = (("scene_phases", 0),) if exact else ()
    _, tg = games(name)
    for jgame, game in near_edges(name, kw, camdy, ppu, size, reps):
        st = convert.state(tg, game, "cpu")
        if exact:
            want = np.asarray(JR.observe_batch(name, kw)(jgame))
            got = tg.observe_batch(tg.Config(**dict(kw)), st)
        else:
            want = JR.observe_each(name, kw, jgame, size)
            got = tg.observe(tg.Config(), st, size)
        np.testing.assert_array_equal(want, got.numpy())
