"""The JAX package's programs that the port's CPU tests hold the port
against, built once per test process and shared by every test file that
runs in it.

A jitted JAX function is traced, lowered and compiled once per function
object and shape. The persistent compilation cache (tests/conftest.py)
spares a later process the XLA compile of a program it has seen, but
only for the same program at the same shapes, and never the tracing. So
the port's tests take the JAX reference from here:

* `env(game, kw, tpu)`: one JAX Environment per game, config and render
  path;
* `vmapped(game, fn, kw)`: the game module's `generate` or `step`,
  vmapped and jitted;
* `observe_batch(game, kw, tpu)`, `observe(game, kw, size)`: the game's
  batched render on either path and its single-env render at a size;
* `bank(game, kw, seed, n)`: a bank of `Environment.generate_bank`.

Every function of one render path runs under that path (`render_path`),
so that its trace, made at its first call, is that path's whatever a
test has patched around it. The TPU path is the JAX render's kernels,
`scene_tpu_raw` and `composite_tpu`, in interpret mode
(`tpu_kernels`): what B1 and B3 replace.

The suite's shape is 8 envs on banks of 8 levels; a test keeps another
size only where the size is what it checks. Nothing here is stored on
disk: each comparison runs the JAX package in the same session, on the
same inputs."""
import contextlib
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import procgen2_tpu as pg
from procgen2_tpu.render import compositor as jC
from procgen2_tpu.render import scene_kernel as jsk
from procgen2_tpu.render import stamp_kernel as jstk


def game_module(name):
    return importlib.import_module(f"procgen2_tpu.games.{name}")


def config(name, kw=()):
    return game_module(name).Config(**dict(kw))


def np_tree(tree):
    """The tree's leaves as numpy arrays (PRNG keys as their key data)."""
    return jax.tree.map(
        lambda a: (np.asarray(jax.random.key_data(a))
                   if jnp.issubdtype(a.dtype, jax.dtypes.prng_key)
                   else np.asarray(a)), tree)


@contextlib.contextmanager
def tpu_kernels():
    """The JAX render on its TPU path: its scene kernel (`scene_tpu_raw`)
    and stamp kernel (`composite_tpu`) wherever the render takes them on
    a TPU, run in interpret mode."""
    raw, composite = jsk.scene_tpu_raw, jstk.composite_tpu
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jC, "_use_stamp_kernel", lambda: True)
        mp.setattr(jsk, "scene_tpu_raw",
                   lambda *a, **k: raw(*a, **{**k, "interpret": True}))
        mp.setattr(jstk, "composite_tpu",
                   lambda *a, **k: composite(*a, **{**k, "interpret": True}))
        yield


@contextlib.contextmanager
def cpu_render():
    """The JAX render on its CPU path (stamps summed by matmul), whatever a
    test has patched around it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jC, "_use_stamp_kernel", lambda: False)
        yield


def render_path(tpu):
    return tpu_kernels() if tpu else cpu_render()


class _OnPath:
    """A function that always runs, and so traces, on one render path."""

    def __init__(self, fn, tpu):
        self.fn, self.tpu = fn, tpu

    def __call__(self, *args, **kw):
        with render_path(self.tpu):
            return self.fn(*args, **kw)


class Env:
    """A JAX Environment whose every call runs on one render path. Its
    `generate_bank`, which renders nothing, is the CPU path's, so both
    paths share one trace of the level generator."""

    def __init__(self, game, cfg, tpu):
        self.env = pg.Environment(game_module(game), cfg)
        self.game, self.cfg = self.env.game, self.env.cfg
        for name in ("reset", "reset_pinned", "step", "step_raw", "render"):
            setattr(self, name, _OnPath(getattr(self.env, name), tpu))
        self.generate_bank = (_env(game, cfg, False).generate_bank if tpu
                              else _OnPath(self.env.generate_bank, False))


@functools.lru_cache(maxsize=None)
def _env(game, cfg, tpu):
    return Env(game, cfg, tpu)


def env(game, kw=(), tpu=False):
    """The JAX Environment of `game` at config `kw` (a tuple of items),
    every call on the TPU render path (`tpu`) or the CPU one. One per
    Config: kw that spell the same Config share it."""
    return _env(game, config(game, kw), tpu)


@functools.lru_cache(maxsize=None)
def bank(game, kw=(), seed=7, n=8):
    """`Environment.generate_bank(key(seed), n)` of the JAX package."""
    return env(game, kw).generate_bank(jax.random.key(seed), num_levels=n)


@functools.lru_cache(maxsize=None)
def _vmapped(game, fn, cfg):
    return jax.jit(jax.vmap(functools.partial(getattr(game_module(game), fn),
                                              cfg)))


def vmapped(game, fn, kw=()):
    """jit(vmap(game.<fn>(Config(**kw), ...))): `generate` or `step` of
    the game module over a batch."""
    return _vmapped(game, fn, config(game, kw))


@functools.lru_cache(maxsize=None)
def _observe_batch(game, cfg, tpu):
    return _OnPath(jax.jit(functools.partial(game_module(game).observe_batch,
                                             cfg)), tpu)


def observe_batch(game, kw=(), tpu=True):
    """The game's `observe_batch`, jitted, on the TPU render path (`tpu`)
    or the CPU one."""
    return _observe_batch(game, config(game, kw), tpu)


@functools.lru_cache(maxsize=None)
def _observe(game, cfg, size):
    return jax.jit(functools.partial(game_module(game).observe, cfg))


def observe(game, kw=(), size=64):
    """The game's single-env `observe` at `size` px, jitted, as
    `Environment.render` runs it (under `compositor.resolution(size)`)."""
    f = _observe(game, config(game, kw), size)

    def run(state):
        with jC.resolution(size), cpu_render():
            return f(state)
    return run


def observe_each(game, kw, state, size=64):
    """uint8 [N, size, size, 3]: the single-env observe of every env of
    the batched game state, one env at a time. The envs' rows are cut on
    the host (PRNG keys on the device): the same arguments to the jitted
    observe, without an eager JAX op per leaf and env."""
    f = observe(game, kw, size)
    host = jax.tree.map(
        lambda a: (a if jnp.issubdtype(a.dtype, jax.dtypes.prng_key)
                   else np.asarray(a)), state)
    n = jax.tree.leaves(host)[0].shape[0]
    return np.stack([np.asarray(f(jax.tree.map(lambda x: x[i], host)))
                     for i in range(n)])
