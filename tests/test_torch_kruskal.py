"""The port's maze generator (procgen2_tpu_torch/gen/kruskal.py) and
`random.permutation` against the JAX package's, given the same keys and
walls. Every comparison is exact.

* permutation for n in {1, 2, 12, 84, 200} over many keys, and its stable
  order on equal sort bits;
* randint's two draws reduced later (`randint_bits`, `randint_from_bits`)
  against randint with per-element bounds;
* kruskal_maze at jumper's maze sizes (6, 13, 15) and at chaser's and
  maze's largest sizes, with an int `dim` and with a per-level `dim` (the
  JAX side vmapped over it, as maze.py passes a traced one);
* open_dead_ends at the three jumper maze sizes, and with a per-level dim.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procgen2_tpu.gen import kruskal as jk
from procgen2_tpu_torch import random as R
from procgen2_tpu_torch.gen import kruskal as tk


def _keys(n, seed):
    ks = jax.random.split(jax.random.key(seed), n)
    return ks, torch.from_numpy(
        np.asarray(jax.random.key_data(ks)).astype(np.int64))


@pytest.mark.parametrize("n", [1, 2, 12, 84, 200])
def test_permutation_matches_jax(n):
    jks, tks = _keys(300, n)
    want = np.asarray(jax.vmap(lambda k: jax.random.permutation(k, n))(jks))
    got = R.permutation(tks, n)
    np.testing.assert_array_equal(want, got.numpy())
    assert (np.sort(want, axis=1) == np.arange(n)).all()


def test_permutation_keeps_the_order_of_equal_bits(monkeypatch):
    """With sort bits that tie often (the random bits taken mod 4), the
    port's stable sort orders the tied elements as `lax.sort_key_val`
    does in jax's `_shuffle`: by index."""
    n = 84
    jks, tks = _keys(64, 3)
    bits = R._bits32
    monkeypatch.setattr(R, "_bits32", lambda k, shape: bits(k, shape) % 4)
    got = R.permutation(tks, n).numpy()

    def shuffle(k):  # jax 0.9's _shuffle, one round, on the same tied bits
        _, sub = jax.random.split(k)
        keys = jax.random.bits(sub, (n,), jnp.uint32) % 4
        return jax.lax.sort_key_val(keys, jnp.arange(n), is_stable=True)[1]

    want = np.asarray(jax.vmap(shuffle)(jks))
    np.testing.assert_array_equal(want, got)
    assert (got != np.arange(n)).any(axis=1).all()  # every key shuffles


def test_randint_bits_reduce_to_randint():
    """randint_bits drawn once, reduced per element with bounds known only
    later, equals jax.random.randint with those bounds."""
    jks, tks = _keys(500, 11)
    hi = np.random.default_rng(0).integers(0, 5, 500).astype(np.int32)
    want = np.asarray(jax.vmap(
        lambda k, h: jax.random.randint(k, (), 0, jnp.maximum(h, 1)))(
            jks, jnp.asarray(hi)))
    higher, lower = R.randint_bits(tks)
    got = R.randint_from_bits(higher, lower, 0,
                              torch.from_numpy(hi).clamp(min=1))
    np.testing.assert_array_equal(want, got.numpy())


def _dims(max_dim, n, seed):
    """Per-level odd dims in [3, max_dim] (maze.py:99-101), both ends in."""
    d = np.random.default_rng(seed).integers(0, (max_dim - 3) // 2 + 1, n)
    d[:2] = (0, (max_dim - 3) // 2)
    return (d * 2 + 3).astype(np.int32)


# jumper's maze_dim (world_dim // 3), chaser's and maze's largest world_dim
@pytest.mark.parametrize("max_dim", [6, 13, 15, 19, 31])
def test_kruskal_maze_matches_jax(max_dim):
    jks, tks = _keys(64, max_dim)
    want = np.asarray(jax.jit(jax.vmap(
        lambda k: jk.kruskal_maze(k, max_dim, max_dim)))(jks))
    got = tk.kruskal_maze(tks, max_dim, max_dim)
    assert got.dtype == torch.bool and got.shape == (64, max_dim, max_dim)
    np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("max_dim", [15, 31])
def test_kruskal_maze_per_level_dim_matches_jax(max_dim):
    """A traced dim per level, as maze.py:104 passes it: walls outside
    each level's dim x dim region stay."""
    jks, tks = _keys(64, 100 + max_dim)
    dims = _dims(max_dim, 64, max_dim)
    want = np.asarray(jax.jit(jax.vmap(
        lambda k, d: jk.kruskal_maze(k, d, max_dim)))(jks, jnp.asarray(dims)))
    got = tk.kruskal_maze(tks, torch.from_numpy(dims), max_dim).numpy()
    np.testing.assert_array_equal(want, got)
    i = np.arange(max_dim)
    outside = (i[None, :, None] >= dims[:, None, None]) | (
        i[None, None, :] >= dims[:, None, None])
    assert got[outside].all()


@pytest.mark.parametrize("dim", [6, 13, 15])
def test_open_dead_ends_matches_jax(dim):
    """On Kruskal mazes of jumper's three maze sizes (easy, hard, memory),
    with keys of their own: the openings equal the JAX scan's, and there
    are some."""
    jks, tks = _keys(64, dim)
    wall = np.asarray(jax.jit(jax.vmap(
        lambda k: jk.kruskal_maze(k, dim, dim)))(jks))
    jks2, tks2 = _keys(64, 1000 + dim)
    want = np.asarray(jax.jit(jax.vmap(
        lambda k, w: jk.open_dead_ends(k, w, dim)))(jks2, jnp.asarray(wall)))
    got = tk.open_dead_ends(tks2, torch.from_numpy(wall.copy()), dim).numpy()
    np.testing.assert_array_equal(want, got)
    assert (want != wall).sum() > 64


def test_open_dead_ends_per_level_dim_matches_jax():
    max_dim = 15
    jks, tks = _keys(32, 5)
    dims = _dims(max_dim, 32, 6)
    wall = np.asarray(jax.jit(jax.vmap(
        lambda k, d: jk.kruskal_maze(k, d, max_dim)))(jks, jnp.asarray(dims)))
    want = np.asarray(jax.jit(jax.vmap(jk.open_dead_ends))(
        jks, jnp.asarray(wall), jnp.asarray(dims)))
    got = tk.open_dead_ends(tks, torch.from_numpy(wall.copy()),
                            torch.from_numpy(dims)).numpy()
    np.testing.assert_array_equal(want, got)
    assert (want != wall).any()
