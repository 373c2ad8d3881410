"""The port's threefry keys (procgen2_tpu_torch/random.py) against
jax.random (threefry2x32, jax_threefry_partitionable on): key words,
split, fold_in, randint and uniform must be identical."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procgen2_tpu_torch import random as R
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def words(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def test_jax_runs_partitionable_threefry():
    # the variant the port mirrors
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 1, 42, -1, 2 ** 31 - 1, -(2 ** 31)])
def test_key_words(seed):
    np.testing.assert_array_equal(words(jax.random.key(seed)),
                                  R.key(seed).numpy())


@pytest.mark.parametrize("num", [2, 3, 17, (3, 4)])
def test_split(num):
    k = jax.random.key(42)
    np.testing.assert_array_equal(words(jax.random.split(k, num)),
                                  R.split(R.key(42), num).numpy())


def test_split_batched_keys():
    ks = jax.random.split(jax.random.key(3), 5)
    want = words(jax.vmap(lambda k: jax.random.split(k, 3))(ks))
    np.testing.assert_array_equal(
        want, R.split(torch.from_numpy(words(ks)), 3).numpy())


@pytest.mark.parametrize("data", [0, 5, 2 ** 31 + 3, 2 ** 32 - 1])
def test_fold_in(data):
    k = jax.random.key(9)
    np.testing.assert_array_equal(
        words(jax.random.fold_in(k, np.uint32(data))),
        R.fold_in(R.key(9), data).numpy())


def test_fold_in_vector_like_generate_bank():
    ids = np.arange(300, dtype=np.uint32) + np.uint32(1000)
    want = words(jax.vmap(lambda i: jax.random.fold_in(jax.random.key(0), i))(
        jnp.asarray(ids)))
    got = R.fold_in(R.key(0), torch.from_numpy(ids.astype(np.int64)))
    np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("lo,hi", [
    (0, 3), (1, 4), (0, 1024), (5, 5), (9, 2), (-7, 9), (3, 70000),
    (0, 2 ** 31 - 1), (-(2 ** 31), 2 ** 31 - 1),
])
def test_randint(lo, hi):
    k = jax.random.key(11)
    ks = jax.random.split(k, 256)
    want = np.asarray(jax.vmap(lambda kk: jax.random.randint(kk, (), lo, hi))(ks))
    got = R.randint(torch.from_numpy(words(ks)), (), lo, hi)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(want, got.numpy())
    np.testing.assert_array_equal(np.asarray(jax.random.randint(k, (5, 3), lo, hi)),
                                  R.randint(R.key(11), (5, 3), lo, hi).numpy())


def test_randint_per_key_bounds():
    """Bounds that differ per key, as coinrun.generate draws them."""
    ks = jax.random.split(jax.random.key(5), 64)
    lo = np.arange(64, dtype=np.int32) % 5
    hi = lo + np.arange(64, dtype=np.int32) % 7
    want = np.asarray(jax.vmap(
        lambda kk, a, b: jax.random.randint(kk, (), a, b))(ks, lo, hi))
    got = R.randint(torch.from_numpy(words(ks)), (), torch.from_numpy(lo),
                    torch.from_numpy(hi))
    np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("shape", [(), (7, 9)])
def test_uniform(shape):
    ks = jax.random.split(jax.random.key(13), 128)
    want = np.asarray(jax.vmap(lambda kk: jax.random.uniform(kk, shape))(ks))
    got = R.uniform(torch.from_numpy(words(ks)), shape)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(want.view(np.int32), got.numpy().view(np.int32))


@pytest.mark.parametrize("lo,hi", [(0.7, 1.2), (-1.0, 1.0), (-0.5, 0.5),
                                   (180.0, 260.0), (0.3, 2.9)])
def test_uniform_general_range(lo, hi):
    """Ranges whose width is not a power of two: XLA CPU computes
    `floats * (hi - lo) + lo` as one fused multiply-add (bossfight's
    barrier rows draw (0.7, 1.2)). Bitwise, over 4096 keys."""
    ks = jax.random.split(jax.random.key(21), 4096)
    want = np.asarray(jax.jit(jax.vmap(
        lambda kk: jax.random.uniform(kk, (), minval=lo, maxval=hi)))(ks))
    got = R.uniform(torch.from_numpy(words(ks)), (), lo, hi)
    np.testing.assert_array_equal(want.view(np.int32), got.numpy().view(np.int32))
    want = np.asarray(jax.random.uniform(ks[0], (7, 9), minval=lo, maxval=hi))
    got = R.uniform(torch.from_numpy(words(ks[0])), (7, 9), lo, hi)
    np.testing.assert_array_equal(want.view(np.int32), got.numpy().view(np.int32))


def test_uniform_per_key_range():
    """Ranges that differ per key, bitwise."""
    ks = jax.random.split(jax.random.key(22), 512)
    rng = np.random.default_rng(0)
    lo = rng.uniform(-3, 3, 512).astype(np.float32)
    hi = lo + rng.uniform(0.1, 5, 512).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(
        lambda kk, a, b: jax.random.uniform(kk, (3,), minval=a, maxval=b)))(
            ks, lo, hi))
    got = R.uniform(torch.from_numpy(words(ks)), (3,), torch.from_numpy(lo),
                    torch.from_numpy(hi))
    np.testing.assert_array_equal(want.view(np.int32), got.numpy().view(np.int32))


def test_fma32_rounds_once():
    """_fma32 is a * b + c rounded once to f32, where two f32 ops round
    twice: 1 + 2**-12 squared minus 1 keeps its 2**-24 term."""
    a = torch.tensor([1.0 + 2.0 ** -12], dtype=torch.float32)
    assert float(R._fma32(a, a, -1.0)) == 2.0 ** -11 + 2.0 ** -24
    assert float(a * a - 1.0) == 2.0 ** -11


def test_bad_keys_and_seeds_raise():
    with pytest.raises(TypeError):
        R.split(torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        R.key(2 ** 31)



@pytest.mark.parametrize("num", [2, 3])
def test_split_chain(num):
    """The keys of a loop running `key, *subs = split(key, num)`, walked
    before it, equal the loop's, per level of a batch of keys."""
    ks = jax.random.split(jax.random.key(4), 5)

    def chain(k):
        subs = []
        for _ in range(7):
            k, *sub = jax.random.split(k, num)
            subs.append(jnp.stack([jax.random.key_data(s) for s in sub]))
        return jnp.stack(subs)

    want = np.asarray(jax.vmap(chain)(ks)).astype(np.int64)
    got = R.split_chain(torch.from_numpy(words(ks)), 7, num)
    np.testing.assert_array_equal(want, got.numpy())
