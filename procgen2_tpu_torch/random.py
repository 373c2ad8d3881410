"""Threefry-2x32 keys in torch, word for word the `jax.random` stream.

The JAX package draws every level, reset and auto-reset from
`jax.random` with `jax_threefry_partitionable` on (the default from jax
0.5). This module reproduces that variant, so a trajectory of the port
can be held against the JAX package given the same key:

* `key(seed)`          -> [0, seed]              (prng.threefry_seed)
* `split(k, n)[j]`     -> threefry(k, (0, j))    (prng._threefry_split_foldlike);
                          `split_chain` walks a loop's chain of splits
* `fold_in(k, d)`      -> threefry(k, (0, d))    (prng._threefry_fold_in)
* random bits[j]       -> o1 ^ o2 of threefry(k, (0, j))
                          (prng._threefry_random_bits_partitionable)
* `randint`            -> jax.random._randint's two-word span/multiplier trick
                          (`randint_bits` draws the two words, and
                          `randint_from_bits` reduces them)
* `permutation`        -> jax.random._shuffle: a stable sort on random bits
* `uniform`            -> jax.random._uniform's mantissa bit trick, with
                          `floats * (hi - lo) + lo` rounded once, as
                          XLA CPU's fused multiply-add does (`_fma32`)

A key is a tensor `[..., 2]` of 32-bit words held in int64 (torch's uint32
lacks most ops, on CUDA especially); every leading dimension is a batch
dimension, so a batch of keys takes the place of `vmap`. All arithmetic
is integer, so CPU and CUDA give the same words.
"""
from __future__ import annotations

import math

import torch

_M = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _add(a, b):
    return (a + b) & _M


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M


def _threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 with 20 rounds on broadcastable int64 word tensors
    (jax/_src/prng.py `_threefry2x32_lowering`)."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = _add(x1, ks[0])
    x2 = _add(x2, ks[1])
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = _add(x1, x2)
            x2 = _rotl(x2, r) ^ x1
        x1 = _add(x1, ks[(i + 1) % 3])
        x2 = _add(_add(x2, ks[(i + 2) % 3]), i + 1)
    return x1, x2


def _hash_counts(k, shape):
    """threefry(k, (0, j)) for j = 0..prod(shape)-1, reshaped to
    k.shape[:-1] + shape (counts stay below 2**32, so the high word is 0)."""
    shape = tuple(shape)
    n = 1
    for s in shape:
        n *= s
    counts = torch.arange(n, dtype=torch.int64, device=k.device).reshape(shape)
    pad = (None,) * len(shape)
    k1 = k[..., 0][(...,) + pad]
    k2 = k[..., 1][(...,) + pad]
    return _threefry2x32(k1, k2, torch.zeros_like(counts), counts)


def _check(k):
    if k.dtype != torch.int64 or k.shape[-1:] != (2,):
        raise TypeError(f"a key is an int64 tensor [..., 2], got "
                        f"{k.dtype} {tuple(k.shape)}")


def key(seed: int, device=None) -> torch.Tensor:
    """`jax.random.key(seed)` for a 32-bit seed: words [0, seed mod 2**32]."""
    seed = int(seed)
    if not -(2 ** 31) <= seed < 2 ** 31:
        raise ValueError(f"seed must fit in int32, got {seed}")
    return torch.tensor([0, seed & _M], dtype=torch.int64, device=device)


def key_data(k: torch.Tensor) -> torch.Tensor:
    """The key's words (`jax.random.key_data`): the key itself."""
    _check(k)
    return k


def split(k: torch.Tensor, num=2) -> torch.Tensor:
    """[..., 2] -> [..., *num, 2] (`jax.random.split`, batched)."""
    _check(k)
    shape = tuple(num) if isinstance(num, (tuple, list)) else (int(num),)
    o1, o2 = _hash_counts(k, shape)
    return torch.stack([o1, o2], dim=-1)


def split_chain(k: torch.Tensor, n: int, num=2) -> torch.Tensor:
    """The keys a loop draws when it runs `k, *subs = split(k, num)` n
    times: [..., n, num - 1, 2]. The chain depends on nothing else, so a
    loop whose body only uses its keys can walk it first and draw from
    all of them at once."""
    subs = []
    for _ in range(n):
        ks = split(k, num)
        k = ks[..., 0, :]
        subs.append(ks[..., 1:, :])
    return torch.stack(subs, dim=-3)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in`; `data` (int or int tensor, taken mod 2**32)
    broadcasts against the key's batch dims."""
    _check(k)
    d = torch.as_tensor(data, dtype=torch.int64, device=k.device) & _M
    o1, o2 = _threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack([o1, o2], dim=-1)


def _bits32(k, shape):
    o1, o2 = _hash_counts(k, shape)
    return o1 ^ o2


def _batched(v, k, shape, dtype):
    """minval/maxval: a number, or a tensor of the key's batch shape
    (extended over the sample `shape`)."""
    v = torch.as_tensor(v, dtype=dtype, device=k.device)
    if v.ndim:
        v = v.reshape(tuple(v.shape) + (1,) * len(shape))
    return v


def randint_bits(k: torch.Tensor, shape=()):
    """The two 32-bit draws `jax.random.randint(k, shape, ...)` reduces:
    (higher, lower) int64 [..., *shape]. They do not depend on minval or
    maxval, so a loop whose bounds change as it runs can draw once before
    it and reduce each element with `randint_from_bits` later."""
    _check(k)
    shape = tuple(shape)
    ks = split(k)
    return _bits32(ks[..., 0, :], shape), _bits32(ks[..., 1, :], shape)


def randint_from_bits(higher, lower, minval=0, maxval=1) -> torch.Tensor:
    """`randint`'s value from its two draws (`randint_bits`): int32 in
    [minval, maxval) (minval where maxval <= minval); minval and maxval
    numbers or int tensors broadcast against the draws."""
    dev = higher.device
    lo32, hi32 = -(2 ** 31), 2 ** 31 - 1
    minval = torch.as_tensor(minval, dtype=torch.int64,
                             device=dev).clamp(lo32, hi32)
    maxval = torch.as_tensor(maxval, dtype=torch.int64,
                             device=dev).clamp(lo32, hi32)
    span = (maxval - minval) & _M
    span = torch.where(maxval <= minval, torch.ones_like(span), span)
    mult = (2 ** 16) % span
    mult = ((mult * mult) & _M) % span
    # (h % span) * mult can pass 2**63; int64 multiply wraps, and only the
    # low 32 bits are kept, as uint32 arithmetic does
    off = (((higher % span) * mult) & _M) + (lower % span)
    off = (off & _M) % span
    out = ((minval + off + 2 ** 31) & _M) - 2 ** 31  # int32 wrap-around add
    return out.to(torch.int32)


def randint(k: torch.Tensor, shape=(), minval=0, maxval=1) -> torch.Tensor:
    """`jax.random.randint(k, shape, minval, maxval)` with dtype int32:
    out[..., *shape] in [minval, maxval) (minval where maxval <= minval)."""
    shape = tuple(shape)
    higher, lower = randint_bits(k, shape)
    return randint_from_bits(higher, lower,
                             _batched(minval, k, shape, torch.int64),
                             _batched(maxval, k, shape, torch.int64))


def permutation(k: torch.Tensor, n: int) -> torch.Tensor:
    """`jax.random.permutation(k, n)`: a permutation of range(n) per key,
    int64 [..., n]. jax 0.9's `_shuffle` runs ceil(3 ln n / ln(2**32 - 1))
    rounds (one for 2 <= n < 1626, none for n = 1); each splits
    (k, sub) = split(k), draws 32 random bits of sub over (n,), and sorts
    by them ascending and stable (`lax.sort_key_val`), so equal bits keep
    their order."""
    _check(k)
    rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(_M)))
    perm = torch.arange(n, device=k.device).expand(k.shape[:-1] + (n,))
    for _ in range(rounds):
        ks = split(k)
        k = ks[..., 0, :]
        order = torch.sort(_bits32(ks[..., 1, :], (n,)), dim=-1,
                           stable=True).indices
        perm = perm.gather(-1, order)
    return perm


def _fma32(a, b, c) -> torch.Tensor:
    """f32 `a * b + c` rounded once, as XLA CPU computes it: it contracts
    a multiply feeding an add into one fused multiply-add. The product of
    two f32 values is exact in float64, so the sum is taken there and
    rounded to f32 once. Two separate torch ops, so the card computes the
    same value. a, b, c: f32 tensors or numbers (broadcast)."""
    def f64(x):
        return (x.double() if isinstance(x, torch.Tensor)
                else float(torch.tensor(x, dtype=torch.float32)))
    return (f64(a) * f64(b) + f64(c)).to(torch.float32)


def uniform(k: torch.Tensor, shape=(), minval=0.0, maxval=1.0) -> torch.Tensor:
    """`jax.random.uniform(k, shape, float32, minval, maxval)` as it runs on
    XLA CPU: `floats * (maxval - minval) + minval` is one fused multiply-add
    there (`_fma32`)."""
    _check(k)
    shape = tuple(shape)
    bits = _bits32(k, shape)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    lo = _batched(minval, k, shape, torch.float32)
    hi = _batched(maxval, k, shape, torch.float32)
    return torch.maximum(lo, _fma32(floats, hi - lo, lo))


def categorical(k: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """`jax.random.categorical(k, logits)` over the last axis, int64
    [...]: argmax(gumbel + logits), the first index on ties. `logits` is
    f32 [..., C], its leading dims the key's batch dims.

    The Gumbel noise is -log(-log(u)), u = uniform(minval=tiny, maxval=1),
    taken in float64 and rounded once to f32. XLA CPU's f32 log is its own
    polynomial, not correctly rounded, so a value may differ from JAX's
    by an ulp; the argmax moves only where the two largest values lie
    within that ulp, which held for none of 20,000 draws over half-open
    20 x 20 masks (tests/test_torch_caveflyer.py holds it to the JAX
    draw)."""
    _check(k)
    u = uniform(k, logits.shape[k.ndim - 1:],
                minval=torch.finfo(torch.float32).tiny, maxval=1.0)
    g = (-torch.log(-torch.log(u.double()))).to(torch.float32)
    return torch.argmax(g + logits, dim=-1)
