"""The port's cos32/sin32 and atan2f (procgen2_tpu_torch/trig.py) against
XLA CPU's f32 `jnp.cos`/`jnp.sin` and `jnp.arctan2`. cos and sin bitwise (f32 compared as int32 views, nan as
nan), on over 10**6 angles: uniform over several ranges up to |x| = 10**4,
tiny values around 2**-12, values around glibc's thresholds 0.75 (its
pi/4 test on the top 12 bits) and 120 (the large-argument reduction),
values near multiples of pi/2 (where the reduction cancels), huge and
special values.

glibc's x86-64 build fuses the polynomial's multiply-adds; trig.py does
not (it reproduces only the reduction's). `test_unfused_polynomial_
rounds_as_the_fused_one` holds the two equal after the rounding to f32,
with the fused steps emulated exactly. Run as a script,

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_trig.py LO HI

it compares the port's cos32 and sin32 on every f32 x with LO <= |x| <
HI with the fused polynomial's and with XLA's, and prints the inputs
where they differ.

atan2f is held to jax.jit(jnp.arctan2) with a tolerance of 0 ulp (the
same bits; NaN as NaN) on over 10**6 f32 pairs: random signs and
exponents over the whole f32 range (subnormals too, which XLA's CPU
flags read and write as zeros), the axes, signed zeros, infinities and
NaN, ratios |y/x| within a few ulp of atanf's branch points (2**-29,
2**-26, 7/16, 11/16, 19/16, 39/16, 2**25) and of atan2f's (2**60), and
x == 1; and on vectors within a few ulp of each of jumper's compass-needle
bin boundaries, angle = (k + 0.5) * 2 pi / 64."""
import ctypes
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procgen2_tpu_torch import trig


def _around(v, n, rng):
    """n f32 values within 64 ulp of v."""
    v = np.float32(v)
    return v + rng.integers(-64, 65, n).astype(np.float32) * np.spacing(v)


def _angles():
    rng = np.random.default_rng(0)
    parts = [
        rng.uniform(-7, 7, 400_000),
        rng.uniform(-130, 130, 300_000),
        rng.uniform(-1e4, 1e4, 200_000),
        np.exp(rng.uniform(-20, 15, 50_000)) * rng.choice([-1, 1], 50_000),
        (rng.integers(-6000, 6000, 50_000) * (np.pi / 2)
         + rng.uniform(-1e-3, 1e-3, 50_000)),
    ]
    parts = [p.astype(np.float32) for p in parts]
    for v in (2.0 ** -12, 2.0 ** -126, 0.75, np.pi / 4, 120.0, np.pi / 2,
              np.pi, 1e4):
        parts += [_around(v, 2000, rng), -_around(v, 2000, rng)]
    parts.append(np.float32([0.0, -0.0, 1e-45, 3.4e38, -3.4e38, np.inf,
                             -np.inf, np.nan]))
    return np.concatenate(parts)


@pytest.fixture(scope="module")
def angles():
    x = _angles()
    want = jax.jit(lambda a: (jnp.cos(a), jnp.sin(a)))(jnp.asarray(x))
    return x, [np.asarray(w) for w in want]


def _same(want, got):
    bits = want.view(np.int32) == got.view(np.int32)
    return bits | (np.isnan(want) & np.isnan(got))


def test_angles_cover_both_reductions(angles):
    x, _ = angles
    ax = np.abs(x[np.isfinite(x)])
    assert x.size >= 10 ** 6
    assert (ax < 2.0 ** -12).any() and (ax >= 1e4).any()
    assert ((ax >= 0.75) & (ax < 120)).sum() > 10 ** 5
    assert (ax >= 120).sum() > 10 ** 5


@pytest.mark.parametrize("name", ["cos", "sin"])
def test_matches_xla(angles, name):
    x, (want_cos, want_sin) = angles
    t = torch.from_numpy(x)
    got = (trig.cos32 if name == "cos" else trig.sin32)(t).numpy()
    want = want_cos if name == "cos" else want_sin
    ok = _same(want, got)
    assert ok.all(), (x[~ok][:8], want[~ok][:8], got[~ok][:8])


def test_sincos_equals_cos_and_sin(angles):
    x, (want_cos, want_sin) = angles
    c, s = trig.sincos32(torch.from_numpy(x[:200_000]).reshape(400, 500))
    assert _same(want_cos[:200_000], c.reshape(-1).numpy()).all()
    assert _same(want_sin[:200_000], s.reshape(-1).numpy()).all()


def test_float64_rounded_once_is_not_enough(angles):
    """Why glibc's algorithm is transcribed: cos and sin in float64 rounded
    to f32, and torch's own f32 cos/sin, differ from XLA's in many angles,
    most of all near multiples of pi/2, where glibc's fused reduction is
    exact."""
    x, (want_cos, _) = angles
    t = torch.from_numpy(x[:400_000])
    f64 = torch.cos(t.double()).float().numpy()
    f32 = torch.cos(t).numpy()
    assert (~_same(want_cos[:400_000], f64)).sum() > 1000
    assert (~_same(want_cos[:400_000], f32)).sum() > 1000


def _split(a):
    t = 134217729.0 * a  # 2**27 + 1: Veltkamp's split into 26 + 27 bits
    hi = t - (t - a)
    return hi, a - hi


def _two_prod(a, b):
    """(p, e), p = a * b rounded, e its exact error (Dekker)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _two_sum(a, b):
    """(s, e), s = a + b rounded, e its exact error (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _fma(a, b, c):
    """a * b + c rounded once, in float64 ops: Boldo and Melquiond's
    emulation, the sum of the two error terms rounded to odd."""
    a, b, c = torch.broadcast_tensors(
        *(torch.as_tensor(v, dtype=torch.float64) for v in (a, b, c)))
    p, e = _two_prod(a, b)
    s, t = _two_sum(c, p)
    u, v = _two_sum(t, e)
    even = (u.view(torch.int64) & 1) == 0
    toward = torch.where(v > 0, float("inf"), float("-inf")).double()
    u = torch.where((v != 0) & even, torch.nextafter(u, toward), u)
    return s + u


def _poly_fused(x, x2, sign, table1, odd):
    """trig._poly with glibc's contracted multiply-adds fused."""
    S, C = trig._S, trig._C
    x = x * sign
    x3 = x * x2
    s1 = _fma(x2, S[2], S[1])
    x7 = x3 * x2
    sin = _fma(x7, s1, _fma(x3, S[0], x))
    neg = torch.where(table1, -1.0, 1.0).double()
    x4 = x2 * x2
    c2 = _fma(x2, C[4] * neg, C[3] * neg)
    c1 = _fma(x2, C[1] * neg, C[0] * neg)
    cos = _fma(x4 * x2, c2, _fma(x4, C[2] * neg, c1))
    return torch.where(odd, cos, sin)


def _fused_differs(x):
    """Indices of the f32 tensor x where cos32 or sin32 with the fused
    polynomial differ from the port's, how often the float64 polynomial
    values differ, and the port's results as int32 views (each a pair:
    cos, sin)."""
    unfused = trig._poly
    out, rates, gots = [], [], []
    for want_cos in (True, False):
        vals = []

        def run(poly):
            def record(*a):
                vals.append(poly(*a))
                return vals[-1]
            trig._poly = record
            try:
                return trig._sincos(x, want_cos).view(torch.int32)
            finally:
                trig._poly = unfused
        got, fused = run(unfused), run(_poly_fused)
        out.append((got != fused).nonzero().flatten())
        rates.append((vals[0] != vals[1]).double().mean().item())
        gots.append(got)
    return out, rates, gots


def test_fma_emulation_is_exact():
    """_fma against exact rational arithmetic on products whose rounding
    matters (float64 a * b + c with c near -a * b)."""
    from fractions import Fraction
    rng = np.random.default_rng(1)
    a = rng.uniform(-2, 2, 2000)
    b = rng.uniform(-2, 2, 2000)
    c = -(a * b) * (1 + rng.uniform(-1e-15, 1e-15, 2000))
    got = _fma(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c))
    want = [float(Fraction(x) * Fraction(y) + Fraction(z))
            for x, y, z in zip(a, b, c)]
    assert got.tolist() == want
    assert (got.numpy() != a * b + c).sum() > 100


def test_unfused_polynomial_rounds_as_the_fused_one(angles):
    """On the test angles the float64 polynomial values with and without
    the fused multiply-adds differ in some per cent of the evaluations,
    yet never in their f32 rounding."""
    x = angles[0][::4]
    (d_cos, d_sin), (r_cos, r_sin), _ = _fused_differs(torch.from_numpy(x))
    assert d_cos.numel() == 0 and d_sin.numel() == 0
    assert r_cos > 0.01 and r_sin > 0.005


def test_rejects_other_dtypes():
    with pytest.raises(TypeError):
        trig.cos32(torch.zeros(3, dtype=torch.float64))


def _atan2_pairs():
    """(y, x) f32 pairs, over 10**6 of them."""
    rng = np.random.default_rng(2)

    def spread(n):  # every exponent, subnormals included, either sign
        e = rng.integers(-150, 128, n)
        m = rng.uniform(1, 2, n)
        return (m * 2.0 ** e * rng.choice([-1, 1], n)).astype(np.float32)

    ys, xs = [spread(600_000)], [spread(600_000)]
    ys.append(rng.uniform(-30, 30, 300_000).astype(np.float32))
    xs.append(rng.uniform(-30, 30, 300_000).astype(np.float32))
    for r in (2.0 ** -29, 2.0 ** -26, 7 / 16, 11 / 16, 19 / 16, 39 / 16,
              2.0 ** 25, 2.0 ** 60, 2.0 ** -60):
        x = spread(20_000)
        ulp = rng.integers(-8, 9, 20_000) * 2.0 ** -23
        with np.errstate(over="ignore"):  # some overflow to +-inf
            y = (x.astype(np.float64) * r * (1 + ulp)).astype(np.float32)
        ys.append(y * rng.choice(np.float32([-1, 1]), 20_000))
        xs.append(x)
    ys.append(spread(20_000))  # x == 1: atanf(y)
    xs.append(np.ones(20_000, np.float32))
    special = np.float32([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0,
                          2.5, -2.5, 1e-45, -1e-45, 3e38, -3e38, 1e-40])
    Y, X = np.meshgrid(special, special)
    ys.append(Y.ravel())
    xs.append(X.ravel())
    return np.concatenate(ys), np.concatenate(xs)


@pytest.fixture(scope="module")
def atan2_pairs():
    y, x = _atan2_pairs()
    return y, x, np.asarray(jax.jit(jnp.arctan2)(y, x))


def test_atan2f_matches_xla(atan2_pairs):
    y, x, want = atan2_pairs
    assert y.size >= 10 ** 6
    got = trig.atan2f(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    bad = ~_same(want, got)
    assert not bad.any(), list(zip(y[bad][:10], x[bad][:10]))


def test_atan2f_is_neither_float64_nor_libm_on_subnormals(atan2_pairs):
    """Why atan2f is transcribed: float64 rounded once differs from XLA in
    many pairs; glibc's atan2f called directly differs on subnormal
    operands and results, which XLA's CPU flags flush to zero."""
    y, x, want = atan2_pairs
    f64 = np.arctan2(y.astype(np.float64), x.astype(np.float64)).astype(
        np.float32)
    assert (~_same(want, f64)).sum() > 10_000
    libm = ctypes.CDLL("libm.so.6")
    libm.atan2f.restype = ctypes.c_float
    libm.atan2f.argtypes = [ctypes.c_float, ctypes.c_float]
    pick = np.random.default_rng(3).choice(y.size, 20_000, replace=False)
    lib = np.float32([libm.atan2f(y[i], x[i]) for i in pick])
    sub = (np.abs(y[pick]) < 2.0 ** -126) | (np.abs(x[pick]) < 2.0 ** -126)
    assert _same(want[pick], lib)[~sub & (np.abs(lib) >= 2.0 ** -126)].all()
    assert (~_same(want[pick], lib)).any()


def test_atan2f_near_needle_bin_boundaries():
    """Vectors whose angle lies within a few ulp of a bin boundary of
    jumper's needle, (k + 0.5) * 2 pi / 64: atan2f and the bin
    round(angle * f32(64 / 2 pi)) mod 64 equal XLA's."""
    rng = np.random.default_rng(4)
    k = np.arange(-64, 64)
    theta = (k + 0.5) * 2 * np.pi / 64
    r = rng.uniform(0.05, 60.0, (k.size, 400))
    x = (r * np.cos(theta)[:, None]).astype(np.float32)
    y = (r * np.sin(theta)[:, None]).astype(np.float32)
    step = rng.integers(-4, 5, (2,) + x.shape).astype(np.float32)
    x = x + step[0] * np.spacing(x)
    y = y + step[1] * np.spacing(y)
    x, y = x.ravel(), y.ravel()

    @jax.jit
    def xla_bin(y, x):  # jumper.py:814-817
        angle = jnp.arctan2(y, x)
        return angle, jnp.mod(jnp.round(angle * (64 / (2 * np.pi))).astype(
            jnp.int32), 64)

    want_a, want_b = (np.asarray(v) for v in xla_bin(y, x))
    got_a = trig.atan2f(torch.from_numpy(y), torch.from_numpy(x))
    got_b = torch.remainder(torch.round(got_a * (64 / (2 * np.pi))).to(
        torch.int32), 64)
    assert _same(want_a, got_a.numpy()).all()
    np.testing.assert_array_equal(want_b, got_b.numpy())
    # both bins of a boundary are reached at nearly all of them
    sides = len(set(zip(k.repeat(400).tolist(), want_b.tolist())))
    assert sides >= 1.8 * k.size


def test_atan2f_rejects_other_dtypes():
    with pytest.raises(TypeError):
        trig.atan2f(torch.zeros(3, dtype=torch.float64), torch.zeros(3))


def _sweep(lo, hi, chunk=1 << 21):
    """Every f32 x with lo <= |x| < hi, by bit pattern: the port's cos32
    and sin32 against XLA's and against the fused polynomial."""
    lo = int(np.float32(lo).view(np.int32))
    hi = int(np.float32(hi).view(np.int32))
    xla = jax.jit(lambda a: (jnp.cos(a), jnp.sin(a)))
    t0, n, fused, other = time.time(), 0, [], []
    rate = np.zeros(2)
    for start in range(lo, hi, chunk):
        bits = torch.arange(start, min(start + chunk, hi), dtype=torch.int64)
        x = bits.to(torch.int32).view(torch.float32)
        x = torch.cat([x, -x])
        diffs, rates, gots = _fused_differs(x)
        want = xla(x.numpy())
        for name, d, w, g in zip(("cos", "sin"), diffs, want, gots):
            fused += [(name, float(x[i])) for i in d.tolist()]
            miss = ~_same(np.asarray(w), g.view(torch.float32).numpy())
            other += [(name, float(v)) for v in x.numpy()[miss]]
        rate += np.float64(rates) * x.numel()
        n += x.numel()
    print(f"{n} f32 inputs with {sys.argv[1]} <= |x| < {sys.argv[2]}, "
          f"{time.time() - t0:.0f} s\n"
          f"  float64 polynomial values changed by fusing: cos "
          f"{rate[0] / n:.4%}, sin {rate[1] / n:.4%}\n"
          f"  f32 results changed by fusing: {len(fused)} {fused[:20]}\n"
          f"  f32 results unlike XLA's jnp.cos/jnp.sin: {len(other)} "
          f"{other[:20]}")


if __name__ == "__main__":
    _sweep(float(sys.argv[1]), float(sys.argv[2]))
