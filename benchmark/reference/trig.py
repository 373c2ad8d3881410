"""f32 cos and sin as XLA CPU computes them: a frozen copy of the
program's `trig.py` (`cos32`, `sin32`, `sincos32` and their tables), cut
to those three, for bossfight's bullet volleys.

XLA CPU's f32 cos/sin are glibc's `cosf` / `sinf` (sysdeps/ieee754/
flt-32: s_sinf.c, s_cosf.c, s_sincosf.h, s_sincosf_data.c), which are
not correctly rounded. This transcribes glibc's algorithm in torch
float64 ops (each a separate IEEE operation on the CPU and on the card,
so both give the same bits) and rounds once to f32:

  * |x| < 2**-12: sin x = x, cos x = 1;
  * |x| < 0.75: the polynomial on x directly;
  * |x| < 120: `reduce_fast`, n = ((int32)(x * 2**24 * 2/pi) + 2**23)
    >> 24, r = x - n * pi/2; the quadrant picks the sign and the table;
  * |x| >= 120: `reduce_large`, r = the 2.62 fixed-point product of the
    mantissa with 4/pi (`__inv_pio4`), in 64-bit integer arithmetic;
  * inf and nan: nan.

The constants are glibc's `__sincosf_table` and `__inv_pio4`, as hex
literals.
"""
from __future__ import annotations

import torch

from .utils.consts import const

# glibc __sincosf_table: the quadrant signs, 2/pi * 2**24, pi/2, and the
# cosine (c0-c4) and sine (s1-s3) polynomials. Table 1, used when the
# quadrant has bit 1 set, negates the cosine's coefficients.
_SIGN = (1.0, -1.0, -1.0, 1.0)
_HPI_INV = float.fromhex("0x1.45f306dc9c883p+23")
_HPI = float.fromhex("0x1.921fb54442d18p+0")
_C = (1.0,
      float.fromhex("-0x1.ffffffd0c621cp-2"),
      float.fromhex("0x1.55553e1068f19p-5"),
      float.fromhex("-0x1.6c087e89a359dp-10"),
      float.fromhex("0x1.99343027bf8c3p-16"))
_S = (float.fromhex("-0x1.555545995a603p-3"),
      float.fromhex("0x1.1107605230bc4p-7"),
      float.fromhex("-0x1.994eb3774cf24p-13"))
_HPI_HI = float.fromhex("0x1.921fb5p+0")  # _HPI's top 26 bits
_HPI_LO = float.fromhex("0x1.110b46p-26")  # _HPI - _HPI_HI, exact
_PI63 = float.fromhex("0x1.921fb54442d18p-62")  # pi/2 * 2**-62

# glibc __inv_pio4: 4/pi in 32-bit words, each 8 bits on from the last
_INV_PIO4 = (
    0xa2, 0xa2f9, 0xa2f983, 0xa2f9836e,
    0xf9836e4e, 0x836e4e44, 0x6e4e4415, 0x4e441529,
    0x441529fc, 0x1529fc27, 0x29fc2757, 0xfc2757d1,
    0x2757d1f5, 0x57d1f534, 0xd1f534dd, 0xf534ddc0,
    0x34ddc0db, 0xddc0db62, 0xc0db6295, 0xdb629599,
    0x6295993c, 0x95993c43, 0x993c4390, 0x3c439041)

_M32 = 0xFFFFFFFF
# abstop12 thresholds: the top 12 bits (exponent and 3 mantissa bits) of
# 2**-12, pi/4 as f32 (0x3f490fdb) and 120
_TOP_TINY, _TOP_PIO4, _TOP_120, _TOP_INF = 0x398, 0x3F4, 0x42F, 0x7F8


def _poly(x, x2, sign, table1, odd):
    """glibc sinf_poly on float64 tensors: the sine polynomial where `odd`
    is false, the cosine one where it is true; the cosine's coefficients
    negated where `table1`. x is multiplied by `sign` (+-1) first."""
    x = x * sign
    # sine: x + x3 * s1 + x7 * (s2 + x2 * s3)
    x3 = x * x2
    s1 = _S[1] + x2 * _S[2]
    x7 = x3 * x2
    s = x + x3 * _S[0]
    sin = s + x7 * s1
    # cosine: c0 + x2 * c1 + x4 * c2 + x6 * (c3 + x2 * c4)
    neg = torch.where(table1, -1.0, 1.0).to(torch.float64)
    x4 = x2 * x2
    c2 = _C[3] * neg + x2 * (_C[4] * neg)
    c1 = _C[0] * neg + x2 * (_C[1] * neg)
    x6 = x4 * x2
    c = c1 + x4 * (_C[2] * neg)
    cos = c + x6 * c2
    return torch.where(odd, cos, sin)


def _reduce_fast(x):
    """glibc reduce_fast: (r float64, n int64) with x = n * pi/2 + r.

    glibc's x86-64 build selects a variant compiled with FMA, where
    `x - n * hpi` is one fused multiply-add: r is x - n * pi/2 rounded once.
    With |n| < 2**7, pi/2 = _HPI_HI + _HPI_LO (26 and 24 significant bits)
    makes both products exact, and x - n * _HPI_HI too (a multiple of
    2**-25 below 1, since |x| >= 0.75 here), so the last subtraction is
    the only rounding, as in the fused operation."""
    r = x * _HPI_INV
    n = (r.to(torch.int32) + 0x800000) >> 24
    nf = n.to(torch.float64)
    return (x - nf * _HPI_HI) - nf * _HPI_LO, n.to(torch.int64)


def _reduce_large(xi):
    """glibc reduce_large on the f32 bit patterns xi (int64, |x| >= 120):
    (r float64, n int64). The 32 x 96 -> 128-bit product runs in int64,
    whose wrap-around adds and shifts give uint64's low bits; the quadrant
    is taken from the top two bits, masked, so the sign never enters."""
    dev = xi.device
    table = const(_INV_PIO4, dev, torch.int64)
    base = (xi >> 26) & 15
    shift = (xi >> 23) & 7
    m = ((xi & 0xFFFFFF) | 0x800000) << shift  # < 2**31
    res0 = (m * table[base]) & _M32  # uint32 product
    res1 = m * table[base + 4]  # < 2**63
    res2 = m * table[base + 8]
    res0 = (res2 >> 32) | (res0 << 32)
    res0 = res0 + res1
    n = ((res0 + (1 << 61)) >> 62) & 3
    res0 = res0 - (n << 62)
    return res0.to(torch.float64) * _PI63, n


def _sincos(y: torch.Tensor, want_cos) -> torch.Tensor:
    """cos where `want_cos` (a bool, or a bool tensor broadcast against
    y), else sin, of the f32 tensor y."""
    if y.dtype != torch.float32:
        raise TypeError(f"cos32/sin32 take float32, got {y.dtype}")
    if not isinstance(want_cos, torch.Tensor):
        want_cos = const(want_cos, y.device)
    xi = y.view(torch.int32).to(torch.int64) & _M32
    top = (xi >> 20) & 0x7FF
    x = y.to(torch.float64)

    # |x| < 120: reduce_fast (unused lanes compute garbage, masked below)
    r_f, n_f = _reduce_fast(torch.where(top < _TOP_120, x, 0.0))
    # |x| >= 120: reduce_large, the input's sign folded into the quadrant
    r_l, n_l = _reduce_large(xi)
    n_l = n_l + (xi >> 31)
    small = top < _TOP_PIO4
    large = top >= _TOP_120
    r = torch.where(small, x, torch.where(large, r_l, r_f))
    n = torch.where(small, 0, torch.where(large, n_l, n_f))
    sign = const(_SIGN, y.device, torch.float64)[n & 3]
    sign = torch.where(small, 1.0, sign)
    # cos uses the other polynomial of the quadrant (n ^ 1); reduce_large's
    # quadrant for the polynomial is n without the sign, as in glibc
    n_poly = torch.where(large, n_l - (xi >> 31), n)
    odd = ((n_poly & 1) == 1) ^ want_cos
    out = _poly(r, r * r, sign, (n & 2) == 2, odd).to(torch.float32)

    tiny = torch.where(want_cos, torch.ones_like(y), y)
    out = torch.where(top < _TOP_TINY, tiny, out)
    return torch.where(top >= _TOP_INF, torch.full_like(y, float("nan")), out)


def cos32(x: torch.Tensor) -> torch.Tensor:
    """f32 cos, bit for bit XLA CPU's (glibc's cosf)."""
    return _sincos(x, True)


def sin32(x: torch.Tensor) -> torch.Tensor:
    """f32 sin, bit for bit XLA CPU's (glibc's sinf)."""
    return _sincos(x, False)


def sincos32(x: torch.Tensor):
    """(cos32(x), sin32(x)) from one pass over both."""
    pick = const((True, False), x.device).reshape((2,) + (1,) * x.ndim)
    c, s = _sincos(torch.stack([x, x]), pick)
    return c, s
