"""How XLA CPU rounds the f32 arithmetic that the port has to reproduce
bit for bit, measured on the JAX package's own code paths:

* a multiply feeding an add is one fused multiply-add (rounded once) in
  `jax.random.uniform` with a range whose width is not a power of two:
  the port's `random._fma32`;
* a division by a constant is a multiply by the constant's f32
  reciprocal (bossfight's `/ MOVE_TIME`, `/ (2 pi / ROT_BINS)`);
* f32 cos/sin are not correctly rounded, standalone or inside bossfight's
  step: they are glibc's cosf/sinf, which the port transcribes
  (`trig.py`), so its volley velocities are exact where float64 cos/sin
  rounded once would differ (tests/test_torch_bossfight.py,
  tests/test_torch_trig.py).

Run as a script to print the rates:

    JAX_PLATFORMS=cpu python tests/test_torch_xla_rounding.py
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procgen2_tpu.games import bossfight as jb
from procgen2_tpu_torch import random as R
from procgen2_tpu_torch.games import bossfight as tb
from procgen2_tpu_torch.utils import convert
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _words(ks):
    return torch.from_numpy(np.asarray(jax.random.key_data(ks)).astype(np.int64))


def _differ(a, b):
    return int((np.asarray(a).view(np.int32) != np.asarray(b).view(np.int32)).sum())


def uniform_rounding(n=20000, lo=0.7, hi=1.2):
    """(values, two-rounding mismatches, fused mismatches) of
    uniform(lo, hi) over n keys against jax.random.uniform."""
    ks = jax.random.split(jax.random.key(13), n)
    want = np.asarray(jax.jit(jax.vmap(
        lambda k: jax.random.uniform(k, (), minval=lo, maxval=hi)))(ks))
    bits = R._bits32(_words(ks), ())
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo32, hi32 = torch.tensor(lo), torch.tensor(hi)
    twice = torch.maximum(lo32, floats * (hi32 - lo32) + lo32)
    return n, _differ(want, twice.numpy()), _differ(want, R.uniform(
        _words(ks), (), lo, hi).numpy())


def division_rounding(n=200000, c=70.0):
    """(values, mismatches against a true f32 division, against a multiply
    by the f32 reciprocal) of XLA's x / c."""
    x = np.random.default_rng(0).uniform(-3, 3, n).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: a / c)(x))
    true = (torch.from_numpy(x) / c).numpy()
    recip = (torch.from_numpy(x) * float(np.float32(1) / np.float32(c))).numpy()
    return n, _differ(want, true), _differ(want, recip)


def cos_sin_rounding(n=200000):
    """Over n f32 angles in [0, 7): the fraction of XLA's cos and sin that
    differ from torch's f32 ones and from float64 rounded once, and the
    largest error against float64."""
    r = np.random.default_rng(1).uniform(0, 7, n).astype(np.float32)
    c, s = (np.asarray(v) for v in jax.jit(lambda a: (jnp.cos(a), jnp.sin(a)))(r))
    t = torch.from_numpy(r)
    out = {}
    for name, xla, f32, f64 in (("cos", c, torch.cos(t), np.cos(r.astype(np.float64))),
                                ("sin", s, torch.sin(t), np.sin(r.astype(np.float64)))):
        out[name] = (_differ(xla, f32.numpy()) / n,
                     _differ(xla, f64.astype(np.float32)) / n,
                     float(np.abs(xla - f64).max()))
    return out


def volley_rounding(n=512):
    """One bossfight step of n envs that all fire the radial volley
    (8 bullets each): the fraction of new velocity components that differ
    from float64 cos/sin rounded once, the largest such difference, and
    the number that differ from the port's step."""
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(7), i))(
        jnp.arange(n, dtype=jnp.uint32))
    lv = jax.jit(jax.vmap(functools.partial(jb.generate, jb.Config())))(keys)
    st = jax.vmap(functools.partial(jb.reset, jb.Config()))(
        lv, jax.random.split(jax.random.key(8), n))
    st = st.replace(weapon_index=jnp.full(n, 2, jnp.int32),
                    phase_timer=jnp.full(n, 3.0),
                    attack_timer=jnp.full(n, 10.0))
    out, *_ = jax.jit(jax.vmap(functools.partial(jb.step, jb.Config())))(
        st, jnp.full(n, 4, jnp.int32))
    rot = torch.from_numpy(np.array(out.bb_rot)[:, :8]).double()
    f64 = (torch.stack([torch.cos(rot).float(), -torch.sin(rot).float()], -1)
           * tb.Config().bullet_speed).numpy()
    want = np.asarray(out.bb_vel)[:, :8]
    numpy_st = jax.tree.map(
        lambda a: (np.asarray(jax.random.key_data(a))
                   if jnp.issubdtype(a.dtype, jax.dtypes.prng_key)
                   else np.asarray(a)), st)
    port, *_ = tb.step(tb.Config(), convert.state(tb, numpy_st, "cpu"),
                       torch.full((n,), 4, dtype=torch.int32))
    return (_differ(want, f64) / want.size,
            float(np.abs(want.astype(np.float64) - f64).max()),
            _differ(want, port.bb_vel[:, :8].numpy()))


def test_uniform_is_one_fused_multiply_add():
    n, twice, fused = uniform_rounding(4000)
    assert twice > 0 and fused == 0


def test_division_by_a_constant_is_a_reciprocal_multiply():
    n, true, recip = division_rounding(20000)
    assert true > 0 and recip == 0


def test_cos_sin_are_not_correctly_rounded():
    for name, (vs_f32, vs_f64, err) in cos_sin_rounding(20000).items():
        assert vs_f32 > 0 and vs_f64 > 0 and err < 2.0 ** -24, name


def test_volley_velocities_within_the_budget():
    """Float64 cos/sin rounded once miss XLA's volley velocities by a
    little; the port's (glibc's cosf/sinf, the fused angle) by nothing."""
    frac, err, port = volley_rounding(64)
    assert frac > 0 and err <= tb.Config().bullet_speed * 2.0 ** -19
    assert port == 0


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    n, twice, fused = uniform_rounding()
    print(f"uniform(0.7, 1.2), {n} keys: two roundings differ in {twice}, "
          f"one fused multiply-add in {fused}")
    n, true, recip = division_rounding()
    print(f"x / 70, {n} values: true division differs in {true}, multiply by "
          f"the f32 reciprocal in {recip}")
    for name, (vs_f32, vs_f64, err) in cos_sin_rounding().items():
        print(f"{name}, 200000 angles in [0, 7): differs from torch f32 in "
              f"{vs_f32:.4%}, from float64 rounded once in {vs_f64:.4%}; "
              f"max error vs float64 {err:.3e}")
    for n in (8, 2000):
        frac, err, port = volley_rounding(n)
        print(f"bossfight step, {n} envs firing the radial volley: "
              f"{frac:.4%} of new velocity components differ from float64 "
              f"cos/sin rounded once, max |diff| {err:.3e}; {port} differ "
              f"from the port's")
