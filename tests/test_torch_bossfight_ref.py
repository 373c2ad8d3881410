"""The port's BossfightRefSim (procgen2_tpu_torch/tools/bossfight_ref.py,
on the port's mt19937 oracle) against the JAX package's copy: the same
seeds and actions give the same reward and termination at every step
and the same state after it, every field (f32 bit for bit) and every
bullet slot. Actions: NOOPs, sustained fire, and a seeded scripted mix
of moves and fire, each over a few hundred steps or to the episode's
end."""
import numpy as np
import pytest

from procgen2_tpu.tools.bossfight_ref import BossfightRefSim as JSim
from procgen2_tpu_torch.tools.bossfight_ref import BossfightRefSim as TSim
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SEEDS = (0, 1, 3, 6)
STEPS = 300


def _fields(sim):
    """The sim's state: scalars, and each bullet's slots, as numpy."""
    out = {}
    for k, v in vars(sim).items():
        if k == "rng":
            continue
        if k in ("ab", "bb"):
            v = [(b.px, b.py, b.vx, b.vy, b.frame, b.bouncing, b.btimer)
                 for b in v]
        out[k] = v
    return out


def _same(want, got, what):
    assert want.keys() == got.keys(), what
    for k in want:
        a, b = np.asarray(want[k]), np.asarray(got[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (what, k)
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=f"{what}: {k}")


def _actions(kind, seed):
    if kind == "noop":
        return [4] * STEPS
    if kind == "fire":
        return [9] * STEPS
    rng = np.random.default_rng(seed)
    return [int(a) for a in rng.choice([0, 1, 2, 3, 5, 6, 7, 8, 9, 9, 9],
                                       STEPS)]


@pytest.mark.parametrize("kind", ["noop", "fire", "scripted"])
@pytest.mark.parametrize("seed", SEEDS)
def test_bossfight_ref_sim_matches_jax(seed, kind):
    js, ts = JSim(seed), TSim(seed)
    try:
        _same(_fields(js), _fields(ts), f"seed {seed} after reset")
        for t, a in enumerate(_actions(kind, seed)):
            jr, jterm = js.step(a)
            tr, tterm = ts.step(a)
            assert type(tr) is type(jr) and jr.view(np.int32) == tr.view(
                np.int32), (seed, kind, t)
            assert jterm == tterm, (seed, kind, t)
            _same(_fields(js), _fields(ts), f"seed {seed} {kind} step {t}")
            if jterm:
                break
    finally:
        js.close()
        ts.close()
