"""The port's opt-in guards (procgen2_tpu_torch/utils/guards.py), the
counterpart of `tests/test_guards.py`: a NaN in an intermediate raises,
and so does an infinity made from finite values (a -inf written on
purpose does not); an out-of-bounds gather raises a `GuardError` only
with index checks on (without, torch's own IndexError); user checks;
clean steps of maze and coinrun pass, and a NaN put into a state
raises."""
import dataclasses

import pytest
import torch

import procgen2_tpu_torch as pt
from procgen2_tpu_torch import random as R
from procgen2_tpu_torch.utils import guards
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_checked_raises_on_nan_in_an_intermediate():
    cf = guards.checked(lambda x: (torch.log(x) * 2.0).clamp(max=10.0))
    assert float(cf(torch.tensor(4.0))) == pytest.approx(2.0 * 1.3862944)
    with pytest.raises(guards.GuardError, match="log"):
        cf(torch.tensor(-1.0))


def test_checked_infinities():
    with pytest.raises(guards.GuardError, match="infinity"):
        guards.checked(lambda x: 1.0 / x)(torch.zeros(3))
    # a mask of -inf (a categorical's logits) is the code's own
    masked = guards.checked(
        lambda m: torch.where(m, 0.0, float("-inf")).argmax(-1))
    assert int(masked(torch.tensor([False, True, False]))) == 1


def test_checked_raises_on_oob_gather_only_with_index_checks():
    table = torch.arange(8.0)
    cf = guards.checked(lambda i: table[i], errors=guards.INDEX_CHECKS)
    assert cf(torch.tensor([3, -1])).tolist() == [3.0, 7.0]
    with pytest.raises(guards.GuardError, match="out of bounds"):
        cf(torch.tensor([42]))
    with pytest.raises(guards.GuardError, match="out of bounds"):
        guards.checked(lambda i: table.gather(0, i),
                       errors=guards.INDEX_CHECKS)(torch.tensor([1, 9]))
    # index checks are opt-in: without them torch's own check fires
    with pytest.raises(IndexError):
        guards.checked(lambda i: table[i])(torch.tensor([42]))


def test_user_checks():
    def fn(x):
        guards.check(x > 0, "x positive")
        return x * 2
    assert torch.equal(guards.checked(fn)(torch.ones(2)), torch.full((2,), 2.0))
    with pytest.raises(guards.GuardError, match="x positive"):
        guards.checked(fn)(-torch.ones(2))
    fn(-torch.ones(2))  # unguarded: a no-op


@pytest.mark.parametrize("game,cfg", [("maze", {"mode": "easy"}),
                                      ("coinrun", {})])
def test_checked_step_clean_then_nan(game, cfg):
    env = pt.make(game, device="cpu", **cfg)
    bank = env.generate_bank(R.key(0), 4)
    state, ts = guards.checked_reset(env, 4)(bank, R.key(1))
    step = guards.checked_step(env)
    for i in range(3):
        state, ts = step(bank, state, R.randint(R.key(i), (4,), 0, 15))
    assert ts.obs.shape == (4, 64, 64, 3)
    pos = state.game.pos.clone()
    pos[1, 0] = float("nan")
    bad = dataclasses.replace(state, game=dataclasses.replace(state.game,
                                                              pos=pos))
    with pytest.raises(guards.GuardError, match="NaN"):
        step(bank, bad, torch.zeros(4, dtype=torch.int32))
