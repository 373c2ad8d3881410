"""The steps a CUDA graph records copy nothing from the host and read
nothing back (procgen2_tpu_torch/dist/rollout.py captures T of them).

On the card a graph cannot record a host-to-device copy
(`torch.tensor(..., device="cuda")`, a list or numpy index, `from_numpy`)
or a host read (`bool`, `.item()`, `.tolist()`, a boolean-mask index,
`nonzero`). Here, on the CPU, `rollout`'s steps run once as its warm-up
does, then again under a dispatch mode that fails on any op of either
kind, for every game and each exact-camera path (`scene_phases=0`)."""
import traceback

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import procgen2_tpu_torch as pt
from procgen2_tpu_torch import random as R
from procgen2_tpu_torch.dist.rollout import _scan
from procgen2_tpu_torch.render import compositor
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

aten = torch.ops.aten
# ops that make a tensor from host data, or read a device value on the host
HOST_OPS = {aten.lift_fresh.default, aten.lift_fresh_copy.default,
            aten._local_scalar_dense.default, aten.nonzero.default,
            aten.masked_select.default, aten._unique2.default,
            aten.unique_dim.default, aten.unique_consecutive.default,
            aten.repeat_interleave.Tensor}
MASK_INDEXED = {aten.index.Tensor, aten.index_put.default,
                aten.index_put_.default, aten._index_put_impl_.default}


class NoHostTraffic(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        bad = func in HOST_OPS or (func in MASK_INDEXED and any(
            isinstance(i, torch.Tensor) and i.dtype in (torch.bool,
                                                        torch.uint8)
            for i in args[1] if i is not None))
        if bad:
            raise AssertionError(f"{func} in a captured step, at {_site()}")
        return func(*args, **(kwargs or {}))


def _site():
    """The innermost frame of the port's package on the stack."""
    frames = [f for f in traceback.extract_stack()
              if "procgen2_tpu_torch" in f.filename]
    return f"{frames[-1].filename}:{frames[-1].lineno}" if frames else "?"


def _no_call(name):
    def fail(*a, **k):
        raise AssertionError(f"Tensor.{name} in a captured step, at "
                             f"{_site()}")
    return fail


CASES = [(g, {}) for g in pt.GAMES] + [
    (g, {"scene_phases": 0})
    for g in ("coinrun", "climber", "caveflyer", "jumper")]


@pytest.mark.parametrize("game,cfg", CASES,
                         ids=[g + ("-exact" if c else "") for g, c in CASES])
def test_steps_copy_nothing_from_the_host(game, cfg, monkeypatch):
    env = pt.make(game, device="cpu", **cfg)
    bank = env.generate_bank(R.key(0), 4)
    state, _ = env.reset(bank, R.key(1), 4)
    with compositor.host_reads_off():
        state, _ = _scan(env, bank, state, R.key(2), 2, None,
                                     None)
        for name in ("tolist", "numpy", "item"):
            monkeypatch.setattr(torch.Tensor, name, _no_call(name))
        key = R.key(3)
        with NoHostTraffic():
            _scan(env, bank, state, key, 2, None, None)


def test_the_check_sees_host_traffic():
    x = torch.arange(4)
    for fn in (lambda: torch.tensor([1, 2]), lambda: bool(x.any()),
               lambda: x[x > 1], lambda: x[[0, 2]],
               lambda: torch.as_tensor(3, dtype=torch.int64)):
        with pytest.raises(AssertionError), NoHostTraffic():
            fn()
    with NoHostTraffic():  # what a captured step may do
        torch.where(x > 1, 0, x) * 2 + torch.full((), 3)
