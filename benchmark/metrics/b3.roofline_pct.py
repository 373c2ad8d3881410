"""b3.roofline_pct: the stamp kernel B3's share of its roofline in the
profiled slice: the least time the card could take for the work the
reference's stamp groups of those steps need (all rows; `roofline/
stamp_composite.py`, `roofline/peaks.py`), over the profiler's device
time of the kernels named below. The bound counts the same work whatever
implements the render; where no such kernel ran, nothing is read."""
import contextlib

from benchmark.reference.render import composite as ref_composite
from benchmark.roofline import peaks, stamp_composite

KERNELS = ("stamp_composite_kernel",)


def prepare(run):
    acc = run.scratch["b3.roofline_pct"] = {"bound_ms": 0.0, "calls": 0}

    def observe(args):
        acc["bound_ms"] += peaks.bound(*stamp_composite.work(*args))[0]
        acc["calls"] += 1

    @contextlib.contextmanager
    def hook():
        ref_composite.OBSERVERS.append(observe)
        try:
            yield
        finally:
            ref_composite.OBSERVERS.remove(observe)

    run.during_profiled(hook)


def read(run):
    s, acc = run.trace, run.scratch.get("b3.roofline_pct")
    if s is None or not acc or not acc["calls"]:
        return None
    t_us = s.kernel_us(KERNELS)
    if t_us <= 0:
        return None
    return 100.0 * acc["bound_ms"] * 1e3 / t_us
