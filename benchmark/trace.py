"""The profiled slice of a traced run, reduced to what the per-layer
readers and the result's `device` and `breakdown` take.

The slice is a few whole calls of the window under torch.profiler (CUPTI),
each call inside a `bench.call` range and its host read inside
`bench.read`. Its window runs from the first call's start to the last
read's end, less the idle gaps that the profiler opened: those under its
own buffer handling, and those under `cudaGraphLaunch`, which CUPTI's
tracing of a graph's launch stretches from the 1-4 ms that the host's
whole side of an unprofiled call takes (`rollout.host_ms`) to tens of ms.
Device activity is every kernel, copy and set on the device; busy time is
the union of their intervals inside the window.
"""
from __future__ import annotations

import dataclasses

import numpy as np

CALL, READ = "bench.call", "bench.read"
TOP = 10  # entries of each breakdown list
# host ranges that the profiler makes or stretches: an idle gap under one
# of them is the profiler's doing, and is left out of the slice's window
PROFILER_OWN = ("Buffer Flush", "Activity Buffer Request", "cudaGraphLaunch")
OWN_NOTE = " (the profiler's; left out of the window)"


@dataclasses.dataclass
class Slice:
    calls: int
    steps: int  # batched steps in the slice
    window_us: float
    busy_us: float
    kernels: list  # (name, start_us, end_us) of each device kernel
    device_ops: list  # (name, seconds) summed by name, most first
    idle_gaps: list  # (what the host was doing, seconds), most first

    def kernel_us(self, names=None) -> float:
        """Summed time of the kernels whose name holds one of `names`
        (all kernels where None)."""
        return sum(e - s for n, s, e in self.kernels if _named(n, names))

    def kernel_count(self, names=None) -> int:
        return sum(1 for n, _, _ in self.kernels if _named(n, names))


def _named(name, names):
    """Whether kernel `name` (as the profiler gives it, signature and all)
    is one of `names`."""
    return names is None or any(k == name or k + "(" in name or k + "<" in name
                                for k in names)


def _is_kernel(name: str) -> bool:
    low = name.lower()
    return not (low.startswith("memcpy") or low.startswith("memset"))


def _times(e):
    """(start, end) of a raw profiler event in us."""
    start = e.start_ns() / 1e3
    return start, start + e.duration_ns() / 1e3


def reduce(events, calls: int, steps: int) -> Slice | None:
    """A Slice from the profiler's raw events
    (`prof.profiler.kineto_results.events()`), or None where the profiler
    saw no device activity."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in events:
        name = e.name()
        on_dev = e.device_type() == cuda
        if on_dev and name in (CALL, READ):
            continue  # the ranges' own annotations on the device's timeline
        (dev if on_dev else host).append((name, *_times(e)))
    marks = [h for h in host if h[0] in (CALL, READ)]
    if not marks:
        return None
    w0 = min(s for _, s, _ in marks)
    w1 = max(e for _, _, e in marks)
    dev = sorted((d for d in dev if w0 <= d[1] < w1), key=lambda x: x[1])
    if not dev:
        return None

    busy, gaps, cur_s, cur_e = 0.0, [], None, None
    for _, s, e in dev:
        e = min(e, w1)
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            else:
                gaps.append((w0, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
        gaps.append((cur_e, w1))

    by_op: dict = {}
    for n, s, e in dev:
        by_op[n] = by_op.get(n, 0.0) + (e - s) / 1e6
    idle = _label_gaps(gaps, host)
    own = sum(v for n, v in idle if n in PROFILER_OWN)
    return Slice(
        calls=calls, steps=steps, window_us=w1 - w0 - own * 1e6,
        busy_us=busy, kernels=[d for d in dev if _is_kernel(d[0])],
        device_ops=sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP],
        idle_gaps=[(n + OWN_NOTE if n in PROFILER_OWN else n, v)
                   for n, v in idle[:TOP]])


def _label_gaps(gaps, host):
    """Each idle gap's seconds summed under the innermost host range
    (profiler CPU event) open at its midpoint; "no host range" where none
    is."""
    gaps = np.array([g for g in gaps if g[1] > g[0]], dtype=np.float64)
    if not len(gaps):
        return []
    mids = gaps.mean(axis=1)  # ascending: the gaps are in time order
    label = np.full(len(mids), -1)
    names = sorted({h[0] for h in host})
    index = {n: i for i, n in enumerate(names)}
    # the longest ranges first, so that each inner range overwrites them
    for name, s, e in sorted(host, key=lambda h: h[1] - h[2]):
        a, b = np.searchsorted(mids, [s, e], side="left")
        label[a:b] = index[name]
    secs = (gaps[:, 1] - gaps[:, 0]) / 1e6
    by_label: dict = {}
    for i in np.unique(label):
        name = names[i] if i >= 0 else "no host range"
        by_label[name] = float(secs[label == i].sum())
    return sorted(by_label.items(), key=lambda kv: -kv[1])
