"""The profiled slice's device time split among the program's layers, at the
layer marks that the program launches while a profiler records: empty
kernels named `trace_mark_<layer>`, nodes of the rollout's graph.

A rollout of T steps launches (actions, game_step, auto_reset, render,
end) x T, then stack, end. A layer's time is the time of the kernels that
run between one of its marks and the next mark, summed. The gaps between
those kernels are left out: under the profiler a graph's replay spreads
its nodes apart (coinrun at 4096 envs on an H100: 281-535 ms from a call's
first kernel to its last for 168 ms of kernels, where the same replay
takes 172 ms with no profiler), so the gaps are mostly the profiler's.
What runs after an `end` (the copies out, the host read's sum), before a
call's first mark (the copies in) and the marks themselves belong to no
layer. Where the slice's marks are not exactly that sequence for each of
its calls (a program that launches none, or a mark missing, extra or out
of order), nothing is read, so that no time is put down to the wrong
layer.
"""
from __future__ import annotations

import re

MARK = re.compile(r"trace_mark_([a-z_]+)")
STEP = ("actions", "game_step", "auto_reset", "render", "end")
LAYERS = ("actions", "game_step", "auto_reset", "render", "stack")


def split(s) -> dict | None:
    """{layer: device ms per batched step} over the Slice `s`, or None."""
    if s is None or not s.calls or not s.steps or s.steps % s.calls:
        return None
    T = s.steps // s.calls
    marks, us, layer = [], dict.fromkeys(LAYERS, 0.0), None
    for name, start, end in s.kernels:
        m = MARK.search(name)
        if m:
            marks.append(m.group(1))
            layer = None if m.group(1) == "end" else m.group(1)
        elif layer is not None:
            us[layer] += end - start
    if marks != list(STEP * T + ("stack", "end")) * s.calls:
        return None
    return {k: v / 1e3 / s.steps for k, v in us.items()}


def ms_per_step(run, layer: str) -> float | None:
    """One layer's ms per step in the run's traced slice, the split made
    once per run."""
    if "layers" not in run.scratch:
        run.scratch["layers"] = split(run.trace)
    got = run.scratch["layers"]
    return None if got is None else got[layer]
