"""Tracing of the port: named ranges on the host and layer marks on the
device, on exactly while a PyTorch profiler records
(`torch.profiler.profile`, or `torch.autograd.profiler.emit_nvtx` for
nsys). There is no flag: with no profiler recording, each site costs one
check of the profiler's state and does nothing else.

`span(name)` is a named range among the trace's host events, opened as
an op's range (`RecordFunctionFast`, the range PyTorch's compiled code
opens) and not as `record_function`'s user range: the profiler copies a
user range onto the device's timeline over the kernels launched inside
it, so a span around a graph's launch would read as one long device
event, and the trace's device activity would hold the host's spans. A
host range does not run inside a CUDA graph's replay, so each
layer boundary on the device also gets a mark, `mark(layer, device)`: a
one-thread empty kernel named `trace_mark_<layer>`
(`render/csrc/trace_marks.cu`, built at first use like the render
kernels), launched on the current stream. Under a capture it becomes a
node of the graph, so a profiled replay shows each layer's kernels after
its mark, on the device's clock. Spans and marks carry the same names.

The marks, in the order a step of `dist.rollout` launches them:
  actions     `rollout._scan`: the step's key split and its action draw
              (or the policy), span `rollout.actions`
  game_step   `Environment.step`: the game's step and the episode
              accumulators, span `env.game_step`
  auto_reset  `Environment.step`: the split of the env keys, the level
              draw, the bank gather, the game's reset, the selects and the
              next state, span `env.auto_reset`
  render      `Environment.step`: the observations and the TimeStep (its
              `truncated`), span `env.render`
  end         `Environment.step`: closes the step
and after the T steps:
  stack       `rollout._scan`: the stack of the T steps into the buffer,
              span `rollout.stack`
  end         closes the rollout.
A rollout of T steps thus launches (actions, game_step, auto_reset,
render, end) x T, stack, end: 5T + 2 marks. A layer's device time is
that of the kernels between its mark and the next mark; what follows an
`end` belongs to no layer.

Inside a layer, spans with no mark name its parts on the host:
`render.stamp_groups` (bossfight's cull and stamp groups) and `render.b3`
(the stamp kernel's launch, `render/stamp_kernel.py::composite`); on the
device B3 is found by its kernel's name, `stamp_composite_kernel`.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

LAYERS = ("actions", "game_step", "auto_reset", "render", "stack", "end")
_OFF = contextlib.nullcontext()  # reusable: entering it does nothing


def active() -> bool:
    """Whether a profiler records on this thread."""
    return torch._C._autograd._profiler_enabled()


def span(name: str):
    """A named host range while a profiler records, else a context that
    does nothing."""
    if torch._C._autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _OFF


def mark(layer: str, device: torch.device):
    """Launch `trace_mark_<layer>` on `device`'s current stream while a
    profiler records and `device` is a card; else nothing."""
    if device.type == "cuda" and torch._C._autograd._profiler_enabled():
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _launchers()[layer](stream)
        if rc != 0:
            raise RuntimeError(f"trace_mark_{layer} launch failed: code {rc}")


@functools.lru_cache(maxsize=None)
def _launchers() -> dict:
    """Build (or find) and load the marks once per process: {layer: C
    launch(stream) -> 0 or a cudaError_t}. Needs nvcc."""
    from ..render import _build

    lib, _ = _build.load("trace_marks")
    out = {}
    for layer in LAYERS:
        fn = getattr(lib, f"trace_mark_{layer}_launch")
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p]
        out[layer] = fn
    return out
