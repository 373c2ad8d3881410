"""The reader of maze's render kernel M1, `m1.ms_per_step`: on the CPU
against made-up slices; on the card (marked `cuda`; skips without one) on
a profiled replay of maze's rollout graph in easy mode, where it reads the
kernel's time, inside the render's."""
import pytest
import torch

from benchmark import harness, layers, spec, traffic
from benchmark import trace as trace_mod
from benchmark.trace import Slice

M1 = "(anonymous namespace)::maze_render_kernel((anonymous namespace)::Args)"
B3 = "void stamp_composite_kernel(__nv_bfloat16 const*, StampGroups, int)"


def _slice(kernels, steps=8):
    return Slice(calls=1, steps=steps, window_us=1.0, busy_us=1.0,
                 kernels=kernels, device_ops=[], idle_gaps=[])


def test_m1_time_is_the_kernels_over_the_steps():
    r = spec.reader("m1.ms_per_step")
    run = harness.Run(spec.cell("maze_easy.rollout"))
    assert r.read(run) is None  # no trace
    run.trace = _slice([(M1, 0.0, 40.0), (B3, 40.0, 900.0),
                        ("trace_mark_render", 900.0, 901.0),
                        (M1, 1000.0, 1056.0)])
    assert r.read(run) == pytest.approx(0.096 / 8)
    run.trace = _slice([(B3, 0.0, 50.0)])
    assert r.read(run) is None  # no such kernel ran: silent, never 0


def test_m1_is_reported_in_the_maze_cell_alone():
    assert [w for w in (c["name"] for c in spec.load_spec()["workloads"])
            if "m1.ms_per_step" in {m["name"] for m in spec.cell(w).per_layer}
            ] == ["maze_easy.rollout"]


@pytest.mark.cuda
def test_m1_reader_reads_a_profiled_maze_replay():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from procgen2_tpu_torch.dist import make_vec, rollout

    n, T, dev = 1024, 8, torch.device("cuda:0")
    cell = spec.cell("maze_easy.rollout")
    cfg = cell.config
    vec = make_vec(cfg["game"], num_envs=n, num_levels=cfg["num_levels"],
                   device=dev, **cfg["config"])
    keys = traffic.Keys(2 ** 31 + 9, dev)
    state, _ = vec.reset(keys.reset)
    key = keys.call(1)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):  # captures the marked graph
        rollout(vec, state, key, T)
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        # as the harness does: one call outside the slice first, which
        # takes the profiler's own warm-up (it may drop a session's first
        # kernel, and with it a layer mark)
        rollout(vec, state, key, T)
        torch.cuda.synchronize()
        with torch.profiler.record_function(trace_mod.CALL):
            _, buf = rollout(vec, state, key, T)
        with torch.profiler.record_function(trace_mod.READ):
            int(buf.dones.sum())
    run = harness.Run(cell)
    run.trace = trace_mod.reduce(prof.profiler.kineto_results.events(), 1, T)
    got = spec.reader("m1.ms_per_step").read(run)
    kernel_us = [e - s for k, s, e in run.trace.kernels
                 if "maze_render_kernel" in k]
    assert len(kernel_us) == T  # one launch a step
    assert 0 < got == pytest.approx(sum(kernel_us) / 1e3 / T)
    assert got < spec.reader("render.ms_per_step").read(run)
    assert layers.split(run.trace) is not None  # the five layers read too
