"""The readers of the stamp kernel B3, `b3.ms_per_step` and
`b3.roofline_pct`: on the CPU against made-up slices and the reference's
composite calls; on the card (marked `cuda`; skips without one) on a
profiled replay of bossfight's rollout graph in easy mode, where both
read, the roofline share under 100% and equal to the bound of the
reference's groups over the kernel's time reckoned apart, and the five
layer metrics read too."""
import pytest
import torch

from benchmark import harness, layers, spec, traffic
from benchmark import trace as trace_mod
from benchmark.reference import env as ref_env
from benchmark.reference.render import composite as ref_composite
from benchmark.reference.utils.tree import tree_map
from benchmark.roofline import peaks, stamp_composite
from benchmark.trace import Slice

B3 = "void stamp_composite_kernel(__nv_bfloat16 const*, StampGroups, int)"
B4 = "void stamp_sum_kernel(StampGroups, __nv_bfloat16*, int)"


def _slice(kernels, steps=8):
    return Slice(calls=1, steps=steps, window_us=1.0, busy_us=1.0,
                 kernels=kernels, device_ops=[], idle_gaps=[])


def _run():
    return harness.Run(spec.cell("bossfight_easy.rollout"))


def _groups(n=2, obs=64, seed=0):
    g = torch.Generator().manual_seed(seed)
    img = torch.rand((n, 3, obs, obs), generator=g).to(torch.bfloat16)

    def group(V, P, K):
        return (torch.rand((V, 4, P, P), generator=g).to(torch.bfloat16),
                torch.randint(0, V, (n, K), generator=g, dtype=torch.int32),
                torch.ones((n, K)),
                torch.randint(-P, obs, (n, K), generator=g, dtype=torch.int32),
                torch.randint(-P, obs, (n, K), generator=g, dtype=torch.int32))

    return img, [group(56, 8, 40), group(8, 40, 1), group(5, 20, 8),
                 group(12, 8, 13)]


def test_b3_time_is_the_kernels_over_the_steps():
    r = spec.reader("b3.ms_per_step")
    run = _run()
    assert r.read(run) is None  # no trace
    run.trace = _slice([(B3, 0.0, 100.0), (B4, 100.0, 900.0),
                        ("trace_mark_render", 900.0, 901.0),
                        (B3, 1000.0, 1140.0)])
    assert r.read(run) == pytest.approx(0.240 / 8)
    run.trace = _slice([(B4, 0.0, 50.0)])
    assert r.read(run) is None  # no such kernel ran: silent, never 0


def test_b3_share_divides_the_bound_by_the_kernel_time():
    """The reader sums the bound of each composite call the reference makes
    in the profiled calls, and divides it by the kernels' device time."""
    r = spec.reader("b3.roofline_pct")
    run = _run()
    r.prepare(run)
    img, groups = _groups()
    with run.profiled_hooks[0]():
        ref_composite.composite(img, groups)
        ref_composite.composite(img, groups)
    assert not ref_composite.OBSERVERS  # the hook removes its observer
    assert r.read(run) is None  # no trace: nothing to read
    bound_ms = peaks.bound(*stamp_composite.work(img, groups))[0]
    run.trace = _slice([(B3, 0.0, 2 * bound_ms * 1e3), (B4, 0.0, 1e6),
                        (B3, 10.0, 10.0 + 2 * bound_ms * 1e3)])
    assert r.read(run) == pytest.approx(50.0)
    run.trace = _slice([(B4, 0.0, 50.0)])
    assert r.read(run) is None


@pytest.mark.cuda
def test_b3_readers_read_a_profiled_bossfight_replay():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from procgen2_tpu_torch.dist import make_vec, rollout

    n, T, dev = 1024, 8, torch.device("cuda:0")
    cell = spec.cell("bossfight_easy.rollout")
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
        with torch.profiler.record_function(trace_mod.CALL):
            _, buf = rollout(vec, state, key, T)
        with torch.profiler.record_function(trace_mod.READ):
            int(buf.dones.sum())
    run = harness.Run(cell)
    run.trace = trace_mod.reduce(prof.profiler.kineto_results.events(), 1, T)
    names = ("b3.ms_per_step", "b3.roofline_pct")
    readers = {m: spec.reader(m) for m in names}
    readers["b3.roofline_pct"].prepare(run)
    ref = ref_env.Env(cfg["game"], cfg["config"], n, cfg["num_levels"], dev)
    rows = torch.arange(n, device=dev)
    ref_state, _ = ref.reset(vec.bank, keys.reset, rows)
    start = tree_map(lambda _, p: p, ref_state, state)
    seen = []
    ref_composite.OBSERVERS.append(seen.append)
    try:
        with run.profiled_hooks[0]():
            ref.rollout(vec.bank, start, key, T, rows)
    finally:
        ref_composite.OBSERVERS.remove(seen.append)
    got = {m: r.read(run) for m, r in readers.items()}
    kernel_us = sum(e - s for k, s, e in run.trace.kernels
                    if "stamp_composite_kernel" in k)
    assert len(seen) == T  # one composite call a step
    assert 0 < got["b3.ms_per_step"] == pytest.approx(kernel_us / 1e3 / T)
    bound_ms = sum(peaks.bound(*stamp_composite.work(*a))[0] for a in seen)
    assert got["b3.roofline_pct"] == pytest.approx(
        100 * bound_ms * 1e3 / kernel_us)
    assert 0 < got["b3.roofline_pct"] < 100
    assert layers.split(run.trace) is not None  # the five layers read too
