"""A rehearsal of the window on the CPU at a tiny size, and the metric
arithmetic: the rate, the tail over all calls, the reservoir of checked
calls, the idle share and breakdown from a synthetic device trace, and a
step mix that plugs in as data. The CLI itself refuses to run without a
card."""
import subprocess
import sys
import types

import pytest
import torch

from benchmark import harness, spec, trace, traffic

SEED = 2 ** 31 + 11  # past 32 signed bits


def _tiny(workload, **traffic_over):
    cell = spec.cell(workload)
    cell.config.update(num_envs=4, num_levels=3)
    cell.traffic.update(warmup_s=0.2, **traffic_over)
    return cell


def test_percentile_is_nearest_rank():
    v = list(range(1, 101))
    assert harness.percentile(v, 95) == 95
    assert harness.percentile([3.0], 95) == 3.0
    assert harness.percentile([5, 1, 4, 2, 3], 95) == 5


def test_reservoir_keeps_k_calls_drawn_from_the_seed():
    def draw(seed):
        r = harness.Reservoir(3, seed)
        for c in range(1, 200):
            slot = r.offer()
            if slot is not None:
                r.items[slot] = c
        return sorted(r.items.values())

    assert draw(5) == draw(5) and len(draw(5)) == 3
    assert draw(5) != draw(6)
    assert max(draw(7)) > 3  # later calls are drawn too


def test_keys_come_from_the_whole_seed():
    a, b = traffic.Keys(SEED, "cpu"), traffic.Keys(SEED + 2 ** 32, "cpu")
    assert not torch.equal(a.reset, b.reset)
    assert torch.equal(a.call(5000), traffic.Keys(SEED, "cpu").call(5000))
    assert not torch.equal(a.call(1), a.call(2))


@pytest.mark.parametrize("workload", [w["name"] for w in
                                      spec.load_spec()["workloads"]])
def test_window_on_the_cpu(workload):
    cell = _tiny(workload)
    r = harness.run_cell(cell, SEED, 0.5, False, device="cpu")
    assert r["correct"] and r["failed"] == 0
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device",
                       "run", "checks"]  # the checks come last
    m, run = r["metrics"], r["run"]
    # the cell's end-to-end metrics; the peak is the card's
    assert set(m) == {x["name"] for x in cell.end_to_end} - {"peak_device_mib"}
    assert m["env_steps_per_s"]["value"] == pytest.approx(
        4 * 8 * run["calls"] / run["window_s"])
    assert m["env_steps_per_s"]["unit"] == "env-steps/s"
    assert run["window_s"] >= 0.5 and r["attempted"] == run["calls"]
    assert all(v["value"] == 0 and v["limit"] == 0
               for v in r["checks"].values())
    assert run["held_host_bytes"] > 0 and run["keep_s"] >= 0


def test_a_step_mix_plugs_in_as_data():
    cell = _tiny("maze_easy.rollout", call="step", steps_per_call=1)
    r = harness.run_cell(cell, SEED, 0.3, False, device="cpu")
    assert r["correct"] and r["attempted"] > 0


def _event(name, start_us, dur_us, on_dev):
    dt = torch.autograd.DeviceType
    return types.SimpleNamespace(
        name=lambda: name, device_type=lambda: dt.CUDA if on_dev else dt.CPU,
        start_ns=lambda: int(start_us * 1e3),
        duration_ns=lambda: int(dur_us * 1e3))


def test_slice_from_a_synthetic_trace():
    """Two calls of 100 us: kernels 10-40 and 50-60 us, a copy 120-150 us;
    the profiler's own flush opens the gap 160-180 us, and its slowed
    graph launch the gap 0-10 us."""
    ev = [_event(trace.CALL, 0, 80, False), _event(trace.READ, 80, 20, False),
          _event(trace.CALL, 100, 80, False),
          _event(trace.READ, 180, 20, False),
          _event("cudaGraphLaunch", 0, 10, False),
          _event("cudaStreamSynchronize", 85, 15, False),
          _event("Buffer Flush", 155, 30, False),
          _event(trace.CALL, 0, 100, True),  # an annotation, not work
          _event("scene_raw_kernel(int*, int)", 10, 30, True),
          _event("add_kernel", 50, 10, True),
          _event("Memcpy DtoD (Device -> Device)", 120, 30, True),
          _event("late_kernel", 250, 10, True)]  # after the slice
    s = trace.reduce(ev, 2, 16)
    assert s.busy_us == pytest.approx(70)
    assert s.window_us == pytest.approx(200 - 50 - 10)  # less both gaps
    assert s.kernel_count() == 2 and s.kernel_us() == pytest.approx(40)
    assert s.kernel_us(("scene_raw_kernel",)) == pytest.approx(30)
    gaps = dict(s.idle_gaps)
    assert gaps["cudaGraphLaunch" + trace.OWN_NOTE] == pytest.approx(10e-6)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(60e-6)
    assert gaps[trace.CALL] == pytest.approx(10e-6)
    assert gaps["Buffer Flush" + trace.OWN_NOTE] == pytest.approx(50e-6)
    assert sum(gaps.values()) == pytest.approx((200 - 70) * 1e-6)
    run = types.SimpleNamespace(trace=s)
    assert spec.reader("device.idle_pct").read(run) == pytest.approx(
        100 * (1 - 70 / 140))
    assert spec.reader("device.busy_ms_per_step").read(run) == \
        pytest.approx(70e-3 / 16)
    assert spec.reader("step.kernels").read(run) == pytest.approx(2 / 16)


def test_no_device_activity_reads_nothing():
    ev = [_event(trace.CALL, 0, 80, False), _event("x", 10, 5, False)]
    assert trace.reduce(ev, 1, 8) is None
    run = types.SimpleNamespace(trace=None)
    for m in ("device.idle_pct", "device.busy_ms_per_step", "step.kernels"):
        assert spec.reader(m).read(run) is None


def test_the_cli_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal needs none")
    p = subprocess.run(
        [sys.executable, str(spec.ROOT / "benchmark" / "run.py"),
         "--workload", "maze_easy.rollout", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=spec.ROOT)
    assert p.returncode != 0
    assert "{" not in p.stdout
