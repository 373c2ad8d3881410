"""The split of the profiled slice at the program's layer marks
(`benchmark/layers.py`) on synthetic slices: each layer's kernel time, the
gaps between kernels, the marks and what follows an `end` left out, the
division by the slice's steps; a missing, extra or reordered mark reads
nothing for every layer; and the five readers load by name and read the
split."""
import types

import pytest

from benchmark import layers, spec
from benchmark.trace import Slice

READERS = {"rollout.actions_ms_per_step": "actions",
           "game.ms_per_step": "game_step",
           "autoreset.ms_per_step": "auto_reset",
           "render.ms_per_step": "render",
           "rollout.stack_ms_per_step": "stack"}
# us of the kernels after each layer's mark, and after each `end`
WORK = {"actions": 10.0, "game_step": 200.0, "auto_reset": 30.0,
        "render": 70.0, "stack": 40.0, "end": 500.0}
MARK_US, GAP_US = 2.0, 3.0


def _kernels(calls, T, sequence=None):
    """Device kernels of `calls` rollouts of T steps in time order: each
    mark followed by two kernels that share its layer's work, each after
    a gap."""
    seq = sequence or list(layers.STEP * T + ("stack", "end")) * calls
    out, t = [], 0.0
    for layer in seq:
        out.append((f"trace_mark_{layer}", t, t + MARK_US))
        t += MARK_US
        for part in (0.25, 0.75):
            t += GAP_US
            out.append((f"void at::native::work_{layer}(int)", t,
                        t + part * WORK[layer]))
            t += part * WORK[layer]
    return out


def _slice(calls, T, sequence=None):
    return Slice(calls=calls, steps=calls * T, window_us=1.0, busy_us=1.0,
                 kernels=_kernels(calls, T, sequence), device_ops=[],
                 idle_gaps=[])


@pytest.mark.parametrize("calls,T", [(1, 1), (2, 8), (3, 4)])
def test_each_layer_sums_its_kernels_over_the_steps(calls, T):
    got = layers.split(_slice(calls, T))
    steps = calls * T
    want = {layer: WORK[layer] * (T if layer != "stack" else 1) * calls
            / 1e3 / steps for layer in layers.LAYERS}
    assert got == pytest.approx(want)


def test_kernels_before_the_first_mark_belong_to_no_layer():
    s = _slice(2, 2)
    s.kernels = [("Memcpy-like copy_in_kernel", -50.0, -10.0), *s.kernels]
    assert layers.split(s) == pytest.approx(layers.split(_slice(2, 2)))


def _broken():
    seq = list(layers.STEP * 2 + ("stack", "end")) * 2
    missing = seq[:3] + seq[4:]
    extra = seq[:6] + ["render"] + seq[6:]
    swapped = seq.copy()
    swapped[1], swapped[2] = swapped[2], swapped[1]
    return {"missing": missing, "extra": extra, "swapped": swapped,
            "none": [], "one call short": seq[:len(seq) // 2]}


@pytest.mark.parametrize("case", sorted(_broken()))
def test_a_wrong_sequence_of_marks_reads_nothing(case):
    s = _slice(2, 2, _broken()[case] or None)
    if case == "none":
        s.kernels = [k for k in s.kernels if "trace_mark" not in k[0]]
    assert layers.split(s) is None
    run = types.SimpleNamespace(trace=s, scratch={})
    for metric in READERS:
        assert spec.reader(metric).read(run) is None


def test_no_slice_reads_nothing():
    run = types.SimpleNamespace(trace=None, scratch={})
    for metric in READERS:
        assert spec.reader(metric).read(run) is None


def test_the_five_readers_load_by_name_and_read_their_layer():
    names = {m["name"] for m in spec.load_spec()["per_layer"]}
    assert set(READERS) <= names
    s = _slice(2, 8)
    want = layers.split(s)
    run = types.SimpleNamespace(trace=s, scratch={})
    for metric, layer in READERS.items():
        assert spec.reader(metric).read(run) == want[layer]


def test_a_mark_named_as_the_profiler_may_give_it():
    s = _slice(1, 2)
    s.kernels = [(n + "()" if n.startswith("trace_mark_") else n, a, b)
                 for n, a, b in s.kernels]
    assert layers.split(s) == layers.split(_slice(1, 2))
