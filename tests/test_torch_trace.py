"""The port's tracing (`procgen2_tpu_torch/utils/trace.py`), maze and
coinrun in easy mode at 4 envs and T = 2.

On the CPU: with no profiler recording, `ShardedEnv.reset`, `rollout` and
`Environment.step` enter no `record_function` and touch no mark; under
`torch.profiler` the spans come in the order of the layers; and the
trajectory under the profiler equals the one without, bit for bit.

On the card (marked `cuda`; they skip without one): a profiled replay of
the marked graph holds 5T + 2 marks in order, the second of two eager
steps 4 (the profiler may drop a session's first kernels); the marked
graph's buffer equals the plain graph's bit for bit; the first call after
the profiler stops leaves only the plain graph; and a rollout with no
profiler builds and launches no mark. This file imports no jax; on a
machine without it:

    python -m pytest --noconftest tests/test_torch_trace.py
"""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from procgen2_tpu_torch import random as R
from procgen2_tpu_torch.dist import make_vec, rollout
from procgen2_tpu_torch.dist.rollout import graphs
from procgen2_tpu_torch.utils import trace, tree_leaves
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N, T, LEVELS = 4, 2, 3
GAMES = {"maze": {"mode": "easy"}, "coinrun": {"easy_mode": True}}
STEP_SPANS = ["env.game_step", "env.auto_reset", "env.render"]
ROLLOUT_SPANS = ["rollout.actions", *STEP_SPANS] * T + ["rollout.stack"]
GRAPH_SPANS = ["rollout.graph_key", "rollout.copy_in", "rollout.launch",
               "rollout.clone"]
STEP_MARKS = ["game_step", "auto_reset", "render", "end"]
ROLLOUT_MARKS = ["actions", *STEP_MARKS] * T + ["stack", "end"]


def _vec(game, device="cpu"):
    vec = make_vec(game, num_envs=N, num_levels=LEVELS, device=device,
                   **GAMES[game])
    state, _ = vec.reset(R.key(3, vec.env.device))
    return vec, state


def _same(a, b):
    assert type(a) is type(b)
    leaves_a, leaves_b = tree_leaves(a), tree_leaves(b)
    assert len(leaves_a) == len(leaves_b) > 0
    for x, y in zip(leaves_a, leaves_b):
        assert torch.equal(x.cpu(), y.cpu())


def _events(prof, device_type):
    """(start ns, name) of the profile's raw events on `device_type`, in
    order of start (the raw events: building the profiler's event tree
    takes seconds for coinrun's bank)."""
    return sorted((e.start_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == device_type)


def _spans(prof, prefixes=("env.", "rollout.", "vec.")):
    """Names of the port's spans in the profile, in order of start."""
    return [n for _, n in _events(prof, torch.autograd.DeviceType.CPU)
            if n.startswith(prefixes)]


def _marks(prof):
    """Layers of the trace_mark_* kernels the card ran, in time order."""
    return [n.split("trace_mark_")[1].split("(")[0]
            for _, n in _events(prof, torch.autograd.DeviceType.CUDA)
            if "trace_mark_" in n]


@pytest.fixture(scope="module", params=sorted(GAMES))
def cpu_run(request):
    vec, state = _vec(request.param)
    return request.param, vec, state


def test_no_profiler_enters_no_range(cpu_run, monkeypatch):
    game, vec, state = cpu_run

    def refuse(*args, **kwargs):
        raise AssertionError("a range was entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(trace, "_launchers", refuse)
    assert not trace.active()
    fresh = make_vec(game, num_envs=N, num_levels=LEVELS, device="cpu",
                     **GAMES[game])
    fresh.reset(R.key(3))
    final, _ = rollout(vec, state, R.key(5), T)
    vec.step(final, torch.zeros(N, dtype=torch.int32))


def test_spans_come_in_the_order_of_the_layers(cpu_run):
    game, vec, state = cpu_run
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert trace.active()
        fresh = make_vec(game, num_envs=N, num_levels=LEVELS, device="cpu",
                         **GAMES[game])
        fresh.reset(R.key(3))
        final, _ = rollout(vec, state, R.key(5), T)
        vec.step(final, torch.zeros(N, dtype=torch.int32))
    assert _spans(prof) == (["vec.reset", "env.generate_bank", "env.reset"]
                            + ROLLOUT_SPANS + STEP_SPANS)


def test_the_profiled_trajectory_equals_the_plain_one(cpu_run):
    _, vec, state = cpu_run
    plain = rollout(vec, state, R.key(7), T)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = rollout(vec, state, R.key(7), T)
    for a, b in zip(plain, traced):
        _same(a, b)


# ---- on the card ---------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


CARD = [pytest.param(g, marks=pytest.mark.cuda) for g in sorted(GAMES)]
ACTS = [ProfilerActivity.CPU, ProfilerActivity.CUDA]


@pytest.mark.parametrize("game", CARD)
def test_a_profiled_replay_holds_its_marks_in_order(dev, game):
    vec, state = _vec(game, dev)
    key = R.key(5, dev)
    with profile(activities=ACTS):  # captures the marked graph
        rollout(vec, state, key, T)
    torch.cuda.synchronize()
    with profile(activities=ACTS) as prof:
        final, _ = rollout(vec, state, key, T)
        torch.cuda.synchronize()
    assert _marks(prof) == ROLLOUT_MARKS
    assert _spans(prof, ("rollout.",)) == GRAPH_SPANS
    actions = torch.zeros(N, dtype=torch.int32, device=dev)
    with profile(activities=ACTS) as prof:
        # the profiler may miss the first kernels of its session: the
        # second of two eager steps is the one held
        for _ in range(2):
            final, _ = vec.step(final, actions)
        torch.cuda.synchronize()
    marks = _marks(prof)
    assert marks[-4:] == STEP_MARKS
    assert marks == (STEP_MARKS * 2)[-len(marks):]


@pytest.mark.parametrize("game", CARD)
def test_the_marked_graph_equals_the_plain_one_and_goes(dev, game):
    vec, state = _vec(game, dev)
    key = R.key(5, dev)
    plain = rollout(vec, state, key, T)
    with profile(activities=ACTS):
        marked = rollout(vec, state, key, T)
        again = rollout(vec, state, key, T)
    assert sorted(k[0] for k in graphs(vec.env)) == [False, True]
    after = rollout(vec, state, key, T)
    assert [k[0] for k in graphs(vec.env)] == [False]
    for out in (marked, again, after):
        for a, b in zip(plain, out):
            _same(a, b)


@pytest.mark.cuda
def test_no_profiler_builds_or_launches_a_mark(dev, monkeypatch):
    def refuse():
        raise AssertionError("a mark was built or launched")

    monkeypatch.setattr(trace, "_launchers", refuse)
    vec, state = _vec("maze", dev)
    key = R.key(5, dev)
    first = rollout(vec, state, key, T)  # capture and replay
    _same(first, rollout(vec, state, key, T))
    vec.step(state, torch.zeros(N, dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    assert [k[0] for k in graphs(vec.env)] == [False]
