"""One run of one cell: set-up, the measured window, the traced slice, the
reference's check, the metrics and the result line.

Set-up (timed as `setup_s`, from the process's first line): imports, the
card, the system (`make_vec`), the bank and reset (`ShardedEnv.reset`),
call 0, which captures the rollout's graph, and the warm-up, the call
repeated for the mix's `warmup_s`. The window then repeats the call for
`--seconds`, each call timed on the host from its start to its host
read. With `--trace 1` a few calls from the middle of
the window run under the profiler. What the check keeps of a call is
copied to the host, with the card's peak paused (`Peak`). After the
window the peak memory is read, the system is freed, and the reference
re-runs the bank, the reset and the checked calls.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from . import check, spec, traffic
from . import trace as trace_mod
from .reference.utils.tree import tree_map
from .system import FIELDS, SYSTEMS

FORBIDDEN = ("jax", "jaxlib", "flax", "procgen2_tpu")  # top-level names


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile (the smallest value with at least
    q% of the values at or below it)."""
    v = sorted(values)
    return v[max(0, math.ceil(q / 100 * len(v)) - 1)]


class Reservoir:
    """k of the window's calls, each kept with equal chance (algorithm R),
    drawn from the seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.seen, self.items = k, 0, {}
        self.rng = np.random.default_rng(int(seed) & (2 ** 64 - 1))

    def offer(self) -> int | None:
        """The slot the next call takes, or None if it is not kept."""
        self.seen += 1
        if len(self.items) < self.k:
            return len(self.items)
        j = int(self.rng.integers(0, self.seen))
        return j if j < self.k else None


class Peak:
    """The card's peak of allocated bytes over the run, with the check's
    own work left out: it runs paused (its checksums, and its copies of a
    kept call's states and fields to the host), and so does the profiled
    slice, whose calls stay whole on the card until the profiler stops.
    Outside a pause the check holds nothing on the card, so the peak is
    the program's with the harness's loop around it."""

    def __init__(self, dev):
        self.dev, self.on, self.best = dev, dev.type == "cuda", 0
        self.resume()

    def pause(self):
        if self.on:
            self.best = max(self.best,
                            torch.cuda.max_memory_allocated(self.dev))

    def resume(self):
        if self.on:
            torch.cuda.reset_peak_memory_stats(self.dev)

    @contextlib.contextmanager
    def paused(self):
        self.pause()
        try:
            yield
        finally:
            self.resume()

    def read(self) -> int:
        self.pause()
        return self.best


def to_host(tree):
    """Copies of a tree's tensors on the host, in pinned memory, queued on
    the card's stream: the card's tensors can go at once, and the copies
    are whole by the next sync (each call's host read)."""
    return tree_map(lambda x: x.to("cpu", non_blocking=True)
                    if isinstance(x, torch.Tensor) else x, tree)


def held_bytes(checked) -> int:
    """Bytes of what the check keeps of its calls (on the host)."""
    return sum(t.numel() * t.element_size()
               for c in checked
               for t in [*check.flatten(c.before).values(),
                         *check.flatten(c.after).values(),
                         *c.fields.values(), c.obs_sums])


class Run:
    """What the per-layer readers read: the host spans (seconds), the
    traced slice, the traffic mix, room of their own (`scratch`), and
    hooks around the reference's re-run of the profiled calls."""

    def __init__(self, cell):
        self.traffic = cell.traffic
        self.spans: dict = {}
        self.trace = None
        self.profiled_hooks: list = []
        self.scratch: dict = {}

    def span(self, name, seconds):
        self.spans.setdefault(name, []).append(seconds)

    def during_profiled(self, hook):
        """`hook()` gives a context manager that the reference's re-run of
        the profiled calls runs inside."""
        self.profiled_hooks.append(hook)


def _power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else None
    except (OSError, subprocess.SubprocessError):
        return None


def run_cell(cell, seed: int, seconds: float, trace: bool, device="cuda",
             system="port", t0=None):
    """One run; returns the result's dict (with `checks` last)."""
    t0 = time.perf_counter() if t0 is None else t0
    t_entry = time.perf_counter()
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    cfg, mix = cell.config, cell.traffic
    run = Run(cell)
    readers = {m["name"]: spec.reader(m["name"]) for m in cell.per_layer}

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    peak = Peak(dev)
    keys = traffic.Keys(seed, dev)
    sys_ = SYSTEMS[system](cfg, dev) if isinstance(system, str) \
        else system(cfg, dev)
    run.span("system", time.perf_counter() - t_entry)
    n_envs, T = cfg["num_envs"], int(mix["steps_per_call"])
    from .reference.env import Env
    n_actions = Env(cfg["game"], cfg["config"], 1, 1, "cpu").num_actions
    call = traffic.make_call(mix, sys_, n_envs, n_actions)
    read = traffic.make_read(mix)

    # set-up: bank and reset, then call 0 (the graph's capture)
    sync()
    t = time.perf_counter()
    state, obs0 = sys_.reset(keys.reset)
    sync()
    run.span("reset", time.perf_counter() - t)
    with peak.paused():
        reset_state = to_host(state)
        reset_sums = to_host(check.frame_sums(obs0[None]))
    del obs0

    def keep(index, before, after, buf, profiled=False):
        """What the check keeps of a call, copied to the host; the caller
        pauses the peak."""
        return check.Checked(
            index=index, key=keys.call(index),
            before=None if before is None else to_host(before),
            after=to_host(after),
            fields=to_host({f: getattr(buf, f) for f in FIELDS[1:]}),
            obs_sums=to_host(check.frame_sums(buf.obs)), profiled=profiled)

    t = time.perf_counter()
    after, buf = call(state, keys.call(0))
    read(buf)
    sync()
    run.span("call.first", time.perf_counter() - t)
    with peak.paused():
        checked_first = keep(0, None, after, buf)
    state, buf = after, None

    # the device runs the first seconds of a run slower (PERF.md): the
    # call repeats for `warmup_s` before the window
    c, t = 0, time.perf_counter()
    while time.perf_counter() - t < float(mix["warmup_s"]):
        c += 1
        state, buf = call(state, keys.call(c))
        read(buf)
        buf = None
    run.span("warmup", time.perf_counter() - t)
    reservoir = Reservoir(int(mix["check_calls"]), seed)
    profiled: list = []
    n_profile = int(mix["profile_calls"]) if trace else 0
    prof = None
    gc.collect()

    # the window
    call_s, episodes, c0, keep_s = [], 0, c, 0.0
    t_start = t_end = time.perf_counter()
    setup_s = t_start - t0
    while True:
        now = time.perf_counter()
        profiling = prof is not None and len(profiled) < n_profile
        if now - t_start >= seconds and not profiling:
            break
        c += 1
        key = keys.call(c)
        warm = False
        if n_profile and prof is None and now - t_start >= seconds / 2:
            # the profiler starts, and one call runs under it unmarked, so
            # that its own warm-up falls outside the slice
            from torch.profiler import ProfilerActivity, profile
            sync()
            peak.pause()  # until the profiled calls are on the host
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
            warm = True
        marked = not warm and profiling
        slot = None if (warm or marked) else reservoir.offer()
        ctx = (torch.profiler.record_function if marked
               else lambda _: contextlib.nullcontext())
        t = time.perf_counter()
        with ctx(trace_mod.CALL):
            after, buf = call(state, key)
        t_host = time.perf_counter()
        with ctx(trace_mod.READ):
            episodes += read(buf)
        t_end = time.perf_counter()
        call_s.append(t_end - t)
        if prof is None:
            run.span("call.host", t_host - t)
        if marked:
            # held whole: their checksums run once the profiler has stopped
            profiled.append((c, state, after, buf))
            if len(profiled) == n_profile:
                sync()
                prof.__exit__(None, None, None)
                profiled = [keep(*p, profiled=True) for p in profiled]
                peak.resume()
        elif slot is not None:
            t = time.perf_counter()
            with peak.paused():
                reservoir.items[slot] = keep(c, state, after, buf)
            keep_s += time.perf_counter() - t
        state, buf = after, None
    window_s = t_end - t_start
    sync()
    peak_bytes = peak.read()

    # the program is freed before the reference runs
    bank = sys_.bank
    del sys_, call, state, after
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of the JAX package loaded: {found}")

    t_after = time.perf_counter()
    if prof is not None:
        run.trace = trace_mod.reduce(prof.profiler.kineto_results.events(),
                                     n_profile, n_profile * T)
    for r in readers.values():
        if hasattr(r, "prepare"):
            r.prepare(run)
    checked = [checked_first, *reservoir.items.values(), *profiled]
    held = held_bytes(checked)
    diffs, parts, failed = check.compare(cfg, mix, dev, keys.reset, bank,
                                  reset_state, reset_sums, checked,
                                  run.profiled_hooks)
    del bank, reset_state, checked, checked_first, profiled
    check_s = time.perf_counter() - t_after
    correct = all(diffs[k] <= lim for k, lim in check.LIMITS.items())

    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    values, calls = {}, c - c0
    if not trace:
        values = {
            "setup_s": setup_s,
            "env_steps_per_s": n_envs * T * calls / window_s,
            "call_p95_ms": percentile(call_s, 95) * 1e3,
            "peak_device_mib": peak_bytes / 2 ** 20 if on_card else None,
        }
        values = {k: v for k, v in values.items() if k in units}
    else:
        for name, r in readers.items():
            values[name] = r.read(run)
    metrics = {k: {"value": v, "unit": units[k]}
               for k, v in values.items() if v is not None}

    result = {"correct": bool(correct), "attempted": calls, "failed": failed,
              "metrics": metrics}
    result["device"] = {"platform": "gpu" if on_card else dev.type,
                        "kind": (torch.cuda.get_device_name(dev)
                                 if on_card else "cpu"),
                        "count": 1, "memory_peak_bytes": int(peak_bytes)}
    if trace and run.trace is not None:
        s = run.trace
        result["device"].update(busy_s=s.busy_us / 1e6,
                                window_s=s.window_us / 1e6)
        result["breakdown"] = {
            "device_ops": [[n, v] for n, v in s.device_ops],
            "idle_gaps": [[n, v] for n, v in s.idle_gaps]}
    result["run"] = {"window_s": window_s, "calls": calls, "check_s": check_s,
                     "call_ms": {"min": min(call_s) * 1e3,
                                 "p50": statistics.median(call_s) * 1e3,
                                 "max": max(call_s) * 1e3},
                     "setup_parts_s": {
                         "imports": t_entry - t0,
                         **{k: run.spans[k][0] for k in
                            ("system", "reset", "call.first", "warmup")}},
                     "episodes": episodes, "seed": seed,
                     "keep_s": keep_s, "held_host_bytes": held,
                     "card": _power_limit() if on_card else None}
    result["run"]["check_parts"] = parts
    result["checks"] = {k: {"value": diffs[k], "limit": lim}
                        for k, lim in check.LIMITS.items()}
    return result


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t0) -> int:
    args = parse(argv)
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs only on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, torch sees "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      t0=t0)
    found = forbidden_modules()
    if found:
        print(f"modules of the JAX package loaded: {found}", file=sys.stderr)
        return 3
    for name, v in result["checks"].items():
        print(f"check {name}: {v['value']} (limit {v['limit']})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
