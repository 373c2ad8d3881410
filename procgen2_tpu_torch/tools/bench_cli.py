"""Per-game throughput benchmark (procgen2_tpu/tools/bench_cli.py).

The unit of work is the learner's loop, `dist.rollout`: T = 8 steps of
a batch of auto-resetting envs with on-device random actions and the
observations written into a uint8 [T, N, 64, 64, 3] buffer; on a card
the T steps are one CUDA graph, replayed. A checksum of the obs is read
back after the iterations, which waits for the device. Reported as
env-steps/s, with levels/s from a second `generate_bank`.

Run on a card:  python -m procgen2_tpu_torch.tools.bench_cli   # all games
                python -m procgen2_tpu_torch.tools.bench_cli chaser --num-envs 8192
"""
from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import subprocess
import time
from types import SimpleNamespace

import torch


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def bench_game(game: str, num_envs: int = 4096, num_levels: int = 1024,
               T: int = 8, iters: int = 20, profile_dir: str | None = None,
               device="cuda", **config) -> dict:
    """env-steps/s of `iters` rollouts of T steps (after one that
    captures the graph), and levels/s of a second `generate_bank`. A
    quick reading per game: the judged numbers of the port are the
    benchmark's cells (`benchmark/`, BENCHMARK.json)."""
    from .. import make
    from .. import random as prng
    from ..dist import rollout

    env = make(game, device=device, **config)
    dev = env.device
    bank = env.generate_bank(prng.key(0, dev), num_levels=num_levels)
    state, _ = env.reset(bank, prng.key(1, dev), num_envs=num_envs)
    vec = SimpleNamespace(env=env, bank=bank)

    def run(state, k):
        k, sub = prng.split(k).unbind(-2)
        state, buf = rollout(vec, state, sub, T)
        # the checksum keeps the obs a result the host waits for
        return state, k, buf.obs[::4].sum(dtype=torch.int32)

    state, k, chk = run(state, prng.key(2, dev))  # capture + first run
    int(chk)

    _sync(dev)
    t_gen0 = time.perf_counter()
    env.generate_bank(prng.key(3, dev), num_levels=num_levels)
    _sync(dev)
    t_gen = time.perf_counter() - t_gen0

    trace = contextlib.nullcontext()
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        trace = profile(activities=acts)
    with trace as prof:
        start = time.perf_counter()
        for _ in range(iters):
            state, k, chk = run(state, k)
        int(chk)  # a host read of the last checksum waits for the device
        elapsed = time.perf_counter() - start
    if profile_dir:
        pathlib.Path(profile_dir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(pathlib.Path(profile_dir)
                                     / f"{game}.json"))

    return dict(game=game, num_envs=num_envs,
                env_steps_per_s=num_envs * T * iters / elapsed,
                levelgen_per_s=num_levels / t_gen, seconds=elapsed)


def hardware() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main(argv=None):
    from .. import GAMES

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("game", nargs="?", default=None)
    parser.add_argument("--num-envs", type=int, default=4096)
    parser.add_argument("--num-levels", type=int, default=1024)
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--device", default="cuda")
    parser.add_argument(
        "--profile", metavar="DIR", default=None,
        help="write a torch.profiler trace of the timed loop to "
             "DIR/<game>.json (chrome://tracing, Perfetto)")
    parser.add_argument(
        "--out", metavar="FILE", default=None,
        help="also write the results as one JSON document (a machine-"
             "readable per-game record: steps/s, batch, date, commit, card)")
    args = parser.parse_args(argv)

    games = [args.game] if args.game else list(GAMES)
    results = []
    for g in games:
        r = bench_game(g, num_envs=args.num_envs, num_levels=args.num_levels,
                       iters=args.iters, profile_dir=args.profile,
                       device=args.device)
        print(json.dumps(r), flush=True)
        results.append(r)
    if args.out:
        import datetime

        root = pathlib.Path(__file__).resolve().parents[2]
        try:
            commit = subprocess.run(
                ["git", "rev-parse", "--short", "HEAD"], capture_output=True,
                text=True, cwd=root).stdout.strip() or "unknown"
        except OSError:
            commit = "unknown"
        doc = dict(
            date=datetime.date.today().isoformat(), commit=commit,
            hardware=(hardware() if torch.device(args.device).type == "cuda"
                      else "cpu"),
            obs="rendered 64x64 uint8 HWC, written to a [T, N, 64, 64, 3] "
                "buffer on the device",
            games=results)
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")


if __name__ == "__main__":
    main()
