"""Count the top-level ATen ops of one `Environment.step` of each game of
the PyTorch port, on the CPU: how many separate ops (on the card, kernel
launches and their host overhead) a step issues. A count, not a time.
With `--render SIZE`, count those of one `Environment.render(state,
SIZE)` (the exact render of one env, after 6 steps) instead.

    PYTHONPATH=. python scripts/torch_step_ops.py [--envs 64] [--render 512] [games ...]
"""
import argparse

import torch
from torch.profiler import ProfilerActivity, profile

import procgen2_tpu_torch as pt

CONFIGS = {"maze": {"mode": "easy"}}  # the bench's maze; others: defaults


def step_ops(game, n_envs, render=0):
    env = pt.make(game, device="cpu", **CONFIGS.get(game, {}))
    bank = env.generate_bank(pt.random.key(0), 64)
    state, _ = env.reset(bank, pt.random.key(1), n_envs)
    action = torch.randint(0, 15, (n_envs,), dtype=torch.int32)
    for _ in range(6 if render else 1):  # warm up
        state, _ = env.step(bank, state, action)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if render:
            env.render(state, render, 0)
        else:
            env.step(bank, state, action)
    return sum(1 for e in prof.events() if e.name.startswith("aten::")
               and (e.cpu_parent is None
                    or not e.cpu_parent.name.startswith("aten::")))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--envs", type=int, default=64)
    ap.add_argument("--render", type=int, default=0, metavar="SIZE",
                    help="count one Environment.render at SIZE px instead")
    ap.add_argument("games", nargs="*", default=list(pt.GAMES))
    args = ap.parse_args()
    what = (f"Environment.render at {args.render} px" if args.render
            else f"env.step at {args.envs} envs")
    for game in args.games:
        print(f"{game}: {step_ops(game, args.envs, args.render)} top-level "
              f"ATen ops per {what}")


if __name__ == "__main__":
    main()
