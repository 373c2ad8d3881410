"""Count the top-level ATen ops of one `Environment.step` of each game of
the PyTorch port, on the CPU: how many separate ops (on the card, kernel
launches and their host overhead) a step issues. A count, not a time.

    PYTHONPATH=. python scripts/torch_step_ops.py [--envs 64] [games ...]
"""
import argparse

import torch
from torch.profiler import ProfilerActivity, profile

import procgen2_tpu_torch as pt

CONFIGS = {"maze": {"mode": "easy"}}  # the bench's maze; others: defaults


def step_ops(game, n_envs):
    env = pt.make(game, device="cpu", **CONFIGS.get(game, {}))
    bank = env.generate_bank(pt.random.key(0), 64)
    state, _ = env.reset(bank, pt.random.key(1), n_envs)
    action = torch.randint(0, 15, (n_envs,), dtype=torch.int32)
    state, _ = env.step(bank, state, action)  # warm up
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        env.step(bank, state, action)
    return sum(1 for e in prof.events() if e.name.startswith("aten::")
               and (e.cpu_parent is None
                    or not e.cpu_parent.name.startswith("aten::")))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--envs", type=int, default=64)
    ap.add_argument("games", nargs="*", default=list(pt.GAMES))
    args = ap.parse_args()
    for game in args.games:
        print(f"{game}: {step_ops(game, args.envs)} top-level ATen ops per "
              f"env.step at {args.envs} envs")


if __name__ == "__main__":
    main()
