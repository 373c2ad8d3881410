"""Readings of the comparison that decides `correct` under the control or
a planted fault, at a cell's own size, on several seeds in one process.

    python benchmark/tools/control.py --workload <name> --seeds 1 2 3 \
        --seconds 3 [--fault stale|half|altered]

Without --fault the system is the control: the plain reference in the
program's place at the lower precision (`reference/precision.py`). Each
seed prints one JSON line: the seed, `correct` and the checks' numbers.
"""
import argparse
import json
import pathlib
import sys

sys.path[0] = str(pathlib.Path(__file__).resolve().parents[2])

from benchmark import faults, harness, spec  # noqa: E402


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--fault", choices=sorted(faults.FAULTS))
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    cell = spec.cell(args.workload)
    cell.traffic["warmup_s"] = 0  # the control is compared, not timed
    system = faults.FAULTS[args.fault] if args.fault else "control"
    for seed in args.seeds:
        r = harness.run_cell(cell, seed, args.seconds, False,
                             device=args.device, system=system)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "system": args.fault or "control",
                          "correct": r["correct"], "calls": r["attempted"],
                          "checks": {k: v["value"]
                                     for k, v in r["checks"].items()},
                          "parts": r["run"]["check_parts"]}),
              flush=True)


if __name__ == "__main__":
    main()
