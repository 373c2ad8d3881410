"""BENCHMARK.json and the files it names.

A cell (an entry of `workloads`) names a configuration, whose file holds
the game, its Config kwargs and the batch, and a traffic mix, whose file
is `benchmark/traffic/<traffic>.json`. A per-layer metric is read by
`benchmark/metrics/<name>.py`. New cells, mixes and metrics are new files
and entries; nothing here names one of them.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import re

ROOT = pathlib.Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@dataclasses.dataclass
class Cell:
    name: str
    config: dict  # the configuration's file
    traffic: dict  # the traffic mix's file
    chips: int
    end_to_end: list  # the spec's end-to-end metrics this cell reports
    per_layer: list  # the spec's per-layer metrics this cell reports


def load_spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def reports(metric: dict, cell: str) -> bool:
    """Whether `cell` reports `metric` (every cell, where it lists none)."""
    return cell in metric.get("workloads", [cell])


def cell(name: str) -> Cell:
    spec = load_spec()
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(work)})")
    w = work[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    traffic_file = ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json"
    return Cell(
        name=name, config=json.loads((ROOT / conf["file"]).read_text()),
        traffic=json.loads(traffic_file.read_text()),
        chips=int(w["chips"]),
        end_to_end=[m for m in spec["end_to_end"] if reports(m, name)],
        per_layer=[m for m in spec["per_layer"] if reports(m, name)])


def reader(metric: str):
    """The module `benchmark/metrics/<metric>.py`, which defines
    `read(run) -> float | None` (None: nothing to read in this run) and
    may define `prepare(run)`, called before the reference runs."""
    path = ROOT / "benchmark" / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod
