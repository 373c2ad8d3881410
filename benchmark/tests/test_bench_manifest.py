"""BENCHMARK.json against the contract it is written to, the files it
names, and what the harness and the reference load."""
import json
import pathlib
import subprocess
import sys

import pytest

from benchmark import spec, traffic
from benchmark.reference import env as ref_env

SPEC = spec.load_spec()
ROOT = spec.ROOT
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def _names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in SPEC[group]:
            yield e["name"]
    for w in SPEC["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in SPEC["configs"]:
        yield from c["reduced"]


def test_keys_and_entries_are_the_contracts():
    assert set(SPEC) == KEYS
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 << 10


def test_names_units_and_texts_use_the_allowed_characters():
    names = list(_names())
    assert all(spec.NAME.match(n) for n in names), names
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [e["name"] for e in SPEC[group]]
        assert len(got) == len(set(got)), group
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert spec.UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    texts = ([e["why"] for e in SPEC["configs"] + SPEC["workloads"]]
             + [c["source"] for c in SPEC["configs"]]
             + [m["layer"] for m in SPEC["per_layer"]] + SPEC["command"])
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t, t


def test_every_cell_reports_what_its_metrics_move():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for w in SPEC["workloads"]:
        cell = spec.cell(w["name"])
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", [w["name"] for w in SPEC["workloads"]]):
            assert spec.reports(
                {x["name"]: x for x in SPEC["end_to_end"]}[m["moves"]], w)
    layers = {}
    for m in SPEC["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


def test_files_are_found_by_name():
    """Each cell's configuration and traffic, and each per-layer metric's
    reader, is a file of its own that the harness finds by its name."""
    for c in SPEC["configs"]:
        path = ROOT / c["file"]
        assert path.is_relative_to(ROOT / "benchmark")
        conf = json.loads(path.read_text())
        assert conf["reduced"] == c["reduced"] == []
        assert {"game", "config", "num_envs", "num_levels", "source",
                "assumed"} <= set(conf)
    assert len({c["file"] for c in SPEC["configs"]}) == len(SPEC["configs"])
    for m in SPEC["per_layer"]:
        assert callable(spec.reader(m["name"]).read)


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_a_cells_game_and_call_are_modules_found_by_name(workload):
    """The game a configuration names has its reference module,
    `reference/games/<game>.py`, and the call a mix names its module,
    `calls/<call>.py`, with the program's side and the reference's."""
    cell = spec.cell(workload)
    game = ref_env.game_module(cell.config["game"])
    assert game.__name__ == f"benchmark.reference.games.{cell.config['game']}"
    for fn in ("Config", "generate", "reset", "step", "observe_batch",
               "action_space"):
        assert hasattr(game, fn), fn
    call = traffic.call_module(cell.traffic)
    assert call.__name__ == f"benchmark.calls.{cell.traffic['call']}"
    assert callable(call.program) and callable(call.reference)
    assert callable(traffic.make_read(cell.traffic))


def test_a_full_check_fits_its_time_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_four_chip_cells_are_few():
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)


_LOADED = """
import sys
sys.path.insert(0, {root!r})
{imports}
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def _top_level_after(imports):
    out = subprocess.run(
        [sys.executable, "-c", _LOADED.format(root=str(ROOT),
                                              imports=imports)],
        capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]
                          .replace("'", '"')))


FORBIDDEN = {"jax", "jaxlib", "flax", "procgen2_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    mods = ["env", "precision", "games.maze", "games.coinrun",
            "render.scene_kernel", "render.stamp_kernel"]
    loaded = _top_level_after("\n".join(
        f"import benchmark.reference.{m}" for m in mods))
    assert not loaded & (FORBIDDEN | {"procgen2_tpu_torch"})


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_a_run_loads_nothing_of_the_jax_package(workload):
    """A whole run of the cell (on the CPU, at a tiny size) loads nothing
    whose top-level name, compared whole, is jax, jaxlib, flax or
    procgen2_tpu; procgen2_tpu_torch, which begins with it, is loaded."""
    loaded = _top_level_after(f"""
from benchmark import harness, spec
cell = spec.cell({workload!r})
cell.config.update(num_envs=4, num_levels=3)
cell.traffic.update(warmup_s=0.0)
r = harness.run_cell(cell, 2 ** 31 + 5, 0.2, True, device="cpu")
assert r["correct"], r
""")
    assert "procgen2_tpu_torch" in loaded
    assert not loaded & FORBIDDEN
