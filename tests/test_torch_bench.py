"""The port's bench (procgen2_tpu_torch/tools/bench_cli.py) runs on the
CPU at a tiny size and reports the JAX package's fields."""
import json

import pytest

from procgen2_tpu_torch.tools import bench_cli
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_bench_game_smoke():
    r = bench_cli.bench_game("maze", num_envs=4, num_levels=4, T=2, iters=2,
                             device="cpu", mode="easy")
    assert set(r) == {"game", "num_envs", "env_steps_per_s",
                      "levelgen_per_s", "seconds"}
    assert r["game"] == "maze" and r["num_envs"] == 4
    assert r["env_steps_per_s"] > 0 and r["levelgen_per_s"] > 0


def test_bench_cli_writes_its_record(tmp_path, capsys):
    out = tmp_path / "bench.json"
    bench_cli.main(["maze", "--num-envs", "2", "--num-levels", "2",
                    "--iters", "1", "--device", "cpu", "--out", str(out),
                    "--profile", str(tmp_path / "trace")])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    doc = json.loads(out.read_text())
    assert doc["games"] == [line] and doc["hardware"] == "cpu"
    assert (tmp_path / "trace" / "maze.json").exists()

