"""The port's data-parallel env across 2 real processes over gloo on the
CPU (the counterpart of tests/test_multihost.py): each process runs
tests/torch_multihost_worker.py, joins the group through
`init_multihost`, steps its half of 8 maze-easy envs 3 times, all-reduces
`metrics` and writes its rows. The two ranks' rows, concatenated, equal
the single-process run bit for bit; both ranks print the same metrics,
which equal the single process's; `local_slice` gives starts 0 and 4."""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import torch_multihost_worker as W
from procgen2_tpu_torch.dist import make_vec
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_processes_equal_one(tmp_path):
    port = str(_free_port())
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "torch_multihost_worker.py"),
         str(pid), port, str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=ROOT) for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"MHOK pid={pid}" in out and f"start={pid * 4}" in out, out

    venv = make_vec("maze", W.NUM_ENVS, num_levels=W.LEVELS, device="cpu",
                    mode="easy")
    state, ts = W.run(venv)
    want = W.rows(ts, state)
    got = [np.load(tmp_path / f"rank{pid}.npz") for pid in (0, 1)]
    assert set(got[0].files) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(
            np.concatenate([g[k] for g in got]), v, err_msg=k)

    # both ranks reduced the same metrics, the single process's
    lines = [line.split("start=")[1].split(" ", 1)[1]
             for out in outs for line in out.splitlines() if "MHOK" in line]
    m = venv.metrics(ts)
    one = " ".join(f"{k}={v.item()!r}" for k, v in sorted(m.items()))
    assert lines == [one, one], (lines, one)
