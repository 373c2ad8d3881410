"""On the card: one short run of each cell through the harness, traced,
and the control at the cell's own size. Marked `cuda`; skips where torch
sees no card (python -m pytest benchmark/tests -m cuda, on the card)."""
import pytest
import torch

from benchmark import harness, spec

WORKLOADS = [w["name"] for w in spec.load_spec()["workloads"]]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_traced_run_on_the_card(workload):
    _card()
    cell = spec.cell(workload)
    r = harness.run_cell(cell, 2 ** 31 + 3, 4.0, True)
    assert r["correct"], r["checks"]
    dev = r["device"]
    assert dev["platform"] == "gpu" and 0 < dev["busy_s"] <= dev["window_s"]
    assert {m["name"] for m in cell.per_layer} <= set(r["metrics"])


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_fails_at_the_cells_size(workload):
    _card()
    r = harness.run_cell(spec.cell(workload), 2 ** 31 + 4, 2.0, False,
                         system="control")
    assert not r["correct"]
