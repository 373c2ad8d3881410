"""The comparison that decides `correct` fails where it must: under the
control (the plain reference in the program's place, one precision step
below the configuration's) and under each fault a cell can have, planted
under the program, with the rest of a run as the harness drives it (on
the CPU, at a tiny size; the look for a card is skipped)."""
import pytest

from benchmark import faults, harness, spec

WORKLOADS = [w["name"] for w in spec.load_spec()["workloads"]]
SEED = 3_000_000_019


def _run(workload, system, seconds=0.3):
    cell = spec.cell(workload)
    cell.config.update(num_envs=6, num_levels=4)
    cell.traffic.update(warmup_s=0.0)
    return harness.run_cell(cell, SEED, seconds, False, device="cpu",
                            system=system)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_program_is_correct(workload):
    r = _run(workload, "port")
    assert r["correct"] and r["failed"] == 0


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_is_not_correct(workload):
    r = _run(workload, "control")
    assert not r["correct"]
    checks = {k: v["value"] for k, v in r["checks"].items()}
    assert checks["obs_frames"] > 0 and checks["state_elements"] > 0


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("workload", WORKLOADS)
def test_each_fault_is_not_correct(workload, fault):
    r = _run(workload, faults.FAULTS[fault])
    assert not r["correct"] and r["failed"] > 0
