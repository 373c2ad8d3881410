"""Caveflyer and jumper in `memory` mode (45 x 45 worlds, the camera on
the agent; jumper's maze unpruned and without spikes), each main path
against the JAX package's, bitwise (tests/mode_parity.py): bank, reset,
8 steps with a goal lane (and caveflyer's hazard lane) ending on the
first, every state, reward, termination, info and frame, the JAX render
on its TPU path (B1's kernel, and jumper's needle through B3's, in
interpret mode)."""
import pytest

from mode_parity import env_run
from mode_parity import (test_bank_and_reset_match,  # noqa: F401
                         test_placed_lanes_end_and_restart, test_step_matches)
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module", params=["caveflyer memory", "jumper memory"])
def run(request):
    return env_run(request.param)
