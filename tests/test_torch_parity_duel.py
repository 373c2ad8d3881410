"""Bossfight's boss kill on the reference's levels, on the port
(tests/test_parity_scripted.py::test_bossfight_scripted_boss_kill_return_parity,
on procgen2_tpu_torch on the CPU; a file of its own for its length: the
duel runs up to 1,500 steps)."""
import shutil

import numpy as np
import pytest

import procgen2_tpu_torch as pt
from procgen2_tpu_torch.tools import predict
from procgen2_tpu_torch.tools.reference_levels import host_level, reference_bank
from procgen2_tpu_torch.tools.reference_play import play
from torch_threads import one_torch_thread  # noqa: F401


pytestmark = [
    pytest.mark.skipif(
        shutil.which("g++") is None, reason="no C++ toolchain (the oracle)"
    ),
    pytest.mark.usefixtures("one_torch_thread"),
]

f32 = np.float32
BOSSFIGHT_KILL_SEEDS = [0, 1, 2, 4, 5, 6, 8, 9, 10, 11]


def test_bossfight_scripted_boss_kill_return_parity():
    """Closed-loop duel through the full phase machine: hide in a
    barrier's shadow while shielded, volley while unshielded, 3 HP x 3
    rounds -> phase_index 6; exactly one scoring step, the terminal
    +10.0f, zero everywhere else (common_systems.cpp:199-287, 385-386).
    Easy mode (half bullet speed, common_systems.cpp:104) — level
    layouts are mode-independent. The predictor re-simulates the whole
    duel from the action log and the post-reset keys."""
    seeds = BOSSFIGHT_KILL_SEEDS
    env = pt.make("bossfight", device="cpu", mode="easy")
    bank = reference_bank("bossfight", seeds, "cpu")
    levels = [host_level(bank, i) for i in range(len(seeds))]
    out = play(env, bank, seeds, game="bossfight", levels=levels,
               max_steps=1500)
    R, D, A = out["rewards"], out["dones"], out["actions"]
    ends = []
    for i, seed in enumerate(seeds):
        d = D[:, i]
        assert d.any(), f"seed {seed}: boss survived"
        end = int(np.argmax(d))
        assert R[end, i] == f32(10.0), f"seed {seed}: end {R[end, i]}"
        assert not R[:end, i].any(), f"seed {seed}: stray rewards"
        assert not d[:end].any()
        ends.append(end)
    preds = predict.bossfight_predict_many(
        levels, out["keys0"], [A[: e + 1, i] for i, e in enumerate(ends)],
        mode="easy")
    for i, (seed, end) in enumerate(zip(seeds, ends)):
        pr, pt_ = preds[i]
        assert len(pr) == end + 1, f"seed {seed}: predictor ended at " \
            f"{len(pr) - 1}, engine at {end}"
        assert np.array_equal(R[: end + 1, i], pr), f"seed {seed}"
        assert pt_[-1] and not pt_[:-1].any()
