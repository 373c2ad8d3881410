"""Deliberately fatal scripted runs on the port: exact death-step parity
(tests/test_parity_fatal.py, on procgen2_tpu_torch on the CPU).

Each game runs trajectories chosen to DIE on the reference's own levels
— walking into saws/spikes/mobs/meteors — and the exact termination
step and the 0.0 terminal reward are asserted:

  * coinrun / jumper: the death step is independently predicted by the
    scalar numpy re-simulations in tools/predict (mob patrols, spike
    boxes), compared with exact f32 equality.
  * chaser / climber / caveflyer: enemies are simulated only by the
    engine, so the death steps are the JAX suite's pinned constants
    (regression locks measured from the deterministic engine, reset key
    123); the port must die on the same steps. The *semantics* — death
    yields no reward and terminates (chaser.cpp:296-312,
    climber.cpp:339-355, caveflyer.cpp:317-332) — are asserted directly,
    plus state evidence that the agent overlaps a live hazard at the
    recorded death step.

maze has no hazards (maze.cpp:49, 308-310).
"""
import shutil

import numpy as np
import pytest

import procgen2_tpu_torch as pt
from procgen2_tpu_torch.games.chaser import HATCH_TIME
from procgen2_tpu_torch.tools import bots, predict
from procgen2_tpu_torch.tools.reference_levels import host_level, reference_bank
from procgen2_tpu_torch.tools.reference_play import pad, play
from torch_threads import one_torch_thread  # noqa: F401


pytestmark = [
    pytest.mark.skipif(
        shutil.which("g++") is None, reason="no C++ toolchain (the oracle)"
    ),
    pytest.mark.usefixtures("one_torch_thread"),
]

f32 = np.float32
RIGHT, NOOP, JUMP_R = bots.RIGHT, bots.NOOP, 8


def _run_script(env, bank, seeds, actions, max_steps):
    """All lanes follow the same open-loop action list for max_steps."""
    out = play(env, bank, seeds, pad([actions] * len(seeds), max_steps),
               keep_states=True)
    return out["rewards"], out["dones"], out["states"]


def _assert_predicted_death(R, D, pr, pt_, seed, i):
    assert D[:, i].any(), f"seed {seed}: survived"
    end = int(np.argmax(D[:, i]))
    assert R[end, i] == f32(0.0), f"seed {seed}: death reward {R[end, i]}"
    assert not R[:end, i].any(), f"seed {seed}: stray rewards"
    assert len(pr) == end + 1, (
        f"seed {seed}: predictor death at {len(pr) - 1}, engine at {end}"
    )
    assert np.array_equal(R[: end + 1, i], pr), f"seed {seed}"
    assert pt_[-1] and not pt_[:-1].any()


# ---------------------------------------------------------------------------
# coinrun: jump-right spam lands in saw/lava/mob hazards
# ---------------------------------------------------------------------------

COINRUN_FATAL_SEEDS = [3, 6, 8, 10, 15, 16, 20, 23, 24, 25, 28, 29]


def test_coinrun_fatal_death_step_parity():
    """Blind jump-right runs die on the first hazard; death pays 0.0 and
    terminates (coinrun.cpp:357-371). Exact step from CoinrunSim."""
    env = pt.make("coinrun", device="cpu")
    bank = reference_bank("coinrun", COINRUN_FATAL_SEEDS, "cpu")
    acts = [JUMP_R] * 300
    R, D, _ = _run_script(env, bank, COINRUN_FATAL_SEEDS, acts, 150)
    for i, seed in enumerate(COINRUN_FATAL_SEEDS):
        pr, pt_ = predict.coinrun_predict(host_level(bank, i), acts)
        _assert_predicted_death(R, D, pr, pt_, seed, i)


# ---------------------------------------------------------------------------
# jumper: blind right walk into ground spikes
# ---------------------------------------------------------------------------

JUMPER_FATAL_SEEDS = [3, 6, 7, 16, 17, 27, 36, 37, 39, 43, 52, 53]


def test_jumper_fatal_death_step_parity():
    """Walking right into a spike cell terminates with 0.0
    (jumper.cpp:362-364). Exact step from JumperSim (spike rects at cell
    centers, common_systems.cpp:149-162)."""
    env = pt.make("jumper", device="cpu", mode="easy")
    bank = reference_bank("jumper", JUMPER_FATAL_SEEDS, "cpu")
    acts = [RIGHT] * 300
    R, D, _ = _run_script(env, bank, JUMPER_FATAL_SEEDS, acts, 30)
    for i, seed in enumerate(JUMPER_FATAL_SEEDS):
        pr, pt_ = predict.jumper_predict(host_level(bank, i), acts)
        _assert_predicted_death(R, D, pr, pt_, seed, i)


# ---------------------------------------------------------------------------
# chaser / climber / caveflyer: the JAX suite's pinned death steps
# ---------------------------------------------------------------------------

CHASER_FATAL = [  # easy mode, NOOP agent eaten by a patrolling enemy
    (0, 56), (2, 118), (3, 126), (6, 88), (7, 50), (8, 69),
    (9, 50), (10, 60), (11, 102), (12, 86),
]


def _np(x, i):
    return x[i].cpu().numpy()


def test_chaser_fatal_enemy_contact():
    """Enemy contact with eat_timer==0 terminates with reward 0.0
    (chaser.cpp:296-312)."""
    seeds = [s for s, _ in CHASER_FATAL]
    env = pt.make("chaser", device="cpu", mode="easy")
    bank = reference_bank("chaser", seeds, "cpu")
    R, D, states = _run_script(env, bank, seeds, [NOOP] * 200, 200)
    for i, (seed, step_pin) in enumerate(CHASER_FATAL):
        assert D[:, i].any(), f"seed {seed}: survived"
        end = int(np.argmax(D[:, i]))
        assert end == step_pin, f"seed {seed}: died at {end} != {step_pin}"
        assert R[end, i] == f32(0.0)
        assert not R[:end, i].any()  # stationary agent scores nothing
        gs = states[end].game
        pos = _np(gs.pos, i)
        mob_pos = _np(gs.mob_pos, i)
        hatched = _np(gs.hatch_timer, i) >= HATCH_TIME
        overlap = hatched & (
            (np.abs(mob_pos[:, 0] - pos[0]) < 1.0)
            & (np.abs(mob_pos[:, 1] - pos[1]) < 1.0)
        )
        assert overlap.any(), f"seed {seed}: no enemy at death position"
        assert _np(gs.eat_timer, i) == 0.0


CLIMBER_FATAL = [  # hard mode, blind jump-right into patrol mobs
    (1, 24), (3, 47), (4, 100), (5, 115), (7, 43), (8, 20),
    (9, 41), (10, 14), (14, 78), (15, 9), (17, 27), (19, 71),
]


def test_climber_fatal_mob_contact():
    """Flying-mob contact terminates with reward 0.0
    (climber.cpp:339-355; mob bounds (-0.4,-0.4,0.8,0.8) vs agent
    (-0.5,-1,1,1), common_systems.cpp:146-153)."""
    seeds = [s for s, _ in CLIMBER_FATAL]
    env = pt.make("climber", device="cpu", easy_mode=False)
    bank = reference_bank("climber", seeds, "cpu", easy_mode=False)
    R, D, states = _run_script(env, bank, seeds, [JUMP_R] * 150, 150)
    for i, (seed, step_pin) in enumerate(CLIMBER_FATAL):
        assert D[:, i].any(), f"seed {seed}: survived"
        end = int(np.argmax(D[:, i]))
        assert end == step_pin, f"seed {seed}: died at {end} != {step_pin}"
        assert R[end, i] == f32(0.0), f"seed {seed}: {R[end, i]}"
        # crystals may be collected en route (+1 each), never +10
        assert all(v in (f32(0.0), f32(1.0), f32(2.0)) for v in R[:end, i])
        gs = states[end].game
        pos = _np(gs.pos, i)
        mob_pos = _np(gs.mob_pos, i)
        mob_alive = _np(gs.level.mob_alive, i)
        overlap = mob_alive & (
            (pos[0] - 0.5 < mob_pos[:, 0] + 0.4)
            & (pos[0] + 0.5 > mob_pos[:, 0] - 0.4)
            & (pos[1] - 1.0 < mob_pos[:, 1] + 0.4)
            & (pos[1] > mob_pos[:, 1] - 0.4)
        )
        assert overlap.any(), f"seed {seed}: no mob at death position"


CAVEFLYER_FATAL = [  # hard mode, blind thrust+turn into meteors/targets
    (1, 3), (3, 1), (6, 95), (7, 95), (8, 116), (10, 115),
    (12, 95), (13, 124), (17, 11), (18, 28), (20, 14), (21, 52),
]


def test_caveflyer_fatal_hazard_contact():
    """Meteor/target/enemy contact terminates with reward 0.0
    (caveflyer.cpp:317-332; hazard rects common_systems.cpp:182-195)."""
    seeds = [s for s, _ in CAVEFLYER_FATAL]
    env = pt.make("caveflyer", device="cpu", mode="hard")
    bank = reference_bank("caveflyer", seeds, "cpu", mode="hard")
    R, D, states = _run_script(
        env, bank, seeds, [bots.UP_RIGHT] * 200, 200)
    for i, (seed, step_pin) in enumerate(CAVEFLYER_FATAL):
        assert D[:, i].any(), f"seed {seed}: survived"
        end = int(np.argmax(D[:, i]))
        assert end == step_pin, f"seed {seed}: died at {end} != {step_pin}"
        assert R[end, i] == f32(0.0), f"seed {seed}: {R[end, i]}"
        assert not R[:end, i].any(), f"seed {seed}: stray rewards"
        gs = states[end].game
        pos = _np(gs.pos, i)
        lvl = host_level(gs.level, i)

        def _rects_overlap(cx, cy, half):
            return (
                (pos[0] - 0.4 < cx + half) & (pos[0] + 0.4 > cx - half)
                & (pos[1] - 0.4 < cy + half) & (pos[1] + 0.4 > cy - half)
            )

        enemy_pos = _np(gs.enemy_pos, i)
        hit = (
            (lvl.obst_exists & _rects_overlap(
                lvl.obst_pos[:, 0], lvl.obst_pos[:, 1], 0.25)).any()
            or (_np(gs.target_alive, i) & _rects_overlap(
                lvl.target_pos[:, 0], lvl.target_pos[:, 1], 0.25)).any()
            # enemies advance within the killing sub-step after the
            # (pre-move) contact test — allow their one-sub-step drift
            or (lvl.enemy_exists & _rects_overlap(
                enemy_pos[:, 0], enemy_pos[:, 1], 0.4 + 0.2)).any()
        )
        assert hit, f"seed {seed}: no hazard at death position"
