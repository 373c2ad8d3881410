"""Scripted bit-exact return parity of the port for the non-maze games
(tests/test_parity_scripted.py, on procgen2_tpu_torch on the CPU).

For each game, the reference's own levels (the port's oracle and
tools/reference_levels) are played by scripted/bot trajectories that
*score*, and the port's per-step reward/termination sequence is
asserted against the reference's reward rules — re-derived from the
layout by an independent predictor where the game's kinematics permit
(tools/bots.py, tools/predict.py), or as exact event values/counts/order
where the trajectory is found by a closed-loop bot. The seeds, modes,
step caps and the pinned reset key (123) are the JAX suite's.

Reward-rule citations per game:
  chaser    +0.04/point, +10 all collected   chaser.cpp:307-309
  climber   +1/crystal, +10 all collected    climber.cpp:348-350
  coinrun   +10 coin                         coinrun.cpp:357-371
  jumper    +10 carrot                       jumper.cpp:362-364
  caveflyer +3/target, +10 goal              caveflyer.cpp:330-332
  bossfight -10 death                        bossfight.cpp:318-320
The bossfight boss kill (+10) runs in tests/test_torch_parity_duel.py.
"""
import shutil

import numpy as np
import pytest

import procgen2_tpu_torch as pt
from procgen2_tpu_torch.tools import bots, predict
from procgen2_tpu_torch.tools.reference_levels import host_level, reference_bank
from procgen2_tpu_torch.tools.reference_play import chaser_plan, pad, play
from torch_threads import one_torch_thread  # noqa: F401


pytestmark = [
    pytest.mark.skipif(
        shutil.which("g++") is None, reason="no C++ toolchain (the oracle)"
    ),
    pytest.mark.usefixtures("one_torch_thread"),
]

f32 = np.float32


def _levels(bank, n):
    return [host_level(bank, i) for i in range(n)]


# ---------------------------------------------------------------------------
# chaser: full clear — every pellet (+0.04 each), orbs, completion +10
# ---------------------------------------------------------------------------

# Most scripted routes END IN ENEMY CONTACT (enemies re-decide every
# sub-step, games/chaser.py:_mob_substep): economy parity is asserted as
# exact prefixes up to death; CHASER_CLEAR_SEEDS are the rare full clears.
CHASER_SEEDS = [5, 17, 20, 21, 28, 34, 35, 36, 43, 46, 59, 71, 83, 84, 88]
CHASER_CLEAR_SEEDS = [119, 137, 261]


def test_chaser_scripted_full_clear_return_parity():
    env = pt.make("chaser", device="cpu", mode="easy")
    bank = reference_bank("chaser", CHASER_SEEDS, "cpu")

    acts, preds = [], []
    for i, seed in enumerate(CHASER_SEEDS):
        lvl = host_level(bank, i)
        a = chaser_plan(lvl)
        rew, term = bots.chaser_predict(lvl, a)
        # The predictor's economy has the reference's last-write-wins
        # sub-step quirk (chaser.cpp:297-307): observable scoring events
        # are <= the layout's point count, every nonzero is an exact 0.04
        # multiple, and the completion step pays delta*0.04 + 10.0.
        n_points = int(lvl.point_grid0.sum()) + int(lvl.orb_exists.sum())
        scoring = rew[rew != 0.0]
        assert 1 <= len(scoring) <= n_points
        assert term[-1] and not term[:-1].any()
        assert rew[-1] >= f32(10.0)  # completion bonus observed
        candidates = {f32(f32(k) * f32(0.04)) for k in range(1, 5)} | {
            f32(f32(f32(k) * f32(0.04)) + f32(10.0)) for k in range(0, 5)
        }
        assert all(r in candidates for r in scoring), seed
        acts.append(a)
        preds.append((rew, term))

    out = play(env, bank, CHASER_SEEDS, pad(acts))
    R, D = out["rewards"], out["dones"]
    for i, seed in enumerate(CHASER_SEEDS):
        rew, term = preds[i]
        n = len(rew)
        if D[: n - 1, i].any():
            # enemy contact: economy bit-exact up to the death step,
            # which pays 0.0
            end = int(np.argmax(D[:, i]))
            assert np.array_equal(R[:end, i], rew[:end]), (
                f"seed {seed}: prefix mismatch at "
                f"{np.nonzero(R[:end, i] != rew[:end])[0][:5]}"
            )
            assert R[end, i] == f32(0.0), f"seed {seed}: death reward"
        else:
            assert D[n - 1, i], f"seed {seed}: no completion"
            assert np.array_equal(R[:n, i], rew), (
                f"seed {seed}: reward sequence mismatch at "
                f"{np.nonzero(R[:n, i] != rew)[0][:5]}"
            )

    # the full-clear pool: routes that beat the enemies end to end
    bank = reference_bank("chaser", CHASER_CLEAR_SEEDS, "cpu")
    acts, preds = [], []
    for i, seed in enumerate(CHASER_CLEAR_SEEDS):
        lvl = host_level(bank, i)
        a = chaser_plan(lvl)
        acts.append(a)
        preds.append(bots.chaser_predict(lvl, a))
    out = play(env, bank, CHASER_CLEAR_SEEDS, pad(acts))
    R, D = out["rewards"], out["dones"]
    for i, seed in enumerate(CHASER_CLEAR_SEEDS):
        rew, term = preds[i]
        n = len(rew)
        assert not D[: n - 1, i].any(), f"seed {seed}: early death"
        assert D[n - 1, i], f"seed {seed}: no completion"
        assert rew[-1] >= f32(10.0)
        assert np.array_equal(R[:n, i], rew), f"seed {seed}"


# ---------------------------------------------------------------------------
# climber: scripted ascent — +1 per crystal, +10 on collecting all
# ---------------------------------------------------------------------------

CLIMBER_SEEDS = [0, 5, 7, 9, 11, 12, 13, 17, 18, 19, 22, 23, 24, 25, 28]


def test_climber_scripted_ascent_return_parity():
    env = pt.make("climber", device="cpu", easy_mode=True)
    bank = reference_bank("climber", CLIMBER_SEEDS, "cpu", easy_mode=True)
    levels = _levels(bank, len(CLIMBER_SEEDS))
    out = play(env, bank, CLIMBER_SEEDS, game="climber", levels=levels,
               max_steps=1200)
    R, D = out["rewards"], out["dones"]
    for i, seed in enumerate(CLIMBER_SEEDS):
        n_crystals = int(levels[i].point_exists.sum())
        d = D[:, i]
        assert d.any(), f"seed {seed}: never completed"
        end = int(np.argmax(d))
        r = R[: end + 1, i]
        # final crystal (+1) and all-collected (+10) share the completion
        # sub-step: exactly 11.0f (climber.cpp:348-350)
        assert r[end] == f32(11.0), f"seed {seed}: end reward {r[end]}"
        # every other scoring step is an exact whole crystal count
        mid = r[:end]
        nz = mid[mid != 0.0]
        assert all(v in (f32(1.0), f32(2.0)) for v in nz), (seed, nz)
        assert len(nz) <= n_crystals - 1
        assert not d[:end].any()


# ---------------------------------------------------------------------------
# coinrun: run right to the coin — single +10 on the coin step
# ---------------------------------------------------------------------------

COINRUN_SEEDS = [0, 1, 2, 5, 7, 9, 11, 12, 17, 19, 22, 26, 27, 31, 33]


def test_coinrun_scripted_run_right_return_parity():
    env = pt.make("coinrun", device="cpu")
    bank = reference_bank("coinrun", COINRUN_SEEDS, "cpu")
    levels = _levels(bank, len(COINRUN_SEEDS))
    out = play(env, bank, COINRUN_SEEDS, game="coinrun", levels=levels,
               max_steps=400)
    R, D, A = out["rewards"], out["dones"], out["actions"]
    for i, seed in enumerate(COINRUN_SEEDS):
        d = D[:, i]
        assert d.any(), f"seed {seed}: never reached the coin"
        end = int(np.argmax(d))
        r = R[: end + 1, i]
        # exactly one scoring event: the coin, +10.0f, terminal
        assert r[end] == f32(10.0), f"seed {seed}: end reward {r[end]}"
        assert not r[:end].any(), f"seed {seed}: stray rewards"
        assert not d[:end].any()
        # the independent re-simulation (predict.CoinrunSim), bit-exact
        pr, pt_ = predict.coinrun_predict(levels[i], A[: end + 1, i])
        assert len(pr) == end + 1, f"seed {seed}: predictor ended at " \
            f"{len(pr) - 1}, engine at {end}"
        assert np.array_equal(r, pr), f"seed {seed}: reward mismatch at " \
            f"{np.nonzero(r != pr)[0][:5]}"
        assert pt_[-1] and not pt_[:-1].any()


# ---------------------------------------------------------------------------
# jumper: BFS waypoint flight to the carrot — single +10, terminal
# ---------------------------------------------------------------------------

JUMPER_SEEDS = [0, 6, 8, 9, 11, 12, 14, 15, 19, 20, 21, 22, 25, 26, 37]


def test_jumper_scripted_carrot_return_parity():
    env = pt.make("jumper", device="cpu", mode="easy")
    bank = reference_bank("jumper", JUMPER_SEEDS, "cpu")
    levels = _levels(bank, len(JUMPER_SEEDS))
    out = play(env, bank, JUMPER_SEEDS, game="jumper", levels=levels,
               max_steps=500)
    R, D, A = out["rewards"], out["dones"], out["actions"]
    for i, seed in enumerate(JUMPER_SEEDS):
        d = D[:, i]
        assert d.any(), f"seed {seed}: never reached the carrot"
        end = int(np.argmax(d))
        r = R[: end + 1, i]
        assert r[end] == f32(10.0), f"seed {seed}: end reward {r[end]}"
        assert not r[:end].any(), f"seed {seed}: stray rewards"
        assert not d[:end].any()
        # the independent re-simulation (predict.JumperSim), bit-exact
        pr, pt_ = predict.jumper_predict(levels[i], A[: end + 1, i])
        assert len(pr) == end + 1, f"seed {seed}: predictor ended at " \
            f"{len(pr) - 1}, engine at {end}"
        assert np.array_equal(r, pr), f"seed {seed}: reward mismatch at " \
            f"{np.nonzero(r != pr)[0][:5]}"
        assert pt_[-1] and not pt_[:-1].any()


# ---------------------------------------------------------------------------
# caveflyer: shoot a target (+3 visible), fly to the goal (+10 terminal)
# ---------------------------------------------------------------------------

# Hard mode: easy levels frequently have zero targets (tilemap.cpp:232-236)
CAVEFLYER_SEEDS = [7, 9, 20, 27, 35, 36, 39, 51, 53, 68, 69, 77]


def test_caveflyer_scripted_target_and_goal_return_parity():
    env = pt.make("caveflyer", device="cpu", mode="hard")
    bank = reference_bank("caveflyer", CAVEFLYER_SEEDS, "cpu", mode="hard")
    levels = _levels(bank, len(CAVEFLYER_SEEDS))
    out = play(env, bank, CAVEFLYER_SEEDS, game="caveflyer", levels=levels,
               max_steps=900)
    R, D = out["rewards"], out["dones"]
    for i, seed in enumerate(CAVEFLYER_SEEDS):
        d = D[:, i]
        assert d.any(), f"seed {seed}: never reached the goal"
        end = int(np.argmax(d))
        r = R[: end + 1, i]
        # goal step: exactly +10.0f (or +13.0f if a kill shares the
        # sub-step), terminal (caveflyer.cpp:330-332)
        assert r[end] in (f32(10.0), f32(13.0)), \
            f"seed {seed}: end reward {r[end]}"
        # at least one VISIBLE +3 target kill; every mid scoring value
        # an exact multiple of 3.0f
        mid = r[:end]
        nz = mid[mid != 0.0]
        total_target = float(nz.sum()) + float(r[end]) - 10.0
        assert total_target >= 3.0, f"seed {seed}: no visible +3"
        assert all(v in (f32(3.0), f32(6.0)) for v in nz), (seed, nz)
        assert not d[:end].any()


# ---------------------------------------------------------------------------
# bossfight: death -10
# ---------------------------------------------------------------------------

BOSSFIGHT_NOOP_SEEDS = [1, 2, 3, 4, 5, 6, 7, 8, 9, 12]  # all die in ~170


def test_bossfight_noop_death_return_parity():
    """A stationary agent is eventually hit by a boss bullet: exactly
    one scoring step, the terminal -10.0f (bossfight.cpp:318-320), and
    0.0 everywhere before — with the exact death step independently
    predicted by predict.BossfightSim (the boss phase machine + bullet
    kinematics, common_systems.cpp:199-386, on the engine's keyed
    draws)."""
    seeds = BOSSFIGHT_NOOP_SEEDS
    env = pt.make("bossfight", device="cpu")  # hard (reference default)
    bank = reference_bank("bossfight", seeds, "cpu")
    out = play(env, bank, seeds, pad([[bots.NOOP] * 250] * len(seeds)))
    R, D = out["rewards"], out["dones"]
    preds = predict.bossfight_predict_many(
        _levels(bank, len(seeds)), out["keys0"],
        [[bots.NOOP] * 250] * len(seeds), mode="hard")
    for i, seed in enumerate(seeds):
        d = D[:, i]
        assert d.any(), f"seed {seed}: noop agent survived 250 steps?"
        end = int(np.argmax(d))
        assert R[end, i] == f32(-10.0), f"seed {seed}: {R[end, i]}"
        assert not R[:end, i].any()
        pr, pt_ = preds[i]
        assert len(pr) == end + 1, f"seed {seed}: predictor death at " \
            f"{len(pr) - 1}, engine at {end}"
        assert np.array_equal(R[: end + 1, i], pr), f"seed {seed}"
        assert pt_[-1] and not pt_[:-1].any()
