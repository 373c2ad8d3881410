"""Cross-engine parity of the PyTorch port against the EXECUTED reference
C++ engines (the port's counterpart of tests/test_reference_execution.py,
the same seeds, actions and assertions, on the CPU).

The reference games build headless against the SDL3 stub in
`native/sdl3_stub/` (`make -C native reference`): rendering is stubbed
to no-ops, but generation, physics, rewards and termination are the
real compiled C++, driven through the CEnv ABI by
the port's `tools/cenv_loader.ReferenceEnv`. These tests close the loop that the
oracle/predictor parity suites could not: the comparison target here is
`cenv_step`'s actual reward stream, not a re-derivation.

Scope and exclusions (see docs/REFERENCE_EXECUTION.md):
  * observations are all-zero under the stub -> reward/termination
    parity only;
  * per-game modes are the reference's COMPILE-TIME defaults
    (maze/jumper/caveflyer hard, chaser easy, climber/coinrun hard);
  * games whose step loop draws randomness (bossfight's boss AI,
    chaser's enemies) cannot be replayed with keyed draws — chaser
    asserts bit-exact prefixes up to the (reference-RNG-timed) enemy
    death; bossfight is covered by BossfightRefSim, which consumes the
    real mt19937 stream in the binary's draw order and predicts its
    reward stream bit-exactly (the last test below). Caveflyer's
    pinned scripts die on static hazards before enemies interfere, so
    it replays exactly.

The reference .so keeps process-global ECS state (re-running cenv_make
in one process trips an assert), so each game gets ONE module-scoped
env, reset per seed — the game_test.py usage pattern.
"""
import subprocess
from collections import deque
from pathlib import Path

import numpy as np
import pytest
import torch

import procgen2_tpu_torch as pt
from procgen2_tpu_torch.tools import bots, predict
from procgen2_tpu_torch.tools.reference_levels import (host_level,
                                                       reference_bank)
from test_png_assets import REAL_ASSETS
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

f32 = np.float32
REPO = Path(__file__).resolve().parent.parent
BUILD = REPO / "native" / "build"
LEFT, RIGHT, UP, DOWN, JUMP_R = 1, 7, 5, 3, 8


@pytest.fixture(scope="module")
def ref_libs():
    r = subprocess.run(
        ["make", "-C", str(REPO / "native"), "reference"],
        capture_output=True, text=True,
    )
    if r.returncode != 0:
        pytest.skip(f"reference build failed:\n{r.stderr[-800:]}")
    return BUILD


_ENVS = {}


def _ref_env(lib_path, seed):
    """One ReferenceEnv per .so per process (global ECS registration)."""
    from procgen2_tpu_torch.tools.cenv_loader import ReferenceEnv

    key = str(lib_path)
    if key not in _ENVS:
        _ENVS[key] = ReferenceEnv(key, seed=seed)
    return _ENVS[key]


def _level_i(bank, i):
    return host_level(bank, i)


def _pinned(env, bank, seeds):
    """reset_pinned with key 123 and the seeds as fold ids."""
    return env.reset_pinned(bank, pt.random.key(123),
                            torch.tensor(seeds, dtype=torch.int64))


def _full(n, a):
    return torch.full((n,), a, dtype=torch.int32)


def _run_ref(env, seed, actions, max_steps=None):
    env.reset(seed=seed)
    rewards, end = [], None
    for t, a in enumerate(actions[:max_steps]):
        _, r, term, _ = env.step(int(a))
        rewards.append(f32(r))
        if term:
            end = t
            break
    return np.asarray(rewards, f32), end


def _bfs_actions(grid, start, goal):
    H, W = grid.shape
    prev = {start: None}
    q = deque([start])
    while q:
        cur = q.popleft()
        if cur == goal:
            break
        y, x = cur
        for dy, dx, act in ((0, 1, RIGHT), (0, -1, LEFT), (-1, 0, UP),
                            (1, 0, DOWN)):
            ny, nx = y + dy, x + dx
            if 0 <= ny < H and 0 <= nx < W and grid[ny, nx] == 0 \
                    and (ny, nx) not in prev:
                prev[(ny, nx)] = (cur, act)
                q.append((ny, nx))
    if goal not in prev:
        return None
    acts = []
    cur = goal
    while prev[cur] is not None:
        cur, act = prev[cur]
        acts.append(act)
    return acts[::-1]


MAZE_SEEDS = list(range(10))


def test_maze_reference_binary_return_parity(ref_libs):
    """The compiled maze engine pays +10.0 exactly on the goal step of
    the BFS route computed from the ORACLE's layout — executable proof
    that oracle layouts and movement/goal semantics match the real
    engine (maze.cpp:295-310; hard mode, the compile-time default)."""
    bank = reference_bank("maze", MAZE_SEEDS, "cpu", mode="hard")
    env = _ref_env(ref_libs / "ref_maze.so", MAZE_SEEDS[0])
    for i, seed in enumerate(MAZE_SEEDS):
        lvl = _level_i(bank, i)
        grid = np.asarray(lvl.grid)
        start = (int(lvl.agent_pos[1]), int(lvl.agent_pos[0]))
        goal = (int(lvl.goal_pos[1]), int(lvl.goal_pos[0]))
        acts = _bfs_actions(grid, start, goal)
        assert acts is not None, f"seed {seed}: oracle maze unsolvable?"
        rr, end = _run_ref(env, seed, acts)
        assert end == len(acts) - 1, f"seed {seed}: ref ended at {end}"
        assert rr[-1] == f32(10.0)
        assert not rr[:-1].any()


COINRUN_FATAL_SEEDS = [3, 6, 8, 10, 15, 16, 20, 23, 24, 25, 28, 29]


def test_coinrun_reference_binary_death_parity(ref_libs):
    """Blind jump-right runs die in the compiled coinrun engine at the
    EXACT step the CoinrunSim predictor (and therefore the port's engine,
    tests/test_torch_parity.py) computes — full platformer physics,
    mob patrols and hazard geometry validated against the real C++."""
    bank = reference_bank("coinrun", COINRUN_FATAL_SEEDS, "cpu")
    env = _ref_env(ref_libs / "ref_coinrun.so", COINRUN_FATAL_SEEDS[0])
    acts = [JUMP_R] * 300
    for i, seed in enumerate(COINRUN_FATAL_SEEDS):
        pr, pt = predict.coinrun_predict(_level_i(bank, i), acts)
        rr, end = _run_ref(env, seed, acts, max_steps=150)
        assert end == len(pr) - 1, (
            f"seed {seed}: ref died at {end}, predictor at {len(pr) - 1}"
        )
        assert np.array_equal(rr, pr), f"seed {seed}"


JUMPER_HARD_FATAL = [1, 4, 5, 6, 22, 24, 32, 35, 39, 42, 45, 47, 51, 56]


def test_jumper_reference_binary_death_parity(ref_libs):
    """Blind right walks hit spikes in the compiled jumper engine at
    the exact JumperSim-predicted step (hard mode, the reference's
    compile-time default)."""
    bank = reference_bank("jumper", JUMPER_HARD_FATAL, "cpu", mode="hard")
    env = _ref_env(ref_libs / "ref_jumper.so", JUMPER_HARD_FATAL[0])
    acts = [RIGHT] * 300
    for i, seed in enumerate(JUMPER_HARD_FATAL):
        pr, pt = predict.jumper_predict(_level_i(bank, i), acts)
        rr, end = _run_ref(env, seed, acts, max_steps=60)
        assert end == len(pr) - 1, (
            f"seed {seed}: ref died at {end}, predictor at {len(pr) - 1}"
        )
        assert np.array_equal(rr, pr), f"seed {seed}"


CHASER_SEEDS = [5, 17, 20, 21, 28, 34, 35, 36, 43, 46, 59, 71, 83, 84, 88]
CHASER_FULL_CLEAR = {84}  # reference enemies never catch the route


def test_chaser_reference_binary_economy_parity(ref_libs):
    """The compiled chaser engine's pellet economy matches the
    predictor BIT-EXACTLY for the whole run: seeds where the
    reference's enemies (their own mt19937 stream — a divergence from
    the engine's keyed draws by design) never catch the scripted agent
    complete with the exact +10 all-clear; on the rest, every reward up
    to the enemy-death step matches exactly and death pays 0.0.

    Seeds 20/88 were a long-standing residual (1-2 suppressed pellet
    rewards): root-caused to the reference's centering gates calling
    the int-bound global ::abs (argument truncates to 0, gate always
    true — common_systems.cpp:346-420), so turns engage a sub-step
    earlier than an EPS-gated mirror. With the gates mirrored as
    always-true (games/chaser.py, tools/bots._ChaserSim) all 15 seeds
    replay bit-exactly."""
    bank = reference_bank("chaser", CHASER_SEEDS, "cpu")
    env = _ref_env(ref_libs / "ref_chaser.so", CHASER_SEEDS[0])
    for i, seed in enumerate(CHASER_SEEDS):
        lvl = _level_i(bank, i)
        route = bots.chaser_full_route(lvl)
        acts = bots.route_to_actions(route, bots.CHASER_STEPS_PER_CELL)
        pr, pt = bots.chaser_predict(lvl, acts)
        rr, end = _run_ref(env, seed, acts)
        if seed in CHASER_FULL_CLEAR:
            assert end == len(pr) - 1, f"seed {seed}: ref ended at {end}"
            assert np.array_equal(rr, pr), f"seed {seed}"
        else:
            assert end is not None and end < len(pr) - 1, (
                f"seed {seed}: expected an enemy death before completion"
            )
            # bit-exact pellet economy right up to the death step,
            # which itself pays 0.0 (chaser.cpp:296-312)
            assert rr[end] == f32(0.0), f"seed {seed}: death reward"
            assert np.array_equal(rr[:end], pr[:end]), f"seed {seed}"


CLIMBER_FATAL_SEEDS = [1, 3, 4, 5, 7, 8, 9, 10, 14, 15, 17, 19]


def test_climber_reference_binary_death_parity(ref_libs):
    """Climber's step loop is RNG-free (deterministic patrol mobs), so
    blind jump-right runs replay EXACTLY across engines: the compiled
    reference dies on the same step with an identical reward stream as
    the port's engine (hard mode, the compile-time default). The
    reference's stray debug printf (climber.cpp:357) spams REWARD0 to
    stdout while it runs — left as-is, it is reference behavior."""
    bank = reference_bank("climber", CLIMBER_FATAL_SEEDS, "cpu",
                          easy_mode=False)
    env = pt.make("climber", device="cpu", easy_mode=False)
    state = _pinned(env, bank, CLIMBER_FATAL_SEEDS)
    N = len(CLIMBER_FATAL_SEEDS)
    R = np.zeros((150, N), f32)
    D = np.zeros((150, N), bool)
    for t in range(150):
        state, ts = env.step_raw(
            state, _full(N, JUMP_R), render=False)
        R[t] = ts.reward.numpy()
        D[t] = ts.terminated.numpy()

    renv = _ref_env(ref_libs / "ref_climber.so", CLIMBER_FATAL_SEEDS[0])
    for i, seed in enumerate(CLIMBER_FATAL_SEEDS):
        rr, end = _run_ref(renv, seed, [JUMP_R] * 150)
        my_end = int(np.argmax(D[:, i]))
        assert D[:, i].any() and end == my_end, (
            f"seed {seed}: ref died at {end}, engine at {my_end}"
        )
        assert np.array_equal(rr, R[: len(rr), i]), f"seed {seed}"


CAVEFLYER_FATAL_SEEDS = [1, 3, 6, 7, 8, 10, 12, 13, 17, 18, 20, 21]


def test_caveflyer_reference_binary_death_parity(ref_libs):
    """Blind thrust+turn flights (rotational ship physics: f32 cos/sin
    heading integration) replay EXACTLY in the compiled reference: same
    meteor/target death step — or agreement that the flight survives
    200 steps — with identical reward streams, 12/12 hard-mode seeds.
    The pinned scripts die on STATIC hazards before the (divergent)
    enemy RNG can interfere."""
    bank = reference_bank("caveflyer", CAVEFLYER_FATAL_SEEDS, "cpu",
                          mode="hard")
    env = pt.make("caveflyer", device="cpu", mode="hard")
    state = _pinned(env, bank, CAVEFLYER_FATAL_SEEDS)
    N = len(CAVEFLYER_FATAL_SEEDS)
    UP_RIGHT = 6
    R = np.zeros((200, N), f32)
    D = np.zeros((200, N), bool)
    for t in range(200):
        state, ts = env.step_raw(
            state, _full(N, UP_RIGHT), render=False)
        R[t] = ts.reward.numpy()
        D[t] = ts.terminated.numpy()

    renv = _ref_env(ref_libs / "ref_caveflyer.so", CAVEFLYER_FATAL_SEEDS[0])
    for i, seed in enumerate(CAVEFLYER_FATAL_SEEDS):
        rr, end = _run_ref(renv, seed, [UP_RIGHT] * 200)
        my_end = int(np.argmax(D[:, i])) if D[:, i].any() else None
        assert end == my_end, (
            f"seed {seed}: ref ended at {end}, engine at {my_end}"
        )
        assert np.array_equal(rr, R[: len(rr), i]), f"seed {seed}"


PIXEL_SEEDS = [3, 5, 7, 11, 13]


def test_maze_reference_binary_pixel_parity(ref_libs):
    """REAL reference frames vs the port's renders: the stub decodes
    the actual asset PNGs (libpng) and rasterizes the reference's own
    draw calls, so cenv's observation buffer carries genuine reference
    pixels. With the PNG overlay installed on the port's side, frames
    must agree within a nearest-sampling budget: the stub's blitter
    floor-snaps rects like SDL's software renderer but sub-texel
    sampling phases differ, which on noisy textures (sandCenter at
    ~4.3 px/tile) perturbs individual texel picks, not structure.

    Budget: mean |diff| < 4/255 per frame, < 8% of pixels off by > 16
    (measured 0.9-2.8 on the pinned seeds).
    A layout/placement bug (wrong cell, missing sprite, shifted camera)
    blows both numbers immediately."""
    from procgen2_tpu_torch.render import png_assets

    png_assets.install(REAL_ASSETS)
    try:
        bank = reference_bank("maze", PIXEL_SEEDS, "cpu", mode="hard")
        env = pt.make("maze", device="cpu", mode="hard")
        state = _pinned(env, bank, PIXEL_SEEDS)
        mine = env.observe(state).numpy()

        renv = _ref_env(ref_libs / "ref_maze.so", PIXEL_SEEDS[0])
        for i, seed in enumerate(PIXEL_SEEDS):
            ref = renv.reset(seed=seed)
            d = np.abs(ref.astype(np.int32) - mine[i].astype(np.int32))
            assert d.mean() < 4.0, f"seed {seed}: mean|diff| {d.mean():.2f}"
            assert (d > 16).mean() < 0.08, (
                f"seed {seed}: {(d > 16).mean():.3f} of pixels off by >16"
            )
    finally:
        png_assets.uninstall()


CLIMBER_ASCENT_SEEDS = [0, 11, 17, 19, 20]


def test_climber_reference_binary_ascent_parity(ref_libs):
    """Positive-reward cross-engine replay: ClimberBot ascents recorded
    against the port's engine (hard mode) replay in the compiled reference
    with IDENTICAL reward streams — every mid-run +1 crystal and the
    exact same-sub-step 11.0f completion (climber.cpp:348-350), totals
    11-13 across the pinned seeds."""
    B = bots
    bank = reference_bank("climber", CLIMBER_ASCENT_SEEDS, "cpu",
                          easy_mode=False)
    env = pt.make("climber", device="cpu", easy_mode=False)
    state = _pinned(env, bank, CLIMBER_ASCENT_SEEDS)
    N = len(CLIMBER_ASCENT_SEEDS)
    levels = [_level_i(bank, i) for i in range(N)]
    bs = [B.ClimberBot(l) for l in levels]
    T = 600
    R = np.zeros((T, N), f32)
    D = np.zeros((T, N), bool)
    A = np.full((T, N), B.NOOP, np.int32)
    done = np.zeros(N, bool)
    for t in range(T):
        gs = state.game
        pos, vel = gs.pos.numpy(), gs.vel.numpy()
        og, taken = gs.on_ground.numpy(), gs.point_taken.numpy()
        A[t] = [
            bs[i].act(pos[i], vel[i], og[i], taken[i]) if not done[i]
            else B.NOOP
            for i in range(N)
        ]
        state, ts = env.step_raw(state, torch.from_numpy(A[t]), render=False)
        R[t] = ts.reward.numpy()
        D[t] = ts.terminated.numpy()
        done |= D[t]
        if done.all():
            break

    renv = _ref_env(ref_libs / "ref_climber.so", CLIMBER_ASCENT_SEEDS[0])
    for i, seed in enumerate(CLIMBER_ASCENT_SEEDS):
        assert D[:, i].any(), f"seed {seed}: bot never finished"
        end = int(np.argmax(D[:, i]))
        assert R[end, i] == f32(11.0), f"seed {seed}: engine end reward"
        rr, rend = _run_ref(renv, seed, A[: end + 1, i].tolist())
        assert rend == end, f"seed {seed}: ref ended at {rend} != {end}"
        assert np.array_equal(rr, R[: end + 1, i]), f"seed {seed}"


BOSSFIGHT_SEEDS = list(range(8))


def test_bossfight_reference_binary_rng_oracle_parity(ref_libs):
    """The LAST cross-engine game: bossfight's boss AI consumes mt19937
    *during stepping* (weapon choice, shield-time jitter, volley
    offsets, retargets, bounce velocities — games/bossfight/
    common_systems.cpp:104-291,629-638), so engine-vs-binary replay is
    impossible with keyed draws. BossfightRefSim (tools/bossfight_ref)
    instead consumes the REAL libstdc++ mt19937 stream via the oracle in
    the binary's exact draw order and predicts `cenv_step`'s reward
    stream bit-exactly: 8 sustained-fire runs (seed 0 is a full boss
    kill, +10 after 3 damage phases; the rest are deaths) and 8 noop
    runs must match reward-for-reward, step-for-step."""
    from procgen2_tpu_torch.tools.bossfight_ref import BossfightRefSim

    env = _ref_env(ref_libs / "ref_bossfight.so", BOSSFIGHT_SEEDS[0])
    outcomes = []
    for action, horizon in ((9, 1200), (4, 260)):
        for seed in BOSSFIGHT_SEEDS:
            env.reset(seed=seed)
            sim = BossfightRefSim(seed)
            try:
                for t in range(horizon):
                    _, r, term, _ = env.step(action)
                    pr, pterm = sim.step(action)
                    assert f32(r) == pr, (
                        f"seed {seed} action {action} t={t}: "
                        f"ref {r} sim {pr}")
                    assert bool(term) == pterm, (
                        f"seed {seed} action {action} t={t}")
                    if term:
                        outcomes.append((seed, action, t, f32(r)))
                        break
            finally:
                sim.close()
    # the scripted set must include a positive boss-kill trajectory
    assert any(r == f32(10.0) for _, _, _, r in outcomes), outcomes


# Per-game budgets for step-1 frame parity vs the executed reference:
# (config kwargs, mean |diff| budget, frac-of-pixels-off-by->16 budget).
# Measured means on the pinned seeds (see docs/REFERENCE_EXECUTION.md):
# jumper 0.7-1.8, caveflyer 1.3-12, chaser 2.9-9.6, coinrun 5.5-7.3
# (includes the <=0.6 px render-camera quantization), bossfight 3.7-10.8,
# climber 4.1-10.7 (large decorations resampled through the 32 px
# atlas). A one-TILE camera displacement (4.8 px) measured 25-148 mean
# before the bg-crop/OOB-wall fixes — every budget below catches it.
PIXEL_GAMES = {
    "coinrun": ({}, 10.0, 0.18),
    "chaser": ({"mode": "easy"}, 12.0, 0.30),
    "jumper": ({"mode": "hard"}, 4.0, 0.05),
    "climber": ({"easy_mode": False}, 14.0, 0.25),
    "caveflyer": ({"mode": "hard"}, 16.0, 0.30),
    "bossfight": ({}, 14.0, 0.25),
}


@pytest.mark.parametrize("game", sorted(PIXEL_GAMES))
def test_reference_binary_pixel_parity_all_games(ref_libs, game):
    """REAL reference frames for every scrolling/sprite game: reset both
    engines on oracle-pinned levels, advance ONE noop step (the
    reference renders its reset observation with a STALE camera — the
    camera is only written inside the agent-system update, e.g.
    games/jumper/common_systems.cpp:179-181 — so reset frames are not
    comparable for agent-following cameras), and hold the frames to
    per-game nearest-sampling budgets. Finds layout, theme, camera,
    background-mapping and OOB-tile regressions in one shot: this suite
    caught the squashed non-square backgrounds (png_assets square_crop)
    and jumper's missing OOB-is-wall render rule."""
    from procgen2_tpu_torch.render import png_assets

    kw, mean_budget, frac_budget = PIXEL_GAMES[game]
    png_assets.install(REAL_ASSETS)
    try:
        bank = reference_bank(game, PIXEL_SEEDS, "cpu", **kw)
        env = pt.make(game, device="cpu", **kw)
        state = _pinned(env, bank, PIXEL_SEEDS)
        state, ts = env.step(bank, state, _full(len(PIXEL_SEEDS), 4))
        mine = ts.obs.numpy()

        renv = _ref_env(ref_libs / f"ref_{game}.so", PIXEL_SEEDS[0])
        for i, seed in enumerate(PIXEL_SEEDS):
            renv.reset(seed=seed)
            ref, _, _, _ = renv.step(4)
            d = np.abs(ref.astype(np.int32) - mine[i].astype(np.int32))
            assert d.mean() < mean_budget, (
                f"{game} seed {seed}: mean|diff| {d.mean():.2f}"
            )
            assert (d > 16).mean() < frac_budget, (
                f"{game} seed {seed}: {(d > 16).mean():.3f} off by >16"
            )
    finally:
        png_assets.uninstall()


def _record_engine_run(game, kw, seeds, mk_bot, act_fn, T):
    """Closed-loop bot rollout against the port's engine: returns per-step
    actions, rewards, terminations (the climber-ascent recipe)."""
    B = bots
    bank = reference_bank(game, seeds, "cpu", **kw)
    env = pt.make(game, device="cpu", **kw)
    state = _pinned(env, bank, seeds)
    N = len(seeds)
    levels = [_level_i(bank, i) for i in range(N)]
    bs = [mk_bot(lvl) for lvl in levels]
    R = np.zeros((T, N), f32)
    D = np.zeros((T, N), bool)
    A = np.full((T, N), B.NOOP, np.int32)
    done = np.zeros(N, bool)
    for t in range(T):
        gs = state.game
        A[t] = [act_fn(bs[i], gs, i) if not done[i] else B.NOOP
                for i in range(N)]
        state, ts = env.step_raw(state, torch.from_numpy(A[t]), render=False)
        R[t] = ts.reward.numpy()
        D[t] = ts.terminated.numpy()
        done |= D[t]
        if done.all():
            break
    return A, R, D


COINRUN_WIN_SEEDS = [0, 1, 2, 5, 7, 17]


def test_coinrun_reference_binary_win_parity(ref_libs):
    """Positive-reward cross-engine replay: CoinrunBot coin-collecting
    runs recorded against the port's engine replay in the compiled
    reference with IDENTICAL reward streams — zero rewards throughout
    and the exact +10.0f terminal on the coin-touch step
    (coinrun.cpp:364-366). Complements the death-parity suite: every
    deterministic game now has a scoring trajectory validated against
    the executed binary."""
    B = bots

    def act(b, gs, i):
        return b.act(gs.pos[i].numpy(), gs.vel[i].numpy(),
                     gs.on_ground[i].numpy())

    A, R, D = _record_engine_run(
        "coinrun", {}, COINRUN_WIN_SEEDS, B.CoinrunBot, act, 300)
    renv = _ref_env(ref_libs / "ref_coinrun.so", COINRUN_WIN_SEEDS[0])
    for i, seed in enumerate(COINRUN_WIN_SEEDS):
        assert D[:, i].any(), f"seed {seed}: bot never finished"
        end = int(np.argmax(D[:, i]))
        assert R[end, i] == f32(10.0), f"seed {seed}: engine end reward"
        rr, rend = _run_ref(renv, seed, A[: end + 1, i].tolist())
        assert rend == end, f"seed {seed}: ref ended at {rend} != {end}"
        assert np.array_equal(rr, R[: end + 1, i]), f"seed {seed}"


JUMPER_WIN_SEEDS = [1, 4, 6, 7, 10, 23]


def test_jumper_reference_binary_win_parity(ref_libs):
    """Positive-reward cross-engine replay for jumper: JumperBot
    carrot runs (BFS waypoints + double jump) replay in the compiled
    reference with identical streams and the exact +10.0f terminal on
    the carrot step (jumper.cpp:362-364)."""
    B = bots

    def act(b, gs, i):
        return b.act(gs.pos[i].numpy(), gs.vel[i].numpy(),
                     gs.on_ground[i].numpy(), gs.jumps_left[i].numpy(),
                     gs.jump_timer[i].numpy())

    A, R, D = _record_engine_run(
        "jumper", {"mode": "hard"}, JUMPER_WIN_SEEDS, B.JumperBot, act, 500)
    renv = _ref_env(ref_libs / "ref_jumper.so", JUMPER_WIN_SEEDS[0])
    for i, seed in enumerate(JUMPER_WIN_SEEDS):
        assert D[:, i].any(), f"seed {seed}: bot never finished"
        end = int(np.argmax(D[:, i]))
        assert R[end, i] == f32(10.0), f"seed {seed}: engine end reward"
        rr, rend = _run_ref(renv, seed, A[: end + 1, i].tolist())
        assert rend == end, f"seed {seed}: ref ended at {rend} != {end}"
        assert np.array_equal(rr, R[: end + 1, i]), f"seed {seed}"
