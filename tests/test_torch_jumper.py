"""The port's jumper (procgen2_tpu_torch/games/jumper.py) against the JAX
package's, given the same keys, states and actions. Every comparison is
bitwise: f32 compared as int32 views, everything else equal.

* the level bank in easy (every field), hard and memory, with levels that
  have spikes and wall-breakup openings; reset;
* the 4-sub-step step at every step from random states (agents in and
  beside walls, on the ground and in the air, dust of every age);
* `Environment.step` with lane 0 on its carrot (+10) and a lane on a
  spike (death, 0), both of which end and auto-reset, states, rewards and
  obs at every step (chip_smoke.py's placement);
* `observe_batch` against the JAX package's render on its TPU path: the
  scene kernel `scene_tpu_raw` and the stamp kernel `composite_tpu` in
  interpret mode, which B1 and B3 replace; on random states and on states
  whose stamps sit where XLA's fused multiply-adds and folded constants
  move them;
* each rounding site of the render and the step that XLA CPU fuses or
  folds, against a jitted copy of the JAX package's expression, with the
  inputs where the unfused expression differs.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from jax_capture import render_inputs
import procgen2_tpu as pg
import procgen2_tpu_torch as pt
from procgen2_tpu.games import jumper as jjump
from procgen2_tpu.render import compositor as jC
from procgen2_tpu.render import scene_kernel as jsk
from procgen2_tpu.render import stamp_kernel as jstk
from procgen2_tpu_torch import random as R
from procgen2_tpu_torch.games import jumper as tjump
from procgen2_tpu_torch.render import compositor as tC
from procgen2_tpu_torch.utils import convert
import render_parity as RP

NUM_LEVELS, N, T = 16, 8, 8
LEVEL_FIELDS = [f.name for f in dataclasses.fields(tjump.Level)]
STATE_FIELDS = [f.name for f in dataclasses.fields(tjump.State)
                if f.name != "level"]


def np_tree(tree):
    return jax.tree.map(
        lambda a: (np.asarray(jax.random.key_data(a))
                   if jnp.issubdtype(a.dtype, jax.dtypes.prng_key)
                   else np.asarray(a)), tree)


def same(want, got):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    if want.dtype == np.uint32:
        want = want.astype(np.int64)
    assert want.shape == got.shape and want.dtype == got.dtype, (
        want.shape, want.dtype, got.shape, got.dtype)
    if want.dtype == np.float32:
        np.testing.assert_array_equal(want.view(np.int32), got.view(np.int32))
    else:
        np.testing.assert_array_equal(want, got)


def same_tree(want, got):
    """`want`: numpy leaves (JAX side); `got`: the port's dataclasses."""
    if dataclasses.is_dataclass(got):
        for f in dataclasses.fields(got):
            same_tree(getattr(want, f.name), getattr(got, f.name))
        return
    same(want, got)


def _keys(n, seed=7):
    return (jax.vmap(lambda i: jax.random.fold_in(jax.random.key(seed), i))(
        jnp.arange(n, dtype=jnp.uint32)), R.fold_in(R.key(seed),
                                                    torch.arange(n)))


def _jax_kernels(mp):
    """Put the JAX package's render on its TPU path: `scene_tpu_raw` and
    `composite_tpu`, run in interpret mode (a `pytest.MonkeyPatch` mp)."""
    scene, composite = jsk.scene_tpu_raw, jstk.composite_tpu
    mp.setattr(jC, "_use_stamp_kernel", lambda: True)
    mp.setattr(jsk, "scene_tpu_raw",
               lambda *a, **k: scene(*a, **{**k, "interpret": True}))
    mp.setattr(jstk, "composite_tpu",
               lambda *a, **k: composite(*a, **{**k, "interpret": True}))


def _to_jax_state(st):
    return jax.tree.map(jnp.asarray,
                        st.replace(rng=jax.random.wrap_key_data(st.rng)))


@pytest.fixture(scope="module")
def jax_env():
    """The JAX Environment and its bank of NUM_LEVELS levels, level i keyed
    fold_in(key(7), i) as `_keys` keys them."""
    jenv = pg.make("jumper")
    return jenv, jenv.generate_bank(jax.random.key(7), num_levels=NUM_LEVELS)


@pytest.fixture(scope="module")
def banks(jax_env):
    """(JAX bank with numpy leaves, the port's bank), and the number of
    cells each of the port's levels had opened by the wall breakup."""
    _, tk = _keys(NUM_LEVELS)
    opened = []
    breakup = tjump._break_walls

    def counting(grid, r1, r2):
        before = grid.clone()
        after = breakup(grid, r1, r2)
        opened.append((before != after).sum((1, 2)))
        return after

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tjump, "_break_walls", counting)
        tbank = tjump.generate(tjump.Config(), tk)
    return np_tree(jax_env[1]), tbank, opened[0]


# ---------------------------------------------------------------------------
# Bank and reset
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("field", LEVEL_FIELDS)
def test_generate_matches(banks, field):
    jl, tl, _ = banks
    same(getattr(jl, field), getattr(tl, field))


def test_generate_covers_the_branches(banks):
    """The easy bank has levels with spikes and without, levels whose
    walls the breakup opened, and goal and agent on distinct open cells."""
    _, tl, opened = banks
    spikes = tl.spike_grid.sum((1, 2))
    assert (spikes > 0).any() and (spikes == 0).any()
    assert (opened > 0).any()
    D = tl.grid.shape[1]
    for pos, dy in ((tl.goal_pos, 0.5), (tl.agent_pos, 1.0)):
        ry = (pos[:, 1] - dy).long()
        x = (pos[:, 0] - 0.5).long()
        assert (tl.grid[torch.arange(NUM_LEVELS), ry, x] == tjump.EMPTY).all()
        assert ((ry >= 0) & (ry < D)).all()
    assert not torch.equal(tl.goal_pos, tl.agent_pos + torch.tensor([0, 0.5]))


@pytest.mark.parametrize("mode,n", [("hard", 8), ("memory", 4)])
def test_generate_other_modes(mode, n):
    jk, tk = _keys(n, seed=11)
    want = np_tree(jax.jit(jax.vmap(functools.partial(
        jjump.generate, jjump.Config(mode=mode))))(jk))
    got = tjump.generate(tjump.Config(mode=mode), tk)
    same_tree(want, got)
    D = tjump.Config(mode=mode).world_dim
    assert got.grid.shape == (n, D, D)
    assert bool(got.spike_grid.any()) == (mode == "hard")


def test_spike_column_scan_matches_the_cell_loop():
    """The spike pass as a scan over columns equals the JAX package's loop
    over cells (jumper.py:241-255) on grids of floors every third row with
    holes, dense with 3-wide ground runs where a spike blocks its right
    neighbour's run, at p = 0.9."""
    rng = np.random.default_rng(0)
    D, L = 20, 32
    floors = (np.arange(D) % 3 == 0)[None, None, :] | (
        rng.random((L, D, D)) < 0.15)
    grid = np.where(floors, tjump.WALL_MID, tjump.EMPTY).astype(np.int8)
    u = rng.random((L, D, D)).astype(np.float32)

    def loop(g, u):  # jumper.py:227-255, its draws given as u
        def body(i, g):
            def at(i, j):
                inb = (i >= 0) & (i < D) & (j >= 0) & (j < D)
                return jnp.where(inb, g[jnp.clip(i, 0, D - 1),
                                        jnp.clip(j, 0, D - 1)], jnp.int8(2))

            def sog(i, j):
                return ((at(i, j) == 0) & (at(i, j + 1) == 0)
                        & ((at(i, j - 1) == 2) | (at(i, j - 1) == 1)))

            x, y = i // D, i % D
            ok = sog(x, y) & sog(x - 1, y) & sog(x + 1, y) & (u[x, y] < 0.9)
            return g.at[x, y].set(jnp.where(ok, jnp.int8(3), g[x, y]))

        return jax.lax.fori_loop(0, D * D, body, g)

    want = np.asarray(jax.jit(jax.vmap(loop))(jnp.asarray(grid),
                                               jnp.asarray(u)))
    got = tjump._place_spikes(torch.from_numpy(grid.copy()),
                              torch.from_numpy(u), 0.9).numpy()
    np.testing.assert_array_equal(want, got)
    assert (want == 3).sum() > 500
    # a spike's right neighbour on its run, blocked though its draw passed
    run = (want[:, :-1] == 3) & (want[:, 1:] == 0) & (u[:, 1:] < 0.9)
    assert run.any()


def test_reset_matches(banks):
    jl, _, _ = banks
    lv = jax.tree.map(lambda a: jnp.asarray(a[:N]), jl)
    keys = jax.random.split(jax.random.key(8), N)
    want = np_tree(jax.vmap(functools.partial(jjump.reset, jjump.Config()))(
        lv, keys))
    got = tjump.reset(tjump.Config(), convert.level(tjump, jax.tree.map(
        np.asarray, lv), "cpu"), torch.from_numpy(np_tree(keys).astype(np.int64)))
    for f in STATE_FIELDS:
        same(getattr(want, f), getattr(got, f))


# ---------------------------------------------------------------------------
# Step
# ---------------------------------------------------------------------------

def random_states(bank, seed, n=N):
    """States on the bank's first n levels with the agent in open cells
    near walls (on a floor, just above one, mid-cell), random velocities,
    jumps left and jump timers, poses, and dust of every age spread around
    the agent."""
    rng = np.random.default_rng(seed)
    lv = jax.tree.map(lambda a: a[:n], bank)
    f32 = np.float32
    pos = np.zeros((n, 2), f32)
    for i in range(n):
        cells = np.argwhere(lv.grid[i] == tjump.EMPTY)
        ry, x = cells[rng.integers(len(cells))]
        pos[i] = (x + rng.uniform(0.2, 0.8),
                  ry + rng.choice([1.0, rng.uniform(0.8, 1.0)]))
    life = np.where(rng.random((n, 10)) < 0.6,
                    5 - 0.25 * rng.integers(0, 24, (n, 10)),
                    rng.uniform(-1, 5, (n, 10)))
    return jjump.State(
        level=lv,
        pos=pos,
        vel=rng.uniform(-0.6, 0.6, (n, 2)).astype(f32),
        on_ground=rng.random(n) < 0.5,
        jumps_left=rng.integers(0, 3, n).astype(np.int32),
        jump_timer=rng.choice(f32([0, 0, 0.25, 1.5, 2.75, 3.0]), n),
        face_forward=rng.random(n) < 0.5,
        anim_t=rng.random(n).astype(f32),
        part_pos=(pos[:, None] + rng.uniform(-3, 3, (n, 10, 2))).astype(f32),
        part_life=life.astype(f32),
        part_spawn_timer=rng.choice(f32([0, 0.25, 0.5, 0.75]), n),
        t=rng.integers(0, 20, n).astype(np.int32),
        rng=np.zeros((n, 2), np.uint32),
    )


@pytest.fixture(scope="module")
def trajectories(banks):
    """T game-level steps (no auto-reset) from random states, JAX and port
    results per step; actions include jumps, left and right."""
    jl, _, _ = banks
    st = random_states(jl, 0, n=NUM_LEVELS)
    actions = np.random.default_rng(1).integers(
        0, 15, (T, NUM_LEVELS)).astype(np.int32)
    jstep = jax.jit(jax.vmap(functools.partial(jjump.step, jjump.Config())))
    jst = _to_jax_state(st)
    tst = convert.state(tjump, st, "cpu")
    out = []
    for t in range(T):
        jst, jr, jd, ji = jstep(jst, jnp.asarray(actions[t]))
        tst, tr, td, ti = tjump.step(tjump.Config(), tst,
                                     torch.from_numpy(actions[t]))
        out.append((np_tree(jst), np.asarray(jr), np.asarray(jd),
                    np.asarray(ji["to_goal"]), tst, tr, td, ti["to_goal"]))
    return out


@pytest.mark.parametrize("t", range(T))
def test_step_matches(trajectories, t):
    jst, jr, jd, jg, tst, tr, td, tg = trajectories[t]
    for f in STATE_FIELDS:
        same(getattr(jst, f), getattr(tst, f))
    same(jr, tr)
    same(jd, td)
    same(jg, tg)


def test_steps_cover_the_physics(trajectories):
    """Over the trajectories: jumps, landings, ceiling hits, dust spawns,
    and deaths on spikes or goals reached."""
    dones = np.stack([o[2] for o in trajectories])
    on_ground = np.stack([o[0].on_ground for o in trajectories])
    part_life = np.stack([o[0].part_life for o in trajectories])
    jumps = np.stack([o[0].jumps_left for o in trajectories])
    assert on_ground.any() and (~on_ground).any()
    assert (part_life == tjump.PART_LIFESPAN - tjump.DT).any()  # spawned
    assert (jumps < 2).any()
    assert dones.any()


# ---------------------------------------------------------------------------
# Environment: bank, reset, auto-reset, obs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def run(jax_env):
    """Both Environments from the same keys; after reset the carrot lane
    and the spike lane are placed with chip_smoke's placement (carried
    across with utils/convert); T steps with the same actions, rendered
    (the JAX render on its TPU path)."""
    with pytest.MonkeyPatch.context() as mp:
        _jax_kernels(mp)
        return _run(*jax_env)


def _run(jenv, jbank):
    tenv = pt.make("jumper", device="cpu")
    tbank = tenv.generate_bank(pt.random.key(7), NUM_LEVELS)
    jst, jts = jenv.reset(jbank, jax.random.key(8), num_envs=N)
    tst, tts = tenv.reset(tbank, pt.random.key(8), N)
    reset = (np_tree(jst), np.asarray(jts.obs), tst, tts)
    start = np_tree(jst)
    game, lanes = chip_smoke.place_jumper_lanes(
        convert.state(tjump, start.game, "cpu"), N)
    start = start.replace(game=start.game.replace(
        pos=game.pos.numpy(), vel=game.vel.numpy()))
    jst = jax.tree.map(jnp.asarray, start.replace(
        rng=jax.random.wrap_key_data(start.rng),
        game=start.game.replace(rng=jax.random.wrap_key_data(start.game.rng))))
    tst = convert.env_state(tjump, start, "cpu")
    actions = np.random.default_rng(3).integers(0, 15, (T, N)).astype(np.int32)
    steps = []
    for t in range(T):
        jst, jts = jenv.step(jbank, jst, jnp.asarray(actions[t]))
        tst, tts = tenv.step(tbank, tst, torch.from_numpy(actions[t]))
        steps.append((np_tree(jst), np_tree(jts), tst, tts))
    return dict(jbank=jbank, tbank=tbank, reset=reset, steps=steps,
                lanes=lanes)


def test_env_bank_and_reset_match(run):
    same_tree(np_tree(run["jbank"]), run["tbank"])
    jst, jobs, tst, tts = run["reset"]
    same_tree(jst, tst)
    assert tts.obs.shape == (N, 64, 64, 3) and tts.obs.dtype == torch.uint8
    np.testing.assert_array_equal(jobs, tts.obs.numpy())


@pytest.mark.parametrize("t", range(T))
def test_env_step_matches(run, t):
    """States, rewards, terminations, episode info and obs (the port's
    observe_batch against the JAX package's TPU-path render) at every
    step."""
    jst, jts, tst, tts = run["steps"][t]
    same_tree(jst, tst)
    np.testing.assert_array_equal(jts.obs, tts.obs.numpy())
    for k in ("reward", "terminated", "truncated"):
        same(getattr(jts, k), getattr(tts, k))
    for k in ("returned_episode_return", "returned_episode_length", "done",
              "to_goal"):
        same(jts.info[k], tts.info[k])


def test_placed_lanes_end_and_restart(run):
    """The carrot lane (+10) and the spike lane (0) both end on step 0 and
    restart on a bank level: step counter 0, at its spawn, no dust."""
    goal, spike = run["lanes"]
    assert goal == 0 and 0 < spike < N
    _, _, tst, tts = run["steps"][0]
    assert bool(tts.terminated[goal]) and float(tts.reward[goal]) == 10.0
    assert bool(tts.terminated[spike]) and float(tts.reward[spike]) == 0.0
    for lane in (goal, spike):
        g = tst.game
        assert int(g.t[lane]) == 0 and int(tst.ep_length[lane]) == 0
        assert g.pos[lane].tolist() == g.level.agent_pos[lane].tolist()
        assert not bool((g.part_life[lane] > 0).any())


def test_chip_smoke_places_the_same_lanes(run):
    """chip_smoke.py's placement picks its lanes from the first lanes
    only: on the first 8 of 16 envs it places the same lanes at the same
    positions as on a batch of 8, so the card's run and the CPU re-run of
    its first 8 envs start alike."""
    env = pt.make("jumper", device="cpu")
    bank = env.generate_bank(pt.random.key(7), NUM_LEVELS)
    placed = [chip_smoke.place_jumper_lanes(
        env.reset(bank, pt.random.key(8), n)[0].game, N) for n in (2 * N, N)]
    (big, big_lanes), (small, small_lanes) = placed
    assert big_lanes == small_lanes == run["lanes"]
    for f in ("pos", "vel"):
        assert torch.equal(getattr(big, f)[:N], getattr(small, f))


def test_chip_smoke_lane_placement_needs_a_spike(run):
    """With no spike in lanes 1..n-1 the placement raises, rather than
    make a hazard the level lacks."""
    gs = run["reset"][2].game
    lv = dataclasses.replace(
        gs.level, spike_grid=torch.zeros_like(gs.level.spike_grid))
    with pytest.raises(ValueError, match="no spike"):
        chip_smoke.place_jumper_lanes(dataclasses.replace(gs, level=lv), N)


# ---------------------------------------------------------------------------
# Render
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_observe():
    """The JAX package's observe_batch on its TPU path, jitted once."""
    with pytest.MonkeyPatch.context() as mp:
        _jax_kernels(mp)
        fn = jax.jit(functools.partial(jjump.observe_batch, jjump.Config()))
        yield lambda st: np.asarray(fn(_to_jax_state(st)))


@pytest.mark.parametrize("seed", [0, 1])
def test_observe_batch_matches_jax(banks, jax_observe, seed):
    """observe_batch on random states (every pose, dust of every age,
    needles in every direction) against the JAX package's render on its
    TPU path: B1's and B3's TPU kernels in interpret mode."""
    st = random_states(banks[0], 10 + seed)
    want = jax_observe(st)
    got = tjump.observe_batch(tjump.Config(), convert.state(tjump, st, "cpu"))
    assert got.dtype == torch.uint8 and got.shape == (N, 3, 64, 64)
    np.testing.assert_array_equal(want, got.numpy())


def _fma(a, b, c):
    """f32 a * b + c rounded once."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


SITES = ("pix", "drift", "bunny", "dist", "needle")


def _placements(st, pix=True, drift=True, bunny=True, dist=True,
                needle=True):
    """The f32 values the render rounds to the stamps' and the needle's
    top-left pixels, from numpy states: (y, x) of the dust (its 10 slots),
    of the bunny, and of the needle. With every switch True, as XLA CPU
    computes them; a switch False computes its site otherwise: pix's
    (c - cam) * 4.8 + 32 - 4, the dust's y - ratio * 0.17 and the needle
    pixel's chain of adds as the JAX source reads, each op rounded on its
    own and no constant folded; the bunny's y - 1 + off + bscale * 1.33 *
    0.5 with bscale * f32(0.665) fused into the add (XLA folds it to that
    product, but LLVM then folds the select of constant scales times 0.665
    into rounded constants, so it fuses nothing there); the needle
    distance's x * x + y * y as sqrt(fma(x, x, y * y)), which a jit of
    that line alone computes, but the render's graph does not."""
    f32 = np.float32
    cam_x = np.round(st.pos[:, 0] * f32(4)).astype(f32) * f32(0.25)
    cam_y = np.round((st.pos[:, 1] - f32(0.5)) * f32(4)).astype(f32) \
        * f32(0.25)

    def place(cx, cy):
        dx, dy = cx - cam_x[:, None], cy - cam_y[:, None]
        if pix:
            return _fma(dy, f32(4.8), f32(28)), _fma(dx, f32(4.8), f32(28))
        return ((dy * f32(4.8) + f32(32)) - f32(4),
                (dx * f32(4.8) + f32(32)) - f32(4))

    ratio = np.clip((f32(5) - st.part_life) * f32(0.2), f32(0), f32(1))
    py = (_fma(-ratio, f32(0.17), st.part_pos[..., 1]) if drift
          else st.part_pos[..., 1] - ratio * f32(0.17))
    dust = place(st.part_pos[..., 0], py)
    pose = np.where((np.abs(st.vel[:, 0]) < f32(0.01)) & st.on_ground, 0,
                    np.where(~st.on_ground, 1,
                             np.where(st.anim_t > f32(0.5), 3, 2)))
    j = pose == 1
    bscale = np.where(j, f32(0.6), f32(0.5))
    y0 = st.pos[:, 1] - f32(1) + np.where(j, f32(0.25), f32(0.2))
    by = (y0 + bscale * f32(1.33) * f32(0.5) if bunny
          else _fma(bscale, f32(1.33) * f32(0.5), y0))
    bx = (st.pos[:, 0] - f32(0.25) + np.where(j, f32(-0.05), f32(0))
          + bscale * f32(0.5))
    bun = place(bx[:, None], by[:, None])
    tg = st.level.goal_pos - st.pos
    sq = (tg[:, 0] * tg[:, 0] + tg[:, 1] * tg[:, 1] if dist
          else _fma(tg[:, 0], tg[:, 0], tg[:, 1] * tg[:, 1]))
    dinv = f32(1) / np.maximum(f32(1e-4), np.sqrt(sq))
    dirx, diry = tg[:, 0] * dinv, tg[:, 1] * dinv
    if needle:
        ndl = (_fma(diry, f32(15), f32(tjump._NEEDLE_R0)),
               _fma(dirx, f32(15), f32(tjump._NEEDLE_C0)))
    else:
        cs = 200.0 * 0.3
        ndl = (((f32(cs * 0.5 + 9.6) + f32(15) * diry) + f32(3)) - f32(16),
               ((f32(64 - cs * 0.75 - 9.6) + f32(15) * dirx) + f32(15))
               - f32(16))
    return dust, bun, ndl


def _moved(a, b, pixels):
    """bool [n]: where two `_placements` differ, in their rounded pixels
    or (pixels False) in their f32 bits."""
    out = np.zeros(a[0][0].shape[0], bool)
    for x, o in zip(a, b):
        for u, v in zip(x, o):
            d = (np.round(u) != np.round(v)) if pixels else (
                u.view(np.int32) != v.view(np.int32))
            out |= d.reshape(d.shape[0], -1).any(1)
    return out


def _site_states(bank, site, n=8, tries=16384, seed=30):
    """n states where computing `site` op by op (`_placements`) gives
    another pixel than XLA's fused or folded rounding, found among `tries`
    random states whose value at that site is set within a few ulp of a
    half pixel: a dust particle's x (pix) or drifted y (drift), or the
    needle's y (dist, needle). The bunny's two products differ by 1e-8,
    under half an ulp of its pixel's f32 value near a half, so no pixel
    moves: its states are those where the f32 value differs (the jumping
    pose with y near 0.955, where the sum's ulp is that fine)."""
    rng = np.random.default_rng(seed + SITES.index(site))
    f32 = np.float32
    st = random_states(bank, seed, n=NUM_LEVELS)
    st = jax.tree.map(lambda a: np.resize(a, (tries,) + a.shape[1:]), st)
    cam_x = np.round(st.pos[:, 0] * f32(4)).astype(f32) * f32(0.25)
    cam_y = np.round((st.pos[:, 1] - f32(0.5)) * f32(4)).astype(f32) \
        * f32(0.25)

    def jitter(v):
        return (v + rng.integers(-8, 9, v.shape) * np.spacing(v)).astype(f32)

    half = (rng.integers(0, 56, (tries, 10)) + 0.5 - 28) / 4.8
    part = st.part_pos.copy()
    if site == "pix":
        part[..., 0] = jitter(f32(cam_x[:, None] + half))
    elif site == "drift":
        ratio = np.clip((f32(5) - st.part_life) * f32(0.2), 0, 1)
        part[..., 1] = jitter(f32(cam_y[:, None] + half + ratio * 0.17))
    pos, goal, on_ground = st.pos.copy(), st.level.goal_pos, st.on_ground
    if site == "bunny":
        on_ground = np.zeros_like(on_ground)
        pos[:, 1] = jitter(np.full(tries, f32(0.955)))
    elif site in ("dist", "needle"):  # 15 * diry + 26.6 near a half
        dy = (rng.integers(12, 42, tries) + 0.5 - 26.6) / 15
        dx = np.sqrt(1 - dy * dy) * rng.choice([-1, 1], tries)
        r = rng.uniform(0.5, 15, tries)
        pos = jitter(f32(goal - r[:, None] * np.stack([dx, dy], -1)))
    st = st.replace(part_pos=part, pos=pos, on_ground=on_ground)
    moved = _moved(_placements(st), _placements(st, **{site: False}),
                   pixels=site != "bunny")
    pick = np.flatnonzero(moved)[:n]
    assert pick.size == n, (site, pick.size)
    return jax.tree.map(lambda a: a[pick], st)


@pytest.fixture(scope="module")
def site_states(banks):
    """`_site_states` for every site, 8 states each, in SITES order."""
    parts = [_site_states(banks[0], site) for site in SITES]
    return jax.tree.map(lambda *a: np.concatenate(a), *parts)


def test_observe_batch_matches_jax_where_fusion_moves_stamps(site_states,
                                                             jax_observe):
    """On states whose dust and needle land where one rounding of XLA's
    fused multiply-adds and folded constants gives another pixel than the
    source's op-by-op rounding (`_site_states` of pix, drift and needle),
    the port's obs equal the JAX render's (TPU path, interpret mode). Not
    the dist states: at 8 envs XLA CPU runs the distance's loop without
    vectorizing it and then fuses x * x into the add, unlike its vector
    loop at larger batches, which the port follows
    (test_render_rounding_sites_match_xla)."""
    st = jax.tree.map(lambda a: np.concatenate(
        [a[0:2], a[8:11], a[32:35]]), site_states)
    want = jax_observe(st)
    got = tjump.observe_batch(tjump.Config(), convert.state(tjump, st, "cpu"))
    np.testing.assert_array_equal(want, got.numpy())


def test_render_rounding_sites_match_xla(banks, site_states):
    """The f32 values the port's render rounds to pixels, and its stamp
    groups' variants and f32 scales, equal those of the JAX package's
    jitted render, bitwise, on random states and on `_site_states`; and
    each site XLA CPU fuses or folds changes some of those values (for all
    but the bunny, some pixel) where the source's op-by-op rounding is
    taken instead (`_placements`): pix's (c - cam) * 4.8 + 32 - 4 (one
    fused multiply-add with 28), the dust's drift y - ratio * 0.17 (fused),
    the bunny's y + bscale * 1.33 * 0.5 (bscale * f32(0.665), rounded:
    not fused), sqrt(x**2 + y**2) (each op rounded: not fused) and the
    needle pixel's constant adds (folded in f32, fused). The dust's (5 - life) / 5 is a
    multiply by f32(0.2) (its scales hold it), and the needle's bin comes
    from glibc's atan2f."""
    # 64 states: XLA CPU vectorizes the render's elementwise loops, and
    # the distance's rounding differs between its vector loop (each op
    # rounded, as the port) and its scalar loop (x * x fused), which it
    # takes for batches of 16 or fewer and for the tail of a batch past a
    # multiple of the vector width
    st = jax.tree.map(lambda *a: np.concatenate(a), site_states,
                      random_states(banks[0], 20, n=NUM_LEVELS),
                      random_states(banks[0], 21, n=8))
    got = render_inputs(jjump, jjump.Config(), _to_jax_state(st))
    rounded, groups = got["rounded"], [g[:2] for g in got["groups"]]
    assert len(rounded) == 9
    tst = convert.state(tjump, st, "cpu")
    args = tjump._scene_inputs(tjump.Config(), tst)
    ratio, pcentre = tjump._dust(tst)
    _, bcentre = tjump._bunny(tst)
    cam_x = torch.round(tst.pos[:, 0] * 4) / 4
    cam_y = torch.round((tst.pos[:, 1] - 0.5) * 4) / 4
    centres = torch.cat([pcentre, tst.level.goal_pos[:, None]], 1)
    port = [tst.pos[:, 0] * 4, (tst.pos[:, 1] - 0.5) * 4,
            *tC.stamp_origin(centres, cam_x, cam_y, tjump.PPU, 8),
            *tC.stamp_origin(bcentre, cam_x, cam_y, tjump.PPU, 8),
            *tjump._needle(tst)]
    for w, g in zip(rounded, port):
        same(w, g.reshape(w.shape))
    for (wv, ws), g in zip(groups, args[12]):
        same(wv, g[1])
        same(ws, g[2])
    xla = _placements(st)
    want = ((rounded[2][:, :10], rounded[3][:, :10]), (rounded[4], rounded[5]),
            (rounded[7], rounded[8]))
    for x, w in zip(xla, want):
        for u, v in zip(x, w):
            same(v, u.reshape(v.shape))
    for k, site in enumerate(SITES):
        other = _placements(st, **{site: False})
        part = slice(8 * k, 8 * k + 8)
        assert _moved(xla, other, pixels=site != "bunny")[part].all(), site


def _differ(a, b):
    return (np.asarray(a).view(np.int32) != np.asarray(b).view(np.int32)).any()


def test_compass_blend_rounds_each_bf16_op():
    """The compass circle over the scene, img * (1 - a) + rgbp on bf16
    arrays, as XLA CPU computes it (jumper.py:805-806): every op rounded to
    bf16; one f32 rounding of the whole would differ."""
    rng = np.random.default_rng(8)
    img = torch.from_numpy(rng.integers(0, 256, (4, 3, 64, 64)).astype(
        np.float32)).to(torch.bfloat16)
    ST = tjump._scene_tensors(4, 20, "cpu")
    rgbp_np, a_np = tjump._compass_overlay(64)
    want = np.asarray(jax.jit(lambda i: i * (1.0 - jnp.asarray(
        a_np, jnp.bfloat16)) + jnp.asarray(rgbp_np, jnp.bfloat16))(
            jnp.asarray(img.float().numpy(), jnp.bfloat16)))
    got = tjump._compass(img, ST)
    np.testing.assert_array_equal(want.astype(np.float32), got.float().numpy())
    once = (img.float() * (1.0 - ST["compass_a"].float())
            + ST["compass_rgbp"].float()).to(torch.bfloat16)
    assert not torch.equal(once, got)


def test_step_rounding_sites_match_xla(trajectories):
    """The step's candidate sites (jumper.py:372, :396-407, :431): vel +
    mix * (...) * DT and anim_t + 0.1 * DT need no fused multiply-add
    (the products by DT are exact, and 0.1 * DT is Python's 0.025,
    rounded once); the dust spawn (y - 0.8 resolved, + 0.8, - 0.2) is
    ry + f32(0.8 - 0.2) as XLA folds it, where two roundings differ; and
    the agent's rect after the resolver is (rx, ry), XLA folding
    (rx + 0.25) - 0.25. The step tests hold all of it field by field;
    here, that the folded spawn differs from the unfolded one somewhere,
    so those tests see it."""
    assert np.float32(0.1 * 0.25) == np.float32(0.1) * np.float32(0.25)
    ry = np.random.default_rng(9).uniform(0, 20, 10000).astype(np.float32)
    folded = ry + np.float32(tjump._SPAWN_DY)
    assert _differ(folded, (ry + np.float32(0.8)) - np.float32(0.2))
    spawned = [o[0].part_pos[o[0].part_life == tjump.PART_LIFESPAN - tjump.DT]
               for o in trajectories]
    assert sum(len(s) for s in spawned) > 0


def test_particle_scale_reaches_b1_in_f32(banks):
    """The dust group's scales are 0.5 * (1 - ratio) in f32, as the JAX
    package hands them to its TPU kernel: fractional, not just 0/1, and not
    rounded to bf16."""
    st = random_states(banks[0], 12)
    groups = tjump._scene_inputs(tjump.Config(),
                                 convert.state(tjump, st, "cpu"))[12]
    assert [g[1].shape[1] for g in groups] == [11, 1]
    s = groups[0][2]
    ratio = np.clip((np.float32(5.0) - st.part_life) * np.float32(0.2), 0, 1)
    want = np.where(st.part_life > 0, np.float32(0.5) * (1 - ratio), 0)
    same(want.astype(np.float32), s[:, :10])
    frac = s[(s > 0) & (s < 1)]
    assert frac.numel() > 0
    assert not torch.equal(frac, frac.to(torch.bfloat16).float())


# ---------------------------------------------------------------------------
# The exact renders (tests/render_parity.py): observe at 64 and 128 px,
# Environment.render, the selectors against the JAX render's `_onehot`
# arguments, the scene_phases=0 render on the TPU's stamp path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [64, 128])
def test_observe_matches_jax(size):
    st = RP.check_observe("jumper", size=size)
    assert (st.game.part_life > 0).any()  # the dust, at fractional alpha


def test_observe_selectors_match_the_jax_render():
    RP.check_selectors("jumper")


@pytest.mark.parametrize("env_index", [0, 1])
def test_render_matches_jax(env_index):
    RP.check_render("jumper", env_index=env_index)


def test_observe_exact_matches_jax():
    RP.check_exact("jumper")


def test_observe_exact_selectors_match_the_jax_render():
    RP.check_exact_selectors("jumper")


@pytest.mark.parametrize("exact", [False, True])
def test_observe_matches_jax_near_texel_edges(exact):
    """Cameras that put pixel centres within 2 ulp of texel edges: every
    layer of jumper's renders computes its camera coords fused
    (c * f32(1/4.8) + cam, one rounding); the unfused form fails here."""
    RP.check_near_edges("jumper", 0.5, tjump.PPU, exact=exact)
