"""The port's caveflyer (procgen2_tpu_torch/games/caveflyer.py) and the
modules it brought (gen/rooms.py, gen/kruskal.py, random.categorical,
physics/tiles.probe_any_solid) against the JAX package's, given the same
keys, masks, states and actions. Every comparison is bitwise: f32 compared
as int32 views, everything else equal.

* categorical and masked_uniform_cell on masks of caveflyer's three sizes
  (20, 40, 45), half open and all but one cell masked; the rooms functions
  on random walls; probe_any_solid on rects that straddle tiles and edges;
* the level bank (easy, every field; hard and memory, smaller banks) and
  reset;
* the 4-sub-step step at every step from random states on levels with
  objects, with bullets placed on walls, meteors, targets (+3) and enemy
  ships;
* `Environment.step` with a lane on its goal (+10) and a lane on a hazard
  (death, 0), both of which end and auto-reset, states, rewards and obs
  at every step;
* `observe_batch` against the JAX package's render on its TPU path (the
  scene kernel `scene_tpu_raw` in interpret mode), which B1 replaces. Its
  CPU fallback (`scene_reference` on the expanded field) rounds a stamp's
  scale to bf16 before the texel product, so its smoke, the one group
  with a fractional alpha, can differ by one bf16 rounding (ROADMAP C).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import game_lanes
import jax_reference as JR
import procgen2_tpu_torch as pt
from procgen2_tpu.gen import kruskal as jkruskal
from procgen2_tpu.gen import rooms as jrooms
from procgen2_tpu.games import caveflyer as jcave
from procgen2_tpu.physics import tiles as jtiles
from procgen2_tpu_torch import random as R
from procgen2_tpu_torch.games import caveflyer as tcave
from procgen2_tpu_torch.gen import kruskal as tkruskal
from procgen2_tpu_torch.gen import rooms as trooms
from procgen2_tpu_torch.physics import tiles as ttiles
from procgen2_tpu_torch.utils import convert
import render_parity as RP
import texel_edges
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NUM_LEVELS, N, T = 64, 8, 6
LEVEL_FIELDS = [f.name for f in dataclasses.fields(tcave.Level)]
STATE_FIELDS = [f.name for f in dataclasses.fields(tcave.State)
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


def _generate_both(mode, n):
    """The JAX package's bank of n levels in `mode` (`Environment.
    generate_bank`, level i keyed as `_keys` keys it) and the port's."""
    _, tk = _keys(n)
    jl = JR.bank("caveflyer", (("mode", mode),), seed=7, n=n)
    return np_tree(jl), tcave.generate(tcave.Config(mode=mode), tk)


@pytest.fixture(scope="module")
def jax_env():
    """The JAX Environment (its render on the TPU path: B1's kernel
    `scene_tpu_raw` in interpret mode) and its bank of NUM_LEVELS levels,
    level i keyed fold_in(key(7), i) as `_keys` keys it: every easy-mode
    fixture shares this one compile of the level generator."""
    return JR.env("caveflyer", tpu=True), JR.bank("caveflyer", n=NUM_LEVELS)


@pytest.fixture(scope="module")
def banks(jax_env):
    _, tk = _keys(NUM_LEVELS)
    return np_tree(jax_env[1]), tcave.generate(tcave.Config(), tk)


# ---------------------------------------------------------------------------
# categorical, masked_uniform_cell, rooms, probe_any_solid
# ---------------------------------------------------------------------------

def _masks(D, n, seed):
    """n masks [n, D, D]: half open at random, the last quarter with all
    but one cell masked."""
    rng = np.random.default_rng(seed)
    m = rng.random((n, D, D)) < 0.5
    for i in range(3 * n // 4, n):
        m[i] = False
        m[i, rng.integers(D), rng.integers(D)] = True
    return m


@pytest.mark.parametrize("D", [20, 40, 45])
def test_categorical_matches_jax(D):
    """categorical (float64 Gumbel rounded once) picks the cell that
    jax.random.categorical picks, on 512 draws per mask size."""
    n = 512
    m = _masks(D, n, D)
    logits = np.where(m.reshape(n, -1), 0.0, -np.inf).astype(np.float32)
    jk, tk = _keys(n, seed=D)
    want = jax.jit(jax.vmap(jax.random.categorical))(jk, jnp.asarray(logits))
    got = R.categorical(tk, torch.from_numpy(logits))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert m.reshape(n, -1)[np.arange(n), got.numpy()].all()


@pytest.mark.parametrize("D", [20, 45])
def test_masked_uniform_cell_matches_jax(D):
    n = 64
    m = _masks(D, n, 100 + D)
    jk, tk = _keys(n, seed=3)
    wi, wj = jax.jit(jax.vmap(jkruskal.masked_uniform_cell))(jk, jnp.asarray(m))
    gi, gj = tkruskal.masked_uniform_cell(tk, torch.from_numpy(m))
    np.testing.assert_array_equal(np.asarray(wi), gi.numpy())
    np.testing.assert_array_equal(np.asarray(wj), gj.numpy())


@pytest.fixture(scope="module")
def walls():
    """Random 50% walls [16, 20, 20] smoothed once (rooms of all shapes)."""
    rng = np.random.default_rng(5)
    w = rng.random((16, 20, 20)) < 0.5
    return np.asarray(jax.vmap(jrooms.ca_smooth)(jnp.asarray(w)))


def test_ca_smooth_matches_jax():
    w = np.random.default_rng(6).random((16, 20, 20)) < 0.5
    want = jax.vmap(jrooms.ca_smooth)(jnp.asarray(w))
    same(want, trooms.ca_smooth(torch.from_numpy(w)))


def test_rooms_bfs_path_dilate_match_jax(walls):
    """largest_room, bfs_dist, shortest_path_mask and dilate_in on the
    same open masks, from a source and to a destination in the room."""
    open_ = ~walls
    H = open_.shape[1]
    iters = H * H // 2
    room_j = jax.vmap(lambda o: jrooms.largest_room(o, iters))(
        jnp.asarray(open_))
    room_t = trooms.largest_room(torch.from_numpy(open_), iters)
    same(room_j, room_t)
    room = np.asarray(room_j)
    rng = np.random.default_rng(7)
    cells = [np.argwhere(r) for r in room]
    src = np.stack([c[rng.integers(len(c))] for c in cells])
    dst = np.stack([c[rng.integers(len(c))] for c in cells])
    dist_j = jax.vmap(lambda r, y, x: jrooms.bfs_dist(r, y, x, iters))(
        jnp.asarray(room), jnp.asarray(src[:, 0]), jnp.asarray(src[:, 1]))
    dist_t = trooms.bfs_dist(room_t, torch.from_numpy(src[:, 0]),
                             torch.from_numpy(src[:, 1]), iters)
    same(dist_j, dist_t)
    path_j = jax.vmap(jrooms.shortest_path_mask)(
        dist_j, jnp.asarray(dst[:, 0]), jnp.asarray(dst[:, 1]))
    path_t = trooms.shortest_path_mask(dist_t, torch.from_numpy(dst[:, 0]),
                                       torch.from_numpy(dst[:, 1]))
    same(path_j, path_t)
    assert (np.asarray(path_j).sum((1, 2)) > 1).any()
    dil_j = jax.vmap(lambda p, o: jrooms.dilate_in(p, o, 4))(path_j, room_j)
    same(dil_j, trooms.dilate_in(path_t, room_t, 4))


def test_probe_any_solid_matches_jax(walls):
    """Rects of the bullets' (0.02) and the enemies' (0.8) sizes placed
    on tile corners, edges and across the map's border (out of bounds is
    solid). The port takes the rects by their edges; the far edges here
    are x + w in f32, as the JAX function computes them."""
    rng = np.random.default_rng(8)
    n, K = walls.shape[0], 64
    x = (rng.integers(-2, 22, (n, K)) + rng.choice(
        [0.0, 0.01, 0.5, 0.99, -0.01, 0.6], (n, K))).astype(np.float32)
    y = (rng.integers(-2, 22, (n, K)) + rng.choice(
        [0.0, 0.01, 0.5, 0.99, -0.01, 0.2], (n, K))).astype(np.float32)
    wh = rng.choice(np.float32([0.02, 0.8]), (n, K))
    want = np.asarray(jax.vmap(lambda s, a, b, c: jtiles.probe_any_solid(
        s, a, b, c, c, oob_solid=True))(jnp.asarray(walls), x, y, wh))
    got = ttiles.probe_any_solid(
        torch.from_numpy(walls),
        (torch.from_numpy(x), torch.from_numpy(x + wh)),
        (torch.from_numpy(y), torch.from_numpy(y + wh)))
    same(want, got)
    inside = (x >= 0) & (x + wh <= walls.shape[2]) & (y >= 0) & (
        y + wh <= walls.shape[1])
    assert want[inside].any() and not want[inside].all()
    assert want[~inside].all()


# ---------------------------------------------------------------------------
# Bank and reset
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("field", LEVEL_FIELDS)
def test_generate_matches(banks, field):
    jl, tl = banks
    same(getattr(jl, field), getattr(tl, field))


@pytest.mark.parametrize("mode,n", [("hard", 16), ("memory", 8)])
def test_generate_other_modes(mode, n):
    jl, tl = _generate_both(mode, n)
    same_tree(jl, tl)
    D = tcave.Config(mode=mode).world_dim
    assert tl.wall.shape == (n, D, D)


def test_generate_covers_the_branches(banks):
    """The bank has levels with and without objects, and enemy ships
    moving along each axis at 0.1-0.2 units per sub-step."""
    _, tl = banks
    n_obj = tl.obst_exists.sum(1)
    assert (n_obj == 0).any() and (n_obj > 0).any()
    v = tl.enemy_vel0[tl.enemy_exists]
    assert ((v == 0).sum(-1) == 1).all()
    assert (v.abs().max(-1).values >= 0.1).all()
    assert (v[:, 0] != 0).any() and (v[:, 1] != 0).any()


def test_reset_matches(banks):
    jl, _ = banks
    lv = jax.tree.map(lambda a: jnp.asarray(a[:N]), jl)
    keys = jax.random.split(jax.random.key(8), N)
    want = np_tree(jax.vmap(functools.partial(jcave.reset, jcave.Config()))(
        lv, keys))
    got = tcave.reset(tcave.Config(), convert.level(tcave, jax.tree.map(
        np.asarray, lv), "cpu"), torch.from_numpy(np_tree(keys).astype(np.int64)))
    for f in STATE_FIELDS:
        same(getattr(want, f), getattr(got, f))


# ---------------------------------------------------------------------------
# Step
# ---------------------------------------------------------------------------

def random_states(bank, seed, n=N):
    """States on the bank's first n levels that have objects, with the
    ship anywhere (in walls too), random velocities and headings, live,
    exploding and dead bullets, targets alive at random, moved enemies and
    smoke of every age. Bullet 0 of env i is live and sits on a wall (i %
    4 == 0), a meteor (1) or an enemy ship (3), or flies into a live
    target (2) on the last sub-step, where its +3 is the step's reward (a
    step's reward is its last active sub-step's)."""
    rng = np.random.default_rng(seed)
    pick = np.flatnonzero(bank.obst_exists.any(1))[:n]
    lv = jax.tree.map(lambda a: a[pick], bank)
    D = lv.wall.shape[1]
    M = lv.obst_exists.shape[1]
    f32 = np.float32
    enemy_pos = (lv.enemy_pos0 + rng.uniform(-1, 1, (n, M, 2))).astype(f32)
    b_pos = rng.uniform(0, D, (n, 32, 2)).astype(f32)
    b_vel = rng.uniform(-1, 1, (n, 32, 2)).astype(f32)
    b_frame = rng.choice(f32([-1, 0, 0, 0, 1, 2.5, 4.875]), (n, 32))
    target_alive = lv.target_exists | (rng.random((n, M)) < 0.3)
    for i in range(n):
        ry, x = np.argwhere(lv.wall[i])[rng.integers(lv.wall[i].sum())]
        # 0.48 left of the target, 0.1 a sub-step: it overlaps the target
        # (half-size 0.25) from the fourth probe on, inside the target's cell
        spots = (np.float32([x + 0.5, ry + 0.5]), lv.obst_pos[i, 0],
                 lv.target_pos[i, 0] - f32([0.48, 0.0]), enemy_pos[i, 0] + 0.3)
        b_pos[i, 0] = spots[i % 4]
        if i % 4 == 2:
            b_vel[i, 0] = (0.4, 0.0)
            target_alive[i, 0] = True
    b_frame[:, 0] = 0.0
    # bullet 0 the newest, so that it stays in the ring's window while
    # expiring bullets shrink it
    next_bullet = rng.integers(0, 32, n).astype(np.int32)
    next_bullet[2::4] = 1
    life = np.where(rng.random((n, 10)) < 0.6,
                    5 - 0.25 * rng.integers(0, 24, (n, 10)),
                    rng.uniform(-1, 5, (n, 10)))
    rot = np.where(rng.random(n) < 0.5, rng.integers(-400, 400, n) * 0.0125,
                   rng.uniform(-30, 30, n))
    return jcave.State(
        level=lv,
        pos=rng.uniform(0.5, D - 0.5, (n, 2)).astype(f32),
        vel=rng.uniform(-0.4, 0.4, (n, 2)).astype(f32),
        rot=rot.astype(f32),
        bullet_timer=rng.choice(f32([0, 0, 0.25, 0.5]), n),
        b_pos=b_pos,
        b_vel=b_vel,
        b_rot=rng.uniform(-10, 10, (n, 32)).astype(f32),
        b_frame=b_frame,
        num_bullets=np.full(n, 32, np.int32),
        next_bullet=next_bullet,
        target_alive=target_alive,
        enemy_pos=enemy_pos,
        enemy_vel=lv.enemy_vel0,
        part_pos=rng.uniform(0, D, (n, 10, 2)).astype(f32),
        part_life=life.astype(f32),
        part_dir=rng.uniform(-1, 1, (n, 10, 2)).astype(f32),
        part_rot=rng.uniform(-10, 10, (n, 10)).astype(f32),
        part_spawn_timer=rng.choice(f32([0, 0.25, 0.5, 0.75]), n),
        t=rng.integers(0, 20, n).astype(np.int32),
        rng=np.zeros((n, 2), np.uint32),
    )


def _to_jax_state(st):
    return jax.tree.map(jnp.asarray,
                        st.replace(rng=jax.random.wrap_key_data(st.rng)))


@pytest.fixture(scope="module")
def trajectories(banks):
    """T game-level steps (no auto-reset) from random states: JAX and port
    results per step, and the first step's bullet frames before it."""
    jl, _ = banks
    st = random_states(jl, 0)
    actions = np.random.default_rng(1).integers(0, 15, (T, N)).astype(np.int32)
    actions[:2, ::3] = 9  # fire
    jstep = JR.vmapped("caveflyer", "step")
    jst = _to_jax_state(st)
    tst = convert.state(tcave, st, "cpu")
    out = []
    for t in range(T):
        jst, jr, jd, _ = jstep(jst, jnp.asarray(actions[t]))
        tst, tr, td, _ = tcave.step(tcave.Config(), tst,
                                    torch.from_numpy(actions[t]))
        out.append((np_tree(jst), np.asarray(jr), np.asarray(jd), tst, tr, td))
    return out


@pytest.mark.parametrize("t", range(T))
def test_step_matches(trajectories, t):
    jst, jr, jd, tst, tr, td = trajectories[t]
    for f in STATE_FIELDS:
        same(getattr(jst, f), getattr(tst, f))
    same(jr, tr)
    same(jd, td)


def test_step_bullets_strike_every_kind(trajectories):
    """Step 0's placed bullets: all four strike (their frames go to the
    explosion), and the targets flown into are destroyed, for +3."""
    jst, jr, _, _, _, _ = trajectories[0]
    assert (jst.b_frame[:, 0] >= 1.0).all()
    assert not jst.target_alive[2::4, 0].any()
    assert (np.remainder(jr, 10) == 3).any()


# ---------------------------------------------------------------------------
# Environment: bank, reset, auto-reset, obs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def run(jax_env):
    """Both Environments from the same keys; after reset the goal lane and
    the hazard lane are placed with game_lanes' placement (carried across
    with utils/convert); T steps with the same actions, rendered (the JAX
    render on its TPU path)."""
    return _run(*jax_env)


def _run(jenv, jbank):
    tenv = pt.make("caveflyer", device="cpu")
    tbank = tenv.generate_bank(pt.random.key(7), NUM_LEVELS)
    jst, jts = jenv.reset(jbank, jax.random.key(8), num_envs=N)
    tst, tts = tenv.reset(tbank, pt.random.key(8), N)
    reset = (np_tree(jst), np.asarray(jts.obs), tst, tts)
    start = np_tree(jst)
    game, lanes = game_lanes.place_caveflyer_lanes(
        convert.state(tcave, start.game, "cpu"), N)
    start = start.replace(game=start.game.replace(
        pos=game.pos.numpy(), vel=game.vel.numpy(),
        target_alive=game.target_alive.numpy()))
    jst = jax.tree.map(jnp.asarray, start.replace(
        rng=jax.random.wrap_key_data(start.rng),
        game=start.game.replace(rng=jax.random.wrap_key_data(start.game.rng))))
    tst = convert.env_state(tcave, start, "cpu")
    actions = np.random.default_rng(3).integers(0, 15, (T, N)).astype(np.int32)
    steps = []
    for t in range(T):
        jst, jts = jenv.step(jbank, jst, jnp.asarray(actions[t]))
        tst, tts = tenv.step(tbank, tst, torch.from_numpy(actions[t]))
        steps.append((np_tree(jst), np_tree(jts), tst, tts))
    return dict(jbank=jbank, tbank=tbank, reset=reset, steps=steps,
                lanes=lanes, start=start)


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
    for k in ("returned_episode_return", "returned_episode_length", "done"):
        same(jts.info[k], tts.info[k])


def test_placed_lanes_end_and_restart(run):
    goal, hazard = run["lanes"]
    _, _, tst, tts = run["steps"][0]
    assert bool(tts.terminated[goal]) and float(tts.reward[goal]) == 10.0
    assert bool(tts.terminated[hazard]) and float(tts.reward[hazard]) == 0.0
    for lane in (goal, hazard):  # restarted: step counter 0, no bullets
        assert int(tst.game.t[lane]) == 0 and int(tst.ep_length[lane]) == 0
        assert int(tst.game.num_bullets[lane]) == 0
        assert tst.game.pos[lane].tolist() == \
            tst.game.level.agent_pos[lane].tolist()


def test_chip_smoke_places_the_same_lanes(run):
    """game_lanes' placement (the one `run` and chip_smoke.py use) picks its
    lanes from the first lanes only: on the first 8 of 16 envs it places
    the same lanes at the same positions as on a batch of 8, so the card's
    run and the CPU re-run of its first 8 envs start alike."""
    env = pt.make("caveflyer", device="cpu")
    bank = env.generate_bank(pt.random.key(7), NUM_LEVELS)
    placed = [game_lanes.place_caveflyer_lanes(
        env.reset(bank, pt.random.key(8), n)[0].game, N) for n in (2 * N, N)]
    (big, big_lanes), (small, small_lanes) = placed
    assert big_lanes == small_lanes == run["lanes"]
    for f in ("pos", "vel", "target_alive"):
        assert torch.equal(getattr(big, f)[:N], getattr(small, f))


@pytest.fixture(scope="module")
def jax_observe():
    """The JAX package's observe_batch on its TPU path, jitted once."""
    fn = JR.observe_batch("caveflyer")
    return lambda st: np.asarray(fn(_to_jax_state(st)))


@pytest.mark.parametrize("seed", [0, 1])
def test_observe_batch_matches_jax(banks, jax_observe, seed):
    """observe_batch on random states (ship, bullets, explosions, smoke of
    every age and rotation) against the JAX package's render on its TPU
    path: B1's TPU kernel in interpret mode."""
    st = random_states(banks[0], 10 + seed)
    want = jax_observe(st)
    got = tcave.observe_batch(tcave.Config(), convert.state(tcave, st, "cpu"))
    assert got.dtype == torch.uint8 and got.shape == (N, 3, 64, 64)
    np.testing.assert_array_equal(want, got.numpy())


def test_scene_groups_carry_fractional_smoke(banks):
    """The smoke group's scales are the fading alpha in f32, as the JAX
    package hands them to its TPU kernel: fractional, not just 0/1, and
    not rounded to bf16."""
    st = random_states(banks[0], 12)
    groups = tcave._scene_inputs(tcave.Config(),
                                 convert.state(tcave, st, "cpu"))[12]
    assert [g[1].shape[1] for g in groups] == [10, 19, 32, 1]
    s = groups[0][2]
    ratio = np.clip((np.float32(5.0) - st.part_life) * np.float32(0.2), 0, 1)
    want = np.where(st.part_life > 0, np.float32(0.5) * (1 - ratio), 0)
    same(want.astype(np.float32), s)
    frac = s[(s > 0) & (s < 1)]
    assert frac.numel() > 0
    assert not torch.equal(frac, frac.to(torch.bfloat16).float())


def test_chip_smoke_lane_placement_needs_a_hazard(run):
    """With no meteor, live target or enemy ship in lanes 1..n-1 the
    placement raises, rather than make a hazard the level lacks."""
    gs = run["reset"][2].game
    lv = dataclasses.replace(gs.level,
                             obst_exists=torch.zeros_like(gs.level.obst_exists),
                             enemy_exists=torch.zeros_like(gs.level.enemy_exists))
    bare = dataclasses.replace(gs, level=lv,
                               target_alive=torch.zeros_like(gs.target_alive))
    with pytest.raises(ValueError, match="no hazard"):
        game_lanes.place_caveflyer_lanes(bare, N)


# ---------------------------------------------------------------------------
# The exact renders (tests/render_parity.py): observe at 64 and 128 px,
# Environment.render, the selectors against the JAX render's `_onehot`
# arguments, the scene_phases=0 render on the TPU's stamp path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [64, 128])
def test_observe_matches_jax(size):
    st = RP.check_observe("caveflyer", size=size, fire=0.4)
    g = convert.state(tcave, st.game, "cpu")
    window = tcave._ring_window(g.next_bullet, g.num_bullets)
    assert (g.part_life > 0).any()  # rotated smoke at fractional alpha
    assert (window & (g.b_frame == 0)).any()  # rotated lasers
    assert (window & (g.b_frame >= 1)).any()  # explosions


def test_observe_selectors_match_the_jax_render():
    RP.check_selectors("caveflyer", fire=0.4)


@pytest.mark.parametrize("env_index", [0, 1])
def test_render_matches_jax(env_index):
    RP.check_render("caveflyer", env_index=env_index, fire=0.4)


def test_observe_exact_matches_jax():
    RP.check_exact("caveflyer", fire=0.4)


def test_observe_exact_selectors_match_the_jax_render():
    RP.check_exact_selectors("caveflyer", fire=0.4)


@pytest.mark.parametrize("case", ["caveflyer_ship"])
def test_rotated_sprites_match_jax_on_texel_edges(case):
    """The rotated ship with a pixel on a texel edge (within an ulp) in
    every env: the port's observe equals the JAX package's, bitwise
    (tests/texel_edges.py, on this file's rollout programs)."""
    texel_edges.check(case)
