"""The port's chaser (procgen2_tpu_torch/games/chaser.py) against the JAX
package's, given the same keys, states and actions. Every comparison is
bitwise: f32 compared as int32 views, everything else equal.

* the level bank in easy (every field, through the Environment), hard and
  extreme (orbs per quadrant, eggs, pellets, the respawn cells); reset;
* the 4-sub-step step in every mode from random states built to reach
  junction turns, deaths, eaten enemies respawning, flights after an orb
  and completions;
* `Environment.step` with lane 0 left with nothing to collect (+10) and
  lane 1 with a hatched enemy on its agent (death, 0), both of which end
  and auto-reset (chip_smoke.py's placement), states, rewards and obs at
  every step;
* `observe_batch` in every mode: the kind field (walls, pellets, live
  orbs) and the one stamp group of enemies and agent, which the JAX
  package draws by its matmul semantics on every backend;
* the render's constant tables against the indices the JAX package's
  jitted render hands `compositor._onehot`, the stamps' pixels against
  the values its `jnp.round` takes (states near half pixels), both at 64
  envs (`jax_capture`); the reward's rounding site; argmin on ties.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from jax_capture import onehot_inputs, render_inputs
import procgen2_tpu as pg
import procgen2_tpu_torch as pt
from procgen2_tpu.games import chaser as jchase
from procgen2_tpu_torch import random as R
from procgen2_tpu_torch.games import chaser as tchase
from procgen2_tpu_torch.render import compositor as tC
from procgen2_tpu_torch.utils import convert
import render_parity as RP

NUM_LEVELS, N, T = 16, 8, 8
MODES = ("easy", "hard", "extreme")
LEVEL_FIELDS = [f.name for f in dataclasses.fields(tchase.Level)]
STATE_FIELDS = [f.name for f in dataclasses.fields(tchase.State)
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


def _to_jax_state(st):
    return jax.tree.map(jnp.asarray,
                        st.replace(rng=jax.random.wrap_key_data(st.rng)))


@pytest.fixture(scope="module")
def banks():
    """{mode: (JAX bank with numpy leaves, the port's bank)} of NUM_LEVELS
    levels keyed fold_in(key(7), i)."""
    jk, tk = _keys(NUM_LEVELS)
    out = {}
    for mode in MODES:
        want = np_tree(jax.jit(jax.vmap(functools.partial(
            jchase.generate, jchase.Config(mode=mode))))(jk))
        out[mode] = (want, tchase.generate(tchase.Config(mode=mode), tk))
    return out


# ---------------------------------------------------------------------------
# Bank and reset
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("field", LEVEL_FIELDS)
def test_generate_matches(banks, mode, field):
    jl, tl = banks[mode]
    same(getattr(jl, field), getattr(tl, field))


@pytest.mark.parametrize("mode", MODES)
def test_generate_covers_the_branches(banks, mode):
    """4 orbs (3 in hard, 5 in extreme), the mode's eggs, and the agent,
    eggs, orbs and pellets on distinct free cells; pellets on all the
    others, which are also the respawn cells."""
    _, tl = banks[mode]
    cfg = tchase.Config(mode=mode)
    D = cfg.world_dim
    n_orbs = {"easy": 4, "hard": 3, "extreme": 5}[mode]
    assert (tl.orb_exists.sum(1) == n_orbs).all()
    assert (tl.egg_exists.sum(1) == cfg.total_enemies).all()
    n = torch.arange(NUM_LEVELS)
    taken = torch.zeros_like(tl.wall, dtype=torch.int32)
    for pos, live in ((tl.agent_pos[:, None], None), (tl.egg_pos, tl.egg_exists),
                      (tl.orb_pos, tl.orb_exists)):
        x, ry = (pos - 0.5).long().unbind(-1)
        for k in range(pos.shape[1]):
            ok = torch.ones(NUM_LEVELS, dtype=torch.bool) if live is None \
                else live[:, k]
            assert not tl.wall[n[ok], ry[ok, k], x[ok, k]].any()
            assert not tl.point_grid0[n[ok], ry[ok, k], x[ok, k]].any()
            taken[n[ok], ry[ok, k], x[ok, k]] += 1
    assert taken.max() == 1
    free = ~tl.wall
    assert torch.equal(tl.point_grid0 | (taken > 0), free)
    assert torch.equal(torch.flip(tl.respawn_free.transpose(1, 2), (1,)),
                       tl.point_grid0)
    assert tl.wall.shape == (NUM_LEVELS, D, D)


def test_reset_matches(banks):
    jl, _ = banks["easy"]
    lv = jax.tree.map(lambda a: jnp.asarray(a[:N]), jl)
    keys = jax.random.split(jax.random.key(8), N)
    want = np_tree(jax.vmap(functools.partial(jchase.reset, jchase.Config()))(
        lv, keys))
    got = tchase.reset(tchase.Config(), convert.level(tchase, jax.tree.map(
        np.asarray, lv), "cpu"), torch.from_numpy(np_tree(keys).astype(np.int64)))
    for f in STATE_FIELDS:
        same(getattr(want, f), getattr(got, f))


# ---------------------------------------------------------------------------
# Step
# ---------------------------------------------------------------------------

DIRS = np.array([[-1, 0], [1, 0], [0, -1], [0, 1], [0, 0]], np.float32)
DEATH, EATEN, ORB_FLEE, COMPLETE, COMPLETE3, FREE = range(6)


def random_states(bank, seed, n=NUM_LEVELS):
    """States on the bank's first n levels, env i of kind i % 6: a hatched
    enemy on the agent with nothing eaten (DEATH) or while the eat timer
    runs (EATEN); an uncollected orb overlapping the agent (ORB_FLEE);
    one pellet left, under the agent, every orb taken (COMPLETE); three
    pellets left under an agent on a cell corner (COMPLETE3: +0.12 + 10);
    or free. Elsewhere random: the agent and enemies on free cells and
    between cells, moving or not, every timer and animation frame,
    pellets and orbs partly collected."""
    rng = np.random.default_rng(seed)
    lv = jax.tree.map(lambda a: a[:n], bank)
    D = lv.wall.shape[-1]
    E = tchase.MAX_ENEMIES
    f32 = np.float32
    pos = np.zeros((n, 2), f32)
    vel = DIRS[rng.integers(0, 5, n)]
    next_vel = DIRS[rng.integers(0, 5, n)]
    mob_pos = np.zeros((n, E, 2), f32)
    mob_vel = (DIRS[rng.integers(0, 5, (n, E))]
               * rng.choice(f32([0.125, 0.25]), (n, E, 1))).astype(f32)
    hatch = rng.choice(f32([0, 0.25, 10, 49.75, 50, 50, 50]), (n, E))
    eat = rng.choice(f32([0, 0, 0, 0.25, 30, 75]), n)
    points = lv.point_grid0 & (rng.random(lv.point_grid0.shape) < 0.7)
    orb_taken = rng.random((n, tchase.MAX_ORBS)) < 0.3

    def free_cell(i):
        ry, x = np.argwhere(~lv.wall[i])[rng.integers((~lv.wall[i]).sum())]
        return np.float32([x + 0.5, ry + 0.5])

    def along(p, step, k):  # off a cell centre along one axis
        return p + DIRS[rng.integers(0, 4)] * step * k

    for i in range(n):
        pos[i] = along(free_cell(i), 0.05, rng.integers(0, 10))
        for e in range(E):
            mob_pos[i, e] = along(free_cell(i), 0.0625, rng.integers(0, 8))
        kind = i % 6
        if kind in (DEATH, EATEN):
            mob_pos[i, 0] = pos[i] + f32([0.5, 0.0])
            hatch[i, 0] = 50.0
            eat[i] = 0.0 if kind == DEATH else 30.0
        elif kind == ORB_FLEE:
            k = int(np.flatnonzero(lv.orb_exists[i])[0])
            orb_taken[i, k] = False
            pos[i] = lv.orb_pos[i, k] - f32([0.6, 0.0])
            eat[i] = 0.0
        elif kind in (COMPLETE, COMPLETE3):
            orb_taken[i] = True
            points[i] = False
            vel[i] = next_vel[i] = 0.0
            hatch[i] = 0.0
            cells = np.argwhere(~lv.wall[i, :D - 1, :D - 1])
            ry, x = cells[rng.integers(len(cells))]
            if kind == COMPLETE:
                pos[i] = (x + 0.5, ry + 0.5)
                points[i, ry, x] = True
            else:  # on the corner of four cells, three with a pellet
                pos[i] = (x + 1.0, ry + 1.0)
                points[i, ry, x] = points[i, ry, x + 1] = True
                points[i, ry + 1, x] = True
    return jchase.State(
        level=lv, pos=pos, vel=vel, next_vel=next_vel,
        input_timer=rng.choice(f32([0, 0.25, 1.0, 2.25, 2.5]), n),
        mob_pos=mob_pos, mob_vel=mob_vel, hatch_timer=hatch.astype(f32),
        eat_timer=eat.astype(f32),
        anim_timer=rng.choice(f32([0, 0.25, 0.75, 1.0]), n),
        anim_index=rng.integers(0, 6, n).astype(np.int32),
        point_grid=points, orb_taken=orb_taken,
        t=rng.integers(0, 20, n).astype(np.int32),
        rng=np.asarray(jax.random.key_data(jax.random.split(
            jax.random.key(seed), n))))


@pytest.fixture(scope="module")
def trajectories(banks):
    """T game-level steps (no auto-reset) from random states in every mode,
    JAX and port results per step; the completion envs hold still on the
    first step."""
    out = {}
    for m, mode in enumerate(MODES):
        st = random_states(banks[mode][0], m)
        actions = np.random.default_rng(10 + m).integers(
            0, 15, (T, NUM_LEVELS)).astype(np.int32)
        actions[0, np.arange(NUM_LEVELS) % 6 >= COMPLETE] = 4
        jstep = jax.jit(jax.vmap(functools.partial(
            jchase.step, jchase.Config(mode=mode))))
        jst = _to_jax_state(st)
        tst = convert.state(tchase, st, "cpu")
        steps = []
        for t in range(T):
            before = tst
            jst, jr, jd, _ = jstep(jst, jnp.asarray(actions[t]))
            tst, tr, td, _ = tchase.step(tchase.Config(mode=mode), tst,
                                         torch.from_numpy(actions[t]))
            steps.append((np_tree(jst), np.asarray(jr), np.asarray(jd), tst,
                          tr, td, before))
        out[mode] = steps
    return out


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("t", range(T))
def test_step_matches(trajectories, mode, t):
    jst, jr, jd, tst, tr, td, _ = trajectories[mode][t]
    for f in STATE_FIELDS:
        same(getattr(jst, f), getattr(tst, f))
    same(jr, tr)
    same(jd, td)


def test_steps_cover_the_physics(trajectories):
    """Over the trajectories of all modes: enemies turning at junctions,
    enemies eaten and respawned as eggs, flights after an orb, deaths,
    completions (with one and with three pellets at once) and pellets
    collected."""
    turns = respawns = flee = deaths = 0
    rewards = set()
    for steps in trajectories.values():
        for _, _, _, tst, tr, td, b in steps:
            hatched = b.hatch_timer >= tchase.HATCH_TIME
            v0, v1 = b.mob_vel, tst.mob_vel
            turned = (v0 != 0).any(-1) & (v1 != 0).any(-1) & (
                (v0 * v1).sum(-1) == 0)
            turns += int((turned & hatched).sum())
            respawns += int((hatched & (tst.hatch_timer < b.hatch_timer)
                             & (b.eat_timer > 0)[:, None]).sum())
            flee += int(((tst.eat_timer > b.eat_timer)
                         & (tst.orb_taken.sum(1) > b.orb_taken.sum(1))).sum())
            deaths += int((td & (tr < 10)).sum())
            rewards |= set(tr[td].tolist())
    assert turns and respawns and flee and deaths
    assert {np.float32(10.04), np.float32(10.12)} <= {np.float32(r)
                                                      for r in rewards}


def test_reward_site_rounds_alike_fused_or_not(trajectories):
    """delta * 0.04 + (available == 0) * 10 (chaser.py:535): XLA may
    contract it into one fused multiply-add. A sub-step collects at most
    8 (the 1x1 agent overlaps at most 2 x 2 pellet cells and 2 x 2 orb
    cells), and up to 37 one rounding and two give the same f32, so the
    port's op-by-op form equals either; they first differ at 38 with the
    +10. The JAX step's completion rewards with three pellets at once
    equal the port's (the step tests)."""
    d = np.arange(40, dtype=np.float32)
    differ = []
    for plus in (0.0, 10.0):
        twice = (d * np.float32(0.04)).astype(np.float32) + np.float32(plus)
        once = (np.float64(d) * np.float64(np.float32(0.04)) + plus).astype(
            np.float32)
        differ.append(np.flatnonzero(once.view(np.int32)
                                     != twice.view(np.int32)).tolist())
        port = tchase._reward(torch.from_numpy(d.astype(np.int32)),
                              torch.full(d.shape, int(plus == 0)))
        same(twice, port)
    assert differ == [[], [38, 39]]
    got = [float(o[4][k]) for o in trajectories["easy"]
           for k in np.flatnonzero(o[5].numpy())]
    assert np.float32(10.12) in np.float32(got)


def test_argmin_keeps_the_first_index_on_ties():
    """torch.argmin, as the enemies' greedy choice takes it, equals
    jnp.argmin on rows with ties, infinities and signed zeros (the flee
    negates distances): the first index of the minimum."""
    rng = np.random.default_rng(4)
    x = rng.integers(0, 4, (20000, 4)).astype(np.float32)
    x[rng.random(x.shape) < 0.3] = np.inf
    x[rng.random(x.shape) < 0.1] = -0.0
    x = np.where(rng.random((20000, 1)) < 0.5, -x, x)
    want = np.asarray(jax.jit(lambda a: jnp.argmin(a, axis=-1))(x))
    got = torch.argmin(torch.from_numpy(x), dim=-1).numpy()
    np.testing.assert_array_equal(want, got)
    assert ((x == x.min(1, keepdims=True)).sum(1) > 1).mean() > 0.3


# ---------------------------------------------------------------------------
# Environment: bank, reset, auto-reset, obs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def run():
    """Both Environments (the default Config, easy) from the same keys;
    after reset the completion lane and the death lane are placed with
    chip_smoke's placement (carried across with utils/convert); T steps
    with the same actions, the placed lanes' first action 4 (no move)."""
    jenv = pg.make("chaser")
    tenv = pt.make("chaser", device="cpu")
    jbank = jenv.generate_bank(jax.random.key(7), num_levels=NUM_LEVELS)
    tbank = tenv.generate_bank(pt.random.key(7), NUM_LEVELS)
    jst, jts = jenv.reset(jbank, jax.random.key(8), num_envs=N)
    tst, tts = tenv.reset(tbank, pt.random.key(8), N)
    reset = (np_tree(jst), np.asarray(jts.obs), tst, tts)
    start = np_tree(jst)
    game, lanes = chip_smoke.place_chaser_lanes(
        convert.state(tchase, start.game, "cpu"))
    start = start.replace(game=start.game.replace(**{
        f: getattr(game, f).numpy() for f in (
            "point_grid", "orb_taken", "mob_pos", "hatch_timer",
            "eat_timer")}))
    jst = jax.tree.map(jnp.asarray, start.replace(
        rng=jax.random.wrap_key_data(start.rng),
        game=start.game.replace(rng=jax.random.wrap_key_data(start.game.rng))))
    tst = convert.env_state(tchase, start, "cpu")
    actions = chip_smoke.hold_first_action(torch.from_numpy(
        np.random.default_rng(3).integers(0, 15, (T, N)).astype(np.int32)),
        lanes).numpy()
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
    """States, rewards, terminations, episode info and obs at every
    step."""
    jst, jts, tst, tts = run["steps"][t]
    same_tree(jst, tst)
    np.testing.assert_array_equal(jts.obs, tts.obs.numpy())
    for k in ("reward", "terminated", "truncated"):
        same(getattr(jts, k), getattr(tts, k))
    for k in ("returned_episode_return", "returned_episode_length", "done"):
        same(jts.info[k], tts.info[k])


def test_placed_lanes_end_and_restart(run):
    """The completion lane (+10) and the death lane (0) both end on step 0
    and restart on a bank level: step counter 0, at its start, its
    pellets back."""
    done_lane, death = run["lanes"]
    assert (done_lane, death) == (0, 1)
    _, _, tst, tts = run["steps"][0]
    assert bool(tts.terminated[done_lane]) and float(tts.reward[done_lane]) == 10.0
    assert bool(tts.terminated[death]) and float(tts.reward[death]) == 0.0
    g = tst.game
    for lane in (done_lane, death):
        assert int(g.t[lane]) == 0 and int(tst.ep_length[lane]) == 0
        assert g.pos[lane].tolist() == g.level.agent_pos[lane].tolist()
        assert torch.equal(g.point_grid[lane], g.level.point_grid0[lane])


# ---------------------------------------------------------------------------
# Render
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_observe_batch_matches_jax(banks, mode):
    """observe_batch on random states (every enemy sprite: eggs, flyer
    frames, fleeing walkers; orbs live and taken; enemies overlapping)
    against the JAX package's jitted render."""
    st = random_states(banks[mode][0], 20, n=N)
    want = np.asarray(jax.jit(functools.partial(
        jchase.observe_batch, jchase.Config(mode=mode)))(_to_jax_state(st)))
    tst = convert.state(tchase, st, "cpu")
    got = tchase.observe_batch(tchase.Config(mode=mode), tst)
    assert got.dtype == torch.uint8 and got.shape == (N, 3, 64, 64)
    np.testing.assert_array_equal(want, got.numpy())
    var = tchase._stamp_slots(tchase.Config(mode=mode), tst)[0]
    assert {0, 1} <= set(var.unique().tolist()) and (var >= 2).any()


@pytest.mark.parametrize("mode", MODES)
def test_stamp_group_is_off_the_kernel_path(mode):
    """P = int(64 / D) + 3 (8, 7, 6) with K = 6 slots: the reference's
    dispatch takes the matmul semantics on every backend."""
    D = tchase.Config(mode=mode).world_dim
    P = tchase._stamp_banks(64 / D).shape[-1]
    assert P == {"easy": 8, "hard": 7, "extreme": 6}[mode]
    assert not tC.stamp_kernel_ok(P, tchase.MAX_ENEMIES + 1)


@pytest.mark.parametrize("mode", MODES)
def test_constant_tables_match_the_jax_render(banks, mode):
    """The tile, texel and background selectors of the port's render equal
    the indices (and masks) the JAX package's jitted render hands
    `compositor._onehot`, at 64 envs, per axis and per mode; the
    background's row selector is built from the column coords there too
    (chaser.py:666-670)."""
    st = random_states(banks[mode][0], 21, n=NUM_LEVELS)
    st = jax.tree.map(lambda a: np.resize(a, (64,) + a.shape[1:]), st)
    calls = onehot_inputs(functools.partial(
        jchase.observe_batch, jchase.Config(mode=mode)), _to_jax_state(st))
    tab = tchase._tables(mode)
    D = tchase.Config(mode=mode).world_dim
    want = [("t", D, None), ("t", D, None), ("u", tC.S, None),
            ("u", tC.S, None), ("b", 64, "b_ok"), ("b", 64, "b_ok")]
    assert len(calls) == len(want)
    for (idx, n, valid), (name, n_want, ok) in zip(calls, want):
        assert n == n_want, name
        same(idx, tab[name])
        if ok is None:
            assert valid is None, name
        else:
            same(valid, tab[ok])


def _origins(d, ppu, P, fused=True):
    """(c - centre) * ppu + 32 - P/2 in f32 from d = c - centre: one
    rounding of d * ppu + (32 - P/2), or each op rounded."""
    f32 = np.float32
    if fused:
        return (np.float64(d) * np.float64(f32(ppu))
                + (32.0 - P / 2)).astype(f32)
    return ((d * f32(ppu)).astype(f32) + f32(32.0)).astype(f32) - f32(P / 2)


@pytest.mark.parametrize("mode", MODES)
def test_stamp_placement_matches_xla_near_half_pixels(banks, mode):
    """The stamps' pixels in the render's own graph: on 64 states (a
    batch XLA runs in its vector loop) whose enemies and agent lie within
    a few ulp of half a pixel, where rounding each op gives another
    pixel, the port's (c - centre) * ppu + 32 - P/2 before rounding
    equals what the JAX render hands `jnp.round` (jax_capture), bitwise:
    XLA folds the constants and fuses the multiply-add (C2's pattern,
    `compositor.stamp_origin`)."""
    cfg = tchase.Config(mode=mode)
    D = cfg.world_dim
    ppu = 64 / D
    P = int(ppu) + 3
    f32 = np.float32
    rng = np.random.default_rng(50)
    st = random_states(banks[mode][0], 22, n=NUM_LEVELS)
    st = jax.tree.map(lambda a: np.resize(a, (4096,) + a.shape[1:]), st)
    off = (rng.integers(0, 60, (4096, 6, 2)) + 0.5 - (32 - P / 2)) / ppu
    pts = f32(D / 2) + off.astype(f32)
    pts = (pts + rng.integers(-6, 7, pts.shape) * np.spacing(pts)).astype(f32)
    d = pts - f32(D / 2)
    moved = (np.round(_origins(d, ppu, P)) != np.round(
        _origins(d, ppu, P, fused=False))).reshape(4096, -1).any(1)
    pick = np.flatnonzero(moved)[:64]
    assert pick.size == 64
    st = jax.tree.map(lambda a: a[pick], st)
    st = st.replace(mob_pos=pts[pick, :5], pos=pts[pick, 5])
    got = render_inputs(jchase, jchase.Config(mode=mode), _to_jax_state(st))
    assert got["groups"] is None and len(got["rounded"]) == 4
    _, r0, c0, _ = tchase._stamp_slots(cfg, convert.state(tchase, st, "cpu"))
    same(got["rounded"][2], r0)
    same(got["rounded"][3], c0)
    same(_origins(d[pick], ppu, P)[..., 1], r0)


# ---------------------------------------------------------------------------
# The exact renders (tests/render_parity.py): observe at 64 and 128 px,
# Environment.render, the selectors against the JAX render's `_onehot`
# arguments
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [64, 128])
def test_observe_matches_jax(size):
    st = RP.check_observe("chaser", size=size, steps=60)
    assert (st.game.hatch_timer >= tchase.HATCH_TIME).any()  # flyers
    assert (st.game.eat_timer > 0).any()  # fleeing walkers


def test_observe_selectors_match_the_jax_render():
    RP.check_selectors("chaser", steps=60)


@pytest.mark.parametrize("env_index", [0, 1])
def test_render_matches_jax(env_index):
    RP.check_render("chaser", env_index=env_index, steps=60)
