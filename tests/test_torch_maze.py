"""The port's maze (procgen2_tpu_torch/games/maze.py) against the JAX
package's, given the same keys, states and actions. Every comparison is
bitwise: f32 compared as int32 views, everything else equal.

* the level bank in easy (every field, through the Environment), hard and
  memory (per-level maze sizes, the goal off the start); reset;
* `step` from random states, with actions 9-14 probing two and three
  cells over at the grid's edge, goals reached and timeouts;
* `Environment.step` with lane 0 on its goal (+10) and lane 1 at its
  last step (terminated with 0), both of which end and auto-reset
  (chip_smoke.py's placement), states, rewards and obs at every step;
* `observe_batch` in every mode, with the mouse on the cheese (kinds 5
  and 6) and memory mode's camera at t = 0 and t > 0;
* the render's constant tables (tile, texel, cheese and background
  selectors) against those `compositor._onehot` takes in the JAX
  package's jitted render, at 64 envs (`jax_capture.onehot_inputs`).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from jax_capture import onehot_inputs
import procgen2_tpu as pg
import procgen2_tpu_torch as pt
from procgen2_tpu.games import maze as jmaze
from procgen2_tpu_torch import random as R
from procgen2_tpu_torch.games import maze as tmaze
from procgen2_tpu_torch.render import compositor as tC
from procgen2_tpu_torch.utils import convert
import render_parity as RP

NUM_LEVELS, N, T = 16, 8, 8
MODES = ("easy", "hard", "memory")
LEVEL_FIELDS = [f.name for f in dataclasses.fields(tmaze.Level)]
STATE_FIELDS = [f.name for f in dataclasses.fields(tmaze.State)
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
            jmaze.generate, jmaze.Config(mode=mode))))(jk))
        out[mode] = (want, tmaze.generate(tmaze.Config(mode=mode), tk))
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
    """Mazes of several sizes per bank, each centred in the all-wall
    world, the goal on an empty cell other than the agent's start."""
    _, tl = banks[mode]
    wd = tmaze.Config(mode=mode).world_dim
    dims = tl.maze_dim
    assert len(set(dims.tolist())) > 2 and (dims % 2 == 1).all()
    assert ((dims >= 3) & (dims <= wd)).all()
    n = torch.arange(NUM_LEVELS)
    for pos in (tl.goal_pos, tl.agent_pos):
        x, ry = (pos - 0.5).long().unbind(-1)
        assert (tl.grid[n, ry, x] == tmaze.EMPTY).all()
    assert not (tl.goal_pos == tl.agent_pos).all(-1).any()
    assert ((tl.grid == tmaze.EMPTY).sum((1, 2)) <= dims ** 2).all()


def test_reset_matches(banks):
    jl, _ = banks["easy"]
    lv = jax.tree.map(lambda a: jnp.asarray(a[:N]), jl)
    keys = jax.random.split(jax.random.key(8), N)
    want = np_tree(jax.vmap(functools.partial(jmaze.reset, jmaze.Config()))(
        lv, keys))
    got = tmaze.reset(tmaze.Config(), convert.level(tmaze, jax.tree.map(
        np.asarray, lv), "cpu"), torch.from_numpy(np_tree(keys).astype(np.int64)))
    for f in STATE_FIELDS:
        same(getattr(want, f), getattr(got, f))


# ---------------------------------------------------------------------------
# Step
# ---------------------------------------------------------------------------

def random_states(bank, seed, n=NUM_LEVELS, timeout=tmaze.TIMEOUT):
    """States on the bank's first n levels: a quarter of the agents on
    the goal's cell or next to it, a quarter on any cell (walls and the
    grid's right edge included: the step only tests the cell it moves
    to), the rest on empty cells; random facing; step counters up to the
    timeout, a quarter at its last step."""
    rng = np.random.default_rng(seed)
    lv = jax.tree.map(lambda a: a[:n], bank)
    wd = lv.grid.shape[-1]
    f32 = np.float32
    pos = np.zeros((n, 2), f32)
    for i in range(n):
        kind = i % 4
        if kind == 0:
            pos[i] = lv.goal_pos[i] + rng.integers(-1, 2, 2) * (
                rng.random() < 0.5)
        elif kind == 1:
            pos[i] = rng.integers(0, wd, 2) + 0.5
            pos[i, 0] = rng.choice([pos[i, 0], wd - 0.5, wd - 1.5, wd - 2.5])
        else:
            cells = np.argwhere(lv.grid[i] == tmaze.EMPTY)
            ry, x = cells[rng.integers(len(cells))]
            pos[i] = (x + 0.5, ry + 0.5)
    t = rng.integers(0, timeout, n).astype(np.int32)
    t[rng.random(n) < 0.25] = timeout - 1
    return jmaze.State(level=lv, pos=pos, face_forward=rng.random(n) < 0.5,
                       t=t, rng=np.zeros((n, 2), np.uint32))


@pytest.fixture(scope="module")
def trajectories(banks):
    """T game-level steps (no auto-reset) from random states in easy and
    hard, JAX and port results per step, with actions 0-14."""
    out = []
    for mode in ("easy", "hard"):
        cfg = jmaze.Config(mode=mode)
        st = random_states(banks[mode][0], 0 if mode == "easy" else 1,
                           timeout=T + 2)
        jcfg = jmaze.Config(mode=mode, timeout=T + 2)
        tcfg = tmaze.Config(mode=mode, timeout=T + 2)
        assert cfg.world_dim == tcfg.world_dim
        actions = np.random.default_rng(2).integers(
            0, 15, (T, NUM_LEVELS)).astype(np.int32)
        jstep = jax.jit(jax.vmap(functools.partial(jmaze.step, jcfg)))
        jst = _to_jax_state(st)
        tst = convert.state(tmaze, st, "cpu")
        for t in range(T):
            before = (tst.pos.clone(), tst.face_forward.clone())
            jst, jr, jd, _ = jstep(jst, jnp.asarray(actions[t]))
            tst, tr, td, _ = tmaze.step(tcfg, tst, torch.from_numpy(actions[t]))
            out.append((mode, np_tree(jst), np.asarray(jr), np.asarray(jd),
                        tst, tr, td, actions[t], before))
    return out


@pytest.mark.parametrize("k", range(2 * T))
def test_step_matches(trajectories, k):
    _, jst, jr, jd, tst, tr, td, _, _ = trajectories[k]
    for f in STATE_FIELDS:
        same(getattr(jst, f), getattr(tst, f))
    same(jr, tr)
    same(jd, td)


def test_steps_cover_the_moves(trajectories):
    """Over the trajectories: actions 9-14 moving two or three cells and
    blocked beyond the grid's right edge, moves left, goals reached,
    timeouts (terminated with 0) and facing flips."""
    far_moves = edge_blocks = left = flips = 0
    reached = timeouts = 0
    for mode, jst, jr, jd, tst, tr, td, a, (x0, face0) in trajectories:
        wd = tmaze.Config(mode=mode).world_dim
        dx = (tst.pos[:, 0] - x0[:, 0]).numpy()
        far = a >= 9
        far_moves += int((far & (dx >= 2)).sum())
        mx = a // 3 - 1
        edge_blocks += int((far & (x0[:, 0].numpy() + mx >= wd)
                            & (dx == 0)).sum())
        left += int(((a < 3) & (dx == -1)).sum())
        flips += int((tst.face_forward != face0).sum())
        reached += int((tr == 10).sum())
        timeouts += int((td & (tr == 0)).sum())
    assert far_moves and edge_blocks and left and flips
    assert reached and timeouts


# ---------------------------------------------------------------------------
# Environment: bank, reset, auto-reset, obs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def run():
    """Both Environments in easy mode (the bench's) from the same keys;
    after reset the goal lane and the timeout lane are placed with
    chip_smoke's placement (carried across with utils/convert); T steps
    with the same actions, the placed lanes' first action 4 (no move)."""
    jenv = pg.make("maze", mode="easy")
    tenv = pt.make("maze", device="cpu", mode="easy")
    jbank = jenv.generate_bank(jax.random.key(7), num_levels=NUM_LEVELS)
    tbank = tenv.generate_bank(pt.random.key(7), NUM_LEVELS)
    jst, jts = jenv.reset(jbank, jax.random.key(8), num_envs=N)
    tst, tts = tenv.reset(tbank, pt.random.key(8), N)
    reset = (np_tree(jst), np.asarray(jts.obs), tst, tts)
    start = np_tree(jst)
    game, lanes = chip_smoke.place_maze_lanes(
        convert.state(tmaze, start.game, "cpu"), tenv.cfg)
    start = start.replace(game=start.game.replace(
        pos=game.pos.numpy(), t=game.t.numpy()))
    jst = jax.tree.map(jnp.asarray, start.replace(
        rng=jax.random.wrap_key_data(start.rng),
        game=start.game.replace(rng=jax.random.wrap_key_data(start.game.rng))))
    tst = convert.env_state(tmaze, start, "cpu")
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
    """The goal lane (+10) and the timeout lane (terminated with 0) both
    end on step 0 and restart on a bank level: step counter 0, at its
    start."""
    goal, timeout = run["lanes"]
    assert (goal, timeout) == (0, 1)
    _, _, tst, tts = run["steps"][0]
    assert bool(tts.terminated[goal]) and float(tts.reward[goal]) == 10.0
    assert bool(tts.terminated[timeout]) and float(tts.reward[timeout]) == 0.0
    assert float(tts.info["returned_episode_length"][timeout]) == 1
    g = tst.game
    for lane in (goal, timeout):
        assert int(g.t[lane]) == 0 and int(tst.ep_length[lane]) == 0
        assert g.pos[lane].tolist() == g.level.agent_pos[lane].tolist()


# ---------------------------------------------------------------------------
# Render
# ---------------------------------------------------------------------------

def render_states(bank, seed, n=N):
    """Random states on empty cells (random facing, t > 0), and agents on
    the goal facing either way (kinds 5 and 6)."""
    st = random_states(bank, seed, n=n)
    rng = np.random.default_rng(seed + 100)
    lv = st.level
    pos = st.pos.copy()
    for i in range(n):
        cells = np.argwhere(lv.grid[i] == tmaze.EMPTY)
        ry, x = cells[rng.integers(len(cells))]
        pos[i] = (x + 0.5, ry + 0.5)
    on_goal = np.arange(n) % 3 == 0
    pos[on_goal] = lv.goal_pos[on_goal]
    face = np.arange(n) % 2 == 0
    return st.replace(pos=pos, face_forward=face,
                      t=np.maximum(st.t, 1).astype(np.int32))


@pytest.mark.parametrize("mode", MODES)
def test_observe_batch_matches_jax(banks, mode):
    """observe_batch against the JAX package's jitted render, with the
    mouse facing both ways on the cheese and off it; memory mode at t > 0
    (the camera on the agent) and t = 0 (the map centre)."""
    cfg_j, cfg_t = jmaze.Config(mode=mode), tmaze.Config(mode=mode)
    st = render_states(banks[mode][0], 5)
    if mode == "memory":
        st = st.replace(t=np.where(np.arange(N) < 3, 0, st.t).astype(np.int32))
    want = np.asarray(jax.jit(functools.partial(jmaze.observe_batch, cfg_j))(
        _to_jax_state(st)))
    tst = convert.state(tmaze, st, "cpu")
    got = tmaze.observe_batch(cfg_t, tst)
    assert got.dtype == torch.uint8 and got.shape == (N, 3, 64, 64)
    np.testing.assert_array_equal(want, got.numpy())
    kinds = tmaze._augmented(tst)
    assert {5, 6} <= set(kinds.unique().tolist())


def test_memory_camera_moves_with_the_agent(banks):
    """Memory mode: the frame at t = 0 is centred on the map, at t > 0 on
    the agent; one cell of agent motion shifts the walls by 8 pixels."""
    st = render_states(banks["memory"][0], 6)
    tst = convert.state(tmaze, st, "cpu")
    cfg = tmaze.Config(mode="memory")
    at0 = tmaze.observe_batch(cfg, dataclasses.replace(
        tst, t=torch.zeros_like(tst.t)))
    moved = tmaze.observe_batch(cfg, tst)
    away = (tst.pos != tmaze.Config(mode="memory").world_dim / 2).any(-1)
    assert away.any()
    assert (at0[away] != moved[away]).flatten(1).any(1).all()


@pytest.mark.parametrize("mode", MODES)
def test_constant_tables_match_the_jax_render(banks, mode):
    """The tile, texel, cheese and background selectors of the port's
    render equal the indices (and masks) the JAX package's jitted render
    hands `compositor._onehot`, at 64 envs: where XLA folds them
    (maze.py:268-307: `c / ppu`, and `/ 0.95` of the cheese's rect, a
    multiply by the reciprocal there), per axis and per mode. Memory mode
    builds its texel selectors with the camera on cell 0, and its
    background selectors per env."""
    st = render_states(banks[mode][0], 7, n=NUM_LEVELS)
    st = jax.tree.map(lambda a: np.resize(a, (64,) + a.shape[1:]), st)
    calls = onehot_inputs(functools.partial(
        jmaze.observe_batch, jmaze.Config(mode=mode)), _to_jax_state(st))
    tab = tmaze._tables(mode)
    S, W = tC.S, 64
    want_tab = [("u", S, None), ("v", S, None), ("cu", S, "cu_ok"),
                ("cv", S, "cv_ok")]
    if mode == "memory":
        assert len(calls) == 6
        cfg = tmaze.Config(mode=mode)
        tst = convert.state(tmaze, st, "cpu")
        cam = torch.where(tst.t[:, None] > 0, tst.pos,
                          cfg.world_dim / 2.0)
        wx_b, wy_b = tC.camera_coords(64 / cfg.visibility, cam[:, 0],
                                      cam[:, 1])
        per_env = [tC.texel_index(wx_b / 64.0, W), tC.texel_index(wy_b / 64.0, W)]
        for (idx, n, valid), (i, ok) in zip(calls[4:], per_env):
            assert n == W
            same(idx, i.to(torch.int32))
            same(valid, ok)
    else:
        wd = tmaze.Config(mode=mode).world_dim
        want_tab = [("tx", wd, None), ("ty", wd, None)] + want_tab + [
            ("ub", W, "ub_ok"), ("vb", W, "vb_ok")]
        assert len(calls) == len(want_tab) == 8
    for (idx, n, valid), (name, n_want, ok) in zip(calls, want_tab):
        assert n == n_want, name
        same(idx, tab[name])
        if ok is None:
            assert valid is None, name
        else:
            same(valid, tab[ok])
    # under the fixed camera the cheese's rect leaves pixels of its cell
    # out; memory mode's 8 pixels per cell all fall inside it
    assert (~tab["cu_ok"]).any() == (mode != "memory")


# ---------------------------------------------------------------------------
# The exact renders (tests/render_parity.py): observe at 64 and 128 px,
# Environment.render, the selectors against the JAX render's `_onehot`
# arguments
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [64, 128])
def test_observe_matches_jax(size):
    st = RP.check_observe("maze", size=size)
    assert (st.game.t > 0).all()


def test_observe_selectors_match_the_jax_render():
    RP.check_selectors("maze")


@pytest.mark.parametrize("env_index", [0, 1])
def test_render_matches_jax(env_index):
    RP.check_render("maze", env_index=env_index)


@pytest.mark.parametrize("mode", ["easy", "memory"])
def test_observe_matches_jax_in_mode(mode):
    """Memory mode's camera follows the agent (at the map centre on the
    first frame); easy's is fixed."""
    RP.check_observe("maze", (("mode", mode),), size=64)
