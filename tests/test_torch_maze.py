"""The port's maze (procgen2_tpu_torch/games/maze.py) against the JAX
package's, given the same keys, states and actions. Every comparison is
bitwise: f32 compared as int32 views, everything else equal.

* the level bank in easy (every field, through the Environment), hard and
  memory (per-level maze sizes, the goal off the start); reset;
* `step` from random states, with actions 9-14 probing two and three
  cells over at the grid's edge, goals reached and timeouts;
* `Environment.step` with lane 0 on its goal (+10) and lane 1 at its
  last step (terminated with 0), both of which end and auto-reset
  (game_lanes' placement), states, rewards and obs at every step;
* `observe_batch` in every mode, with the mouse on the cheese (kinds 5
  and 6) and memory mode's camera at t = 0 and t > 0;
* the render's constant tables (tile, texel, cheese and background
  selectors) against those `compositor._onehot` takes in the JAX
  package's jitted render, at 64 envs (`jax_capture.onehot_inputs`);
* what the CPU can hold of M1, the fixed camera's render kernel: the
  constants its wrapper passes against the plain render's, its
  arithmetic on them in plain torch against the plain render, the plain
  render on CPU tensors in every mode (no launch), and the wrapper's
  refusals.
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
from jax_capture import onehot_inputs
import procgen2_tpu_torch as pt
from procgen2_tpu.games import maze as jmaze
from procgen2_tpu_torch import random as R
from procgen2_tpu_torch.games import maze as tmaze
from procgen2_tpu_torch.render import compositor as tC
from procgen2_tpu_torch.render import maze_render
from procgen2_tpu_torch.utils import convert
import render_parity as RP
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

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
        want = np_tree(JR.vmapped("maze", "generate", (("mode", mode),))(jk))
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
        tcfg = tmaze.Config(mode=mode, timeout=T + 2)
        assert cfg.world_dim == tcfg.world_dim
        actions = np.random.default_rng(2).integers(
            0, 15, (T, NUM_LEVELS)).astype(np.int32)
        jstep = JR.vmapped("maze", "step", (("mode", mode),
                                             ("timeout", T + 2)))
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
    game_lanes' placement (carried across with utils/convert); T steps
    with the same actions, the placed lanes' first action 4 (no move)."""
    jenv = JR.env("maze", (("mode", "easy"),))
    tenv = pt.make("maze", device="cpu", mode="easy")
    jbank = JR.bank("maze", (("mode", "easy"),), n=NUM_LEVELS)
    tbank = tenv.generate_bank(pt.random.key(7), NUM_LEVELS)
    jst, jts = jenv.reset(jbank, jax.random.key(8), num_envs=N)
    tst, tts = tenv.reset(tbank, pt.random.key(8), N)
    reset = (np_tree(jst), np.asarray(jts.obs), tst, tts)
    start = np_tree(jst)
    game, lanes = game_lanes.place_maze_lanes(
        convert.state(tmaze, start.game, "cpu"), tenv.cfg)
    start = start.replace(game=start.game.replace(
        pos=game.pos.numpy(), t=game.t.numpy()))
    jst = jax.tree.map(jnp.asarray, start.replace(
        rng=jax.random.wrap_key_data(start.rng),
        game=start.game.replace(rng=jax.random.wrap_key_data(start.game.rng))))
    tst = convert.env_state(tmaze, start, "cpu")
    actions = game_lanes.hold_first_action(torch.from_numpy(
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
    cfg_t = tmaze.Config(mode=mode)
    st = render_states(banks[mode][0], 5)
    if mode == "memory":
        st = st.replace(t=np.where(np.arange(N) < 3, 0, st.t).astype(np.int32))
    want = np.asarray(JR.observe_batch("maze", (("mode", mode),), tpu=False)(
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


# ---------------------------------------------------------------------------
# M1, the fixed camera's render kernel (render/maze_render.py): its
# constants, its arithmetic on them, and the dispatch, on the CPU (the
# kernel itself: tests/test_torch_cuda.py)
# ---------------------------------------------------------------------------

FIXED = ("easy", "hard")
# the layers each render kind takes (maze.py's kinds: 0 empty, 1 wall,
# 2 cheese, 3 mouse, 4 flipped mouse, 5 and 6 those on the cheese)
KIND_LAYERS = {0: (), 1: ("wall",), 2: ("cheese",), 3: ("mouse",),
               4: ("mouse_flip",), 5: ("cheese", "mouse"),
               6: ("cheese", "mouse_flip")}


def m1_model(c, grid, goal_pos, pos, face, bg_index):
    """M1's arithmetic (csrc/maze_render.cu) in plain torch on the
    constants `c` the wrapper passes: each pixel's kind from the tables,
    the grid and the kind codes, its layers from bit L of the layer table;
    a pixel with no layer is its background byte, one with layer 0 alone
    its byte of `walled`, any other runs its layers alone from the
    background, each bf16 op rounded."""
    N, D, _ = grid.shape
    i32 = torch.int32
    ty, tx = c.tables.long()

    def cell(v):
        i = v.to(i32)
        return torch.where(i < 0, i + D, i).long()

    def at(p):
        return ((ty[None, :, None] == cell(p[:, 1])[:, None, None])
                & (tx[None, None, :] == cell(p[:, 0])[:, None, None]))

    on_cheese = ((pos[:, 0].to(i32) == goal_pos[:, 0].to(i32))
                 & (pos[:, 1].to(i32) == goal_pos[:, 1].to(i32)))
    mouse = torch.tensor(c.mouse, dtype=torch.int8)[
        face.long() + 2 * on_cheese.long()]
    G = grid[:, ty][:, :, tx]
    G = torch.where(at(goal_pos), torch.tensor(c.cheese, dtype=torch.int8),
                    G)
    G = torch.where(at(pos), mouse[:, None, None], G)
    bits = c.layer_lut.long()[G.long() + 128][:, None]
    bg = c.bg_bank[bg_index.long()]
    f = bg.float()

    def rn(x):
        return x.to(torch.bfloat16).float()

    for L in range(maze_render.LAYERS):
        k, a = c.kinds[L, :3].float(), c.kinds[L, 3].float()
        f = torch.where(((bits >> L) & 1).bool(), rn(f + rn(a * rn(k - f))),
                        f)
    chain = f.round().clamp(0, 255).to(torch.uint8)
    return torch.where(bits == 0, bg, torch.where(
        bits == 1, c.walled[bg_index.long()], chain))


def render_lanes(mode, n=18):
    """A CPU maze State of n envs, 3 steps in, with game_lanes' render
    lanes: the mouse on its cheese and off it facing both ways, on its
    start cell, every background."""
    env = pt.make("maze", device="cpu", mode=mode)
    bank = env.generate_bank(R.key(0), NUM_LEVELS)
    st, _ = env.reset(bank, R.key(1), n)
    g = torch.Generator().manual_seed(2)
    for _ in range(3):
        st, _ = env.step(bank, st, torch.randint(
            0, 15, (n,), generator=g, dtype=torch.int32), render=False)
    return env.cfg, game_lanes.place_maze_render_lanes(st.game)


@pytest.mark.parametrize("mode", FIXED)
def test_m1_arithmetic_equals_the_plain_render(mode):
    """M1's arithmetic on the constants the wrapper passes equals the plain
    render bit for bit, on states with every kind and every background:
    the tables, kind codes, layer table, kind images and walled
    backgrounds are the plain render's."""
    cfg, gs = render_lanes(mode)
    assert set(tmaze._augmented(gs).unique().tolist()) == set(KIND_LAYERS)
    assert set(gs.level.bg_index.tolist()) == set(range(tmaze.NUM_BGS))
    c = tmaze._render_tensors(mode, "cpu")["m1"]
    lv = gs.level
    got = m1_model(c, lv.grid, lv.goal_pos, gs.pos, gs.face_forward,
                   lv.bg_index)
    assert torch.equal(got, tmaze.observe_batch_reference(cfg, gs))


@pytest.mark.parametrize("mode", FIXED)
def test_m1_constants_are_the_plain_renders(mode):
    """The constants M1 takes: ty/tx the plain render's selectors; the
    kind images in `_compose`'s order (wall, cheese, mouse, flipped
    mouse); bit L of the layer table set for exactly the int8 kinds whose
    field `_compose`'s layer L blends over (KIND_LAYERS for the render's
    kinds); the backgrounds the plain render's; `walled` the plain render
    of an all-wall field over each background."""
    R = tmaze._render_tensors(mode, "cpu")
    c = R["m1"]
    assert torch.equal(c.tables, torch.stack([R["ty"], R["tx"]]).int())
    order = ("wall", "cheese", "mouse", "mouse_flip")
    assert tuple(name for name, _ in tmaze._LAYERS) == order
    for L, name in enumerate(order):
        rgb, a = R[name]
        assert torch.equal(c.kinds[L, :3].view(torch.int16),
                           rgb.view(torch.int16))
        assert torch.equal(c.kinds[L, 3].view(torch.int16),
                           a.view(torch.int16))
    kinds = torch.arange(-128, 128, dtype=torch.int8)
    for L, (_, on) in enumerate(tmaze._LAYERS):
        assert torch.equal(((c.layer_lut >> L) & 1).bool(), on(kinds))
    for k, names in KIND_LAYERS.items():
        assert {order[L] for L in range(4)
                if int(c.layer_lut[k + 128]) >> L & 1} == set(names), k
    assert c.bg_bank is R["bg_bank"]
    B = tmaze.NUM_BGS
    walls = torch.full((B, 1, 64, 64), tmaze.WALL, dtype=torch.int8)
    assert torch.equal(c.walled, tmaze._compose(
        R["bg_bank"].to(torch.bfloat16), walls, R))


@pytest.mark.parametrize("on_cheese", [False, True])
@pytest.mark.parametrize("flip", [False, True])
def test_m1_kind_codes_are_augmenteds(flip, on_cheese):
    """The mouse's kind M1 takes for (flip, on_cheese), mouse[flip + 2 *
    on_cheese], and the cheese's are those `_augmented` writes on the
    agent's and the goal's cells."""
    _, gs = render_lanes("easy", n=1)
    lv = gs.level
    pos = lv.goal_pos.clone() if on_cheese else lv.agent_pos.clone()
    gs = dataclasses.replace(gs, pos=pos,
                             face_forward=torch.tensor([flip]))
    c = tmaze._render_tensors("easy", "cpu")["m1"]
    aug = tmaze._augmented(gs)[0]
    (gx, gy), (mx, my) = lv.goal_pos[0].int(), pos[0].int()
    assert int(aug[my, mx]) == c.mouse[int(flip) + 2 * int(on_cheese)]
    if not on_cheese:
        assert int(aug[gy, gx]) == c.cheese


def test_m1_packs_negative_kinds_as_int8_bytes():
    assert maze_render.pack_kinds((-1, 0, 0, -128)) == -0x7fffff01
    assert maze_render.pack_kinds((3, 4, 5, 6)) == 0x06050403


@pytest.mark.parametrize("mode", MODES)
def test_cpu_tensors_take_the_plain_render(mode):
    """On the CPU `observe_batch` is the plain render in every mode, and
    neither it nor `Environment.step` launches M1."""
    env = pt.make("maze", device="cpu", mode=mode)
    bank = env.generate_bank(R.key(0), 4)
    st, _ = env.reset(bank, R.key(1), 4)
    before = maze_render.render.launches
    got = tmaze.observe_batch(env.cfg, st.game)
    env.step(bank, st, torch.zeros(4, dtype=torch.int32))
    assert maze_render.render.launches == before
    assert torch.equal(got, tmaze.observe_batch_reference(env.cfg, st.game))


def _wrapper_args(gs, c):
    lv = gs.level
    return dict(grid=lv.grid, goal_pos=lv.goal_pos, pos=gs.pos,
                face_forward=gs.face_forward, bg_index=lv.bg_index,
                consts=c)


BAD_ARGS = {
    "grid int32": ("grid", lambda x: x.int()),
    "grid not square": ("grid", lambda x: x[:, :, :-1]),
    "pos f64": ("pos", lambda x: x.double()),
    "pos [N, 3]": ("pos", lambda x: torch.cat([x, x[:, :1]], 1)),
    "goal_pos [N - 1, 2]": ("goal_pos", lambda x: x[1:]),
    "face_forward u8": ("face_forward", lambda x: x.to(torch.uint8)),
    "bg_index int64": ("bg_index", lambda x: x.long()),
    "on the CPU": (None, None),
}


@pytest.mark.parametrize("case", sorted(BAD_ARGS))
def test_m1_wrapper_rejects_bad_arguments(case):
    """The wrapper refuses, before building anything, a state tensor of
    another dtype or shape, and tensors on the CPU."""
    _, gs = render_lanes("easy", n=4)
    args = _wrapper_args(gs, tmaze._render_tensors("easy", "cpu")["m1"])
    name, bad = BAD_ARGS[case]
    if name is not None:
        args[name] = bad(args[name])
    with pytest.raises(ValueError):
        maze_render.render(**args)


BAD_CONSTS = {
    "kinds f32": lambda c: dataclasses.replace(c, kinds=c.kinds.float()),
    "tables [2, 63]": lambda c: dataclasses.replace(
        c, tables=c.tables[:, 1:].contiguous()),
    "walled [8, ...]": lambda c: dataclasses.replace(c, walled=c.walled[1:]),
    "layer_lut int8": lambda c: dataclasses.replace(
        c, layer_lut=c.layer_lut.to(torch.int8)),
    "kinds off a 16-byte boundary": lambda c: dataclasses.replace(
        c, kinds=torch.empty(c.kinds.numel() + 1, dtype=torch.bfloat16)[
            1:].view(c.kinds.shape)),
    "mouse kind 200": lambda c: dataclasses.replace(c, mouse=(3, 4, 5, 200)),
    "three mouse kinds": lambda c: dataclasses.replace(c, mouse=(3, 4, 5)),
}


@pytest.mark.parametrize("case", sorted(BAD_CONSTS))
def test_m1_constants_check_refuses(case):
    """`check_consts` refuses constants of another dtype or shape, off a
    16-byte boundary, or with kind codes that are not int8."""
    good = tmaze._render_tensors("easy", "cpu")["m1"]
    maze_render.check_consts(good, torch.device("cpu"))
    with pytest.raises(ValueError):
        maze_render.check_consts(BAD_CONSTS[case](good), torch.device("cpu"))
