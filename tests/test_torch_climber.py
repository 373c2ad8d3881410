"""The port's climber (procgen2_tpu_torch/games/climber.py) against the
JAX package's, given the same keys, states and actions: the level bank
and reset identical; the 4-sub-step physics exact at every step, from
random states and through `Environment.step` with a lane placed on a mob
(death, reward 0) and a lane on its last crystal (+1 + 10), both of which
auto-reset; `observe_batch` bitwise equal to the JAX CPU render; and the
expanded-field scene render (B5's inputs) bitwise equal to the raw one
(B1's) on the same states."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import game_lanes
import jax_reference as JR
from jax_capture import render_inputs
import procgen2_tpu_torch as pt
from procgen2_tpu.games import climber as jclimb
from procgen2_tpu_torch import random as R
from procgen2_tpu_torch.games import climber as tclimb
from procgen2_tpu_torch.render import scene_kernel as tsk
from procgen2_tpu_torch.utils import convert
import render_parity as RP
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NUM_LEVELS, N, T = 64, 8, 6
LEVEL_FIELDS = [f.name for f in dataclasses.fields(tclimb.Level)]
STATE_FIELDS = [f.name for f in dataclasses.fields(tclimb.State)
                if f.name != "level"]


def np_tree(tree):
    return jax.tree.map(
        lambda a: (np.asarray(jax.random.key_data(a))
                   if jnp.issubdtype(a.dtype, jax.dtypes.prng_key)
                   else np.asarray(a)), tree)


def same(want, got):
    want = np.asarray(want)
    got = got.numpy()
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


def _generate_both(cfg_kw, n):
    """The JAX package's bank of n levels (`Environment.generate_bank`,
    level i keyed fold_in(key(7), i)) and the port's."""
    jl = JR.bank("climber", tuple(sorted(cfg_kw.items())), seed=7, n=n)
    tl = tclimb.generate(tclimb.Config(**cfg_kw),
                         R.fold_in(R.key(7), torch.arange(n)))
    return np_tree(jl), tl


@pytest.fixture(scope="module")
def banks():
    return _generate_both({}, NUM_LEVELS)


@pytest.mark.parametrize("field", LEVEL_FIELDS)
def test_generate_matches(banks, field):
    jl, tl = banks
    same(getattr(jl, field), getattr(tl, field))


def test_generate_covers_the_branches(banks):
    """The bank has every difficulty, levels with and without mobs, levels
    with skipped crystals, and levels with many crystals."""
    _, tl = banks
    assert len(set(tl.difficulty.tolist())) == 3
    n_mobs = tl.mob_alive.sum(1)
    assert (n_mobs == 0).any() and (n_mobs >= 3).any()
    assert (tl.point_exists.sum(1) < tl.difficulty ** 2 + 1).any()
    assert (tl.point_exists.sum(1) >= 8).any()


def test_generate_easy_mode():
    jl, tl = _generate_both(dict(easy_mode=True), 8)
    for f in LEVEL_FIELDS:
        same(getattr(jl, f), getattr(tl, f))


def place_lanes(gs, n):
    """numpy game State: the first of the first n lanes with a live mob on
    that mob (its rect 0.3 below the mob's centre: death, no crystal), and
    the first other lane on its last crystal with every other crystal
    taken (+1 + 10); their velocities zeroed. Returns (state, lanes)."""
    lv = gs.level
    pos, vel, taken = gs.pos.copy(), gs.vel.copy(), gs.point_taken.copy()
    mob = next(i for i in range(n) if lv.mob_alive[i].any())
    pos[mob] = (gs.mob_pos[mob, int(np.argmax(lv.mob_alive[mob]))]
                + np.float32([0.0, 0.3]))
    crys = next(i for i in range(n) if i != mob)
    last = int(lv.point_exists[crys].sum()) - 1
    taken[crys] = lv.point_exists[crys]
    taken[crys, last] = False
    pos[crys] = lv.point_pos[crys, last] + np.float32([0.0, 0.5])
    vel[[mob, crys]] = 0.0
    return gs.replace(pos=pos, vel=vel, point_taken=taken), [mob, crys]


def random_states(bank, seed, n=N):
    """States on the bank's first n levels with the agent anywhere (in
    walls, mid-air), random velocities, poses, mob positions and taken
    crystals."""
    rng = np.random.default_rng(seed)
    lv = jax.tree.map(lambda a: a[:n], bank)
    f32 = np.float32
    return jclimb.State(
        level=lv,
        pos=np.stack([rng.uniform(1.0, 19.0, n), rng.uniform(1.5, 63.0, n)],
                     -1).astype(f32),
        vel=rng.uniform(-0.6, 0.6, (n, 2)).astype(f32),
        on_ground=rng.random(n) < 0.5,
        face_forward=rng.random(n) < 0.5,
        anim_t=rng.random(n).astype(f32),
        mob_pos=(lv.mob_pos0 + rng.uniform(-2, 2, lv.mob_pos0.shape)).astype(f32),
        mob_vx=rng.choice(f32([-0.15, 0.15]), lv.mob_vx0.shape),
        point_taken=rng.random(lv.point_exists.shape) < 0.3,
        t=rng.integers(0, 20, n).astype(np.int32),
        rng=np.zeros((n, 2), np.uint32),
    )


def _to_jax_state(st):
    return jax.tree.map(jnp.asarray,
                        st.replace(rng=jax.random.wrap_key_data(st.rng)))


def test_reset_matches(banks):
    jl, _ = banks
    lv = jax.tree.map(lambda a: jnp.asarray(a[:N]), jl)
    keys = jax.random.split(jax.random.key(8), N)
    want = np_tree(jax.vmap(functools.partial(jclimb.reset, jclimb.Config()))(
        lv, keys))
    got = tclimb.reset(tclimb.Config(), convert.level(tclimb, jax.tree.map(
        np.asarray, lv), "cpu"), torch.from_numpy(np_tree(keys).astype(np.int64)))
    for f in STATE_FIELDS:
        same(getattr(want, f), getattr(got, f))


@pytest.fixture(scope="module")
def trajectories(banks):
    """T game-level steps (no auto-reset) from random states: JAX and port
    results per step."""
    jl, _ = banks
    st = random_states(jl, 0)
    actions = np.random.default_rng(1).integers(0, 15, (T, N)).astype(np.int32)
    jstep = JR.vmapped("climber", "step")
    jst = _to_jax_state(st)
    tst = convert.state(tclimb, st, "cpu")
    out = []
    for t in range(T):
        jst, jr, jd, _ = jstep(jst, jnp.asarray(actions[t]))
        tst, tr, td, _ = tclimb.step(tclimb.Config(), tst,
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


@pytest.fixture(scope="module")
def run():
    """Both Environments from the same keys; after reset the mob lane and
    the last-crystal lane are placed (carried across with utils/convert);
    T steps with the same actions, rendered."""
    jenv = JR.env("climber")
    tenv = pt.make("climber", device="cpu")
    jbank = JR.bank("climber", n=N)
    tbank = tenv.generate_bank(pt.random.key(7), N)
    jst, jts = jenv.reset(jbank, jax.random.key(8), num_envs=N)
    tst, tts = tenv.reset(tbank, pt.random.key(8), N)
    reset = (np_tree(jst), np.asarray(jts.obs), tst, tts)
    start = np_tree(jst)
    game, lanes = place_lanes(start.game, N)
    start = start.replace(game=game)
    jst = jax.tree.map(jnp.asarray, start.replace(
        rng=jax.random.wrap_key_data(start.rng),
        game=start.game.replace(rng=jax.random.wrap_key_data(start.game.rng))))
    tst = convert.env_state(tclimb, start, "cpu")
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
    observe_batch against the JAX package's CPU render) at every step."""
    jst, jts, tst, tts = run["steps"][t]
    same_tree(jst, tst)
    np.testing.assert_array_equal(jts.obs, tts.obs.numpy())
    for k in ("reward", "terminated", "truncated"):
        same(getattr(jts, k), getattr(tts, k))
    for k in ("returned_episode_return", "returned_episode_length", "done"):
        same(jts.info[k], tts.info[k])


def test_placed_lanes_end_and_restart(run):
    mob, crys = run["lanes"]
    _, _, tst, tts = run["steps"][0]
    assert bool(tts.terminated[mob]) and float(tts.reward[mob]) == 0.0
    assert bool(tts.terminated[crys]) and float(tts.reward[crys]) == 11.0
    for lane in (mob, crys):  # restarted: step counter 0, spawn position
        assert int(tst.game.t[lane]) == 0 and int(tst.ep_length[lane]) == 0
        assert tst.game.pos[lane].tolist() == [1.5, 63.0]
        assert not tst.game.point_taken[lane].any()


def test_chip_smoke_places_the_same_lanes(run):
    """game_lanes' torch placement, which makes both lanes end on the
    card, puts them where this file's numpy placement does."""
    jst, _, tst, _ = run["reset"]
    want, lanes = place_lanes(jst.game, N)
    got, glanes = game_lanes.place_climber_lanes(tst.game, N)
    assert glanes == lanes
    for f in ("pos", "vel", "point_taken"):
        same(getattr(want, f), getattr(got, f))


@pytest.mark.parametrize("seed", [0, 1])
def test_observe_batch_matches_jax(banks, seed):
    """observe_batch on random states (agents, mobs and crystals all over
    the level, every pose and frame) against the JAX package's CPU render,
    which renders the expanded field through its `scene_reference`."""
    st = random_states(banks[0], 10 + seed)
    want = np.asarray(JR.observe_batch("climber", tpu=False)(
        _to_jax_state(st)))
    got = tclimb.observe_batch(tclimb.Config(), convert.state(tclimb, st, "cpu"))
    assert got.dtype == torch.uint8 and got.shape == (N, 3, 64, 64)
    np.testing.assert_array_equal(want, got.numpy())


def test_stamp_placement_rounds_as_xla(banks):
    """The stamps' pixel offsets: XLA CPU folds `(c - cam) * PPU + 32 - 4`
    into one multiply-add with 28 and fuses it, which the port reproduces
    (random._fma32), so r0/c0 are exact, near halves included; rounding
    the sum with 32 first would not be."""
    st = random_states(banks[0], 20, n=NUM_LEVELS)
    tst = convert.state(tclimb, st, "cpu")
    cam_x, cam_y, *_ = tclimb._camera(tclimb.Config(), tst)
    centers = torch.cat([tst.level.point_pos, tst.mob_pos + 0.1], dim=1)

    @jax.jit
    def pix(c, cam):  # climber.py:552-556, the row offset of a P = 8 patch
        return ((c - cam[:, None]) * jclimb.PPU + 64 / 2) - 8 / 2

    want = np.asarray(pix(jnp.asarray(centers[..., 1].numpy()),
                          jnp.asarray(cam_y.numpy())))
    fused = R._fma32(centers[..., 1] - cam_y[:, None], tclimb.PPU, 28.0)
    twice = R._fma32(centers[..., 1] - cam_y[:, None], tclimb.PPU, 32.0) - 4.0
    np.testing.assert_array_equal(want.view(np.int32),
                                  fused.numpy().view(np.int32))
    assert (want != twice.numpy()).any()
    _, _, _, r0, c0 = tclimb._stamp_group(tst, cam_x, cam_y, None)
    np.testing.assert_array_equal(np.round(want).astype(np.int32),
                                  r0[:, :2 * tclimb.MAX_POINTS].numpy())


def test_stamp_placement_matches_xla_near_half_pixels(banks):
    """The same fold in the render's own graph: on 64 states (a batch XLA
    runs in its vector loop) whose crystals lie within a few ulp of half a
    pixel, where rounding the sum with 32 first gives another pixel, the
    port's pixels equal those the JAX render hands its scene kernel
    (jax_capture)."""
    rng = np.random.default_rng(41)
    f32 = np.float32
    st = random_states(banks[0], 31, n=N)
    st = jax.tree.map(lambda a: np.resize(a, (4096,) + a.shape[1:]), st)
    cam_y = np.round((st.pos[:, 1] - f32(8.5)) * f32(4)).astype(f32) * f32(0.25)
    cam = np.stack([np.full(4096, f32(tclimb.MAP_W / 2)), cam_y], -1)
    k = tclimb.MAX_POINTS
    off = (rng.integers(0, 60, (4096, k, 2)) + 0.5 - 28.0) / tclimb.PPU
    pts = np.float32(cam[:, None] + off)
    pts = (pts + rng.integers(-6, 7, pts.shape) * np.spacing(pts)).astype(f32)
    d = pts - cam[:, None]
    once = np.round((np.float64(d) * np.float64(f32(tclimb.PPU))
                     + 28.0).astype(f32))
    twice = np.round((np.float64(d) * np.float64(f32(tclimb.PPU))
                      + 32.0).astype(f32) - f32(4))
    pick = np.flatnonzero((once != twice).reshape(4096, -1).any(1))[:64]
    assert pick.size == 64
    st = jax.tree.map(lambda a: a[pick], st)
    st = st.replace(level=st.level.replace(point_pos=pts[pick]))
    want = render_inputs(jclimb, jclimb.Config(), _to_jax_state(st))
    got = tclimb._scene_inputs(tclimb.Config(), convert.state(tclimb, st, "cpu"))
    for w, g in zip(want["groups"], got[12]):
        for a, b in zip(w, g[1:]):
            same(a, b)


@pytest.mark.parametrize("seed", [0, 1])
def test_expanded_field_scene_equals_raw_scene(banks, seed):
    """B5's plain version on `_scene_field` equals B1's plain version on
    `_scene_inputs` of the same states, bitwise; and the field is the JAX
    package's CPU expansion (its einsums through the expansion tables)."""
    st = random_states(banks[0], 30 + seed)
    tst = convert.state(tclimb, st, "cpu")
    cfg = tclimb.Config()
    field = tclimb._scene_field(cfg, tst)
    raw = tsk.scene_raw_reference(*tclimb._scene_inputs(cfg, tst))
    got = tsk.scene_reference(*field)
    assert torch.equal(got.view(torch.int16), raw.view(torch.int16))

    X = field[0]
    Ey, Ex = (jnp.asarray(t, jnp.bfloat16) for t in
              jclimb.phases_lib.expansion_tables(jclimb.PPU, 64, 4,
                                                 win_size=21))
    gridp, ty0, tx0, jy, jx = (tclimb._scene_inputs(cfg, tst)[i].numpy()
                               for i in range(5))
    b = tst.level.bg_index.numpy()
    bgpad = jclimb._scene_assets(4)["bgpad"]
    W = 21
    win = np.stack([np.concatenate(
        [gridp[n, y + W:y + 2 * W, x + W:x + 2 * W][None].astype(np.float32),
         bgpad[b[n], :, y + W:y + 2 * W, x + W:x + 2 * W].astype(np.float32)])
        for n, (y, x) in enumerate(zip(ty0, tx0))])
    rows = jnp.einsum("nri,ncij->ncrj", Ey[jy], jnp.asarray(win, jnp.bfloat16),
                      preferred_element_type=jnp.bfloat16)
    want = jnp.einsum("ncrj,nju->ncru", rows, Ex[jx],
                      preferred_element_type=jnp.bfloat16)
    np.testing.assert_array_equal(np.asarray(want, np.float32),
                                  X.float().numpy())


# ---------------------------------------------------------------------------
# The exact renders (tests/render_parity.py): observe at 64 and 128 px,
# Environment.render, the selectors against the JAX render's `_onehot`
# arguments, the scene_phases=0 render on the TPU's stamp path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [64, 128])
def test_observe_matches_jax(size):
    st = RP.check_observe("climber", size=size)
    assert st.game.level.mob_alive.any()
    assert (st.game.level.point_exists & ~st.game.point_taken).any()


def test_observe_selectors_match_the_jax_render():
    RP.check_selectors("climber")


@pytest.mark.parametrize("env_index", [0, 1])
def test_render_matches_jax(env_index):
    RP.check_render("climber", env_index=env_index)


def test_observe_exact_matches_jax():
    RP.check_exact("climber")


def test_observe_exact_selectors_match_the_jax_render():
    RP.check_exact_selectors("climber")
