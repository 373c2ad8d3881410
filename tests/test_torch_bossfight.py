"""The port's bossfight (procgen2_tpu_torch/games/bossfight.py) against the
JAX package's, on the CPU.

* The level bank (1024 levels) and reset are identical.
* Step-local parity: along a 40-step JAX rollout from a start state whose
  lanes cover volleys of every weapon, player bullets bouncing off the
  shield, boss damage with its explosions, a phase change and an agent
  death, each JAX state is carried into the port (utils/convert.py) and
  both step once. Every field, rewards and terminations are exact (f32
  compared as int32 views), the bullet volleys' velocities too: they go
  through XLA CPU's f32 cos/sin, which the port reproduces (`trig.py`).
* A free-running rollout of 60 steps, each side from its own state: every
  field, reward and termination exact at every step.
* The agent-death and boss-death lanes: -10 and +10 on the first
  sub-step, termination, and the auto-reset through Environment.step.
* observe_batch: bitwise equal to the JAX render with its stamp kernel in
  interpret mode (the JAX CPU path sums stamps by matmul instead, which
  is not the TPU's result), on frames with live and exploding bullets,
  damage explosions, and the boss with and without its shield.

Why the volleys need `trig.py`: XLA CPU's f32 cos/sin are glibc's cosf and
sinf, not correctly rounded, and where the radial volley's angle feeds
them XLA fuses pi/4 * i + (u * 2) * pi into one multiply-add. Float64
cos/sin rounded once, of the stored rotation, give velocities that differ
from the JAX package's by up to about 8 ulp of the speed
(test_volley_velocities_differ_within_budget).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import procgen2_tpu as pg
import procgen2_tpu_torch as pt
from procgen2_tpu.games import bossfight as jb
from procgen2_tpu.render import compositor as jC
from procgen2_tpu.render import stamp_kernel as jsk
from procgen2_tpu_torch import random as R
from procgen2_tpu_torch.games import bossfight as tb
from procgen2_tpu_torch.utils import convert
import render_parity as RP

NUM_LEVELS, N, T_LOCAL, T_FREE = 1024, 8, 40, 60
LEVEL_FIELDS = [f.name for f in dataclasses.fields(tb.Level)]
STATE_FIELDS = [f.name for f in dataclasses.fields(tb.State)
                if f.name != "level"]
# the most float64 cos/sin rounded once move a volley velocity
VEL_BUDGET = tb.Config().bullet_speed * 2.0 ** -19


def np_tree(tree):
    return jax.tree.map(
        lambda a: (np.asarray(jax.random.key_data(a))
                   if jnp.issubdtype(a.dtype, jax.dtypes.prng_key)
                   else np.asarray(a)), tree)


def to_jax(st):
    return jax.tree.map(jnp.asarray,
                        st.replace(rng=jax.random.wrap_key_data(st.rng)))


def same(want, got, what=""):
    want = np.asarray(want)
    got = got.numpy()
    if want.dtype == np.uint32:
        want = want.astype(np.int64)
    assert want.shape == got.shape and want.dtype == got.dtype, (
        what, want.shape, want.dtype, got.shape, got.dtype)
    if want.dtype == np.float32:
        np.testing.assert_array_equal(want.view(np.int32), got.view(np.int32),
                                      err_msg=what)
    else:
        np.testing.assert_array_equal(want, got, err_msg=what)


def close(want, got, budget):
    err = np.abs(np.asarray(want, np.float64) - got)
    assert err.max() <= budget, (err.max(), budget)


@pytest.fixture(scope="module")
def banks():
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(7), i))(
        jnp.arange(NUM_LEVELS, dtype=jnp.uint32))
    jl = jax.jit(jax.vmap(functools.partial(jb.generate, jb.Config())))(keys)
    tl = tb.generate(tb.Config(), R.fold_in(R.key(7), torch.arange(NUM_LEVELS)))
    return np_tree(jl), tl


@pytest.mark.parametrize("field", LEVEL_FIELDS)
def test_generate_matches(banks, field):
    jl, tl = banks
    same(getattr(jl, field), getattr(tl, field), field)


def test_generate_covers_the_branches(banks):
    """1-4 barriers, every boss texture and background."""
    _, tl = banks
    counts = tl.barrier_exists.sum(1)
    assert set(counts.tolist()) == {1, 2, 3, 4}
    assert len(set(tl.boss_tex.tolist())) == 4
    assert len(set(tl.bg_index.tolist())) == tb.NUM_BGS


def test_reset_matches(banks):
    jl, _ = banks
    lv = jax.tree.map(lambda a: jnp.asarray(a[:N]), jl)
    keys = jax.random.split(jax.random.key(8), N)
    want = np_tree(jax.vmap(functools.partial(jb.reset, jb.Config()))(lv, keys))
    got = tb.reset(tb.Config(), convert.level(tb, jax.tree.map(np.asarray, lv),
                                              "cpu"),
                   torch.from_numpy(np_tree(keys).astype(np.int64)))
    for f in STATE_FIELDS:
        same(getattr(want, f), getattr(got, f), f)


def start_state(bank):
    """Reset states on the bank's first N levels, weapons 0-3 over the
    lanes, and: lane 1 two steps before its shielded phase ends; lane 2
    unshielded with one hit point left (player bullets damage it, it
    explodes and advances); lane 3 in the last phase with one hit point
    left. numpy State."""
    lv = jax.tree.map(lambda a: jnp.asarray(a[:N]), bank)
    st = np_tree(jax.vmap(functools.partial(jb.reset, jb.Config()))(
        lv, jax.random.split(jax.random.key(8), N)))
    phase_timer = np.full(N, 1.0, np.float32)
    phase_index = np.zeros(N, np.int32)
    hp = np.full(N, jb.BOSS_HP, np.int32)
    phase_timer[1] = 178.0
    phase_index[2], phase_timer[2], hp[2] = 1, 5.0, 1
    phase_index[3], phase_timer[3], hp[3] = 5, 5.0, 1
    return st.replace(phase_timer=phase_timer, phase_index=phase_index, hp=hp,
                      weapon_index=np.arange(N, dtype=np.int32) % 4)


def actions(T, seed=1):
    """Fire half the time, else move (left, right, up, down) or stand."""
    rng = np.random.default_rng(seed)
    return np.where(rng.random((T, N)) < 0.5, 9,
                    rng.choice([1, 7, 5, 3, 4], (T, N))).astype(np.int32)


@pytest.fixture(scope="module")
def local(banks):
    """Step-local pairs: (JAX state before, JAX result, port result) for
    each of T_LOCAL steps of a JAX rollout."""
    jstep = jax.jit(jax.vmap(functools.partial(jb.step, jb.Config())))
    jst = to_jax(start_state(banks[0]))
    acts = actions(T_LOCAL)
    out = []
    for t in range(T_LOCAL):
        before = np_tree(jst)
        jst, jr, jd, _ = jstep(jst, jnp.asarray(acts[t]))
        tst, tr, td, _ = tb.step(tb.Config(), convert.state(tb, before, "cpu"),
                                 torch.from_numpy(acts[t]))
        out.append((before, (np_tree(jst), np.asarray(jr), np.asarray(jd)),
                    (tst, tr, td)))
    return out


@pytest.mark.parametrize("field", STATE_FIELDS)
def test_step_local_parity(local, field):
    for t, (_, (jst, _, _), (tst, _, _)) in enumerate(local):
        same(getattr(jst, field), getattr(tst, field), f"step {t}: {field}")


def test_step_local_rewards_and_termination(local):
    for t, (_, (_, jr, jd), (_, tr, td)) in enumerate(local):
        same(jr, tr, f"step {t}: reward")
        same(jd, td, f"step {t}: done")


def test_step_local_covers_the_game(local):
    """The rollout fires every weapon, bounces player bullets off the
    shield, damages the boss, shows explosions, changes phase, and kills
    an agent."""
    fired = set()
    bounced = exploded = phase_changed = damaged = died = False
    for before, (jst, jr, _), _ in local:
        shielded = before.phase_index % 2 == 0
        more = jst.bb_num > before.bb_num
        fired |= set(before.weapon_index[more & shielded].tolist())
        bounced |= bool((jst.ab_bouncing & ~before.ab_bouncing).any())
        exploded |= bool((jst.ex_num > before.ex_num).any())
        phase_changed |= bool((jst.phase_index > before.phase_index).any())
        damaged |= bool((jst.hp < before.hp).any())
        died |= bool((jr == -10.0).any())
    assert fired == {0, 1, 2, 3}
    assert bounced and exploded and phase_changed and damaged and died


def test_volley_velocities_differ_within_budget(local):
    """Why the port takes XLA's cos/sin: float64 cos/sin rounded once, of
    each new bullet's stored rotation, differ from the JAX package's
    velocities (which test_step_local_parity holds the port's to,
    exactly), within VEL_BUDGET."""
    differ = volleys = 0
    speed = tb.Config().bullet_speed
    for before, (jst, _, _), _ in local:
        # bullets fired this step (a bullet that strikes stops: speed 0)
        fired = ((jst.bb_vel != before.bb_vel).any(-1)
                 & (np.abs(jst.bb_vel).sum(-1) > 0))
        new = np.broadcast_to(fired[..., None], jst.bb_vel.shape)
        rot = torch.from_numpy(np.array(jst.bb_rot, np.float64))
        f64 = torch.stack([torch.cos(rot).float(), -torch.sin(rot).float()],
                          -1) * speed
        if new.any():
            volleys += int(new.sum())
            differ += int((new & (jst.bb_vel != f64.numpy())).sum())
            close(jst.bb_vel[new], f64.numpy()[new], VEL_BUDGET)
    assert volleys > 0 and differ > 0


def test_free_running_rollout(banks):
    """T_FREE steps, each side from its own state: every field, reward and
    termination exact at every step."""
    jstep = jax.jit(jax.vmap(functools.partial(jb.step, jb.Config())))
    st = start_state(banks[0])
    jst, tst = to_jax(st), convert.state(tb, st, "cpu")
    acts = actions(T_FREE, seed=2)
    for t in range(T_FREE):
        jst, jr, jd, _ = jstep(jst, jnp.asarray(acts[t]))
        tst, tr, td, _ = tb.step(tb.Config(), tst, torch.from_numpy(acts[t]))
        want = np_tree(jst)
        for f in STATE_FIELDS:
            same(getattr(want, f), getattr(tst, f), f"step {t}: {f}")
        same(jr, tr, f"step {t}: reward")
        same(jd, td, f"step {t}: done")


def test_window_and_ring_push_match():
    """_window's floor modulo on negative offsets and _ring_push's one-hot
    writes, against the JAX functions."""
    rng = np.random.default_rng(0)
    nxt = rng.integers(0, 64, 32).astype(np.int32)
    num = rng.integers(0, 65, 32).astype(np.int32)
    want = jax.vmap(jb._window, in_axes=(0, 0, None))(nxt, num, 64)
    same(want, tb._window(torch.from_numpy(nxt), torch.from_numpy(num), 64))
    ring = [rng.random((32, 64, 2)).astype(np.float32),
            rng.random((32, 64, 2)).astype(np.float32),
            rng.random((32, 64)).astype(np.float32),
            rng.random((32, 64)).astype(np.float32), num, nxt]
    new = [rng.random((32, 2)).astype(np.float32),
           rng.random((32, 2)).astype(np.float32),
           rng.random(32).astype(np.float32), rng.random(32) < 0.7]
    want = jax.vmap(functools.partial(jb._ring_push, size=64))(*ring, *new)
    got = tb._ring_push(*(torch.from_numpy(a) for a in ring + new), 64)
    for w, g in zip(want, got):
        same(w, g)


def test_cull_keeps_top_k_order_on_ties():
    """_cull_alive (stable sort + gather) against lax.top_k + one-hot f32
    einsums: most slots tie (alive or dead), so the order on ties decides
    which slots are drawn, and in which painter order."""
    rng = np.random.default_rng(4)
    M, k = 64, tb.BB_CULL
    alive = rng.random((6, M)) < np.array([0.1, 0.3, 0.5, 0.7, 0.9, 1.0])[:, None]
    var = rng.integers(0, 56, (6, M)).astype(np.int32)
    x = rng.uniform(-2, 2, (6, M)).astype(np.float32)
    y = rng.uniform(-2, 2, (6, M)).astype(np.float32)
    want = jb._cull_alive(k, jnp.asarray(alive), jnp.asarray(var),
                          jnp.asarray(x), jnp.asarray(y))
    got = tb._cull_alive(k, *(torch.from_numpy(a) for a in (alive, var, x, y)))
    for w, g in zip(want, got):
        same(w, g)


@pytest.fixture
def jax_stamp_kernel(monkeypatch):
    """The JAX package's render on its TPU path: the stamp kernel, run in
    interpret mode."""
    orig = jsk.composite_tpu
    monkeypatch.setattr(jC, "_use_stamp_kernel", lambda: True)
    monkeypatch.setattr(jsk, "composite_tpu",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


@pytest.mark.parametrize("t", [5, 22, 39])
def test_observe_batch_matches_jax(local, jax_stamp_kernel, t):
    """Frames along the rollout: by step 22 volleys are in flight and
    player bullets hit the boss; by step 39 bullets have exploded, the
    boss of lane 1 lost its shield and lane 3 shows damage explosions."""
    jst = local[t][1][0]
    want = np.asarray(jax.jit(functools.partial(jb.observe_batch, jb.Config()))(
        to_jax(jst)))
    got = tb.observe_batch(tb.Config(), convert.state(tb, jst, "cpu"))
    assert got.dtype == torch.uint8 and got.shape == (N, 3, 64, 64)
    np.testing.assert_array_equal(want, got.numpy())
    if t == 39:
        live = jb._window(jst.bb_next[0], jst.bb_num[0], 64)
        assert (jst.phase_index % 2 == 1).any() and (jst.phase_index % 2 == 0).any()
        assert (jst.ex_frame >= 0).any() and live.any()
        assert (jst.bb_frame >= 1).any()  # exploding boss bullets


def place_deaths(gs):
    """numpy game State: lane 0's agent on its boss; lane 1's boss in its
    last phase, no hit points, damage show over (as chip_smoke.py's
    place_boss_deaths)."""
    pos, phase_index = gs.pos.copy(), gs.phase_index.copy()
    phase_timer, hp = gs.phase_timer.copy(), gs.hp.copy()
    damage_timer = gs.damage_timer.copy()
    pos[0] = gs.boss_pos[0]
    phase_index[1], phase_timer[1], hp[1] = 5, 1.0, 0
    damage_timer[1] = jb.DAMAGE_TIME
    return gs.replace(pos=pos, phase_index=phase_index, phase_timer=phase_timer,
                      hp=hp, damage_timer=damage_timer)


@pytest.fixture(scope="module")
def env_run():
    """Both Environments from the same keys, the death lanes placed after
    reset, 3 auto-resetting steps with obs (the JAX render on its stamp
    kernel path, interpret mode)."""
    with pytest.MonkeyPatch.context() as mp:
        orig = jsk.composite_tpu
        mp.setattr(jC, "_use_stamp_kernel", lambda: True)
        mp.setattr(jsk, "composite_tpu",
                   lambda *a, **k: orig(*a, **{**k, "interpret": True}))
        jenv = pg.make("bossfight")
        tenv = pt.make("bossfight", device="cpu")
        jbank = jenv.generate_bank(jax.random.key(3), num_levels=16)
        tbank = tenv.generate_bank(pt.random.key(3), 16)
        jst, _ = jenv.reset(jbank, jax.random.key(4), num_envs=N)
        start = np_tree(jst)
        start = start.replace(game=place_deaths(start.game))
        jst = jax.tree.map(jnp.asarray, start.replace(
            rng=jax.random.wrap_key_data(start.rng),
            game=start.game.replace(rng=jax.random.wrap_key_data(start.game.rng))))
        tst = convert.env_state(tb, start, "cpu")
        acts = actions(3, seed=5)
        steps = []
        for t in range(3):
            jst, jts = jenv.step(jbank, jst, jnp.asarray(acts[t]))
            tst, tts = tenv.step(tbank, tst, torch.from_numpy(acts[t]))
            steps.append((np_tree(jst), np_tree(jts), tst, tts))
    return steps


@pytest.mark.parametrize("t", range(3))
def test_env_steps_match(env_run, t):
    jst, jts, tst, tts = env_run[t]
    for f in STATE_FIELDS:
        same(getattr(jst.game, f), getattr(tst.game, f), f)
    for f in ("ep_return", "ep_length", "rng"):
        same(getattr(jst, f), getattr(tst, f), f)
    for f in ("reward", "terminated", "truncated"):
        same(getattr(jts, f), getattr(tts, f), f)
    np.testing.assert_array_equal(jts.obs, tts.obs.numpy())


def test_death_lanes_end_and_restart(env_run):
    """Lane 0 (agent on the boss) gets -10, lane 1 (boss out of hit points
    in its last phase) +10, both on step 0; both restart from the bank."""
    _, _, tst, tts = env_run[0]
    assert tts.terminated[:2].all() and tts.reward[:2].tolist() == [-10.0, 10.0]
    assert not tts.terminated[2:].any()
    g = tst.game
    assert g.t[:2].tolist() == [0, 0] and tst.ep_length[:2].tolist() == [0, 0]
    assert g.phase_index[:2].tolist() == [0, 0]
    assert g.hp[:2].tolist() == [tb.BOSS_HP] * 2
    assert tts.info["returned_episode_return"][:2].tolist() == [-10.0, 10.0]


# ---------------------------------------------------------------------------
# The exact renders (tests/render_parity.py): observe at 64 and 128 px,
# Environment.render, the selectors against the JAX render's `_onehot`
# arguments
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [64, 128])
def test_observe_matches_jax(size):
    st = RP.check_observe("bossfight", size=size, n=4, steps=40, fire=0.5)
    g = convert.state(tb, st.game, "cpu")
    window = tb._window(g.bb_next, g.bb_num, tb.NUM_B_BULLETS)
    assert (window & (g.bb_frame == 0)).any()  # rotated boss bullets
    assert (window & (g.bb_frame >= 1)).any()  # and their explosions
    assert (g.ab_num > 0).any()


@pytest.mark.parametrize("t", [22, 39])
def test_observe_matches_jax_late(local, t):
    """The single-env observe on the rollout's frames with damage
    explosions and an unshielded boss (step 39)."""
    jst = local[t][1][0]
    f = jax.jit(functools.partial(jb.observe, jb.Config()))
    want = np.stack([np.asarray(f(jax.tree.map(lambda x: x[i], to_jax(jst))))
                     for i in range(N)])
    got = tb.observe(tb.Config(), convert.state(tb, jst, "cpu"))
    np.testing.assert_array_equal(want, got.numpy())


def test_observe_selectors_match_the_jax_render():
    RP.check_selectors("bossfight", n=4, steps=40, fire=0.5)


@pytest.mark.parametrize("env_index", [0, 1])
def test_render_matches_jax(env_index):
    RP.check_render("bossfight", env_index=env_index, n=4, steps=40, fire=0.5)


# ---------------------------------------------------------------------------
# mode="easy" (common_systems.cpp:104, 202): half the boss bullets' speed
# and a shorter shield jitter; held like the default mode
# ---------------------------------------------------------------------------

EASY_J, EASY_T = jb.Config(mode="easy"), tb.Config(mode="easy")
T_EASY = 8


@pytest.fixture(scope="module")
def easy_run():
    """A 64-level easy bank from both sides, and T_EASY steps of N envs
    each side from its own state (reset from the bank's first N levels,
    the default mode's start lanes), with their observe_batch inputs."""
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(9), i))(
        jnp.arange(64, dtype=jnp.uint32))
    jl = np_tree(jax.jit(jax.vmap(functools.partial(jb.generate, EASY_J)))(
        keys))
    tl = tb.generate(EASY_T, R.fold_in(R.key(9), torch.arange(64)))
    jstep = jax.jit(jax.vmap(functools.partial(jb.step, EASY_J)))
    st = start_state(jl)
    jst, tst = to_jax(st), convert.state(tb, st, "cpu")
    acts = actions(T_EASY, seed=5)
    steps = []
    for t in range(T_EASY):
        jst, jr, jd, _ = jstep(jst, jnp.asarray(acts[t]))
        tst, tr, td, _ = tb.step(EASY_T, tst, torch.from_numpy(acts[t]))
        steps.append((np_tree(jst), jr, jd, tst, tr, td))
    return jl, tl, steps, jst


@pytest.mark.parametrize("field", LEVEL_FIELDS)
def test_easy_generate_matches(easy_run, field):
    jl, tl, _, _ = easy_run
    same(getattr(jl, field), getattr(tl, field), field)


@pytest.mark.parametrize("t", range(T_EASY))
def test_easy_steps_match(easy_run, t):
    """Every field, reward and termination exact at every step."""
    want, jr, jd, got, tr, td = easy_run[2][t]
    for f in STATE_FIELDS:
        same(getattr(want, f), getattr(got, f), f"step {t}: {f}")
    same(jr, tr, f"step {t}: reward")
    same(jd, td, f"step {t}: done")


def test_easy_observe_matches_jax(easy_run, jax_stamp_kernel):
    """observe_batch (the TPU's stamp semantics) and the single-env
    observe after the last step."""
    _, _, steps, jst = easy_run
    want = np.asarray(jax.jit(functools.partial(jb.observe_batch, EASY_J))(
        jst))
    got = tb.observe_batch(EASY_T, steps[-1][3])
    np.testing.assert_array_equal(want, got.numpy())
    f = jax.jit(functools.partial(jb.observe, EASY_J))
    want = np.stack([np.asarray(f(jax.tree.map(lambda x: x[i], jst)))
                     for i in range(N)])
    np.testing.assert_array_equal(want, tb.observe(EASY_T,
                                                   steps[-1][3]).numpy())
