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
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax_reference as JR
import procgen2_tpu_torch as pt
from procgen2_tpu.games import bossfight as jb
from procgen2_tpu_torch import random as R
from procgen2_tpu_torch.games import bossfight as tb
from procgen2_tpu_torch.utils import convert
import render_parity as RP
from bossfight_parity import (LEVEL_FIELDS, N, STATE_FIELDS, actions,
                              np_tree, same, start_state, to_jax)
import texel_edges
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NUM_LEVELS, T_LOCAL, T_FREE = 1024, 40, 60
# the most float64 cos/sin rounded once move a volley velocity
VEL_BUDGET = tb.Config().bullet_speed * 2.0 ** -19


def close(want, got, budget):
    err = np.abs(np.asarray(want, np.float64) - got)
    assert err.max() <= budget, (err.max(), budget)


@pytest.fixture(scope="module")
def banks():
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(7), i))(
        jnp.arange(NUM_LEVELS, dtype=jnp.uint32))
    jl = JR.vmapped("bossfight", "generate")(keys)
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


@pytest.fixture(scope="module")
def local(banks):
    """Step-local pairs: (JAX state before, JAX result, port result) for
    each of T_LOCAL steps of a JAX rollout."""
    jstep = JR.vmapped("bossfight", "step")
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
    jstep = JR.vmapped("bossfight", "step")
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


@pytest.mark.parametrize("t", [5, 22, 39])
def test_observe_batch_matches_jax(local, t):
    """Frames along the rollout: by step 22 volleys are in flight and
    player bullets hit the boss; by step 39 bullets have exploded, the
    boss of lane 1 lost its shield and lane 3 shows damage explosions. The
    JAX render on its TPU path: the stamp kernel in interpret mode."""
    jst = local[t][1][0]
    want = np.asarray(JR.observe_batch("bossfight")(to_jax(jst)))
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
    last phase, no hit points, damage show over (as game_lanes.
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
    jenv = JR.env("bossfight", tpu=True)
    tenv = pt.make("bossfight", device="cpu")
    jbank = JR.bank("bossfight", seed=3)
    tbank = tenv.generate_bank(pt.random.key(3), 8)
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
    want = JR.observe_each("bossfight", (), to_jax(jst))
    got = tb.observe(tb.Config(), convert.state(tb, jst, "cpu"))
    np.testing.assert_array_equal(want, got.numpy())


def test_observe_selectors_match_the_jax_render():
    RP.check_selectors("bossfight", n=4, steps=40, fire=0.5)


@pytest.mark.parametrize("env_index", [0, 1])
def test_render_matches_jax(env_index):
    RP.check_render("bossfight", env_index=env_index, n=4, steps=40, fire=0.5)


@pytest.mark.parametrize("case", ["bossfight_boss_bullets"])
def test_rotated_sprites_match_jax_on_texel_edges(case):
    """The rotated boss bullets with a pixel on a texel edge (within an ulp) in
    every env: the port's observe equals the JAX package's, bitwise
    (tests/texel_edges.py, on this file's rollout programs)."""
    texel_edges.check(case)
