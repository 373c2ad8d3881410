"""The port's Environment (procgen2_tpu_torch/core/env.py) against the
JAX package's, through the entry points a user calls: the level bank,
reset, auto-resetting steps (with lanes placed on the coin, a saw and
lava so that auto-reset fires), observations, reset_pinned and step_raw.
States, rewards and terminations are identical and obs bitwise equal.
Also: the tree helpers, make's errors, spaces, and that importing the port
loads no jax."""
import dataclasses
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import procgen2_tpu as pg
import procgen2_tpu_torch as pt
from procgen2_tpu.utils import tree as jtree
from procgen2_tpu_torch.games import coinrun as tcoin
from procgen2_tpu_torch.utils import convert, tree_map
from procgen2_tpu_torch.utils import tree as ttree

N, T = 8, 5


def np_tree(tree):
    return jax.tree.map(
        lambda a: (np.asarray(jax.random.key_data(a))
                   if jnp.issubdtype(a.dtype, jax.dtypes.prng_key)
                   else np.asarray(a)), tree)


def assert_same_tree(want, got):
    """`want`: numpy leaves (JAX side); `got`: the port's dataclasses."""
    if dataclasses.is_dataclass(got):
        for f in dataclasses.fields(got):
            assert_same_tree(getattr(want, f.name), getattr(got, f.name))
        return
    want = np.asarray(want)
    if want.dtype == np.uint32:
        want = want.astype(np.int64)
    got = got.numpy()
    assert want.shape == got.shape and want.dtype == got.dtype
    if want.dtype == np.float32:
        np.testing.assert_array_equal(want.view(np.int32), got.view(np.int32))
    else:
        np.testing.assert_array_equal(want, got)


def place_on_hazards(gs):
    """Lane 0 on its coin, the first lane with a saw on it, the first
    other lane with lava in it (numpy game State in, out)."""
    lv = gs.level
    pos, vel = gs.pos.copy(), gs.vel.copy()
    pos[0] = lv.coin_pos[0] + np.float32([0.0, 0.5])
    lanes = [0]
    saws = [i for i in range(1, N) if lv.saw_alive[i].any()]
    if saws:
        i = saws[0]
        pos[i] = lv.saw_pos[i, int(np.argmax(lv.saw_alive[i]))] + np.float32([0.0, 0.5])
        lanes.append(i)
    lava = [i for i in range(1, N) if i not in lanes
            and (lv.grid[i] == tcoin.LAVA_TOP).any()]
    if lava:
        i = lava[0]
        ry, x = np.argwhere(lv.grid[i] == tcoin.LAVA_TOP)[0]
        pos[i] = np.float32([x + 0.5, ry + 1.0])
        lanes.append(i)
    vel[lanes] = 0.0
    return gs.replace(pos=pos, vel=vel)


@pytest.fixture(scope="module")
def run():
    """Both envs from the same keys; lanes placed on hazards after reset
    (carried across with utils/convert); T steps with the same actions."""
    jenv = pg.make("coinrun")
    tenv = pt.make("coinrun", device="cpu")
    jbank = jenv.generate_bank(jax.random.key(7), num_levels=N)
    tbank = tenv.generate_bank(pt.random.key(7), N)
    jst, jts = jenv.reset(jbank, jax.random.key(8), num_envs=N)
    tst, tts = tenv.reset(tbank, pt.random.key(8), N)
    reset = (np_tree(jst), np.asarray(jts.obs), tst, tts)

    start = np_tree(jst)
    start = start.replace(game=place_on_hazards(start.game))
    jst = jax.tree.map(jnp.asarray, start.replace(
        rng=jax.random.wrap_key_data(start.rng),
        game=start.game.replace(rng=jax.random.wrap_key_data(start.game.rng))))
    tst = convert.env_state(tcoin, start, "cpu")
    actions = np.random.default_rng(3).integers(0, 15, (T, N)).astype(np.int32)
    steps = []
    for t in range(T):
        jst, jts = jenv.step(jbank, jst, jnp.asarray(actions[t]))
        tst, tts = tenv.step(tbank, tst, torch.from_numpy(actions[t]))
        steps.append((np_tree(jst), np_tree(jts), tst, tts))
    return dict(jenv=jenv, tenv=tenv, jbank=jbank, tbank=tbank, reset=reset,
                steps=steps, actions=actions)


def test_bank_matches(run):
    assert_same_tree(np_tree(run["jbank"]), run["tbank"])


def test_reset_matches(run):
    jst, jobs, tst, tts = run["reset"]
    assert_same_tree(jst, tst)
    assert tts.obs.shape == (N, 64, 64, 3) and tts.obs.dtype == torch.uint8
    np.testing.assert_array_equal(jobs, tts.obs.numpy())


@pytest.mark.parametrize("t", range(T))
def test_step_matches(run, t):
    jst, jts, tst, tts = run["steps"][t]
    assert_same_tree(jst, tst)
    np.testing.assert_array_equal(jts.obs, tts.obs.numpy())
    for k in ("reward", "terminated", "truncated"):
        assert_same_tree(getattr(jts, k), getattr(tts, k))
    for k in ("returned_episode_return", "returned_episode_length", "done"):
        assert_same_tree(jts.info[k], tts.info[k])


def test_auto_reset_fired(run):
    _, _, tst, tts = run["steps"][0]
    assert bool(tts.terminated[0]) and float(tts.reward[0]) == 10.0
    done = tts.terminated
    assert int(done.sum()) >= 2
    # done lanes restart: step counter 0, spawn position, zeroed returns
    assert (tst.game.t[done] == 0).all() and (tst.ep_length[done] == 0).all()
    assert (tst.game.pos[done] == torch.tensor([1.5, 62.0])).all()


def test_chip_smoke_places_the_same_lanes(run):
    """chip_smoke.py's torch placement, which makes auto-reset fire on the
    card, puts the lanes where this file's numpy placement does."""
    jst, _, tst, _ = run["reset"]
    want = place_on_hazards(jst.game)
    got, lanes = chip_smoke.place_on_hazards(tst.game, N)
    assert lanes[0] == 0 and len(lanes) >= 2
    assert_same_tree(want.pos, got.pos)
    assert_same_tree(want.vel, got.vel)
    assert_same_tree(jst.game.level, got.level)


def test_chip_smoke_refuses_without_a_card():
    """Without a CUDA device chip_smoke.py exits non-zero and prints no
    result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    root = str(__import__("pathlib").Path(__file__).resolve().parents[1])
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chw_obs_is_the_planar_frame(run):
    tenv = run["tenv"]
    _, jts, tst, tts = run["steps"][-1]
    chw = pt.make("coinrun", device="cpu", obs_format="chw").observe(tst)
    assert chw.shape == (N, 3, 64, 64)
    assert torch.equal(chw.permute(0, 2, 3, 1), tts.obs)
    np.testing.assert_array_equal(np.transpose(jts.obs, (0, 3, 1, 2)),
                                  chw.numpy())
    assert torch.equal(tenv.observe(tst), tts.obs)


def test_reset_pinned_matches(run):
    ids = jnp.arange(N, dtype=jnp.uint32) + 100
    want = np_tree(run["jenv"].reset_pinned(run["jbank"], jax.random.key(3),
                                            ids))
    got = run["tenv"].reset_pinned(run["tbank"], pt.random.key(3),
                                   torch.arange(N) + 100)
    assert_same_tree(want, got)


def test_step_raw_matches(run):
    jst, _, tst, _ = run["steps"][0]  # terminated lanes keep simulating
    jst = jax.tree.map(jnp.asarray, jst.replace(
        rng=jax.random.wrap_key_data(jst.rng),
        game=jst.game.replace(rng=jax.random.wrap_key_data(jst.game.rng))))
    a = run["actions"][1]
    jst2, jts = run["jenv"].step_raw(jst, jnp.asarray(a), render=False)
    tst2, tts = run["tenv"].step_raw(tst, torch.from_numpy(a), render=False)
    assert tts.obs is None
    assert_same_tree(np_tree(jst2), tst2)
    assert_same_tree(np.asarray(jts.reward), tts.reward)
    assert_same_tree(np.asarray(jts.terminated), tts.terminated)


def test_tree_helpers_match(run):
    jbank, tbank = run["jbank"], run["tbank"]
    idx = np.array([3, 0, 7, 7, 1], np.int32)
    want = np_tree(jax.vmap(lambda i: jtree.bank_gather(jbank, i))(idx))
    assert_same_tree(want, ttree.bank_gather(tbank, torch.from_numpy(idx).long()))
    pred = np.array([True, False, True, False, False])
    a = jax.tree.map(lambda x: x[:5], jbank)
    b = jax.tree.map(lambda x: x[3:8], jbank)
    want = np_tree(jtree.tree_select(jnp.asarray(pred), a, b))
    got = ttree.tree_select(torch.from_numpy(pred),
                            tree_map(lambda x: x[:5], tbank),
                            tree_map(lambda x: x[3:8], tbank))
    assert_same_tree(want, got)


def test_spaces(run):
    tenv = run["tenv"]
    assert tenv.observation_space()["screen"].shape == (64, 64, 3)
    chw = pt.make("coinrun", device="cpu", obs_format="chw")
    assert chw.observation_space()["screen"].shape == (3, 64, 64)
    space = tenv.action_space()["action"]
    a = space.sample(pt.random.split(pt.random.key(0), 32))
    assert a.shape == (32, 1) and int(a.min()) >= 0 and int(a.max()) < 15
    box = tenv.observation_space()["screen"].sample(pt.random.key(1))
    assert box.dtype == torch.uint8 and box.shape == (64, 64, 3)


def test_make_rejects_what_is_not_ported():
    assert "no_such_game" not in pg.GAMES
    with pytest.raises(ValueError, match="coinrun"):
        pt.make("no_such_game", device="cpu")
    with pytest.raises(ValueError):
        pt.make("coinrun", device="cpu", obs_format="nhwc")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            pt.make("coinrun", device="cuda")
        with pytest.raises(RuntimeError):  # the card is the default device
            pt.make("bossfight")
    env = pt.make("coinrun", device="cpu")
    with pytest.raises(ValueError):
        env.generate_bank(pt.random.key(0, "meta"), 2)


def test_port_imports_no_jax():
    """The port runs where jax is not installed, and uses nothing of the
    JAX package: importing it and running a step of every ported game
    (jumper's with its maze generator and atan2f; chaser's and maze's
    kind-field renders) and its window render, the exact-camera renders
    (scene_phases=0),
    `compositor.stamps_from_pixel_bank` and `scene_kernel.scene` loads
    neither jax nor flax nor the JAX package, and no module in
    sys.modules comes from a file under procgen2_tpu/ (which a load by
    file path would bypass the import blocker with)."""
    code = textwrap.dedent("""
        import pathlib
        import sys
        BLOCK = ("jax", "jaxlib", "flax", "procgen2_tpu")
        for m in [m for m in sys.modules if m.split(".")[0] in BLOCK]:
            del sys.modules[m]

        class Blocker:  # as if none of them were installed
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCK:
                    raise ImportError(f"{name} is blocked")
                return None

        sys.meta_path.insert(0, Blocker())
        import torch
        import procgen2_tpu_torch as pt
        for game in ("coinrun", "bossfight", "caveflyer", "jumper", "chaser",
                     "maze", "climber"):
            env = pt.make(game, device="cpu")
            bank = env.generate_bank(pt.random.key(0), 2)
            state, ts = env.reset(bank, pt.random.key(1), 2)
            state, ts = env.step(bank, state, torch.full((2,), 9, dtype=torch.int32))
            assert ts.obs.shape == (2, 64, 64, 3)
            assert env.render(state, 64, 1).shape == (64, 64, 3)
        for game in ("coinrun", "caveflyer", "jumper", "climber"):
            xenv = pt.make(game, device="cpu", scene_phases=0)
            xbank = xenv.generate_bank(pt.random.key(0), 2)
            _, ts = xenv.reset(xbank, pt.random.key(1), 2)
            assert ts.obs.shape == (2, 64, 64, 3)
        from procgen2_tpu_torch.games import climber
        from procgen2_tpu_torch.render import compositor, scene_kernel
        field = climber._scene_field(env.cfg, state.game)
        assert scene_kernel.scene(*field).shape == (2, 3, 64, 64)
        bank_, var, scale, r0, c0 = field[6][0]
        rgbp, a = compositor.stamps_from_pixel_bank(bank_, var, r0, c0,
                                                    alives=scale)
        assert rgbp.shape == (2, 3, 64, 64) and a.shape == (2, 1, 64, 64)
        assert not [m for m in sys.modules if m.split(".")[0] in BLOCK]
        jax_pkg = (pathlib.Path.cwd() / "procgen2_tpu").resolve()
        loaded = [name for name, m in list(sys.modules.items())
                  if getattr(m, "__file__", None)
                  and jax_pkg in pathlib.Path(m.__file__).resolve().parents]
        assert not loaded, loaded
        print("ok")
    """)
    root = str(__import__("pathlib").Path(__file__).resolve().parents[1])
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
