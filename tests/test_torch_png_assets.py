"""The port's PNG overlay (procgen2_tpu_torch/render/png_assets.py, the
background hook of render/atlas.py and jumper's compass) against the JAX
package's.

* install/uninstall on a three-file fake tree, and every mapped name
  registered (the counterparts of tests/test_png_assets.py's);
* `load_png` equal to the JAX one on synthetic PNGs (square, non-square
  with and without `square_crop`, palette, grey + alpha);
* a full synthetic tree: every `default_mapping` path and every
  `BACKGROUND_PATHS` file as seeded random RGBA with fractional alpha,
  fully clear texels and non-square backgrounds, installed into both
  packages: each game's bank, reset and 2 steps render the same frames
  in both, bitwise, the JAX render on its TPU path (the Pallas kernels in
  interpret mode, as B1 and B3 replace them); jumper's compass is the
  decoded PNG (`source_path`);
* `uninstall`, then a new env of the port renders the procedural frames
  again, bitwise (no cache built from the overlay survives);
* the real assets' golden frames, where the reference's assets tree is
  present (skipped otherwise, as the JAX test is);
* the difference and fixture tools (tools/difference.py), below, whose
  round trip the JAX package's tests/test_png_assets.py holds too."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import game_lanes
import jax_reference as JR
import overlay_assets
import procgen2_tpu as pg
import procgen2_tpu_torch as pt
from jax_reference import tpu_kernels
from procgen2_tpu.render import png_assets as jpng
from procgen2_tpu.tools import difference as jdiff
from procgen2_tpu.tools.reference_levels import reference_bank as jref_bank
from procgen2_tpu_torch.games import jumper as tjumper
from procgen2_tpu_torch.render import atlas as tatlas
from procgen2_tpu_torch.render import png_assets as tpng
from procgen2_tpu_torch.tools import difference as tdiff
from procgen2_tpu_torch.tools.reference_levels import reference_bank
from test_png_assets import REAL_ASSETS, _has_real_assets
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N, NUM_LEVELS, STEPS = 4, 8, 2
GAMES = ("bossfight", "caveflyer", "chaser", "climber", "coinrun", "jumper",
         "maze")
CFG = {"maze": dict(mode="easy")}


@pytest.fixture
def fake_assets(tmp_path):
    """A tiny fake reference assets/ tree with three mapped PNGs."""
    paths = {
        "misc_assets/cheese.png": (255, 0, 255, 255),
        "kenney/Items/coinGold.png": (0, 255, 255, 255),
        "topdown_backgrounds/floortiles.png": (10, 200, 30, 255),
    }
    for rel, color in paths.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        Image.new("RGBA", (96, 96), color).save(p)
    return str(tmp_path)


def test_overlay_install_uninstall(fake_assets):
    try:
        installed = tpng.install(fake_assets)
        assert "cheese" in installed and "coin" in installed
        assert "backgrounds:topdown" in installed
        assert tpng.installed() == installed
        # atlas rebuild picks up the override
        imgs, index = tatlas.build_atlas(("cheese", "coin", "maze_wall"))
        assert (imgs[index["cheese"]][..., :3] == [255, 0, 255]).all()
        assert (imgs[index["coin"]][..., :3] == [0, 255, 255]).all()
        # unmapped-or-missing sprite keeps procedural art (not solid color)
        assert len(np.unique(imgs[index["maze_wall"]][..., 0])) > 1
        # background overlay tiles modulo the supplied file count
        bgs = tatlas.build_backgrounds("topdown", 9)
        assert bgs.shape == (9, tatlas.BG_SIZE, tatlas.BG_SIZE, 3)
        assert (bgs[0] == [10, 200, 30]).all() and (bgs[8] == [10, 200, 30]).all()
    finally:
        tpng.uninstall()
    imgs2, index2 = tatlas.build_atlas(("cheese",))
    assert not (imgs2[index2["cheese"]][..., :3] == [255, 0, 255]).all()
    assert "topdown" not in tatlas._BG_OVERLAY and tpng.installed() == []


def test_default_mapping_names_are_registered():
    """Every mapping key is a sprite of the port's registry, and the
    mapping and background lists are the JAX package's."""
    unknown = [n for n in tpng.default_mapping() if n not in tatlas._REGISTRY]
    assert unknown == []
    assert tpng.default_mapping() == jpng.default_mapping()
    assert {k: list(v) for k, v in tpng.BACKGROUND_PATHS.items()} == {
        k: list(v) for k, v in jpng.BACKGROUND_PATHS.items()}


def _png(path, kind, rng, size):
    img = overlay_assets.random_rgba(rng, *size)
    if kind == "palette":
        im = Image.fromarray(img[..., :3]).convert(
            "P", palette=Image.Palette.ADAPTIVE, colors=17)
    elif kind == "grey_alpha":
        im = Image.fromarray(img[..., ::2], "LA")
    else:
        im = Image.fromarray(img, "RGBA")
    im.save(path)


@pytest.mark.parametrize("kind,size,crop,out", [
    ("rgba", (40, 40), False, 32), ("rgba", (60, 90), True, 64),
    ("rgba", (60, 90), False, 32), ("rgba", (77, 31), True, 32),
    ("palette", (50, 70), True, 64), ("grey_alpha", (45, 45), False, 32),
    ("grey_alpha", (33, 66), True, 60)])
def test_load_png_matches_jax(tmp_path, kind, size, crop, out):
    rng = np.random.default_rng(sum(size) + out)
    path = str(tmp_path / "img.png")
    _png(path, kind, rng, size)
    want = jpng.load_png(path, size=out, square_crop=crop)
    got = tpng.load_png(path, size=out, square_crop=crop)
    assert got.dtype == np.float32 and got.shape == (out, out, 4)
    np.testing.assert_array_equal(want, got)


@pytest.fixture(scope="module")
def synthetic_tree(tmp_path_factory):
    """The synthetic tree chip_smoke.py installs on the card
    (overlay_assets): every mapped
    sprite and background file as seeded random RGBA."""
    root = tmp_path_factory.mktemp("assets")
    overlay_assets.synthetic_assets(str(root))
    return str(root)


@pytest.fixture
def overlay(synthetic_tree):
    """The synthetic tree installed into both packages for one test."""
    try:
        jnames = jpng.install(synthetic_tree, strict=True)
        tnames = tpng.install(synthetic_tree, strict=True)
        assert jnames == tnames and len(tnames) == len(
            tpng.default_mapping()) + len(tpng.BACKGROUND_PATHS)
        yield
    finally:
        jpng.uninstall()
        tpng.uninstall()


def _port_frames(name):
    """The port's bank of NUM_LEVELS, reset of N envs and STEPS steps under
    seeded actions, on the CPU: (bank, [obs u8 [N, 64, 64, 3]])."""
    env = pt.make(name, device="cpu", **CFG.get(name, {}))
    bank = env.generate_bank(pt.random.key(7), NUM_LEVELS)
    state, ts = env.reset(bank, pt.random.key(8), N)
    frames = [ts.obs]
    for a in _actions():
        state, ts = env.step(bank, state, torch.from_numpy(a))
        frames.append(ts.obs)
    return bank, frames


def _actions():
    return np.random.default_rng(5).integers(0, 15, (STEPS, N)).astype(
        np.int32)


@pytest.mark.parametrize("name", GAMES)
def test_overlay_frames_match_jax(overlay, name):
    """Bank, reset and STEPS steps of both packages under the synthetic
    overlay: every frame equal, bitwise; the overlay took (the frames
    are not the procedural ones)."""
    # a JAX env of its own: its traces take the overlay's art; the bank,
    # which no art reaches, is the shared one
    jbank = JR.bank(name, tuple(CFG.get(name, {}).items()), seed=7,
                    n=NUM_LEVELS)
    with tpu_kernels():
        jenv = pg.make(name, **CFG.get(name, {}))
        jst, jts = jenv.reset(jbank, jax.random.key(8), num_envs=N)
        want = [np.asarray(jts.obs)]
        for a in _actions():
            jst, jts = jenv.step(jbank, jst, jnp.asarray(a))
            want.append(np.asarray(jts.obs))
    _, got = _port_frames(name)
    for t, (w, g) in enumerate(zip(want, got)):
        assert g.dtype == torch.uint8, t
        np.testing.assert_array_equal(w, g.numpy(), err_msg=f"frame {t}")
    if name == "jumper":
        assert tpng.source_path("compass_circle") is not None
        a = tjumper._compass_overlay(64)[1]
        assert ((a > 0) & (a < 1)).any()  # the PNG's fractional alpha
    tpng.uninstall()
    _, plain = _port_frames(name)
    assert not torch.equal(torch.stack(got), torch.stack(plain))


@pytest.mark.parametrize("name", GAMES)
def test_uninstall_restores_procedural_frames(synthetic_tree, name):
    """Procedural frames, then the overlay installed and rendered, then
    `uninstall`: a new env renders the procedural frames again, bitwise,
    from the same bank (no cache built from the overlay survives)."""
    bank0, plain = _port_frames(name)
    try:
        tpng.install(synthetic_tree, strict=True)
        bank1, over = _port_frames(name)
    finally:
        tpng.uninstall()
    bank2, again = _port_frames(name)
    assert not torch.equal(torch.stack(over), torch.stack(plain))
    for a, b in zip(plain, again):
        assert torch.equal(a, b)
    for f in dataclasses.fields(bank0):  # levels do not depend on the art
        assert torch.equal(getattr(bank0, f.name), getattr(bank1, f.name))
        assert torch.equal(getattr(bank0, f.name), getattr(bank2, f.name))


@pytest.mark.skipif(not _has_real_assets, reason="reference assets absent")
def test_real_overlay_golden_frames():
    """The real assets tree strict-installed into both packages: each
    game's reset frame on the oracle-pinned reference level of seed 0
    (the goldens' recipe, tests/golden/README.md) equals the JAX
    package's frame on its TPU path, and the committed golden wherever
    the JAX package's CPU render (with which the goldens were made)
    equals its TPU path."""
    golden_path = os.path.join(os.path.dirname(__file__), "golden",
                               "overlay_frames.npz")
    kw_by_game = {"climber": dict(easy_mode=True), "maze": dict(mode="easy")}
    try:
        assert len(tpng.install(REAL_ASSETS, strict=True)) >= 130
        jpng.install(REAL_ASSETS, strict=True)
        with np.load(golden_path) as gold:
            for game in pt.GAMES:
                kw = kw_by_game.get(game, {})
                env = pt.make(game, device="cpu", **kw)
                bank = reference_bank(game, [0], "cpu", **kw)
                _, ts = env.reset(bank, pt.random.fold_in(pt.random.key(0), 0),
                                  1)
                got = ts.obs[0].numpy()
                jbank = jax.tree.map(jnp.asarray, jref_bank(game, [0], **kw))
                jkey = jax.random.fold_in(jax.random.key(0), 0)
                cpu = np.asarray(pg.make(game, **kw).reset(
                    jbank, jkey, num_envs=1)[1].obs[0])
                with tpu_kernels():
                    tpu = np.asarray(pg.make(game, **kw).reset(
                        jbank, jkey, num_envs=1)[1].obs[0])
                np.testing.assert_array_equal(tpu, got, err_msg=game)
                if np.array_equal(cpu, tpu):
                    np.testing.assert_array_equal(gold[game], got,
                                                  err_msg=game)
    finally:
        tpng.uninstall()
        jpng.uninstall()


# ===========================================================================
# The port's difference and fixture tools
# (procgen2_tpu_torch/tools/difference.py) against the JAX package's.
#
# * `compare_frames` and `signed_diff_image` equal the JAX ones on random
#   frame stacks;
# * a maze fixture on the reference's level of seed 7 (the BFS route to the
#   goal, then 4 NOOPs across the episode boundary) recorded and replayed
#   by the port: agreement 1.0 and no pixel difference, over all episodes
#   and over the first (the counterpart of tests/test_png_assets.py's
#   round trip);
# * across the packages: a fixture recorded by the JAX package replays
#   exactly in the port, and one recorded by the port in the JAX package,
#   with the same arrays in the file; for maze (no kernel), and for coinrun
#   on a parity-suite seed with its bot's actions, the JAX render on its
#   TPU path (the Pallas kernels in interpret mode, which B1 replaces).
# ===========================================================================

FIXTURE_KEYS = {"game": "<U", "seed": "<i8", "actions": "<i4",
                "frames": "|u1", "rewards": "<f4", "terminated": "|b1"}


def test_compare_frames_and_signed_diff_match_jax():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, (5, 64, 64, 3)).astype(np.uint8)
    b = np.where(rng.random(a.shape) < 0.7, a,
                 rng.integers(0, 256, a.shape)).astype(np.uint8)
    for x, y in ((a, b), (b, a), (a, a)):
        want, got = jdiff.compare_frames(x, y), tdiff.compare_frames(x, y)
        assert (want.frames, want.mean_abs_diff, want.max_abs_diff,
                want.fraction_within_8) == (
            got.frames, got.mean_abs_diff, got.max_abs_diff,
            got.fraction_within_8)
        np.testing.assert_array_equal(want.per_frame_mean, got.per_frame_mean)
        assert str(want) == str(got)
        np.testing.assert_array_equal(jdiff.signed_diff_image(x, y),
                                      tdiff.signed_diff_image(x, y))
    with pytest.raises(ValueError):
        tdiff.compare_frames(a, b[:2])
    d = tdiff.signed_diff_image(np.full((2, 2, 3), 200, np.uint8),
                                np.full((2, 2, 3), 100, np.uint8))
    assert (d > 127).all()


def _maze_actions(seed=7):
    """The BFS route to the goal of the reference's maze level `seed`
    (easy), then 4 NOOPs into episode 2; and the route's length."""
    actions = game_lanes.maze_route_actions(seed)
    return actions, len(actions) - 4


def _exact(rep, n):
    assert rep["steps_compared"] == n
    assert rep["reward_agreement"] == 1.0
    assert rep["termination_agreement"] == 1.0
    assert rep["pixel"].mean_abs_diff == 0.0
    assert rep["pixel"].fraction_within_8 == 1.0


def _same_fixture(a, b):
    with np.load(a) as x, np.load(b) as y:
        assert sorted(x.files) == sorted(y.files) == sorted(FIXTURE_KEYS)
        for k, dt in FIXTURE_KEYS.items():
            assert x[k].dtype.str.startswith(dt), (k, x[k].dtype)
            assert x[k].dtype == y[k].dtype, k
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def test_fixture_roundtrip_with_terminating_episode(tmp_path):
    """record -> replay -> compare on the port itself, across an episode
    boundary: the route ends on the goal (+10, terminal frame recorded),
    then the NOOPs step episode 2."""
    actions, n_path = _maze_actions()
    fx = tmp_path / "maze_fixture.npz"
    tdiff.record_engine_fixture("maze", str(fx), actions, seed=7,
                                device="cpu", mode="easy")
    with np.load(fx) as data:
        assert data["rewards"][n_path - 1] == 10.0
        assert bool(data["terminated"][n_path - 1])
        assert not data["terminated"][n_path:].any()
    _exact(tdiff.run_fixture_diff(str(fx), episodes="all", device="cpu",
                                  mode="easy"), len(actions))
    # the default stops at the fixture's first episode boundary
    _exact(tdiff.run_fixture_diff(str(fx), device="cpu", mode="easy"),
           n_path)


def test_maze_fixture_across_packages(tmp_path):
    actions, n_path = _maze_actions()
    jfx, tfx = tmp_path / "jax.npz", tmp_path / "torch.npz"
    jdiff.record_engine_fixture("maze", str(jfx), actions, seed=7,
                                mode="easy")
    tdiff.record_engine_fixture("maze", str(tfx), actions, seed=7,
                                device="cpu", mode="easy")
    _same_fixture(jfx, tfx)
    for ep, n in (("all", len(actions)), ("first", n_path)):
        _exact(tdiff.run_fixture_diff(str(jfx), episodes=ep, device="cpu",
                                      mode="easy"), n)
        _exact(jdiff.run_fixture_diff(str(tfx), episodes=ep, mode="easy"), n)


COINRUN_SEED = 0  # of the scripted parity suite's COINRUN_SEEDS


def _coinrun_actions(seed=COINRUN_SEED):
    """The coinrun bot's closed-loop run to the coin on the reference's
    level `seed`, started as the fixture replay starts it (reset key
    fold_in(key(seed), 0)), then 3 NOOPs into episode 2; and the run's
    length."""
    actions = game_lanes.coinrun_bot_actions(seed)
    return actions, len(actions) - 3


def test_coinrun_fixture_across_packages(tmp_path):
    """A coinrun run through B1's plain version on the port and the JAX
    scene kernel (interpret mode): both packages' fixtures hold the same
    arrays and each replays exactly in the other, across the boundary."""
    actions, n_run = _coinrun_actions()
    jfx, tfx = tmp_path / "jax.npz", tmp_path / "torch.npz"
    with tpu_kernels():
        jdiff.record_engine_fixture("coinrun", str(jfx), actions,
                                    seed=COINRUN_SEED)
        tdiff.record_engine_fixture("coinrun", str(tfx), actions,
                                    seed=COINRUN_SEED, device="cpu")
        _same_fixture(jfx, tfx)
        with np.load(tfx) as data:
            assert data["rewards"][n_run - 1] == 10.0
            assert data["terminated"].sum() == 1
        _exact(tdiff.run_fixture_diff(str(jfx), episodes="all",
                                      device="cpu"), len(actions))
        _exact(jdiff.run_fixture_diff(str(tfx), episodes="all"),
               len(actions))
