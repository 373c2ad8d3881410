"""The port's difference and fixture tools
(procgen2_tpu_torch/tools/difference.py) against the JAX package's.

* `compare_frames` and `signed_diff_image` equal the JAX ones on random
  frame stacks;
* a maze fixture on the reference's level of seed 7 (the BFS route to the
  goal, then 4 NOOPs across the episode boundary) recorded and replayed
  by the port: agreement 1.0 and no pixel difference, over all episodes
  and over the first (the counterpart of tests/test_png_assets.py's
  round trip);
* across the packages: a fixture recorded by the JAX package replays
  exactly in the port, and one recorded by the port in the JAX package,
  with the same arrays in the file; for maze (no kernel), and for coinrun
  on a parity-suite seed with its bot's actions, the JAX render on its
  TPU path (the Pallas kernels in interpret mode, which B1 replaces)."""
import numpy as np
import pytest

import chip_smoke
from mode_parity import tpu_kernels
from procgen2_tpu.tools import difference as jdiff
from procgen2_tpu_torch.tools import difference as tdiff
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

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
    actions = chip_smoke.maze_route_actions(seed)
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
    actions = chip_smoke.coinrun_bot_actions(seed)
    return actions, len(actions) - 3


def test_coinrun_fixture_across_packages(tmp_path, one_torch_thread):
    """A coinrun run through B1's plain version on the port and the JAX
    scene kernel (interpret mode): both packages' fixtures hold the same
    arrays and each replays exactly in the other, across the boundary."""
    actions, n_run = _coinrun_actions()
    jfx, tfx = tmp_path / "jax.npz", tmp_path / "torch.npz"
    with pytest.MonkeyPatch.context() as mp:
        tpu_kernels(mp)
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
