"""The slice as a whole against the JAX package: each game on a bank of
the reference's own levels (8 seeds of its parity suite), the port's
bots and the JAX package's each acting on their own engine's states (or
the scripted plans of chaser and maze), 32 `Environment.step`s from the
same pinned key. Every step's actions, state, reward, termination,
truncation, info and `observe_batch` frame must be equal, bitwise. The
JAX render runs on its TPU path, its kernels (B1 `scene_tpu_raw`, B3
`composite_tpu`) in interpret mode, as tests/mode_parity.py runs it."""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import procgen2_tpu as pg
import procgen2_tpu_torch as pt
from mode_parity import tpu_kernels
from procgen2_tpu.tools import bots as jbots
from procgen2_tpu.tools import reference_levels as JRL
from procgen2_tpu_torch.tools import reference_levels as RL
from procgen2_tpu_torch.tools import reference_play as play
from render_parity import np_tree
from torch_parity import same, same_tree
from torch_threads import one_torch_thread  # noqa: F401


pytestmark = [
    pytest.mark.skipif(
        shutil.which("g++") is None, reason="no C++ toolchain (the oracle)"
    ),
    pytest.mark.usefixtures("one_torch_thread"),
]

STEPS = 32
# game -> (config, the first 8 seeds of its parity test's list)
CASES = {
    "coinrun": ({}, [0, 1, 2, 5, 7, 9, 11, 12]),
    "bossfight": ({"mode": "easy"}, [0, 1, 2, 4, 5, 6, 8, 9]),
    "climber": ({"easy_mode": True}, [0, 5, 7, 9, 11, 12, 13, 17]),
    "caveflyer": ({"mode": "hard"}, [7, 9, 20, 27, 35, 36, 39, 51]),
    "jumper": ({"mode": "easy"}, [0, 6, 8, 9, 11, 12, 14, 15]),
    "chaser": ({"mode": "easy"}, [5, 17, 20, 21, 28, 34, 35, 36]),
    "maze": ({"mode": "easy"}, [0, 1, 2, 3, 4, 5, 6, 7]),
}
PLANS = {"maze": play.maze_plan, "chaser": play.chaser_plan}


def _layout_kw(game, cfg):
    return {} if game == "bossfight" else cfg  # layouts ignore its mode


@pytest.mark.parametrize("game", list(CASES))
def test_reference_slice_matches_jax(game):
    cfg, seeds = CASES[game]
    n = len(seeds)
    jbank_np = JRL.reference_bank(game, seeds, **_layout_kw(game, cfg))
    tbank = RL.reference_bank(game, seeds, "cpu", **_layout_kw(game, cfg))
    levels = [RL.host_level(tbank, i) for i in range(n)]
    with pytest.MonkeyPatch.context() as mp:
        tpu_kernels(mp)
        jenv = pg.make(game, **cfg)
        tenv = pt.make(game, device="cpu", **cfg)
        jbank = jax.tree.map(jnp.asarray, jbank_np)
        jst = jenv.reset_pinned(jbank, jax.random.key(play.PIN_KEY),
                                jnp.asarray(seeds, jnp.uint32))
        tst = play.pinned(tenv, tbank, seeds)
        same_tree(np_tree(jst), tst)
        if game in PLANS:
            plan = play.pad([PLANS[game](lvl) for lvl in levels], STEPS)
        else:
            tbot = play.make_bots(game, levels)
            jbot = [getattr(jbots, type(b).__name__)(lvl)
                    for b, lvl in zip(tbot, levels)]
            fields = play.BOTS[game][1]
        done = np.zeros(n, bool)
        for t in range(STEPS):
            if game in PLANS:
                a = plan[t]
            else:
                a = play.bot_actions(tbot, play.read(tst.game, fields, n),
                                     done)
                ja = play.bot_actions(
                    jbot, [np.asarray(getattr(jst.game, f)) for f in fields],
                    done)
                np.testing.assert_array_equal(a, ja, err_msg=f"step {t}")
            jst, jts = jenv.step(jbank, jst, jnp.asarray(a))
            tst, tts = tenv.step(tbank, tst, torch.from_numpy(a))
            same_tree(np_tree(jst), tst)
            np.testing.assert_array_equal(np.asarray(jts.obs),
                                          tts.obs.numpy(), err_msg=f"step {t}")
            for k in ("reward", "terminated", "truncated"):
                same(getattr(jts, k), getattr(tts, k))
            assert set(jts.info) == set(tts.info)
            for k in jts.info:
                same(jts.info[k], tts.info[k])
            done |= tts.terminated.numpy()
