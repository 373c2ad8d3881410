"""The port's bossfight in mode="easy" (common_systems.cpp:104, 202: half
the boss bullets' speed and a shorter shield jitter) against the JAX
package's, held like the default mode (tests/test_torch_bossfight.py):
a 64-level easy bank, T_EASY steps from the default mode's start lanes,
and the renders after the last step."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax_reference as JR
from bossfight_parity import (LEVEL_FIELDS, STATE_FIELDS, actions, np_tree,
                              same, start_state, to_jax)
from procgen2_tpu_torch import random as R
from procgen2_tpu_torch.games import bossfight as tb
from procgen2_tpu_torch.utils import convert
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

EASY = (("mode", "easy"),)
EASY_T = tb.Config(mode="easy")
T_EASY = 8


@pytest.fixture(scope="module")
def easy_run():
    """A 64-level easy bank from both sides, and T_EASY steps of N envs
    each side from its own state (reset from the bank's first N levels,
    the default mode's start lanes), with their observe_batch inputs."""
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(9), i))(
        jnp.arange(64, dtype=jnp.uint32))
    jl = np_tree(JR.vmapped("bossfight", "generate", EASY)(keys))
    tl = tb.generate(EASY_T, R.fold_in(R.key(9), torch.arange(64)))
    jstep = JR.vmapped("bossfight", "step", EASY)
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


def test_easy_observe_matches_jax(easy_run):
    """observe_batch (the TPU's stamp semantics) and the single-env
    observe after the last step."""
    _, _, steps, jst = easy_run
    want = np.asarray(JR.observe_batch("bossfight", EASY)(jst))
    got = tb.observe_batch(EASY_T, steps[-1][3])
    np.testing.assert_array_equal(want, got.numpy())
    want = JR.observe_each("bossfight", EASY, jst)
    np.testing.assert_array_equal(want, tb.observe(EASY_T,
                                                   steps[-1][3]).numpy())

