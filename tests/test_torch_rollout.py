"""The port's rollout (procgen2_tpu_torch/dist/rollout.py) against the
JAX package's `rollout` on the CPU, given the same env, bank, state and
key: every buffer field and the final state, bitwise; with the default
uniform actions and with a policy, past an auto-reset of every env
(timeout 4); and the rollout against stepping the same keys by hand (the JAX package's
`test_dist.py::test_rollout_rewards_consistent`). Maze easy at 8 envs:
its JAX compile is the cheapest of the seven games."""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import pytest
import torch

import procgen2_tpu as pg
import procgen2_tpu_torch as pt
from procgen2_tpu.dist import rollout as jrollout
from procgen2_tpu_torch import random as R
from procgen2_tpu_torch.dist import RolloutBuffer, rollout
from torch_parity import np_tree, same, same_tree
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NUM_LEVELS, N, T = 8, 8, 6
FIELDS = ("obs", "actions", "rewards", "dones", "ep_returns", "ep_lengths")


@pytest.fixture(scope="module")
def envs():
    jenv = pg.make("maze", mode="easy", timeout=4)
    jbank = jenv.generate_bank(jax.random.key(0), num_levels=NUM_LEVELS)
    jstate, _ = jenv.reset(jbank, jax.random.key(1), num_envs=N)
    tenv = pt.make("maze", mode="easy", timeout=4, device="cpu")
    tbank = tenv.generate_bank(R.key(0), NUM_LEVELS)
    tstate, _ = tenv.reset(tbank, R.key(1), N)
    return (SimpleNamespace(env=jenv, bank=jbank), jstate,
            SimpleNamespace(env=tenv, bank=tbank), tstate)


def _policy_jax(bias, k):
    return (bias + jax.random.randint(k, (N,), 0, 3)) % 15


def _policy_torch(bias, k):
    return (bias + R.randint(k, (N,), 0, 3)) % 15


@pytest.fixture(scope="module", params=["uniform", "policy"])
def runs(request, envs):
    jns, jstate, tns, tstate = envs
    if request.param == "uniform":
        jargs, targs = {}, {}
    else:
        bias = torch.arange(N, dtype=torch.int32) * 2
        jargs = dict(policy=_policy_jax, policy_state=jnp.asarray(bias.numpy()))
        targs = dict(policy=_policy_torch, policy_state=bias)
    jfinal, jbuf = jrollout(jns, jstate, jax.random.key(5), T, **jargs)
    tfinal, tbuf = rollout(tns, tstate, R.key(5), T, **targs)
    return np_tree(jfinal), np_tree(jbuf), tfinal, tbuf


@pytest.mark.parametrize("field", FIELDS)
def test_rollout_buffer_matches_jax(runs, field):
    _, jbuf, _, tbuf = runs
    same(getattr(jbuf, field), getattr(tbuf, field))


def test_rollout_final_state_matches_jax(runs):
    jfinal, jbuf, tfinal, _ = runs
    same_tree(jfinal, tfinal)
    # timeout = 4 < T: every env ends and restarts on the way (maze's
    # timeout counts as terminated), so the final state covers auto-reset
    assert jbuf.dones[3].all()


def test_rollout_equals_stepping_by_hand(envs):
    """`rollout` is `key, k_act = split(key)`, `randint(k_act, (N,), 0,
    15)`, `Environment.step`, T times (test_dist.py's consistency check,
    here bitwise and on every field)."""
    _, _, tns, state = envs
    key = R.key(11)
    final, buf = rollout(tns, state, key, T)
    assert isinstance(buf, RolloutBuffer)
    assert buf.obs.shape == (T, N, 64, 64, 3) and buf.obs.dtype == torch.uint8
    for t in range(T):
        key, k_act = R.split(key).unbind(-2)
        a = R.randint(k_act, (N,), 0, 15)
        state, ts = tns.env.step(tns.bank, state, a)
        for got, want in ((buf.actions[t], a), (buf.obs[t], ts.obs),
                          (buf.rewards[t], ts.reward),
                          (buf.dones[t], ts.terminated),
                          (buf.ep_returns[t],
                           ts.info["returned_episode_return"]),
                          (buf.ep_lengths[t],
                           ts.info["returned_episode_length"])):
            assert torch.equal(got, want), t
    pt.utils.tree_map(lambda a, b: None if torch.equal(a, b) else
                      pytest.fail("final state differs"), final, state)
