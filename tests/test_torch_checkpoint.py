"""The port's checkpoints (procgen2_tpu_torch/utils/checkpoint.py) in the
JAX package's file layout, on the CPU: a file saved by the port mid-run
restores in the JAX package and the reverse, and each continuation
(auto-resets included) equals the live one bit for bit; a missing
namespace, leaf, a leaf of the wrong shape or dtype, or a key where none
belongs raises. Maze easy at 4 envs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import procgen2_tpu as pg
import procgen2_tpu_torch as pt
from procgen2_tpu.utils import checkpoint as jckpt
from procgen2_tpu_torch import random as R
from procgen2_tpu_torch.utils import checkpoint
from torch_parity import np_tree, same_tree
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N, LEVELS, WARM, CONT = 4, 8, 6, 12


def _actions(n, seed):
    return np.random.default_rng(seed).integers(0, 15, size=(n, N))


def _roll_jax(env, bank, state, acts):
    out = []
    for a in acts:
        state, ts = env.step(bank, state, jnp.asarray(a, jnp.int32))
        out.append((np.asarray(ts.obs), np.asarray(ts.reward),
                    np.asarray(ts.terminated)))
    return state, out


def _roll_torch(env, bank, state, acts):
    out = []
    for a in acts:
        state, ts = env.step(bank, state, torch.from_numpy(a.astype(np.int32)))
        out.append((ts.obs.numpy(), ts.reward.numpy(), ts.terminated.numpy()))
    return state, out


def _same_runs(a, b):
    for (oa, ra, ta), (ob, rb, tb) in zip(a, b, strict=True):
        np.testing.assert_array_equal(oa, ob)
        np.testing.assert_array_equal(ra.view(np.int32), rb.view(np.int32))
        np.testing.assert_array_equal(ta, tb)


@pytest.fixture(scope="module")
def mid():
    """Both packages after WARM steps from the same keys and actions."""
    jenv = pg.make("maze", mode="easy", timeout=8)
    jbank = jenv.generate_bank(jax.random.key(0), num_levels=LEVELS)
    jstate, _ = jenv.reset(jbank, jax.random.key(1), num_envs=N)
    tenv = pt.make("maze", mode="easy", timeout=8, device="cpu")
    tbank = tenv.generate_bank(R.key(0), LEVELS)
    tstate, _ = tenv.reset(tbank, R.key(1), N)
    acts = _actions(WARM, 3)
    jstate, _ = _roll_jax(jenv, jbank, jstate, acts)
    tstate, _ = _roll_torch(tenv, tbank, tstate, acts)
    same_tree(np_tree(jstate), tstate)
    return jenv, jbank, jstate, tenv, tbank, tstate


def test_port_checkpoint_restores_in_jax(mid, tmp_path):
    jenv, jbank, jstate, tenv, tbank, tstate = mid
    path = str(tmp_path / "port.npz")
    checkpoint.save(path, state=tstate, bank=tbank)
    acts = _actions(CONT, 11)
    _, live = _roll_jax(jenv, jbank, jstate, acts)
    res = jckpt.restore(path, state=jstate, bank=jbank)
    _, resumed = _roll_jax(jenv, res["bank"], res["state"], acts)
    _same_runs(live, resumed)
    assert any(t.any() for _, _, t in live)  # auto-resets after the restore
    _, port_live = _roll_torch(tenv, tbank, tstate, acts)
    _same_runs(live, port_live)


def test_jax_checkpoint_restores_in_port(mid, tmp_path):
    jenv, jbank, jstate, tenv, tbank, tstate = mid
    path = str(tmp_path / "jax.npz")
    jckpt.save(path, state=jstate, bank=jbank)
    res = checkpoint.restore(path, state=tstate, bank=tbank)
    same_tree(np_tree(jstate), res["state"])
    same_tree(np_tree(jbank), res["bank"])
    acts = _actions(CONT, 12)
    _, live = _roll_torch(tenv, tbank, tstate, acts)
    _, resumed = _roll_torch(tenv, res["bank"], res["state"], acts)
    _same_runs(live, resumed)


def test_port_round_trip_and_layout(mid, tmp_path):
    *_, tstate = mid
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, state=tstate)
    with np.load(path) as data:
        names = set(data.files)
    assert "__prngkey__:threefry2x32:state/rng" in names
    assert "__prngkey__:threefry2x32:state/game/rng" in names
    assert "state/game/level/grid" in names and "state/rng" not in names
    back = checkpoint.restore(path, state=tstate)["state"]
    pt.utils.tree_map(lambda a, b: None if torch.equal(a, b) and
                      a.dtype == b.dtype else pytest.fail("leaf differs"),
                      tstate, back)


def test_restore_raises_on_what_does_not_fit(mid, tmp_path):
    *_, tbank, tstate = mid
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, state=tstate)
    with pytest.raises(KeyError, match="bank"):
        checkpoint.restore(path, bank=tbank)
    with pytest.raises(ValueError, match="shape|int64|float"):
        checkpoint.restore(path, state=dataclasses.replace(
            tstate, ep_return=tstate.ep_return[:2]))
    with pytest.raises(ValueError):
        checkpoint.restore(path, state=dataclasses.replace(
            tstate, ep_length=tstate.ep_length.long()))
    with pytest.raises(KeyError, match="level/nope"):
        checkpoint.restore(path, state=dataclasses.replace(
            tstate, game=dataclasses.replace(
                tstate.game, level={"grid": tstate.game.level.grid,
                                    "nope": tstate.game.level.grid})))
