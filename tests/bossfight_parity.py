"""What the bossfight tests share (tests/test_torch_bossfight.py and
test_torch_bossfight_easy.py): the batch, the fields compared, the
conversions to the JAX side, the bitwise comparison, the start lanes and
the actions."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from jax_reference import np_tree  # noqa: F401 (the JAX side as numpy)
from procgen2_tpu.games import bossfight as jb
from procgen2_tpu_torch.games import bossfight as tb

N = 8
LEVEL_FIELDS = [f.name for f in dataclasses.fields(tb.Level)]
STATE_FIELDS = [f.name for f in dataclasses.fields(tb.State)
                if f.name != "level"]


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
