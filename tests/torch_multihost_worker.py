"""Worker of tests/test_torch_multihost.py: one of 2 processes of the
port's data-parallel env over gloo on the CPU (the counterpart of
tests/multihost_worker.py). It joins the group with `init_multihost`,
checks that a batch that does not divide over the group raises, resets
its 4 of 8 maze-easy envs with `make_vec`, steps them 3 times under its
rows of the global actions, all-reduces `metrics`, checks `local_slice`,
and writes its rows to OUT_DIR/rank<pid>.npz. It imports no jax.

Run (by the test, or by hand):
    python tests/torch_multihost_worker.py <process_id> <port> <out_dir>
"""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from procgen2_tpu_torch import make  # noqa: E402
from procgen2_tpu_torch import random as R  # noqa: E402
from procgen2_tpu_torch.dist import (ShardedEnv, init_multihost,  # noqa: E402
                                     local_slice, make_vec)
from procgen2_tpu_torch.utils import tree_leaves  # noqa: E402

NUM_ENVS, LEVELS, STEPS = 8, 4, 3


def rows(ts, state):
    """The numpy arrays a rank writes: obs, reward, terminated and the
    state's leaves."""
    out = dict(obs=ts.obs.numpy(), reward=ts.reward.numpy(),
               terminated=ts.terminated.numpy())
    out.update({f"state{i}": x.numpy()
                for i, x in enumerate(tree_leaves(state))})
    return out


def run(venv):
    """Reset from key(0), then STEPS steps under this rank's rows of the
    global actions randint(key(1), (NUM_ENVS,)): (state, last TimeStep)."""
    state, ts = venv.reset(R.key(0))
    actions = R.randint(R.key(1), (NUM_ENVS,), 0, 15)[venv.lo:venv.hi]
    for _ in range(STEPS):
        state, ts = venv.step(state, actions)
    return state, ts


def main(pid, port, out_dir):
    init_multihost(f"localhost:{port}", num_processes=2, process_id=pid,
                   device="cpu")
    try:
        ShardedEnv(make("maze", device="cpu"), 7, LEVELS)
    except ValueError:
        pass
    else:
        raise AssertionError("7 envs over 2 processes did not raise")
    venv = make_vec("maze", NUM_ENVS, num_levels=LEVELS, device="cpu",
                    mode="easy")
    assert (venv.world, venv.rank) == (2, pid)
    state, ts = run(venv)
    m = venv.metrics(ts)
    r, start = local_slice(ts.reward, venv)
    assert r.shape == (NUM_ENVS // 2,) and start == pid * NUM_ENVS // 2
    assert local_slice(ts.obs)[1] == start
    np.savez(os.path.join(out_dir, f"rank{pid}.npz"), **rows(ts, state))
    vals = " ".join(f"{k}={v.item()!r}" for k, v in sorted(m.items()))
    print(f"MHOK pid={pid} rows={r.shape[0]} start={start} {vals}",
          flush=True)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), sys.argv[2], sys.argv[3])
