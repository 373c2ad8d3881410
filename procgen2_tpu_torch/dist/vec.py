"""Data-parallel vectorized environments (procgen2_tpu/dist/vec.py), in
PyTorch's idiom: one process per device, the processes joined by
`torch.distributed`.

The JAX package shards one global batch over a device mesh and lets XLA
insert the collectives. Here each of the W processes of a process group
(rank r) owns the rows [r*N/W, (r+1)*N/W) of the global batch of N envs
on its own device, and steps them with a plain `Environment`. The level
bank is replicated without communication: every rank generates it from
the same key, and generation is deterministic. A reset takes each rank's
rows of the one global key split, so the ranks' rows together are the
single-process reset bit for bit, and the auto-resets draw from each
env's own key. Only the scalar metrics cross between processes, in one
all-reduce.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from .. import random as prng
from ..core.env import Environment, TimeStep
from ..utils import trace


def _group_shape(group=None):
    """(world size, rank) of `group`, or (1, 0) when no process group is
    initialised."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(group), dist.get_rank(group)
    return 1, 0


def _local_cuda():
    """This process's card: LOCAL_RANK, as launchers set it, else the
    global rank over the cards of the host."""
    return torch.device("cuda", int(os.environ.get(
        "LOCAL_RANK", dist.get_rank() % torch.cuda.device_count())))


def local_slice(x, env: "ShardedEnv | None" = None):
    """The rows of a batch tensor that this process holds, as numpy, and
    their global row offset: `(rows, start)`. With `env`, its rows;
    otherwise every rank holds an equal share of the default group's
    batch, so rank r's rows start at r * len(x)."""
    rows = x.detach().cpu().numpy()
    if env is not None:
        return rows, env.lo
    return rows, _group_shape()[1] * rows.shape[0]


class ShardedEnv:
    """An Environment over this process's rows of a global batch, the bank
    replicated. The rows lie on the env's device: after `init_multihost`
    this process's card is the current one, so `make(game)` puts them
    there.

    Usage (in each of W processes, after `init_multihost`; or alone):
        env = make_vec("maze", num_envs=65536, num_levels=4096)
        state, ts = env.reset(pt.random.key(0, env.env.device))
        state, ts = env.step(state, actions)   # this rank's N/W rows
        metrics = env.metrics(ts)              # all-reduced scalars
    """

    def __init__(self, env: Environment, num_envs: int, num_levels: int,
                 start_level: int = 0, group=None):
        self.world, self.rank = _group_shape(group)
        if num_envs % self.world:
            raise ValueError(f"num_envs={num_envs} must divide over "
                             f"{self.world} processes")
        self.env = env
        self.num_envs = num_envs
        self.num_levels = num_levels
        self.start_level = start_level
        self.group = group
        self.lo = self.rank * num_envs // self.world
        self.hi = (self.rank + 1) * num_envs // self.world
        self._bank = None

    @property
    def bank(self):
        if self._bank is None:
            raise RuntimeError("call reset(key) first (generates the bank)")
        return self._bank

    def reset(self, key, bank_key=None):
        """Generate the replicated bank (once), then this rank's rows of
        the reset of all num_envs envs from `key`."""
        with trace.span("vec.reset"):
            if self._bank is None:
                bk = (bank_key if bank_key is not None
                      else prng.fold_in(key, 17))
                self._bank = self.env.generate_bank(
                    bk, num_levels=self.num_levels,
                    start_level=self.start_level)
            keys = prng.split(key, self.num_envs)[self.lo:self.hi]
            return self.env.reset_keys(self._bank, keys)

    def step(self, state, actions):
        """Step this rank's rows: `actions` int [N/W]."""
        return self.env.step(self.bank, state, actions)

    def metrics(self, ts: TimeStep):
        """Mean reward, episodes done and mean return of the finished
        episodes over the global batch: this rank's sums, one all-reduce
        of the f32 3-vector [sum reward, sum done, sum return * done] over
        the group, then the JAX package's three scalars. The sums add in
        another order than XLA's, so a sum of inexact f32 values may differ
        in its last bits; sums of exact values (maze's 0 and 10) do not."""
        done = ts.terminated
        ep_ret = ts.info["returned_episode_return"]
        sums = torch.stack([ts.reward.sum(), done.sum().float(),
                            (ep_ret * done).sum()])
        if self.world > 1:
            dist.all_reduce(sums, op=dist.ReduceOp.SUM, group=self.group)
        r_sum, n_done, ret_sum = sums.unbind()
        return dict(
            reward_mean=r_sum / self.num_envs,
            episodes_done=n_done.to(torch.int32),
            episode_return_mean=torch.where(
                n_done > 0, ret_sum / torch.clamp(n_done, min=1.0), 0.0))


def make_vec(game, num_envs: int, num_levels: int = 1024,
             start_level: int = 0, device="cuda", **config) -> ShardedEnv:
    """A ShardedEnv of `game` (a name in GAMES or a game module) on
    `device`, the card by default (after `init_multihost`, this process's
    card); config kwargs go to `make`.

    `num_levels`/`start_level` select a portable level set: level i is
    keyed fold_in(bank_key, start_level + i)."""
    from .. import make

    return ShardedEnv(make(game, device=device, **config), num_envs,
                      num_levels, start_level=start_level)


def init_multihost(coordinator_address: str | None = None, *,
                   num_processes: int | None = None,
                   process_id: int | None = None, device="cuda", **kwargs):
    """Join this process to a process group: `torch.distributed.
    init_process_group` with backend NCCL for the card (`device`, the
    default) or gloo for the CPU (`device="cpu"`).

    `coordinator_address` ("host:port") becomes init_method
    "tcp://host:port", `num_processes` the world size and `process_id`
    the rank; without them the launcher's environment variables
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK) serve, as
    `jax.distributed.initialize` reads its own. Other kwargs (`timeout`,
    ...) go to init_process_group. With NCCL, this process's card
    (LOCAL_RANK, else the rank over the host's cards) becomes the current
    one. Call once per process, before `make_vec`."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but torch sees no "
                               "CUDA device")
        backend = "nccl"
    else:
        backend = "gloo"
    if coordinator_address is not None:
        kwargs["init_method"] = f"tcp://{coordinator_address}"
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    dist.init_process_group(backend=backend, **kwargs)
    if backend == "nccl":
        torch.cuda.set_device(_local_cuda())


__all__ = ["ShardedEnv", "make_vec", "local_slice", "init_multihost"]
