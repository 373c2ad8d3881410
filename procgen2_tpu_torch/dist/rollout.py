"""Rollout collection: T steps of a batch of envs into a [T, N, ...]
buffer (procgen2_tpu/dist/rollout.py), the loop a learner calls.

The JAX package runs the T steps as one compiled program (`lax.scan`
under `jit`). PyTorch's counterpart is a CUDA graph: on a card, the T
steps are captured once per (env, bank, batch, T, policy) and replayed,
so one rollout is one graph launch instead of thousands of kernel
launches per step. On the CPU the steps run eagerly. Either way each
step draws `key, k_act = split(key)`, then its actions (uniform over the
action space, or `policy(policy_state, k_act)`), then runs
`Environment.step`, so the same key gives the JAX package's trajectory.

A graph reads its inputs at fixed addresses. Before each replay the
state, the key and the policy state are copied into the graph's own
tensors, and what it returns is cloned from its outputs, so no later
replay overwrites what a caller holds. The bank is read where it lies:
a graph is replayed only for a bank whose tensors are the ones it was
captured on (the same addresses, shapes, strides and dtypes).

An Environment keeps at most GRAPHS_PER_ENV graphs, the least recently
used evicted first, and all of them in one memory pool: a capture reuses
the memory that earlier captures freed, and that an evicted graph held.
Sharing is safe because the graphs replay one after another on one
stream and a replay's outputs are cloned before any other graph runs: a
graph's intermediates may lie where another graph's outputs were, but
those outputs are read only right after their own replay. A step
captured must make no host read and copy nothing from the host: the
renders then leave out their dead-sprite skips
(`compositor.host_reads_off`), and constants come from
`utils.consts.const`. If capture fails, `rollout` raises; it never falls
back to stepping eagerly on the card.

The kernel wrappers' `.launches` counters count what the host issues:
a capture adds each kernel once, and a replay adds nothing.

Under a profiler (`utils/trace.py`) the host's side runs in the spans
`rollout.graph_key` (the key and its lookup in the table),
`rollout.capture`, `rollout.copy_in`, `rollout.launch` and
`rollout.clone`, and the steps launch their layer marks. A graph is
keyed on whether a profiler records: the first call under one captures
a marked graph, once, in the env's pool, and replays it while the
profiler runs; the first call with none evicts every marked graph and
replays the plain one. A call with no profiler never builds, captures or
launches a mark.
"""
from __future__ import annotations

import collections
import dataclasses
import weakref
from typing import Any, Callable

import torch

from .. import random as prng
from ..render import compositor
from ..utils import trace
from ..utils.tree import tree_leaves, tree_map

GRAPHS_PER_ENV = 4  # captured rollouts kept per Environment


@dataclasses.dataclass
class RolloutBuffer:
    obs: torch.Tensor  # uint8 [T, N, 64, 64, 3] (or [T, N, 3, 64, 64], chw)
    actions: torch.Tensor  # i32 [T, N]
    rewards: torch.Tensor  # f32 [T, N]
    dones: torch.Tensor  # bool [T, N]
    ep_returns: torch.Tensor  # f32 [T, N] (valid where dones)
    ep_lengths: torch.Tensor  # i32 [T, N]


def _scan(inner, bank, state, key, num_steps, policy, policy_state):
    """The T steps, eagerly: (final state, RolloutBuffer)."""
    num_envs, dev = state.ep_length.shape[0], key.device
    outs = []
    for _ in range(num_steps):
        trace.mark("actions", dev)
        with trace.span("rollout.actions"):
            key, k_act = prng.split(key).unbind(-2)
            if policy is None:
                n = inner.game.action_space(inner.cfg).nvec[0]
                actions = prng.randint(k_act, (num_envs,), 0, n)
            else:
                actions = policy(policy_state, k_act)
        state, ts = inner.step(bank, state, actions)
        outs.append((ts.obs, actions, ts.reward, ts.terminated,
                     ts.info["returned_episode_return"],
                     ts.info["returned_episode_length"]))
    trace.mark("stack", dev)
    with trace.span("rollout.stack"):
        buf = RolloutBuffer(*(torch.stack(x) for x in zip(*outs)))
    trace.mark("end", dev)
    return state, buf


def _layout(tree, addresses=False):
    """What a graph fixes of a tree: each leaf's shape and dtype (inputs
    are copied into the graph's own tensors, whatever their strides) and,
    where `addresses` (inputs read where they lie), its strides and
    address too."""
    return tuple((tuple(x.shape), x.dtype)
                 + ((x.stride(), x.data_ptr()) if addresses else ())
                 if isinstance(x, torch.Tensor) else (x,)
                 for x in tree_leaves(tree))


class _Graph:
    """One captured rollout: static inputs, the graph and its outputs."""

    def __init__(self, inner, bank, state, key, num_steps, policy,
                 policy_state, pool):
        def clone(x):
            return x.clone() if isinstance(x, torch.Tensor) else x

        self.policy = policy  # held: the graph's key names it by id
        self.state = tree_map(clone, state)
        self.key = key.clone()
        self.policy_state = tree_map(clone, policy_state)
        args = (inner, bank, self.state, self.key, num_steps, policy,
                self.policy_state)
        # warm up on a side stream (first-call caches, kernel builds), with
        # the host reads that capture leaves out left out here too
        side = torch.cuda.Stream(device=key.device)
        side.wait_stream(torch.cuda.current_stream(key.device))
        with torch.cuda.stream(side), compositor.host_reads_off():
            _scan(*args)
        torch.cuda.current_stream(key.device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool), \
                compositor.host_reads_off():
            self.out = _scan(*args)

    def replay(self, state, key, policy_state):
        def copy(dst, src):
            if isinstance(dst, torch.Tensor):
                dst.copy_(src)

        with trace.span("rollout.copy_in"):
            tree_map(copy, self.state, state)
            self.key.copy_(key)
            tree_map(copy, self.policy_state, policy_state)
        with trace.span("rollout.launch"):
            self.graph.replay()
        with trace.span("rollout.clone"):
            return tree_map(torch.clone, self.out)


class _Table:
    """An Environment's captured rollouts: the memory pool they share and
    the graphs by key, least recently used first."""

    def __init__(self):
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: "collections.OrderedDict[tuple, _Graph]" = \
            collections.OrderedDict()


# env.env (an Environment) -> its _Table; an env's graphs go with it
_TABLES: "weakref.WeakKeyDictionary[Any, _Table]" = weakref.WeakKeyDictionary()


def graphs(inner) -> dict:
    """The captured rollouts of Environment `inner`, by their key, least
    recently used first."""
    table = _TABLES.get(inner)
    return {} if table is None else table.graphs


def rollout(env, state, key, num_steps: int,
            policy: Callable[[Any, torch.Tensor], torch.Tensor] | None = None,
            policy_state: Any = None):
    """Collect `num_steps` of experience from any object with `.bank` (a
    level bank) and `.env` (an Environment), such as a `ShardedEnv`:
    (final_state, RolloutBuffer), as the JAX package's `rollout`.
    `policy(policy_state, k_act) -> actions [N]`; uniform-random actions
    on the device by default.

    On a CUDA device the T steps run as one CUDA graph, captured the first
    time for each (env, bank, N, T, policy, profiler recording or not) and
    replayed after; on the CPU they run eagerly. The returned tensors are
    the caller's own.

    A policy takes every tensor it reads through `policy_state`, which is
    copied in before each replay. A replay reads any other tensor at the
    address captured the first time: a closure rebound between calls to
    new tensors is not seen, and the old ones may have been freed. The
    graph is keyed on `id(policy)`, so a fresh policy object (a
    `functools.partial(net, params)` built per call) captures anew, as
    the JAX rollout traces anew on every call; the env keeps its
    GRAPHS_PER_ENV most recently used graphs, so per-call policies cost
    a capture each, not memory without bound. With a `ShardedEnv` over W
    processes, each draws its own N/W uniform actions from `key`."""
    bank, inner = env.bank, env.env
    if inner.device.type != "cuda":
        return _scan(inner, bank, state, key, num_steps, policy,
                     policy_state)
    traced = trace.active()
    with trace.span("rollout.graph_key"):
        gkey = (traced, num_steps, id(policy), _layout(state), _layout(key),
                _layout(policy_state), _layout(bank, addresses=True))
        table = _TABLES.get(inner)
        if table is None:
            table = _TABLES[inner] = _Table()
        if not traced:  # marked graphs go; their memory returns to the pool
            for k in [k for k in table.graphs if k[0]]:
                del table.graphs[k]
        g = table.graphs.get(gkey)
        if g is not None:
            table.graphs.move_to_end(gkey)
    if g is None:
        while len(table.graphs) >= GRAPHS_PER_ENV:
            table.graphs.popitem(last=False)  # its memory returns to the pool
        with trace.span("rollout.capture"):
            g = _Graph(inner, bank, state, key, num_steps, policy,
                       policy_state, table.pool)
        table.graphs[gkey] = g
    return g.replay(state, key, policy_state)
