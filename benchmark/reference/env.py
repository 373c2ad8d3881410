"""The batched auto-resetting env and the learner's rollout, plain.

A frozen copy of the program's `core/env.py` (bank, reset, step with
auto-reset, the hwc obs) and of the eager loop of `dist/rollout.py`, with
`dist/vec.py`'s key layout (the bank from fold_in(reset key, 17), env i
reset from split(reset key, N)[i]). Every function takes `rows`, the env
rows to follow: row i's trajectory depends only on its own state, its own
keys and the bank, and threefry draws element i of a batch from (key, i),
so any subset of rows gives the rows of the whole batch.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any

import torch

from . import precision
from . import random as prng
from .utils.tree import bank_gather, tree_map, tree_select

BANK_FOLD = 17  # ShardedEnv.reset: the bank key is fold_in(reset key, 17)


@dataclasses.dataclass
class EnvState:
    game: Any
    ep_return: torch.Tensor  # f32 [N]
    ep_length: torch.Tensor  # i32 [N]
    rng: torch.Tensor  # int64 [N, 2]


@dataclasses.dataclass
class Buffer:
    """A rollout's [T, N, ...] fields, as the program's RolloutBuffer."""
    obs: torch.Tensor  # uint8 [T, N, 64, 64, 3]
    actions: torch.Tensor  # i32 [T, N]
    rewards: torch.Tensor  # f32 [T, N]
    dones: torch.Tensor  # bool [T, N]
    ep_returns: torch.Tensor  # f32 [T, N]
    ep_lengths: torch.Tensor  # i32 [T, N]


def game_module(game: str):
    """The reference of `game`: the module `reference/games/<game>.py`."""
    return importlib.import_module(f"{__package__}.games.{game}")


class Env:
    """One configuration of one game: `game` the name of its module under
    `reference/games/`, `config` the game's Config kwargs, `num_envs` the
    whole batch (rows index into it)."""

    def __init__(self, game: str, config: dict, num_envs: int,
                 num_levels: int, device):
        self.game = game_module(game)
        self.cfg = self.game.Config(**config)
        self.num_envs = num_envs
        self.num_levels = num_levels
        self.device = torch.device(device)
        self.num_actions = int(self.game.action_space(self.cfg).nvec[0])

    def generate_bank(self, reset_key):
        ids = torch.arange(self.num_levels, dtype=torch.int64,
                           device=self.device)
        bank_key = prng.fold_in(reset_key, BANK_FOLD)
        return self.game.generate(self.cfg, prng.fold_in(bank_key, ids))

    def _observe(self, gs):
        return self.game.observe_batch(self.cfg, gs).permute(0, 2, 3, 1)

    def reset(self, bank, reset_key, rows):
        """The env state of `rows` (int64 [R]) after the reset, and its obs."""
        keys = prng.split(reset_key, self.num_envs)[rows]
        k = prng.split(keys, 3)
        idx = prng.randint(k[:, 0], (), 0, self.num_levels)
        gs = self.game.reset(self.cfg, bank_gather(bank, idx.long()), k[:, 1])
        n = rows.shape[0]
        state = EnvState(
            game=gs,
            ep_return=torch.zeros(n, dtype=torch.float32, device=self.device),
            ep_length=torch.zeros(n, dtype=torch.int32, device=self.device),
            rng=k[:, 2])
        return state, self._observe(gs)

    def step(self, bank, state: EnvState, action):
        """One step of every row of `state`, terminated rows restarted on a
        level drawn from the bank: (state, obs, reward, done, ep_return,
        ep_length), the last two as the step returned them."""
        gs, reward, terminated, _ = self.game.step(self.cfg, state.game,
                                                   action)
        gs = precision.state(gs)
        ep_return = state.ep_return + reward
        ep_length = state.ep_length + 1
        k = prng.split(state.rng, 3)
        idx = prng.randint(k[:, 1], (), 0, self.num_levels)
        fresh = self.game.reset(self.cfg, bank_gather(bank, idx.long()),
                                k[:, 2])
        gs = tree_select(terminated, fresh, gs)
        new = EnvState(game=gs,
                       ep_return=torch.where(terminated, 0.0, ep_return),
                       ep_length=torch.where(terminated, 0, ep_length),
                       rng=k[:, 0])
        return (new, self._observe(gs), reward, terminated, ep_return,
                ep_length)

    def rollout(self, bank, state: EnvState, key, num_steps: int, rows):
        """`num_steps` steps from `key` with uniform actions over the whole
        batch (each step: key, k_act = split(key); actions =
        randint(k_act, (num_envs,))), of `rows` only: (state, Buffer)."""
        outs = []
        for _ in range(num_steps):
            key, k_act = prng.split(key).unbind(-2)
            actions = prng.randint(k_act, (self.num_envs,), 0,
                                   self.num_actions)[rows]
            state, obs, rew, done, ret, length = self.step(bank, state,
                                                           actions)
            outs.append((obs, actions, rew, done, ret, length))
        return state, Buffer(*(torch.stack(x) for x in zip(*outs)))


def rows_of(tree, rows):
    """Rows `rows` of every leaf of a batched state tree."""
    return tree_map(lambda x: x[rows], tree)
