"""The system under test, behind the interface the harness drives.

`Port` is the program: procgen2_tpu_torch's `make_vec` -> `ShardedEnv`
and `dist.rollout`, imported from this checkout. `Control` is the plain
reference in the program's place at the control's lower precision
(`reference/precision.py`); it never runs in a benchmark run, only in the
control's check (`benchmark/tools/control.py` and the tests).

Each system gives:
  reset(reset_key) -> (state, obs [N, 64, 64, 3])
  bank                the level bank
  rollout(state, key, num_steps) -> (state, buffer)
  step(state, actions) -> (state, buffer of one step)
where a buffer has the rollout's six [T, N, ...] fields.
"""
from __future__ import annotations

import pathlib
import types

import torch

from .reference import env as ref_env
from .reference import precision

FIELDS = ("obs", "actions", "rewards", "dones", "ep_returns", "ep_lengths")


class Port:
    def __init__(self, config: dict, device):
        import procgen2_tpu_torch
        from procgen2_tpu_torch.dist import make_vec, rollout

        root = pathlib.Path(__file__).resolve().parents[1]
        where = pathlib.Path(procgen2_tpu_torch.__file__).resolve()
        if root not in where.parents:
            raise RuntimeError(f"procgen2_tpu_torch was imported from {where}, "
                               f"not from this checkout ({root})")
        self._rollout = rollout
        self.venv = make_vec(config["game"], num_envs=config["num_envs"],
                             num_levels=config["num_levels"], device=device,
                             **config["config"])

    def reset(self, reset_key):
        state, ts = self.venv.reset(reset_key)
        return state, ts.obs

    @property
    def bank(self):
        return self.venv.bank

    def rollout(self, state, key, num_steps):
        return self._rollout(self.venv, state, key, num_steps)

    def step(self, state, actions):
        state, ts = self.venv.step(state, actions)
        info = ts.info
        return state, types.SimpleNamespace(
            obs=ts.obs[None], actions=actions[None], rewards=ts.reward[None],
            dones=ts.terminated[None],
            ep_returns=info["returned_episode_return"][None],
            ep_lengths=info["returned_episode_length"][None])


class Control:
    """The reference over every row, computed at the control's precision."""

    def __init__(self, config: dict, device):
        self.env = ref_env.Env(config["game"], config["config"],
                               config["num_envs"], config["num_levels"],
                               device)
        self.rows = torch.arange(config["num_envs"], device=device)
        self._bank = None

    def reset(self, reset_key):
        with precision.lowered():
            self._bank = self.env.generate_bank(reset_key)
            return self.env.reset(self._bank, reset_key, self.rows)

    @property
    def bank(self):
        return self._bank

    def rollout(self, state, key, num_steps):
        with precision.lowered():
            return self.env.rollout(self._bank, state, key, num_steps,
                                    self.rows)

    def step(self, state, actions):
        with precision.lowered():
            state, obs, rew, done, ret, length = self.env.step(
                self._bank, state, actions)
        return state, types.SimpleNamespace(
            obs=obs[None], actions=actions[None], rewards=rew[None],
            dones=done[None], ep_returns=ret[None], ep_lengths=length[None])


SYSTEMS = {"port": Port, "control": Control}
