"""A minimal custom game module of the port's batched protocol: the
counterpart of examples/wave_game.py (the JAX package's "hello world",
itself the counterpart of the reference's `cenv/test_env.c`).

Its observation is a 16-float cosine wave obs[i] = cos(t + 0.5 i +
phase), plotted into a 64 x 64 frame; its reward is sin(t) at the clock
before the step; the clock advances by 0.25 per step, and the episode
ends once t >= 10 (test_env.c:85-105). Given the same keys and actions
it gives the JAX wave game's frames, rewards and terminations bit for
bit: cos and sin are XLA CPU's f32 cosf and sinf (`trig`).

The protocol (core/env.py) is batched: every function takes and returns
a leading level or env dimension. Implement these names and
`procgen2_tpu_torch.make(module)`, the level bank, auto-reset,
`make_vec`, `rollout`, checkpoints and the Gym adapter work on the game
unchanged:

    Config                     frozen dataclass
    Level, State               dataclasses of tensors (State holds its Level)
    generate(cfg, keys[L, 2])                 -> Level
    reset(cfg, level, keys[N, 2])             -> State
    step(cfg, state, action[N])               -> (State, reward, terminated, info)
    observe_batch(cfg, state)                 -> uint8 [N, 3, 64, 64]
    observe(cfg, state, size)                 -> uint8 [N, size, size, 3]
    obs_space(cfg), action_space(cfg)

For example::

    import procgen2_tpu_torch as pt
    from procgen2_tpu_torch.examples import wave_game
    env = pt.make(wave_game)               # on the card; device="cpu" here
    bank = env.generate_bank(pt.random.key(0, env.device), num_levels=8)
    state, ts = env.reset(bank, pt.random.key(1, env.device), num_envs=32)

A step makes no tensor from host data and reads nothing back to the
host, so `rollout` captures it in a CUDA graph (`utils/consts.py`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import random as prng
from .. import trig
from ..core import spaces
from ..utils.consts import const

NAME = "wave"
RES = 64  # framework obs resolution (the C example renders 8x8 gray)
WAVE_N = 16  # cos-wave taps, as in test_env.c's 16-float observation
BG, FG = 64, (80, 220, 120)  # the plot's background grey and its colour


@dataclasses.dataclass(frozen=True)
class Config:
    dt: float = 0.25  # test_env.c:102 `t += 0.25f`
    horizon: float = 10.0  # test_env.c:104 `terminated = t >= 10.0f`


@dataclasses.dataclass
class Level:
    phase: torch.Tensor  # f32 [L], the level's phase offset


@dataclasses.dataclass
class State:
    level: Level
    t: torch.Tensor  # f32 [N] sim clock (test_env.c:80 `t = 0.0f`)


def generate(cfg: Config, keys) -> Level:
    """The JAX wave game's `uniform(key, (), 0.0, 0.0)` per level."""
    return Level(phase=prng.uniform(keys, (), 0.0, 0.0))


def reset(cfg: Config, level: Level, keys) -> State:
    return State(level=level, t=torch.zeros(
        keys.shape[0], dtype=torch.float32, device=keys.device))


def wave(cfg: Config, state: State) -> torch.Tensor:
    """The 16-float cosine observation, f32 [N, 16]: cos(t + 0.5 i +
    phase)."""
    i = torch.arange(WAVE_N, dtype=torch.float32, device=state.t.device)
    return trig.cos32(state.t[:, None] + 0.5 * i + state.level.phase[:, None])


def step(cfg: Config, state: State, action):
    """The reward is sin of the clock before the step (test_env.c:94);
    the action is accepted and ignored, as in the C example."""
    reward = trig.sin32(state.t)
    t = state.t + cfg.dt
    return State(level=state.level, t=t), reward, t >= cfg.horizon, {}


def observe_batch(cfg: Config, state: State) -> torch.Tensor:
    """The wave plotted into uint8 [N, 3, 64, 64]: column x shows tap
    x * WAVE_N / RES, lit in the row of its amplitude (+1 at the top),
    over grey."""
    col = wave(cfg, state).repeat_interleave(RES // WAVE_N, dim=1)
    rows = torch.round((1.0 - col) * 0.5 * (RES - 1)).to(torch.int32)
    y = torch.arange(RES, dtype=torch.int32, device=rows.device)
    lit = y[None, None, :, None] == rows[:, None, None, :]
    fg = const(FG, rows.device, torch.uint8)[None, :, None, None]
    return torch.where(lit, fg, const(BG, rows.device, torch.uint8))


def observe(cfg: Config, state: State, size: int) -> torch.Tensor:
    """uint8 [N, 64, 64, 3] at any `size`: the plot does not scale, as the
    JAX wave game's observe draws at RES under any render resolution."""
    return observe_batch(cfg, state).permute(0, 2, 3, 1)


def obs_space(cfg: Config):
    return spaces.Box(0, 255, (RES, RES, 3), np.uint8)


def action_space(cfg: Config):
    return spaces.MultiDiscrete((15,))
