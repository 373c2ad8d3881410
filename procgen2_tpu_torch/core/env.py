"""Batched auto-resetting environment over a level bank
(procgen2_tpu/core/env.py), in PyTorch.

The JAX package vmaps unbatched game functions; here a game module's
functions are batched already (leading level or env dimension), and the
random draws are the JAX package's (`..random`), so the same keys and
actions give the same trajectory.

A game module provides:
    Config                   frozen dataclass
    Level, State             dataclasses of tensors with a leading dim
    generate(cfg, keys[L, 2])            -> Level
    reset(cfg, level, keys[N, 2])        -> State
    step(cfg, state, action[N])          -> (State, reward, terminated, info)
    observe_batch(cfg, state)            -> uint8 [N, 3, 64, 64]
    observe(cfg, state, size)            -> uint8 [N, size, size, 3], the
                                            exact render at any size
    obs_space(cfg), action_space(cfg)
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .. import random as prng
from ..utils import trace
from ..utils.tree import bank_gather, key_field, tree_map, tree_select

OBS_KEY = "screen"  # the reference obs dict key, games/maze/maze.cpp:117


@dataclasses.dataclass
class EnvState:
    """Wrapper state: per-env game state plus episode accumulators."""

    game: Any
    ep_return: torch.Tensor  # f32 [N] running return of the episode
    ep_length: torch.Tensor  # i32 [N]
    # int64 [N, 2] key driving the auto-reset's level choice
    rng: torch.Tensor = key_field()


@dataclasses.dataclass
class TimeStep:
    obs: Any  # uint8 [N, 64, 64, 3] (hwc) or [N, 3, 64, 64] (chw), or None
    reward: torch.Tensor  # f32 [N]
    terminated: torch.Tensor  # bool [N]
    truncated: torch.Tensor  # bool [N]; the reference signals timeouts as
    #                           `terminated` (games/maze/maze.cpp:308-310)
    info: dict


class Environment:
    """Batched auto-resetting environment over a level bank on `device`.

    Usage:
        env = make("coinrun", device="cuda")
        bank = env.generate_bank(random.key(0, env.device), num_levels=1024)
        state, ts = env.reset(bank, random.key(1, env.device), num_envs=4096)
        state, ts = env.step(bank, state, actions)  # ts.obs uint8 [4096, 64, 64, 3]
    """

    def __init__(self, game, cfg, device, obs_format: str = "hwc"):
        if obs_format not in ("hwc", "chw"):
            raise ValueError(
                f"obs_format must be 'hwc' or 'chw', got {obs_format!r}")
        self.game = game
        self.cfg = cfg
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            # a tensor made on "cuda" lies on the current card: name it, so
            # that tensors made on env.device compare equal to it
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        # "hwc": uint8 [N, 64, 64, 3], the reference layout (a permuted
        # view of the planar render); "chw": the planar [N, 3, 64, 64]
        self.obs_format = obs_format

    def _key(self, key):
        if key.device != self.device:
            raise ValueError(f"key is on {key.device}, the env on {self.device}")
        return key

    # ------------------------------------------------------------------
    # Level bank
    # ------------------------------------------------------------------
    def generate_bank(self, key, num_levels: int, start_level: int = 0):
        """`num_levels` levels in one batched `generate`; level i is keyed
        by fold_in(key, start_level + i), so a (key, level id) pair names
        the same level across runs and bank sizes."""
        with trace.span("env.generate_bank"):
            ids = torch.arange(num_levels, dtype=torch.int64,
                               device=self.device) + start_level
            return self.game.generate(self.cfg,
                                      prng.fold_in(self._key(key), ids))

    # ------------------------------------------------------------------
    # Reset / step
    # ------------------------------------------------------------------
    def _num_levels(self, bank):
        return getattr(bank, dataclasses.fields(bank)[0].name).shape[0]

    def _fresh(self, bank, keys):
        """Episode start for each key [N, 2]: (level draw, reset key,
        next key) = split(key, 3), as `_reset_one` in the JAX package."""
        k = prng.split(keys, 3)
        idx = prng.randint(k[:, 0], (), 0, self._num_levels(bank))
        gs = self.game.reset(self.cfg, bank_gather(bank, idx.long()), k[:, 1])
        return gs, k[:, 2]

    def reset(self, bank, key, num_envs: int):
        return self.reset_keys(bank, prng.split(self._key(key), num_envs))

    def reset_keys(self, bank, keys):
        """`reset` from each env's key [N, 2] (`reset` splits its key into
        N): a ShardedEnv resets its rows of the global batch with their
        rows of the split."""
        with trace.span("env.reset"):
            num_envs = self._key(keys).shape[0]
            gs, k_state = self._fresh(bank, keys)
            state = EnvState(
                game=gs,
                ep_return=torch.zeros(num_envs, dtype=torch.float32,
                                      device=self.device),
                ep_length=torch.zeros(num_envs, dtype=torch.int32,
                                      device=self.device),
                rng=k_state)
            z = torch.zeros(num_envs, dtype=torch.bool, device=self.device)
            return state, TimeStep(
                obs=self._observe_batch(gs),
                reward=torch.zeros(num_envs, dtype=torch.float32,
                                   device=self.device),
                terminated=z, truncated=z.clone(), info={})

    def reset_pinned(self, bank, key, fold_ids=None):
        """Env i on level i of the bank; env i's key is
        fold_in(key, fold_ids[i]) (default arange). No render."""
        num = self._num_levels(bank)
        if fold_ids is None:
            fold_ids = torch.arange(num, dtype=torch.int64, device=self.device)
        k = prng.split(prng.fold_in(self._key(key), fold_ids), 2)
        gs = self.game.reset(self.cfg, bank, k[:, 0])
        return EnvState(
            game=gs,
            ep_return=torch.zeros(num, dtype=torch.float32, device=self.device),
            ep_length=torch.zeros(num, dtype=torch.int32, device=self.device),
            rng=k[:, 1])

    def _observe_batch(self, game_states):
        planar = self.game.observe_batch(self.cfg, game_states)
        if self.obs_format == "hwc":
            return planar.permute(0, 2, 3, 1)
        return planar

    def step(self, bank, state: EnvState, action, render: bool = True):
        """Step every env; terminated envs restart on a level drawn from the
        bank. The draw is made for every env on every step, done or not
        (split(rng, 3) -> next rng, level draw, reset key), as in the JAX
        package. `action` int [N] (or [N, 1]); `render=False` leaves
        ts.obs None. Under a profiler its three layers are traced
        (`utils/trace.py`)."""
        dev = self.device
        trace.mark("game_step", dev)
        with trace.span("env.game_step"):
            if action.ndim > 1:
                action = action.squeeze(-1)
            gs, reward, terminated, info = self.game.step(self.cfg, state.game,
                                                          action)
            ep_return = state.ep_return + reward
            ep_length = state.ep_length + 1

        trace.mark("auto_reset", dev)
        with trace.span("env.auto_reset"):
            k = prng.split(state.rng, 3)
            idx = prng.randint(k[:, 1], (), 0, self._num_levels(bank))
            fresh = self.game.reset(self.cfg, bank_gather(bank, idx.long()),
                                    k[:, 2])
            gs = tree_select(terminated, fresh, gs)

            info = dict(info)
            info.update(returned_episode_return=ep_return,
                        returned_episode_length=ep_length, done=terminated)
            new_state = EnvState(
                game=gs,
                ep_return=torch.where(terminated, 0.0, ep_return),
                ep_length=torch.where(terminated, 0, ep_length),
                rng=k[:, 0])

        trace.mark("render", dev)
        with trace.span("env.render"):
            obs = self._observe_batch(gs) if render else None
            ts = TimeStep(obs=obs, reward=reward, terminated=terminated,
                          truncated=torch.zeros_like(terminated), info=info)
        trace.mark("end", dev)
        return new_state, ts

    def step_raw(self, state: EnvState, action, render: bool = True):
        """Step without auto-reset: a done env returns its terminal state
        and frame and keeps simulating if stepped again."""
        if action.ndim > 1:
            action = action.squeeze(-1)
        gs, reward, terminated, info = self.game.step(self.cfg, state.game,
                                                      action)
        new_state = EnvState(game=gs, ep_return=state.ep_return + reward,
                             ep_length=state.ep_length + 1, rng=state.rng)
        obs = self._observe_batch(gs) if render else None
        return new_state, TimeStep(obs=obs, reward=reward,
                                   terminated=terminated,
                                   truncated=torch.zeros_like(terminated),
                                   info=dict(info))

    def observe(self, state: EnvState):
        """Observations of an existing state."""
        return self._observe_batch(state.game)

    def render(self, state: EnvState, size: int = 512, env_index: int = 0):
        """One env's scene re-rendered at window resolution, uint8
        [size, size, 3] on the env's device, whatever `obs_format` is.

        The reference renders every scene twice, the 64x64 obs and a
        window surface (`cenv_render`, games/coinrun/coinrun.cpp:
        393-411). Here the game's exact render (`observe`) draws env
        `env_index` at `size`, its camera spanning the same world."""
        one = tree_map(lambda x: x[env_index:env_index + 1], state.game)
        return self.game.observe(self.cfg, one, int(size))[0]

    # ------------------------------------------------------------------
    # Spaces
    # ------------------------------------------------------------------
    def observation_space(self):
        space = self.game.obs_space(self.cfg)
        if self.obs_format == "chw" and len(space.shape) == 3:
            h, w, c = space.shape
            space = dataclasses.replace(space, shape=(c, h, w))
        return {OBS_KEY: space}

    def action_space(self):
        return {"action": self.game.action_space(self.cfg)}
