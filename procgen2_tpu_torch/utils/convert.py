"""Carry levels and states across from the JAX package.

The port's "weights" are its level banks and env states. These helpers
take a JAX `Level` bank, game `State` or `EnvState` whose leaves were
turned into numpy arrays (by the caller, which is the side that has jax;
PRNG keys arrive as their `jax.random.key_data` uint32 words) and build
the port's dataclasses on a device. Field names are the same on both
sides; uint32 key words become the port's int64 words.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.env import EnvState


def _tensor(v, device):
    a = np.asarray(v)
    if a.dtype == np.uint32:  # key words
        a = a.astype(np.int64)
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def _fill(cls, src, device, **nested):
    kw = {}
    for f in dataclasses.fields(cls):
        v = getattr(src, f.name)
        kw[f.name] = nested[f.name](v) if f.name in nested else _tensor(v, device)
    return cls(**kw)


def level(game, src, device):
    """`game.Level` from a level (or stacked bank) with numpy leaves."""
    return _fill(game.Level, src, device)


def state(game, src, device):
    """`game.State` (with its Level) from numpy leaves."""
    return _fill(game.State, src, device,
                 level=lambda v: level(game, v, device))


def env_state(game, src, device):
    """`EnvState` (with the game's State) from numpy leaves."""
    return _fill(EnvState, src, device,
                 game=lambda v: state(game, v, device))
