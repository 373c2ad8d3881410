"""procgen2_tpu_torch: the Procgen2 suite of procgen2_tpu, ported to
PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The port is a package beside the JAX one, which stays as its reference.
It never imports jax or `procgen2_tpu` as a package: the numpy-only asset
modules are loaded by path (render/_shared.py). Games ported so far: see
GAMES.

Quick start:
    import procgen2_tpu_torch as pt
    env = pt.make("coinrun", device="cuda")
    bank = env.generate_bank(pt.random.key(0, env.device), num_levels=1024)
    state, ts = env.reset(bank, pt.random.key(1, env.device), num_envs=4096)
    state, ts = env.step(bank, state, actions)  # ts.obs uint8 [4096, 64, 64, 3]
"""
from __future__ import annotations

import importlib

import torch

from . import random
from .core.env import Environment, EnvState, TimeStep

__version__ = "0.1.0"

GAMES = ("coinrun",)


def make(game: str, device, **config) -> Environment:
    """Environment for `game` on `device` ("cpu", "cuda", "cuda:1", ...);
    config kwargs go to the game's Config, `obs_format` ("hwc" or "chw")
    to the Environment. A CUDA device must exist: nothing falls back."""
    if game not in GAMES:
        raise ValueError(f"game {game!r} is not ported to PyTorch yet; "
                         f"ported so far: {GAMES}")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but torch sees no "
                           "CUDA device")
    obs_format = config.pop("obs_format", "hwc")
    mod = importlib.import_module(f".games.{game}", __name__)
    return Environment(mod, mod.Config(**config), device,
                       obs_format=obs_format)


__all__ = ["make", "Environment", "EnvState", "TimeStep", "GAMES", "random",
           "__version__"]
