"""procgen2_tpu_torch: the Procgen2 suite of procgen2_tpu, ported to
PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The port is a package beside the JAX one, which stays as its reference.
It never imports jax or anything of `procgen2_tpu`, and keeps its own
copies of the numpy asset modules (render/atlas.py, render/phases.py).
All seven games are ported (GAMES). Entry points run on the card unless
the caller asks for the CPU.

Quick start, the bench's maze shape:
    import procgen2_tpu_torch as pt
    env = pt.make("maze", mode="easy")  # device="cuda" by default
    bank = env.generate_bank(pt.random.key(0, env.device), num_levels=2048)
    state, ts = env.reset(bank, pt.random.key(1, env.device), num_envs=8192)
    state, ts = env.step(bank, state, actions)  # ts.obs uint8 [8192, 64, 64, 3]
"""
from __future__ import annotations

import importlib

import torch

from . import random
from .core.env import Environment, EnvState, TimeStep

__version__ = "0.1.0"

GAMES = ("coinrun", "bossfight", "climber", "caveflyer", "jumper", "chaser",
         "maze")


def make(game: str, device="cuda", **config) -> Environment:
    """Environment for `game` on `device` ("cuda", the default, "cuda:1",
    "cpu", ...); config kwargs go to the game's Config, `obs_format`
    ("hwc" or "chw") to the Environment. A CUDA device must exist unless
    the caller asks for the CPU: nothing falls back."""
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
