"""Space descriptors (the counterpart of procgen2_tpu/core/spaces.py),
sampled with the port's threefry keys."""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .. import random as prng


@dataclasses.dataclass(frozen=True)
class Box:
    low: float
    high: float
    shape: Tuple[int, ...]
    dtype: np.dtype = np.uint8

    def sample(self, key):
        if np.issubdtype(self.dtype, np.integer):
            v = prng.randint(key, self.shape, int(self.low), int(self.high) + 1)
            return v.to(torch.from_numpy(np.zeros(0, self.dtype)).dtype)
        return prng.uniform(key, self.shape, self.low, self.high)


@dataclasses.dataclass(frozen=True)
class MultiDiscrete:
    nvec: Tuple[int, ...]

    def sample(self, key):
        keys = prng.split(key, len(self.nvec))
        return torch.stack([prng.randint(keys[..., i, :], (), 0, n)
                            for i, n in enumerate(self.nvec)], dim=-1)


@dataclasses.dataclass(frozen=True)
class Discrete:
    n: int

    def sample(self, key):
        return prng.randint(key, (), 0, self.n)
