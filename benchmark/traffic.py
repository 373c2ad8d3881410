"""The one generator of the benchmark's traffic: keys from the seed, and
the call the window repeats, as a traffic mix's file describes it.

A mix (`benchmark/traffic/<name>.json`) holds:
  call            the name of the call's module, `benchmark/calls/<call>.py`:
                  "rollout" (`dist.rollout`, T steps in one graph) or
                  "step" (one `ShardedEnv.step`); a new call is a new file
  steps_per_call  T, the steps of one call
  warmup_s        seconds the call repeats in set-up, before the window
  profile_calls   calls under the profiler in a traced run
  check_calls     calls of the window, besides the set-up's, that the
                  reference re-runs, drawn from the seed (reservoir sampling)
A call's module defines `program(mix, system, num_envs, num_actions)`,
which gives fn(state, key) -> (state, buffer), and `reference(env, bank,
state, key, mix, rows)`, the same call in the plain reference, and may
define `read(buffer)`, the host read that ends each call; by default the
call's episode count (the sum of its `dones`), as a learner's logger
reads it.

Keys: the seed's 64 bits are the root key's two words. The reset key is
fold_in(root, 0) (`ShardedEnv.reset` draws the bank from
fold_in(reset key, 17)); call c's key is fold_in(fold_in(root, 1), c).
Call 0 and the warm-up's calls are the set-up's (call 0 captures the
graph); the window's calls follow them.
"""
from __future__ import annotations

import importlib

import torch

from . import spec
from .reference import random as prng

KEY_CHUNK = 4096  # call keys made at a time, outside any call's timing


def root_key(seed: int, device) -> torch.Tensor:
    """The seed's 64 bits (two's complement) as a key's two 32-bit words."""
    s = int(seed) & (2 ** 64 - 1)
    return torch.tensor([s >> 32, s & 0xFFFFFFFF], dtype=torch.int64,
                        device=device)


class Keys:
    def __init__(self, seed: int, device):
        root = root_key(seed, device)
        self.reset = prng.fold_in(root, 0)
        self._calls_key = prng.fold_in(root, 1)
        self._chunks: dict = {}

    def call(self, c: int) -> torch.Tensor:
        """Call c's key, int64 [2] (its chunk made on first use)."""
        chunk, i = divmod(c, KEY_CHUNK)
        keys = self._chunks.get(chunk)
        if keys is None:
            ids = torch.arange(chunk * KEY_CHUNK, (chunk + 1) * KEY_CHUNK,
                               dtype=torch.int64,
                               device=self._calls_key.device)
            keys = self._chunks[chunk] = prng.fold_in(self._calls_key, ids)
        return keys[i]


def call_module(mix: dict):
    """The module of the mix's call, `benchmark/calls/<call>.py`."""
    name = mix["call"]
    if not spec.NAME.match(name):
        raise ValueError(f"not a call's name: {name!r}")
    return importlib.import_module(f"{__package__}.calls.{name}")


def make_call(mix: dict, system, num_envs: int, num_actions: int):
    """The mix's call: fn(state, key) -> (state, buffer)."""
    return call_module(mix).program(mix, system, num_envs, num_actions)


def episodes(buf) -> int:
    """The default host read: the call's episode count."""
    return int(buf.dones.sum())


def make_read(mix: dict):
    """The host read that ends each of the mix's calls: fn(buffer) -> int."""
    return getattr(call_module(mix), "read", episodes)
