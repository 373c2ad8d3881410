"""The faults a cell can have, planted under the program: each wraps the
port (`system.Port`) and breaks what its calls give. The checks have to
come out not correct under each (benchmark/tests/test_bench_faults.py).

  stale    a call returns the state it was given, unchanged
  half     the second half of the batch is left out of each call: its
           rows keep their state and their buffer rows are zero
  altered  one answer is altered where it is produced: one byte of one
           frame (step 0, row = call count mod N) of each call's obs

The exchange between chips does not exist in a one-chip cell.
"""
from __future__ import annotations

import torch

from .reference.utils.tree import tree_map
from .system import FIELDS, Port


class _Faulty(Port):
    calls = 0

    def rollout(self, state, key, num_steps):
        return self.fault(state, *super().rollout(state, key, num_steps))

    def step(self, state, actions):
        return self.fault(state, *super().step(state, actions))


class Stale(_Faulty):
    def fault(self, before, after, buf):
        return before, buf


class Half(_Faulty):
    def fault(self, before, after, buf):
        n = before.ep_length.shape[0]

        def keep_first(b, a):
            a = a.clone()
            a[n // 2:] = b[n // 2:]
            return a

        for f in FIELDS:
            x = getattr(buf, f).clone()
            x[:, n // 2:] = 0
            setattr(buf, f, x)
        return tree_map(keep_first, before, after), buf


class Altered(_Faulty):
    def fault(self, before, after, buf):
        obs = buf.obs.clone()
        row = self.calls % obs.shape[1]
        obs[0, row].view(-1)[0] += 1
        buf.obs = obs
        self.calls += 1
        return after, buf


FAULTS = {"stale": Stale, "half": Half, "altered": Altered}
