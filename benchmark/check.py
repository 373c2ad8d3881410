"""What decides `correct`: the program's outputs against the plain
reference (`benchmark/reference/`), element by element.

The reference works out everything from the seed: the bank, the reset
and, for each checked call, its T steps with the call's key. Call 0 (the
set-up's) starts from the reference's own reset; a call drawn from the
window starts from the program's state at that call (the output of the
call before), every row of it. Each part is a count of elements (obs:
whole 64x64x3 frames, by a checksum of each) that differ from the
reference, bit for bit; the numbers compared sum them, each with the
limit 0.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from . import traffic as traffic_mod
from .reference import env as ref_env
from .reference.utils.tree import tree_map

STEP_FIELDS = ("actions", "rewards", "dones", "ep_returns", "ep_lengths")
PARTS = ("bank", "reset_state", "reset_frames", *STEP_FIELDS, "frames",
         "state")
# the numbers compared, each the sum of its parts, and their limits: the
# configurations state bit-exact levels, states, rewards, terminations
# and observations. Two numbers, so that the control moves each of them
# (its lower precision leaves the integer parts, such as the bank and the
# actions, alone).
NUMBERS = {"obs_frames": ("reset_frames", "frames"),
           "state_elements": ("bank", "reset_state", *STEP_FIELDS, "state")}
LIMITS = {"obs_frames": 0, "state_elements": 0}
CHUNK_BYTES = 64 << 20  # temporaries of one checksum pass


def flatten(tree, prefix=""):
    """{path: tensor} of a tree of (nested) dataclasses of tensors."""
    if dataclasses.is_dataclass(tree):
        out = {}
        for f in dataclasses.fields(tree):
            out.update(flatten(getattr(tree, f.name), f"{prefix}{f.name}."))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix.rstrip("."): tree}
    return {}


def differ(a: torch.Tensor, b: torch.Tensor) -> int:
    """Elements of `a` (the program's, held on the host or the device) and
    `b` (the reference's) whose bits differ (all of them where the dtype or
    shape differs)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return max(a.numel(), b.numel())
    a = a.to(b.device)
    if a.is_floating_point():
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        a, b = a.view(ints[a.element_size()]), b.view(ints[b.element_size()])
    return int((a != b).sum())


def tree_differ(a, b) -> int:
    fa, fb = flatten(a), flatten(b)
    n = sum(max(x.numel() for x in (fa.get(k), fb.get(k)) if x is not None)
            for k in set(fa) ^ set(fb))
    return n + sum(differ(fa[k], fb[k]) for k in set(fa) & set(fb))


def frame_weights(frame_bytes: int, device) -> torch.Tensor:
    """Fixed odd weights of a frame's 32-bit words, below 2**20, so that a
    frame's weighted sum is exact in int64 (at most 2**31 * 2**20 * words)."""
    g = torch.Generator().manual_seed(20260)
    w = torch.randint(0, 2 ** 19, (frame_bytes // 4,), generator=g) * 2 + 1
    return w.to(device)


def frame_sums(obs: torch.Tensor) -> torch.Tensor:
    """int64 [T, N]: a checksum of each uint8 frame of obs [T, N, ...], the
    weighted sum of its 32-bit words. Any one changed byte changes it."""
    T, N = obs.shape[:2]
    words = obs.contiguous().view(T, N, -1).view(torch.int32)
    w = frame_weights(words.shape[-1] * 4, obs.device)
    rows = max(1, CHUNK_BYTES // (T * words.shape[-1] * 8))
    return torch.cat([(words[:, a:a + rows].long() * w).sum(-1)
                      for a in range(0, N, rows)], dim=1)


@dataclasses.dataclass
class Checked:
    """One call the reference re-runs: its index and key, the program's
    state before it (None: call 0, from the reference's own reset) and
    what the call gave: its state, its buffer's fields but obs, and the
    checksums of its obs; all of them copies on the host (`held`)."""
    index: int
    key: torch.Tensor
    before: object
    after: object
    fields: dict
    obs_sums: torch.Tensor
    profiled: bool = False


def compare(config: dict, traffic: dict, device, reset_key, program_bank,
            program_reset, reset_sums, checked, profiled_hooks=()):
    """The reference against the program: ({number: differing}, {part:
    differing}, how many of the units (the bank, the reset, each checked
    call) differ)."""
    env = ref_env.Env(config["game"], config["config"], config["num_envs"],
                      config["num_levels"], device)
    rows = torch.arange(config["num_envs"], device=device)
    call_mod = traffic_mod.call_module(traffic)
    parts = dict.fromkeys(PARTS, 0)
    failed = 0

    bank = env.generate_bank(reset_key)
    ref_state, ref_obs = env.reset(bank, reset_key, rows)
    got = dict(bank=tree_differ(program_bank, bank),
               reset_state=tree_differ(program_reset, ref_state),
               reset_frames=differ(reset_sums, frame_sums(ref_obs[None])))
    failed += (got["bank"] > 0) + (got["reset_state"] + got["reset_frames"] > 0)
    for k, v in got.items():
        parts[k] += v

    for call in sorted(checked, key=lambda c: c.index):
        # the program's state in the reference's classes (field by field)
        start = ref_state if call.before is None else tree_map(
            lambda _, p: p.to(device) if isinstance(p, torch.Tensor) else p,
            ref_state, call.before)
        with contextlib.ExitStack() as stack:
            for hook in profiled_hooks if call.profiled else ():
                stack.enter_context(hook())
            after, buf = call_mod.reference(env, bank, start,
                                            call.key.to(device), traffic,
                                            rows)
        got = {f: differ(call.fields[f], getattr(buf, f)) for f in STEP_FIELDS}
        got.update(frames=differ(call.obs_sums, frame_sums(buf.obs)),
                   state=tree_differ(call.after, after))
        for k, v in got.items():
            parts[k] += v
        failed += any(got.values())
        del buf, after
    numbers = {n: sum(parts[p] for p in of) for n, of in NUMBERS.items()}
    return numbers, parts, failed
