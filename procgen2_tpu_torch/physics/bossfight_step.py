"""Bossfight's game step as one CUDA kernel (`render/csrc/bossfight_step.cu`).

`games/bossfight.py::step` launches it for a state on a CUDA device; its
plain version is `bossfight.step_reference`, the torch step that CPU
tensors take and that the kernel equals bit for bit. It replaces no TPU
kernel (the JAX package's step is XLA ops): it fuses the plain step's
~15.8k small kernels a step into one launch.

The game's constants travel as arguments (`Consts`, built by bossfight.py
from its own values and its mode's bullet speed and shield jitter), so
that the kernel holds no copy of them and every mode runs the same kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..render._build import check_tensor

NUM_A_BULLETS, NUM_B_BULLETS, NUM_EXPLOSIONS = 32, 64, 8  # the kernel's rings
MAX_BARRIERS = 4
VOLLEY = 8  # _fire_pattern's pushes: kVolley in the source

_F32, _B8, _I32 = torch.float32, torch.bool, torch.int32
# The state's fields in bossfight.State's order (BOSSFIGHT_FIELDS in the
# source): name, dtype and the shape after the env dimension.
FIELDS = (
    ("pos", _F32, (2,)), ("vel", _F32, (2,)), ("alive", _B8, ()),
    ("a_bullet_timer", _F32, ()),
    ("ab_pos", _F32, (NUM_A_BULLETS, 2)), ("ab_vel", _F32, (NUM_A_BULLETS, 2)),
    ("ab_frame", _F32, (NUM_A_BULLETS,)),
    ("ab_bouncing", _B8, (NUM_A_BULLETS,)),
    ("ab_bounce_timer", _F32, (NUM_A_BULLETS,)),
    ("ab_num", _I32, ()), ("ab_next", _I32, ()),
    ("boss_pos", _F32, (2,)), ("boss_vel", _F32, (2,)),
    ("phase_timer", _F32, ()), ("phase_index", _I32, ()),
    ("weapon_index", _I32, ()), ("attack_timer", _F32, ()), ("hp", _I32, ()),
    ("move_timer", _F32, ()), ("explosion_timer", _F32, ()),
    ("damage_timer", _F32, ()),
    ("bb_pos", _F32, (NUM_B_BULLETS, 2)), ("bb_vel", _F32, (NUM_B_BULLETS, 2)),
    ("bb_rot", _F32, (NUM_B_BULLETS,)), ("bb_frame", _F32, (NUM_B_BULLETS,)),
    ("bb_num", _I32, ()), ("bb_next", _I32, ()),
    ("ex_pos", _F32, (NUM_EXPLOSIONS, 2)), ("ex_frame", _F32, (NUM_EXPLOSIONS,)),
    ("ex_num", _I32, ()), ("ex_next", _I32, ()),
    ("t", _I32, ()), ("rng", torch.int64, (2,)),
)


class Consts(ctypes.Structure):
    """The kernel's constants (`struct Consts` in the source, in the same
    order). ctypes rounds each Python float to f32 to nearest, as torch
    rounds a Python scalar operand of an f32 tensor op."""
    _fields_ = [(name, ctypes.c_float) for name in (
        "dt", "move_mix", "move_speed", "lo_x", "hi_x", "lo_y", "hi_y",
        "a_bullet_time", "a_bullet_vy", "bounce_speed", "bounce_time",
        "explosion_dt", "agent_dx", "agent_dy", "agent_w", "agent_h",
        "boss_dx", "boss_dy", "boss_w", "boss_h", "bullet_half",
        "bullet_size", "barrier_half", "barrier_size", "half",
        "unshielded_time", "damage_time", "move_time", "inv_move_time",
        "target_x_scale", "target_y_shift", "pi", "passive_p",
        "bullet_speed", "shield_jitter")] + [
        (name, ctypes.c_float * VOLLEY) for name in ("fan", "cross", "radial")
    ] + [("boss_hp", ctypes.c_int), ("num_weapons", ctypes.c_int)]


@functools.lru_cache(maxsize=None)
def _kernel():
    """Build (or find) and load the kernel once per process. Returns
    (launch, build record). Needs nvcc."""
    from ..render import _build

    lib, record = _build.load("bossfight_step")
    fn = lib.bossfight_step_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 2
                   + [ctypes.POINTER(Consts), ctypes.c_void_p])
    return fn, record


def build():
    """Build (or find) and load the kernel; returns the build record
    (seconds, compiler output). Needs nvcc."""
    return _kernel()[1]


def step(fields, barrier_pos, barrier_exists, action, *, consts, sub_steps):
    """One bossfight step of every env on the card: `fields` the state's
    tensors in FIELDS' order ([N, ...] each), barrier_pos f32 [N, 4, 2],
    barrier_exists bool [N, 4], action int32 [N], `consts` a `Consts`.
    Returns (the new state's tensors in FIELDS' order, reward f32 [N],
    done bool [N]), all new.

    Dtypes, shapes and the device are checked before anything is built
    (ValueError); every tensor must lie on one CUDA device."""
    fields = tuple(fields)
    if len(fields) != len(FIELDS):
        raise ValueError(f"{len(fields)} state fields, expected "
                         f"{len(FIELDS)} ({', '.join(f for f, _, _ in FIELDS)})")
    N = action.shape[0] if action.ndim == 1 else -1
    dev = action.device
    check_tensor(action, _I32, (N,), dev, "action")
    check_tensor(barrier_pos, _F32, (N, MAX_BARRIERS, 2), dev, "barrier_pos")
    check_tensor(barrier_exists, _B8, (N, MAX_BARRIERS), dev,
                 "barrier_exists")
    for x, (name, dtype, shape) in zip(fields, FIELDS):
        check_tensor(x, dtype, (N,) + shape, dev, name)
    if dev.type != "cuda":
        raise ValueError(f"the bossfight step kernel runs on a CUDA device, "
                         f"not {dev}")
    ins = [x.contiguous() for x in fields]
    args = [x.contiguous() for x in (barrier_pos, barrier_exists, action)]
    outs = [torch.empty((N,) + shape, dtype=dtype, device=dev)
            for _, dtype, shape in FIELDS]
    reward = torch.empty(N, dtype=_F32, device=dev)
    done = torch.empty(N, dtype=_B8, device=dev)
    ptrs = ctypes.c_void_p * len(FIELDS)
    fn = _kernel()[0]
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(ptrs(*(x.data_ptr() for x in ins)),
            ptrs(*(x.data_ptr() for x in outs)),
            *(x.data_ptr() for x in args), reward.data_ptr(),
            done.data_ptr(), N, int(sub_steps), ctypes.byref(consts), stream)
    if rc != 0:
        raise RuntimeError(f"bossfight step kernel launch failed: code {rc}")
    step.launches += 1
    return tuple(outs), reward, done


step.launches = 0  # kernel launches
