"""Coinrun's game step as one CUDA kernel (`render/csrc/coinrun_step.cu`,
with the tile resolver in `render/csrc/tiles.cuh`).

`games/coinrun.py::step` launches it for a state on a CUDA device; its
plain version is `coinrun.step_reference`, the torch step that CPU
tensors take and that the kernel equals bit for bit. It replaces no TPU
kernel (the JAX package's step is XLA ops): it fuses the plain step's
~12.5k small kernels a step into one launch.

The game's constants travel as arguments (`Consts`, the packed LUTs, the
out-of-grid tile id and the number of sub-steps), built by coinrun.py
from its own values, so that the kernel holds no copy of them.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..render._build import check_tensor

MAX_SLOTS = 64  # kMaxSlots in csrc/coinrun_step.cu: two slots per lane
LUT_IDS = 16  # tiles::kLutIds: a packed LUT holds tile ids 0..15


class Consts(ctypes.Structure):
    """The kernel's f32 constants (`struct Consts` in the source, in the
    same order). ctypes rounds each Python float to f32 to nearest, as
    torch rounds a Python scalar operand of an f32 tensor op."""
    _fields_ = [(name, ctypes.c_float) for name in (
        "dt", "mix_ground", "mix_air", "max_speed", "max_jump", "gravity_dt",
        "anim_dt", "down_only_vy", "sensor_dy", "mob_top", "mob_h",
        "coin_reward")]


def pack_lut(lut) -> int:
    """A collision LUT (tile id -> NONE/FULL/DOWN_ONLY) as the kernel takes
    it: 2 bits per id, id i at bits 2i and 2i + 1."""
    if len(lut) > LUT_IDS or any(int(v) not in (0, 1, 2) for v in lut):
        raise ValueError(f"a LUT of at most {LUT_IDS} types in 0..2, got "
                         f"{tuple(lut)}")
    return sum(int(v) << (2 * i) for i, v in enumerate(lut))


@functools.lru_cache(maxsize=None)
def _kernel():
    """Build (or find) and load the kernel once per process. Returns
    (launch, build record). Needs nvcc."""
    from ..render import _build

    lib, record = _build.load("coinrun_step")
    fn = lib.coinrun_step_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 24 + [ctypes.c_int] * 6
                   + [ctypes.POINTER(Consts)] + [ctypes.c_uint32] * 4
                   + [ctypes.c_int, ctypes.c_void_p])
    return fn, record


def build():
    """Build (or find) and load the kernel; returns the build record
    (seconds, compiler output). Needs nvcc."""
    return _kernel()[1]


def step(grid, pos, vel, on_ground, face_forward, anim_t, mob_pos, mob_vx,
         mob_alive, saw_pos, saw_alive, coin_pos, t, action, *, consts,
         luts, oob, sub_steps):
    """One coinrun step of every env on the card: grid int8 [N, H, W];
    pos, vel, coin_pos f32 [N, 2]; on_ground, face_forward bool [N];
    anim_t f32 [N]; mob_pos f32 [N, M, 2], mob_vx f32 [N, M], mob_alive
    bool [N, M]; saw_pos f32 [N, S, 2], saw_alive bool [N, S]; t, action
    int32 [N]; `consts` a `Consts`, `luts` the packed (agent, lava, mob
    wall sensor, mob ledge sensor) LUTs, `oob` the tile id outside the
    grid. Returns new tensors (pos, vel, on_ground, face_forward, anim_t,
    mob_pos, mob_vx, t, reward f32 [N], done bool [N]).

    Dtypes, shapes and the device are checked before anything is built
    (ValueError); every tensor must lie on one CUDA device."""
    f32, b8, i32 = torch.float32, torch.bool, torch.int32
    N, H, W = grid.shape if grid.ndim == 3 else (-1, -1, -1)
    M = mob_vx.shape[1] if mob_vx.ndim == 2 else -1
    S = saw_alive.shape[1] if saw_alive.ndim == 2 else -1
    dev = grid.device
    specs = (("grid", grid, torch.int8, (N, H, W)),
             ("pos", pos, f32, (N, 2)), ("vel", vel, f32, (N, 2)),
             ("on_ground", on_ground, b8, (N,)),
             ("face_forward", face_forward, b8, (N,)),
             ("anim_t", anim_t, f32, (N,)),
             ("mob_pos", mob_pos, f32, (N, M, 2)),
             ("mob_vx", mob_vx, f32, (N, M)),
             ("mob_alive", mob_alive, b8, (N, M)),
             ("saw_pos", saw_pos, f32, (N, S, 2)),
             ("saw_alive", saw_alive, b8, (N, S)),
             ("coin_pos", coin_pos, f32, (N, 2)),
             ("t", t, i32, (N,)), ("action", action, i32, (N,)))
    for name, x, dtype, shape in specs:
        check_tensor(x, dtype, shape, dev, name)
    if dev.type != "cuda":
        raise ValueError(f"the coinrun step kernel runs on a CUDA device, "
                         f"not {dev}")
    if min(H, W) <= 0 or not 0 <= M <= MAX_SLOTS or not 0 <= S <= MAX_SLOTS:
        raise ValueError(f"grid {H}x{W}, {M} mob and {S} saw slots: the "
                         f"kernel takes a non-empty grid and at most "
                         f"{MAX_SLOTS} slots of each")
    if len(luts) != 4:
        raise ValueError("luts: the agent's, the lava's and the two mob "
                         "sensors' packed LUTs")
    ins = [x.contiguous() for _, x, _, _ in specs]
    outs = [torch.empty((N, 2), dtype=f32, device=dev),
            torch.empty((N, 2), dtype=f32, device=dev),
            torch.empty(N, dtype=b8, device=dev),
            torch.empty(N, dtype=b8, device=dev),
            torch.empty(N, dtype=f32, device=dev),
            torch.empty((N, M, 2), dtype=f32, device=dev),
            torch.empty((N, M), dtype=f32, device=dev),
            torch.empty(N, dtype=i32, device=dev),
            torch.empty(N, dtype=f32, device=dev),
            torch.empty(N, dtype=b8, device=dev)]
    fn = _kernel()[0]
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(*(x.data_ptr() for x in ins + outs), N, H, W, M, S,
            int(sub_steps), ctypes.byref(consts), *(int(v) for v in luts),
            int(oob), stream)
    if rc != 0:
        raise RuntimeError(f"coinrun step kernel launch failed: code {rc}")
    step.launches += 1
    return tuple(outs)


step.launches = 0  # kernel launches
