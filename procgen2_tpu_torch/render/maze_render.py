"""Maze's fixed-camera render as one CUDA kernel, M1
(`csrc/maze_render.cu`).

`games/maze.py::observe_batch` launches it for states on a CUDA device
under the fixed camera (easy and hard mode); its plain version is
`maze.observe_batch_reference`, which CPU tensors and memory mode take and
which the kernel equals bit for bit. It replaces no TPU kernel (the JAX
package's render is XLA ops): it fuses the plain render's ~60 kernels a
step, most of them full-frame bf16 passes, into one launch that writes the
obs once.

The render's constants travel as arguments (`Consts`, built by maze.py
once per mode and device from the tables, backgrounds and kind images of
its plain render, with the kind codes and the layers' predicates as a
table, and the obs of the first layer alone over each background made by
the plain render's ops), so that the kernel holds no copy of them.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ._build import check_tensor

OBS = 64  # kObs in the source
LAYERS = 4  # kLayers: wall, cheese, mouse, flipped mouse
MAX_DIM = 64  # kMaxDim: the largest grid side the kernel stages
LUT_SIZE = 256  # one entry per int8 kind


@dataclasses.dataclass(frozen=True)
class Consts:
    """What the kernel reads besides the state, on the states' device."""
    tables: torch.Tensor  # int32 [2, OBS]: the grid row under each obs
    #                       row (ty), the grid column under each column (tx)
    bg_bank: torch.Tensor  # u8 [B, 3, OBS, OBS]: the backgrounds as sampled
    #                        under the fixed camera
    walled: torch.Tensor  # u8 [B, 3, OBS, OBS]: the obs of layer 0 alone
    #                       over each background, at every pixel
    kinds: torch.Tensor  # bf16 [LAYERS, 4, OBS, OBS]: each layer's kind
    #                      image in painter order, rgb then alpha
    layer_lut: torch.Tensor  # u8 [LUT_SIZE]: bit L of entry k + 128 set
    #                          where layer L blends over kind k
    cheese: int  # the goal cell's kind
    mouse: tuple  # the agent cell's kind, by flip + 2 * on_cheese


@functools.lru_cache(maxsize=None)
def _kernel():
    """Build (or find) and load the kernel once per process. Returns
    (launch, build record). Needs nvcc."""
    from . import _build

    lib, record = _build.load("maze_render")
    fn = lib.maze_render_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    return fn, record


def build():
    """Build (or find) and load the kernel; returns the build record
    (seconds, compiler output). Needs nvcc."""
    return _kernel()[1]


def pack_kinds(kinds) -> int:
    """Four int8 kinds as the kernel takes them: kind k in bits 8k to
    8k + 7, as a signed 32-bit int."""
    word = sum((int(k) & 0xff) << (8 * i) for i, k in enumerate(kinds))
    return word - (1 << 32) if word >= 1 << 31 else word


def check_consts(consts: Consts, device):
    """Raise ValueError unless `consts` has the kernel's dtypes and shapes,
    lies on `device`, is contiguous and starts on 16-byte boundaries, and
    its kind codes are int8."""
    B = consts.bg_bank.shape[0] if consts.bg_bank.ndim == 4 else -1
    for name, x, dtype, shape in (
            ("tables", consts.tables, torch.int32, (2, OBS)),
            ("bg_bank", consts.bg_bank, torch.uint8, (B, 3, OBS, OBS)),
            ("walled", consts.walled, torch.uint8, (B, 3, OBS, OBS)),
            ("kinds", consts.kinds, torch.bfloat16, (LAYERS, 4, OBS, OBS)),
            ("layer_lut", consts.layer_lut, torch.uint8, (LUT_SIZE,))):
        check_tensor(x, dtype, shape, device, name)
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and start on a "
                             f"16-byte boundary")
    if B < 1:
        raise ValueError("bg_bank holds no background")
    codes = (consts.cheese, *consts.mouse)
    if len(consts.mouse) != 4 or not all(-128 <= int(k) < 128 for k in codes):
        raise ValueError(f"the kind codes must be 1 + 4 int8 values, got "
                         f"{consts.cheese}, {consts.mouse}")


def render(grid, goal_pos, pos, face_forward, bg_index, consts: Consts):
    """The fixed camera's obs of every env: grid int8 [N, D, D] (render
    coords [y, x]); goal_pos, pos f32 [N, 2]; face_forward bool [N];
    bg_index int32 [N]; `consts` a `Consts` on the same CUDA device.
    Returns uint8 [N, 3, OBS, OBS], new.

    Dtypes, shapes and the device are checked before anything is built
    (ValueError)."""
    N = grid.shape[0] if grid.ndim == 3 else -1
    D = grid.shape[-1] if grid.ndim == 3 else -1
    dev = grid.device
    specs = (("grid", grid, torch.int8, (N, D, D)),
             ("goal_pos", goal_pos, torch.float32, (N, 2)),
             ("pos", pos, torch.float32, (N, 2)),
             ("face_forward", face_forward, torch.bool, (N,)),
             ("bg_index", bg_index, torch.int32, (N,)))
    for name, x, dtype, shape in specs:
        check_tensor(x, dtype, shape, dev, name)
    if dev.type != "cuda":
        raise ValueError(f"the maze render kernel runs on a CUDA device, "
                         f"not {dev}")
    if not 1 <= D <= MAX_DIM:
        raise ValueError(f"grid side {D}: the kernel takes 1 to {MAX_DIM}")
    check_consts(consts, dev)
    ins = [x.contiguous() for _, x, _, _ in specs]
    out = torch.empty((N, 3, OBS, OBS), dtype=torch.uint8, device=dev)
    fn = _kernel()[0]
    c = consts
    rc = fn(*(x.data_ptr() for x in ins), c.tables.data_ptr(),
            c.bg_bank.data_ptr(), c.walled.data_ptr(), c.bg_bank.shape[0],
            c.kinds.data_ptr(), c.layer_lut.data_ptr(), int(c.cheese),
            pack_kinds(c.mouse), out.data_ptr(), N, D,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"maze render kernel launch failed: code {rc}")
    render.launches += 1
    return out


render.launches = 0  # kernel launches
