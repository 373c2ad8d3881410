"""Scene kernels: tile layer + background + painter-order stamps of the
quantized-camera scene render.

Two entry points. `scene_raw` (B1) reads the kind field and the
background from the padded tile grid through the phase offset table;
every game on the scene path renders through it. `scene` (B5) reads them
from a pre-expanded field X instead. A CUDA tensor goes to the
hand-written Hopper kernels in `csrc/scene_kernel.cu` (they replace the
Pallas kernels `procgen2_tpu/render/scene_kernel.py::_scene_kernel_raw`
and `_scene_kernel`, with their stamp loop `_blend_stamps_ref`); a CPU
tensor goes to `scene_raw_reference` / `scene_reference`, the plain torch
versions with the same semantics. There is no fallback between the two:
on a CUDA tensor the kernel builds and launches, or the call raises.

Semantics (shared by all), per env and output pixel (r, c):
  * the kind G and the background rgb under the pixel:
      - scene_raw: y = ty0 + pad + TR[jy][r], x = tx0 + pad + TR[jx][c];
        G and rgb are grid[y, x] and bg_bank[bg_i, :, y, x], 0 where
        (y, x) lies outside the padded grid or bg_i outside the bank; jy
        and jx are clamped to [0, qp), the phase is jy * qp + jx;
      - scene: G = X[0, r, c] and rgb = X[1:4, r, c]; the phase is
        p_joint clamped to [0, NPH). G is a bf16 value compared as f32,
        G == float(entry_kind[i]): a fraction matches no entry, and -0.0
        matches kind 0;
  * each tile entry i in order, where G == entry_kind[i] and entry_theme[i]
    is -1 or the env's theme: frame = frame * (1 - a) + rgb from
    tile_bank[phase, i];
  * each stamp group (bank [V, 4, P, P], var, scale, r0, c0 [N, K]) in
    order, each slot in order: a slot with scale == 0 or var outside
    [0, V) is skipped; bank[var] is placed at (r0, c0) clipped to
    [-P, obs]; under it contrib = bf16(texel * scale) and
    frame = frame * (1 - a) + rgb.
  Every bf16 multiply, subtract and add rounds on its own (RNE).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .stamp_kernel import (_I, _IP, _P, _PP, _ints, blend_groups_reference,
                           check, check_groups, check_tiles, group_args)

_BF16 = torch.bfloat16


def _blend_tiles(frame, G, ph, theme, tile_bank, entry_kind, entry_theme):
    """The tile entries in order over `frame` bf16 [N, 3, obs, obs], where
    the kind field G [N, obs, obs] matches the entry's kind (and the env's
    theme its theme), from tile_bank[ph] (ph int [N] in range)."""
    for i, (kv, tv) in enumerate(zip(entry_kind, entry_theme)):
        m = G == int(kv)
        if tv >= 0:
            m = m & (theme == int(tv))[:, None, None]
        t = tile_bank[ph, i].to(_BF16)  # [N, 4, obs, obs]
        frame = torch.where(m[:, None], frame * (1.0 - t[:, 3:4]) + t[:, :3],
                            frame)
    return frame


def scene_raw_reference(gridp, ty0, tx0, jy, jx, bg_i, theme, bg_bank,
                        tr_tab, tile_bank, entry_kind, entry_theme, groups,
                        obs, qp, pad):
    """Plain torch version of the scene kernel (see the module docstring).

    gridp i8 [N, GP, GP]; ty0/tx0/jy/jx/bg_i/theme int [N]; bg_bank bf16
    [NB, 3, GP, GP]; tr_tab int [qp, 1, obs]; tile_bank bf16
    [qp*qp, NE, 4, obs, obs]; entry_kind/entry_theme int sequences of NE;
    groups [(bank bf16 [V, 4, P, P], var int [N, K], scale f32 [N, K],
    r0 int [N, K], c0 int [N, K])]. Returns bf16 [N, 3, obs, obs]."""
    N, GP, _ = gridp.shape
    dev = gridp.device
    NB = bg_bank.shape[0]
    tr = tr_tab.reshape(qp, obs).long()
    py = jy.long().clamp(0, qp - 1)
    px = jx.long().clamp(0, qp - 1)
    ys = ty0.long()[:, None] + pad + tr[py]  # [N, obs]
    xs = tx0.long()[:, None] + pad + tr[px]
    inb = (((ys >= 0) & (ys < GP))[:, :, None]
           & ((xs >= 0) & (xs < GP))[:, None, :])  # [N, obs, obs]
    yc = ys.clamp(0, GP - 1)
    xc = xs.clamp(0, GP - 1)
    n = torch.arange(N, device=dev)
    G = gridp[n[:, None, None], yc[:, :, None], xc[:, None, :]].long()
    G = torch.where(inb, G, torch.zeros_like(G))
    b = bg_i.long()
    bg_ok = inb & ((b >= 0) & (b < NB))[:, None, None]
    bg = bg_bank[b.clamp(0, NB - 1)[:, None, None, None],
                 torch.arange(3, device=dev)[None, :, None, None],
                 yc[:, None, :, None], xc[:, None, None, :]].to(_BF16)
    frame = torch.where(bg_ok[:, None], bg, torch.zeros_like(bg))

    frame = _blend_tiles(frame, G, py * qp + px, theme, tile_bank,
                         entry_kind, entry_theme)
    return blend_groups_reference(frame, groups)


def scene_reference(X, p_joint, theme, tile_bank, entry_kind, entry_theme,
                    groups, obs):
    """Plain torch version of the expanded-field scene kernel (see the
    module docstring).

    X bf16 [N, 4, obs, obs] (channel 0 the kind field, 1-3 the
    background rgb); p_joint/theme int [N]; tile_bank bf16
    [NPH, NE, 4, obs, obs]; entry_kind/entry_theme int sequences of NE;
    groups as `scene_raw_reference`. Returns bf16 [N, 3, obs, obs]."""
    X = X.to(_BF16)
    ph = p_joint.long().clamp(0, tile_bank.shape[0] - 1)
    frame = _blend_tiles(X[:, 1:4], X[:, 0].float(), ph, theme, tile_bank,
                         entry_kind, entry_theme)
    return blend_groups_reference(frame, groups)


# ---------------------------------------------------------------------------
# CUDA kernel binding
# ---------------------------------------------------------------------------

_MAX_ENTRIES = 32  # kMaxEntries in csrc/scene_kernel.cu
MAX_OBS = 256  # kMaxObs in csrc/scene_kernel.cu (B1 stages rows and columns)


@functools.lru_cache(maxsize=None)
def _kernels():
    """Build (or find) and load both kernels once per process. Returns
    ({"scene_raw": launch, "scene": launch}, build record); each launch
    takes inputs its wrapper has checked and writes `out`. Needs nvcc."""
    from . import _build

    lib, record = _build.load("scene_kernel")
    raw_fn = lib.scene_raw_launch
    raw_fn.restype = ctypes.c_int
    raw_fn.argtypes = ([_P] * 10 + [_IP, _IP, _I, _I] + [_PP] * 5
                       + [_IP, _IP, _IP, _P] + [_I] * 6 + [_P])
    fn = lib.scene_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([_P] * 4 + [_IP, _IP, _I, _I] + [_PP] * 5
                   + [_IP, _IP, _IP, _P] + [_I] * 3 + [_P])

    def raw_launch(gridp, ty0, tx0, jy, jx, bg_i, theme, bg_bank, tr_tab,
                   tile_bank, entry_kind, entry_theme, groups, pad, out):
        stream = torch.cuda.current_stream(gridp.device).cuda_stream
        rc = raw_fn(gridp.data_ptr(), ty0.data_ptr(), tx0.data_ptr(),
                    jy.data_ptr(), jx.data_ptr(), bg_i.data_ptr(),
                    theme.data_ptr(), bg_bank.data_ptr(), tr_tab.data_ptr(),
                    tile_bank.data_ptr(), _ints(entry_kind),
                    _ints(entry_theme), len(entry_kind), *group_args(groups),
                    out.data_ptr(), gridp.shape[0], gridp.shape[1],
                    bg_bank.shape[0], tr_tab.shape[0], out.shape[-1], pad,
                    stream)
        if rc != 0:
            raise RuntimeError(f"scene kernel launch failed: code {rc}")

    def launch(X, p_joint, theme, tile_bank, entry_kind, entry_theme,
               groups, out):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        rc = fn(X.data_ptr(), p_joint.data_ptr(), theme.data_ptr(),
                tile_bank.data_ptr(), _ints(entry_kind), _ints(entry_theme),
                len(entry_kind), *group_args(groups), out.data_ptr(),
                X.shape[0], tile_bank.shape[0], out.shape[-1], stream)
        if rc != 0:
            raise RuntimeError(f"expanded-field scene kernel launch failed: "
                               f"code {rc}")

    return dict(scene_raw=raw_launch, scene=launch), record


def build():
    """Build (or find) and load the kernels; returns the build record
    (seconds, compiler output). Needs nvcc."""
    return _kernels()[1]


def _check_entries(entry_kind, entry_theme):
    if len(entry_theme) != len(entry_kind):
        raise ValueError("entry_kind and entry_theme differ in length")
    if len(entry_kind) > _MAX_ENTRIES:
        raise ValueError(f"the kernels take at most {_MAX_ENTRIES} tile "
                         "entries")
    return [int(k) for k in entry_kind], [int(t) for t in entry_theme]


def scene_raw(gridp, ty0, tx0, jy, jx, bg_i, theme, bg_bank, tr_tab,
              tile_bank, entry_kind, entry_theme, groups, obs, qp, pad):
    """Render the scene (arguments and result as `scene_raw_reference`).
    CUDA tensors launch the kernel (dtypes and shapes are checked, nothing
    is converted); CPU tensors run the plain version."""
    if gridp.device.type == "cpu":
        return scene_raw_reference(gridp, ty0, tx0, jy, jx, bg_i, theme,
                                   bg_bank, tr_tab, tile_bank, entry_kind,
                                   entry_theme, groups, obs, qp, pad)
    if gridp.device.type != "cuda":
        raise ValueError(f"scene_raw runs on cpu or cuda, not {gridp.device}")
    dev = gridp.device
    N, GP, _ = gridp.shape
    ne = len(entry_kind)
    i32 = torch.int32
    check(gridp, torch.int8, (N, GP, GP), dev, "grid")
    for name, t in zip(("ty0", "tx0", "jy", "jx", "bg_i", "theme"),
                       (ty0, tx0, jy, jx, bg_i, theme)):
        check(t, i32, (N,), dev, name)
    check(bg_bank, _BF16, (bg_bank.shape[0], 3, GP, GP), dev, "bg_bank")
    check(tr_tab, i32, (qp, 1, obs), dev, "tr_tab")
    check(tile_bank, _BF16, (qp * qp, ne, 4, obs, obs), dev, "tile_bank")
    if obs > MAX_OBS:
        raise ValueError(f"scene_raw takes obs up to {MAX_OBS}, got {obs}")
    check_tiles(obs, ("tile_bank", tile_bank))
    kinds, themes = _check_entries(entry_kind, entry_theme)
    check_groups(groups, N, dev)
    out = torch.empty((N, 3, obs, obs), dtype=_BF16, device=dev)
    _kernels()[0]["scene_raw"](
        gridp, ty0, tx0, jy, jx, bg_i, theme, bg_bank, tr_tab, tile_bank,
        kinds, themes, groups, int(pad), out)
    scene_raw.launches += 1
    return out


scene_raw.launches = 0  # kernel launches; the CPU path does not count


def scene(X, p_joint, theme, tile_bank, entry_kind, entry_theme, groups,
          obs):
    """Render the scene from an expanded field (arguments and result as
    `scene_reference`). CUDA tensors launch the kernel (dtypes and shapes
    are checked, nothing is converted); CPU tensors run the plain
    version."""
    if X.device.type == "cpu":
        return scene_reference(X, p_joint, theme, tile_bank, entry_kind,
                               entry_theme, groups, obs)
    if X.device.type != "cuda":
        raise ValueError(f"scene runs on cpu or cuda, not {X.device}")
    dev = X.device
    N = X.shape[0]
    check(X, _BF16, (N, 4, obs, obs), dev, "X")
    check(p_joint, torch.int32, (N,), dev, "p_joint")
    check(theme, torch.int32, (N,), dev, "theme")
    check(tile_bank, _BF16, (tile_bank.shape[0], len(entry_kind), 4, obs,
                             obs), dev, "tile_bank")
    kinds, themes = _check_entries(entry_kind, entry_theme)
    check_groups(groups, N, dev)
    out = torch.empty((N, 3, obs, obs), dtype=_BF16, device=dev)
    check_tiles(obs, ("X", X), ("tile_bank", tile_bank), ("out", out))
    _kernels()[0]["scene"](X, p_joint, theme, tile_bank, kinds, themes,
                           groups, out)
    scene.launches += 1
    return out


scene.launches = 0  # kernel launches; the CPU path does not count
