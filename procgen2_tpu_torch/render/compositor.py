"""Compositor pieces of the scene path (procgen2_tpu/render/compositor.py).

Only what the quantized-camera scene render needs is here; the exact
(per-env camera) paths come with the stamp kernel."""
from __future__ import annotations

import numpy as np
import torch

OBS = 64  # observation width/height, games/maze/maze.cpp:26-27


def _premultiply_bank(pbank) -> torch.Tensor:
    """u8 [V, 4, P, P] -> premultiplied bf16 bank: rgb * a and a, with
    a = alpha / 255, computed in f32 and rounded to bf16 (RNE)."""
    pbank = torch.from_numpy(np.ascontiguousarray(pbank)).to(torch.float32)
    a_tex = pbank[:, 3:4] * (1.0 / 255.0)
    return torch.cat([pbank[:, :3] * a_tex, a_tex], dim=1).to(torch.bfloat16)
