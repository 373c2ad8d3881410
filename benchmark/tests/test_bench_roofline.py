"""The benchmark's frozen count of the scene kernel's work (roofline/
scene_raw.py) against a walk over every pixel of the kernel's reads
(procgen2_tpu_torch/render/csrc/scene_kernel.cu), and the roofline share
the b1 reader makes of it."""
import numpy as np
import pytest
import torch

from benchmark import spec
from benchmark.reference.games import coinrun
from benchmark.reference.render import phases
from benchmark.roofline import peaks, scene_raw

OBS, QP = 64, 4


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16)


def _random_raw(seed, N=4, GP=40, pad=8):
    """Scene-kernel inputs with windows reaching past both edges of the
    padded grid, stamps half off the frame, dead and out-of-bank slots."""
    rng = np.random.default_rng(seed)
    kinds, themes = (1, 2, 3, 4, 5), (-1, -1, 0, 1, -1)
    TR, _, _ = phases.phase_tables(coinrun.PPU, OBS, QP)
    i32 = lambda a: np.asarray(a, np.int32)  # noqa: E731
    gridp = rng.integers(0, 6, (N, GP, GP)).astype(np.int8)
    ty0 = i32(rng.integers(-pad - 6, GP - pad - 8, N))
    tx0 = i32(rng.integers(-pad - 6, GP - pad - 8, N))
    jy, jx = i32(rng.integers(0, QP, N)), i32(rng.integers(0, QP, N))
    bg_i, theme = i32(rng.integers(0, 3, N)), i32(rng.integers(0, 2, N))
    bg_bank = _bf16(rng.integers(0, 256, (3, 3, GP, GP)))
    a = rng.random((QP * QP, len(kinds), 1, OBS, OBS))
    tile_bank = _bf16(np.concatenate(
        [rng.random((QP * QP, len(kinds), 3, OBS, OBS)) * 255 * a, a], 2))

    def group(V, P, K):
        a = rng.random((V, 1, P, P))
        bank = _bf16(np.concatenate([rng.random((V, 3, P, P)) * 255 * a, a], 1))
        return (bank, i32(rng.integers(-1, V + 1, (N, K))),
                rng.choice(np.float32([0, 1, 1, 0.5, 0.3]), (N, K)),
                i32(rng.integers(-P - 2, OBS + 3, (N, K))),
                i32(rng.integers(-P - 2, OBS + 3, (N, K))))

    groups = [group(6, 8, 5), group(4, 12, 2)]
    tr_tab = i32(TR[:, None, :])
    return (gridp, ty0, tx0, jy, jx, bg_i, theme, bg_bank, tr_tab, tile_bank,
            kinds, themes, groups, OBS, QP, pad)


def _to_torch(x):
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(x)


@pytest.mark.parametrize("seed", [4, 5])
def test_scene_work_counts_each_read_once(seed):
    args = _random_raw(seed, N=2)
    (gridp, ty0, tx0, jy, jx, bg_i, theme, bg_bank, tr_tab, tile_bank,
     kinds, themes, groups, obs, qp, pad) = args
    N, GP, _ = gridp.shape
    cells, bgs, texels, tiles = set(), set(), set(), 0
    for e in range(N):
        py, px = min(max(jy[e], 0), qp - 1), min(max(jx[e], 0), qp - 1)
        for r in range(obs):
            y = ty0[e] + pad + tr_tab[py, 0, r]
            for c in range(obs):
                x = tx0[e] + pad + tr_tab[px, 0, c]
                G = 0
                if 0 <= y < GP and 0 <= x < GP:
                    cells.add((e, y, x))
                    G = gridp[e, y, x]
                    if 0 <= bg_i[e] < bg_bank.shape[0]:
                        bgs.add((bg_i[e], y, x))
                for i, (k, th) in enumerate(zip(kinds, themes)):
                    if G == k and (th < 0 or th == theme[e]):
                        tiles += 1
                        texels.add((py, px, i, r, c))
    blends = 0
    for bank, var, scale, r0, c0 in groups:
        P = bank.shape[-1]
        for e, k in np.ndindex(var.shape):
            if scale[e, k] != 0 and 0 <= var[e, k] < bank.shape[0]:
                blends += sum(0 <= r0[e, k] + i < obs and 0 <= c0[e, k] + j < obs
                              for i in range(P) for j in range(P))
    tgroups = [tuple(_to_torch(x) for x in g) for g in groups]
    small = sum(a.nbytes for a in (ty0, tx0, jy, jx, bg_i, theme, tr_tab))
    small += sum(x.numel() * x.element_size() for g in tgroups for x in g)
    want_bytes = (len(cells) + 3 * 2 * len(bgs) + 4 * 2 * len(texels)
                  + small + N * 3 * obs * obs * 2)
    targs = [_to_torch(a) for a in args[:10]]
    got = scene_raw.work((*targs, kinds, themes, tgroups, obs, qp, pad))
    assert got == (want_bytes, scene_raw.TILE_OPS * tiles
                   + scene_raw.STAMP_OPS * blends)
    assert len(cells) < gridp.size // 2  # the windows read part of the grid


def test_bound_takes_the_larger_of_bytes_and_operations():
    assert peaks.bound(3.35e9, 0) == (1.0, "bytes")
    assert peaks.bound(0, 33.5e9) == (pytest.approx(1.0), "operations")


class _Trace:
    """A profiled slice with given scene-kernel time."""

    def __init__(self, us):
        self.us = us

    def kernel_us(self, names):
        assert names == ("scene_raw_kernel",)
        return self.us


def test_b1_reader_divides_the_bound_by_the_kernel_time():
    """The reader sums the bound of each scene_raw call the reference makes
    in the profiled calls, and divides it by the kernels' device time."""
    from benchmark.reference.render import scene_kernel as ref_scene

    r = spec.reader("b1.roofline_pct")
    hooks = []

    class Run:
        scratch = {}
        trace = None

        def during_profiled(self, h):
            hooks.append(h)

    run = Run()
    r.prepare(run)
    args = _random_raw(6, N=2)
    targs = [_to_torch(a) for a in args[:10]]
    tgroups = [tuple(_to_torch(x) for x in g) for g in args[12]]
    call = (*targs, args[10], args[11], tgroups, *args[13:])
    with hooks[0]():
        ref_scene.scene_raw(*call)
        ref_scene.scene_raw(*call)
    assert not ref_scene.OBSERVERS  # the hook removes its observer
    assert r.read(run) is None  # no trace: nothing to read
    bound_ms = peaks.bound(*scene_raw.work(call))[0]
    run.trace = _Trace(4 * bound_ms * 1e3)
    assert r.read(run) == pytest.approx(50.0)
    run.trace = _Trace(0.0)
    assert r.read(run) is None  # no such kernel ran: silent, never 0
