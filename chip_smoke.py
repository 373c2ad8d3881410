"""Smoke test of the PyTorch port on one CUDA card: builds the port's
kernels from this checkout, holds each against its plain torch version,
drives the main paths of coinrun, bossfight, climber, caveflyer, jumper,
chaser and maze (maze at the bench's 8192 envs) at full width, drives
the render entry points of the stamp-sum and expanded-field scene kernels
on climber's real inputs, the exact-camera renders (scene_phases=0) of
coinrun, climber, caveflyer and jumper, and every game's window render
(Environment.render at 512 px), and checks the results.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero and the final
`ok` line is not printed):
  1. device: a CUDA card must be visible; prints nvidia-smi's name and
     power limit; make("coinrun") (on the card by default);
  2. build: builds the scene kernels (B1, B5) and the stamp kernels (B3,
     B4) from their two sources (nvcc, sm_90a, one compiler process each,
     started together) and prints their times and, per kernel, ptxas's
     registers, shared memory and spills;
  3. kernels vs plain on random inputs at 4096 envs, all bitwise equal:
     the raw scene kernel (B1) on coinrun's shapes; the stamp-over-frame
     kernel (B3) on bossfight's four stamp groups; the stamp-sum kernel
     (B4) on groups with P = 8, 12 and 20; the expanded-field scene kernel
     (B5) on a random scene of 5 tile entries (two themed) and two groups.
     The random groups have out-of-range variants, scale 0, fractional
     scales, stamps off every edge and overlaps. Then B3, B1 and B4 on the
     edge cases of their staged slot tables at 257 envs (edge_groups:
     K = 300, 40 live slots stacked on one pixel between dead ones, P = 40
     at every offset; B1 with themed and unthemed entries for every
     theme), and B5 on a kind field of fractions, -0.0, negative kinds,
     kinds beyond int8, infinities and NaN (edge_field), bitwise; and
     stamp groups off the kernel path (chaser's (P, K): (8, 6), (7, 6),
     (6, 6)) through `compositor.stamps_from_pixel_bank` and
     `composite_stamps`, which must launch no kernel and equal the same
     calls on the CPU (the reference's matmul semantics) bitwise;
  4. coinrun main path: generate_bank(1024) -> reset(4096) -> lanes 0-2
     placed on the coin, a saw and lava -> 8 steps writing obs into a
     uint8 [8, 4096, 64, 64, 3] buffer; the launch count shows the path
     ran the kernel; shapes, dtypes, rewards and obs are checked, and the
     coin lane must have terminated and restarted; the first 8 envs are
     re-run on the CPU through the port and must match exactly, auto-resets
     included; the scene kernel is then held against its plain version
     on the real scene inputs;
  5. where the time goes (coinrun): host wall time of each part of one
     env step, and the device kernels and device time of two steps
     (torch.profiler);
  6. bossfight main path: make("bossfight") -> generate_bank(1024) ->
     reset(4096) -> lane 0's agent placed on the boss (death, -10) and
     lane 1's boss in its last phase with its hit points gone (death, +10)
     -> 8 steps writing obs into the uint8 buffer; the stamp kernel's
     launch count, shapes, dtypes, rewards, both lanes' termination and
     restart, live boss bullets and obs are checked; the first 8 envs are
     re-run on the CPU and must match exactly at every step; the stamp
     kernel is then held against its plain version on the real render
     inputs;
  7. where the time goes (bossfight), as in 5;
  8. climber main path: make("climber") -> generate_bank(1024) ->
     reset(4096) -> a lane's agent placed on a live mob (death, 0) and
     another lane's on its last crystal with the others taken (+1 + 10)
     -> 8 steps writing obs into the uint8 buffer; the raw scene kernel's
     launches, both lanes' termination and restart on step 0, shapes,
     dtypes, rewards and obs are checked; the first 8 envs are re-run on
     the CPU and must match exactly at every step;
  9. climber's render entry points: `compositor.stamps_from_pixel_bank`
     on climber's merged crystal/mob/agent group (B4: P = 8, K = 35, on
     the kernel path) and
     `scene_kernel.scene` on climber's expanded field (B5), each launched
     once with its count set to 0 before; then B1, B4 and B5 each held
     against its plain version on these real inputs, and B5 on the
     expanded field bitwise equal to B1 on the raw inputs of the same
     state; both kernels timed against their bounds, and by ablation of
     their inputs: B5 with no stamps, no tile blend or neither, B4 with
     every slot dead;
 10. where the time goes (climber), as in 5;
 11. caveflyer main path: make("caveflyer") -> generate_bank(1024) ->
     reset(4096) -> lane 0's ship on its goal (+10) and the first other
     lane's on a meteor, target or enemy ship (death, 0) -> 8 steps
     writing obs into the uint8 buffer; the raw scene kernel's launches,
     both lanes' termination and restart on step 0, shapes, dtypes,
     rewards, obs and the envs with a live bullet are checked; the first 8
     envs are re-run on the CPU and must match exactly at every step; the
     scene kernel is then held against its plain version on caveflyer's
     real inputs (four stamp groups, the smoke at fractional scales) and
     on a hard-mode render (D = 40, 107 slots; 256 levels, reset, 2 steps);
 12. where the time goes (caveflyer), as in 5;
 13. jumper main path: make("jumper") -> generate_bank(1024) (the maze
     generator, spikes and wall breakup) -> reset(4096) -> lane 0's agent
     on its carrot (+10) and the first other lane whose level has a spike
     on that spike (death, 0) -> 8 steps writing obs into the uint8
     buffer; the launches of both kernels of its render (B1, then B3 for
     the compass needle) are counted, both lanes' termination and restart
     on step 0, shapes, dtypes, rewards and obs are checked; the first 8
     envs are re-run on the CPU and must match exactly at every step; B1
     is then held against its plain version on jumper's real scene inputs
     (the dust at fractional scales) and B3 on its needle (P = 32, K = 1)
     over the compass-blended frame, bitwise, each timed with its bound;
 14. where the time goes (jumper), as in 5, with the compass blend and
     the needle's stamp kernel as parts of their own;
 15. chaser main path: make("chaser") (easy, 11 x 11) ->
     generate_bank(1024) -> reset(4096) -> lane 0 left with nothing to
     collect (+10) and lane 1's agent under a hatched enemy (death, 0),
     both holding still on their first step -> 8 steps writing obs into
     the uint8 buffer; no kernel may launch (its render is a kind field
     and one stamp group off the kernel path), both lanes' termination and
     restart on step 0, shapes, dtypes, rewards and obs are checked; the
     first 8 envs are re-run on the CPU and must match exactly at every
     step; peak device memory;
 16. where the time goes (chaser), as in 5, with the render's parts (kind
     field, background, the 3 kind blends, the stamp group) and the
     device's idle share;
 17. maze main path at the bench's shape (procgen2_tpu/bench.py:31):
     make("maze", mode="easy") -> generate_bank(2048) -> reset(8192) ->
     lane 0 on its goal (+10) and lane 1 at its last step (terminated
     with 0), both holding still on their first step -> 8 steps into a
     uint8 [8, 8192, 64, 64, 3] buffer, checked as in 15, with the CPU
     re-run and peak device memory; where the time goes, as in 16 (the 4
     kind blends); then maze hard and memory (the agent-centred camera):
     256 levels, reset(4096), 2 steps, no kernel, the CPU re-run of 8 envs;
 19. the exact-camera main paths (scene_phases=0) of coinrun, climber,
     caveflyer and jumper: make(game, scene_phases=0) ->
     generate_bank(1024) -> reset(4096) -> the lanes of its default
     phase -> 8 steps into the uint8 buffer; the stamp kernel (B3) must
     launch once per kernel-path stamp group per render (coinrun 2,
     climber 1, caveflyer 4, jumper 1; the other groups take the matmul
     semantics) and no other kernel; the placed lanes end and restart;
     the first 8 envs are re-run on the CPU and must match at every step;
     B3 is held bitwise against its plain version on every group of the
     last render and timed against its bound; the render's host wall time;
 20. Environment.render(state, 512, env_index) of every game on the card
     (env 0 and 1 of 16, after 6 steps): no kernel launched, bitwise
     equal to the port's render of the same state on the CPU; wall time;
 21. the script's total wall time, then the kernels' JSON line (with
     each kernel's least possible time on this card, `bound_ms`), then
     the `ok` line last.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

import procgen2_tpu_torch as pt  # noqa: E402
from procgen2_tpu_torch import random as prng  # noqa: E402
from procgen2_tpu_torch.games import (bossfight, caveflyer, chaser,  # noqa: E402
                                     climber, coinrun, jumper, maze)
from procgen2_tpu_torch.render import compositor  # noqa: E402
from procgen2_tpu_torch.render import scene_kernel, stamp_kernel  # noqa: E402
from procgen2_tpu_torch.utils import (bank_gather, tree_map,  # noqa: E402
                                      tree_select)

NUM_LEVELS, NUM_ENVS, T = 1024, 4096, 8  # procgen2_tpu/tools/bench_cli.py:18
CPU_ENVS = 8
MAZE_LEVELS, MAZE_ENVS = 2048, 8192  # procgen2_tpu/bench.py:31, the headline
EDGE_ENVS = 257  # envs of the edge cases of phase 3
# H100 SXM data sheet peaks (at 700 W): device memory, and f32 outside the
# tensor cores. The sheet's 67 TFLOP/s counts a fused multiply-add as two
# operations; the kernels are built with --fmad=false and issue each
# multiply and add on its own, so they can do at most half as many.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12 / 2


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, iters):
    """Mean device time of fn() in ms (CUDA events, after one warm-up)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bitwise_diff(a, b):
    """(number of differing bf16 bit patterns, max |a - b|)."""
    n = int((a.view(torch.int16) != b.view(torch.int16)).sum())
    err = float((a.float() - b.float()).abs().max())
    return n, err


def tensor_bytes(*trees):
    """Bytes of every tensor in (nested lists/tuples of) tensors."""
    n = 0
    for t in trees:
        if isinstance(t, torch.Tensor):
            n += t.numel() * t.element_size()
        elif isinstance(t, (list, tuple)):
            n += tensor_bytes(*t)
    return n


def stamp_blends(groups, obs):
    """Number of (pixel, stamp) blends the groups' data needs: each live
    slot blends over the part of its P x P patch inside the frame."""
    n = 0
    for bank, var, scale, r0, c0 in groups:
        V, P = bank.shape[0], bank.shape[-1]
        live = (scale != 0) & (var >= 0) & (var < V)

        def span(x0):
            x0 = x0.long().clamp(-P, obs)
            return (x0 + P).clamp(max=obs) - x0.clamp(min=0)

        n += int((live * span(r0).clamp(min=0) * span(c0).clamp(min=0)).sum())
    return n


def bound(nbytes, nops):
    """Least time in ms the card could take: the larger of the bytes over
    the memory rate and the f32 operations over the f32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# 11 f32 ops per stamp blend (4 texel * scale, 1 - a, 3 multiplies, 3 adds),
# 7 per tile blend (1 - a, 3 multiplies, 3 adds), 8 per summed stamp texel
# (4 texel * scale, 4 adds)
STAMP_OPS, TILE_OPS, SUM_OPS = 11, 7, 8


def distinct(idx, valid, size):
    """Number of distinct values in idx[valid], all in [0, size)."""
    used = torch.zeros(size, dtype=torch.bool, device=idx.device)
    used[idx[valid]] = True
    return int(used.sum())


def scene_work(args):
    """(bytes, f32 operations) that one scene_raw call needs on these
    inputs. Bytes: every element the kernel reads, counted once, and the
    output written once. Of the grid and the background bank that is only
    the cells under some env's camera window, of the tile bank only the
    texels some tile blend reads; the per-env inputs, tr_tab and the stamp
    groups whole (the banks are at most 0.2 MB in all). Operations: the
    tile and stamp blends this data needs."""
    (gridp, ty0, tx0, jy, jx, bg_i, theme, bg_bank, tr_tab, tile_bank,
     kinds, themes, groups, obs, qp, pad) = args
    N, GP, _ = gridp.shape
    NB, dev = bg_bank.shape[0], gridp.device
    tr = tr_tab.reshape(qp, obs).long()
    py, px = jy.long().clamp(0, qp - 1), jx.long().clamp(0, qp - 1)
    ys = ty0.long()[:, None] + pad + tr[py]
    xs = tx0.long()[:, None] + pad + tr[px]
    inb = (((ys >= 0) & (ys < GP))[:, :, None]
           & ((xs >= 0) & (xs < GP))[:, None, :])           # [N, obs, obs]
    cell = (ys.clamp(0, GP - 1)[:, :, None] * GP
            + xs.clamp(0, GP - 1)[:, None, :])
    ncell = torch.arange(N, device=dev)[:, None, None] * GP * GP + cell
    b = bg_i.long()[:, None, None]
    bg_ok = inb & (b >= 0) & (b < NB)
    grid_cells = distinct(ncell, inb, N * GP * GP)
    bg_cells = distinct(b.clamp(0, NB - 1) * GP * GP + cell, bg_ok,
                        NB * GP * GP)
    G = torch.where(inb, gridp.reshape(-1)[ncell].long(), 0)
    npix = obs * obs
    tiles, texels = tile_work(G, py * qp + px, theme, npix, qp * qp, kinds,
                              themes)
    nbytes = (grid_cells * gridp.element_size()
              + bg_cells * 3 * bg_bank.element_size()
              + texels * 4 * tile_bank.element_size()
              + tensor_bytes(ty0, tx0, jy, jx, bg_i, theme, tr_tab, groups)
              + N * 3 * npix * 2)
    return nbytes, TILE_OPS * tiles + STAMP_OPS * stamp_blends(groups, obs)


def tile_work(G, ph, theme, npix, nph, kinds, themes):
    """(tile blends, distinct tile-bank texels read) of the tile entries
    over kind field G [N, obs, obs] at phases ph int [N] (in range)."""
    N = G.shape[0]
    texel = (ph.long()[:, None] * npix
             + torch.arange(npix, device=G.device)).expand(N, npix)
    tiles = texels = 0
    for k, th in zip(kinds, themes):
        m = G == int(k)
        if th >= 0:
            m = m & (theme == int(th))[:, None, None]
        tiles += int(m.sum())
        texels += distinct(texel, m.reshape(N, npix), nph * npix)
    return tiles, texels


def field_work(args):
    """(bytes, f32 operations) that one `scene` call (B5) needs on these
    inputs: X, p_joint, theme and the stamp groups read once whole, the
    tile-bank texels some tile blend reads, the output written once; the
    tile and stamp blends this data needs."""
    X, p_joint, theme, tile_bank, kinds, themes, groups, obs = args
    nph = tile_bank.shape[0]
    ph = p_joint.long().clamp(0, nph - 1)
    tiles, texels = tile_work(X[:, 0].float(), ph, theme, obs * obs, nph,
                              kinds, themes)
    nbytes = (tensor_bytes(X, p_joint, theme, groups)
              + texels * 4 * tile_bank.element_size()
              + X.shape[0] * 3 * obs * obs * 2)
    return nbytes, TILE_OPS * tiles + STAMP_OPS * stamp_blends(groups, obs)


def sum_bound(group, obs):
    """(bound_ms, bound_by) of one `stamps` call (B4): the group read once
    (its bank whole), the 4-channel frame written once; the summed stamp
    texels this data needs."""
    N = group[1].shape[0]
    nbytes = tensor_bytes(group) + N * 4 * obs * obs * 2
    return bound(nbytes, SUM_OPS * stamp_blends([group], obs))


def scene_bound(args):
    """(bound_ms, bound_by) of one scene_raw call on these inputs."""
    return bound(*scene_work(args))


def stamp_bound(img, groups):
    """(bound_ms, bound_by) of one stamp-kernel call on these inputs: the
    frame and the groups read once (banks whole: at most 0.2 MB), the frame
    written once; the stamp blends this data needs."""
    nbytes = tensor_bytes(img, groups) + img.numel() * img.element_size()
    return bound(nbytes, STAMP_OPS * stamp_blends(groups, img.shape[-1]))


def random_scene(n, dev, seed=0):
    """Random scene-kernel inputs with coinrun's shapes, including grid
    windows that leave the padded grid, out-of-range bg and var indices,
    scale 0 and fractional scales, and stamps hanging off every edge."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)

    def rf(shape):
        return torch.rand(shape, generator=g, device=dev)

    ST = coinrun._scene_tensors(4, str(dev))
    kinds, themes = ST["kinds"], ST["themes"]
    ne, nb, gp, obs, qp, pad = len(kinds), 49, 96, 64, 4, 16
    palette = torch.tensor([0] + list(kinds), dtype=torch.int8, device=dev)
    gridp = palette[ri(0, len(palette), (n, gp, gp)).long()]
    ty0, tx0 = ri(-pad - 8, 64 + 8, (n,)), ri(-pad - 8, 64 + 8, (n,))
    jy, jx = ri(0, qp, (n,)), ri(0, qp, (n,))
    bg_i, theme = ri(-1, nb + 1, (n,)), ri(0, 6, (n,))
    bg_bank = ri(0, 256, (nb, 3, gp, gp)).to(torch.bfloat16)
    a = rf((qp * qp, ne, 1, obs, obs))
    tile_bank = torch.cat([rf((qp * qp, ne, 3, obs, obs)) * 255 * a, a],
                          dim=2).to(torch.bfloat16)
    groups = [random_group(g, n, dev, 39, 8, 17, obs),
              random_group(g, n, dev, 40, 12, 1, obs)]
    return (gridp, ty0, tx0, jy, jx, bg_i, theme, bg_bank, ST["tr_tab"],
            tile_bank, kinds, themes, groups, obs, qp, pad)


def random_group(g, n, dev, V, P, K, obs):
    """A random stamp group: a premultiplied bf16 bank [V, 4, P, P]; var in
    [-1, V] (both ends out of range); scales 0, 1, 0.5 and 0.3; r0/c0 in
    [-P - 2, obs + 2] (stamps off and across every edge); where K > 1,
    slot 1 overlaps slot 0, two pixels down and right."""
    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)

    a = torch.rand((V, 1, P, P), generator=g, device=dev)
    bank = torch.cat([torch.rand((V, 3, P, P), generator=g, device=dev)
                      * 255 * a, a], dim=1).to(torch.bfloat16)
    scales = torch.tensor([0.0, 1.0, 1.0, 1.0, 0.5, 0.3], device=dev)
    r0, c0 = ri(-P - 2, obs + 3, (n, K)), ri(-P - 2, obs + 3, (n, K))
    if K > 1:
        r0[:, 1] = r0[:, 0] + 2
        c0[:, 1] = c0[:, 0] + 2
    return (bank, ri(-1, V + 1, (n, K)),
            scales[ri(0, len(scales), (n, K)).long()].contiguous(), r0, c0)


def bossfight_group_shapes():
    """(V, P, K) of bossfight's four stamp groups, in painter order
    (bossfight._stamp_groups)."""
    banks = bossfight._stamp_banks()
    ks = {"barbb": bossfight.MAX_BARRIERS + bossfight.BB_CULL,
          "bosshield": 1, "dmg": bossfight.NUM_EXPLOSIONS,
          "abship": bossfight.AB_CULL + 1}
    return [(banks[k].shape[0], banks[k].shape[-1], K) for k, K in ks.items()]


def random_stamps(n, dev, seed=0):
    """Random stamp-kernel inputs: a bf16 frame [n, 3, 64, 64] of whole
    values in [0, 255] and bossfight's four stamp groups (random_group)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    img = torch.randint(0, 256, (n, 3, 64, 64), generator=g, device=dev,
                        dtype=torch.int32).to(torch.bfloat16)
    return img, [random_group(g, n, dev, V, P, K, 64)
                 for V, P, K in bossfight_group_shapes()]


EDGE_CASES = ("k300", "stacked", "p40")


STACKED = ((5, 8, 48), (4, 12, 32))  # (V, P, K) of the "stacked" groups
SUM_STACKED = ((5, 8, 80),)  # B4 takes one group: its 40 live slots


def edge_groups(case, n, dev, seed=0, obs=64, stacked=STACKED):
    """Stamp groups at the edges of the staged slot tables of the kernels
    (csrc/stamps.cuh), with live slots at fractional scales so that the
    order of their blends or sums shows:
      * "k300": one group of K = 300 (P = 8): more slots than one staging
        pass takes (256); slots 250-261 are live and stacked across the
        pass boundary;
      * "stacked": one group per (V, P, K) of `stacked` (by default two,
        P = 8, K = 48 and P = 12, K = 32; SUM_STACKED is one group of
        K = 80) whose even slots, 40 in all, are live and cover pixel
        (29, 35); the odd slots between them are dead (scale 0, var -1,
        var V, or off the frame);
      * "p40": one group of P = 40 with a slot at every row offset from -P-1
        to obs+1 and every column offset, shifted per env, so that P = 40
        stamps start and end at every column of a lane's 8-pixel run and
        at every row and column of a warp's 16 x 16 region."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)

    def fractions(shape):
        return 0.25 + 0.75 * torch.rand(shape, generator=g, device=dev)

    if case == "k300":
        bank, var, scale, r0, c0 = random_group(g, n, dev, 6, 8, 300, obs)
        stack = slice(250, 262)
        var[:, stack] = ri(0, 6, (n, 12))
        scale[:, stack] = fractions((n, 12))
        r0[:, stack] = 20 + ri(-3, 4, (n, 12))
        c0[:, stack] = 30 + ri(-3, 4, (n, 12))
        return [(bank, var, scale, r0, c0)]
    if case == "stacked":
        groups = []
        for V, P, K in stacked:
            bank, var, scale, r0, c0 = random_group(g, n, dev, V, P, K, obs)
            live = slice(0, K, 2)
            var[:, live] = ri(0, V, (n, K // 2))
            scale[:, live] = fractions((n, K // 2))
            r0[:, live] = 29 - ri(0, P, (n, K // 2))
            c0[:, live] = 35 - ri(0, P, (n, K // 2))
            # dead slot kinds 0-3 in turn: scale 0, var -1, var V, a live
            # slot placed below the frame
            kind = ((torch.arange(K // 2, device=dev)[None]
                     + torch.arange(n, device=dev)[:, None]) % 4)
            scale[:, 1::2] = torch.where(kind == 0, 0.0, 1.0)
            var[:, 1::2] = torch.where(kind == 1, -1, torch.where(
                kind == 2, V, 0)).to(torch.int32)
            r0[:, 1::2] = torch.where(kind == 3, obs, r0[:, 1::2]).to(torch.int32)
            groups.append((bank, var, scale, r0, c0))
        return groups
    if case == "p40":
        P, span = 40, obs + 40 + 3
        bank, var, scale, r0, c0 = random_group(g, n, dev, 3, P, span, obs)
        k = torch.arange(span, device=dev)[None]
        e = torch.arange(n, device=dev)[:, None]
        r0 = (-P - 1 + k).expand(n, span).to(torch.int32).contiguous()
        c0 = (-P - 1 + (k * 37 + e * 13) % span).to(torch.int32)
        scale = torch.where(scale == 0.0, fractions((n, span)), scale)
        return [(bank, var, scale.contiguous(), r0, c0)]
    raise ValueError(f"unknown edge case {case!r}")


def edge_sum_group(case, n, dev, seed=0):
    """B4's input for an edge case: the one group of edge_groups, for
    "stacked" the one group of SUM_STACKED (40 live slots on pixel
    (29, 35) in one group)."""
    (group,) = edge_groups(case, n, dev, seed, stacked=SUM_STACKED)
    return group


def edge_stamps(case, n, dev, seed=0):
    """B3's inputs for an edge case: a bf16 frame [n, 3, 64, 64] of whole
    values in [0, 255] and the case's groups (edge_groups)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 1000)
    img = torch.randint(0, 256, (n, 3, 64, 64), generator=g, device=dev,
                        dtype=torch.int32).to(torch.bfloat16)
    return img, edge_groups(case, n, dev, seed)


EDGE_THEMES = 6  # as coinrun's wall themes


def edge_entries():
    """Tile entries, themed and unthemed, for every theme: kinds 1 and 2
    for each theme in turn, then unthemed kinds 1 (after the themed ones:
    two blends in order on a kind-1 cell), 3, -5 (a negative int8 kind) and
    0 (the kind of a cell outside the grid)."""
    kinds, themes = [], []
    for t in range(EDGE_THEMES):
        kinds += [1, 2]
        themes += [t, t]
    return tuple(kinds + [1, 3, -5, 0]), tuple(themes + [-1, -1, -1, -1])


def edge_scene(case, n, dev, seed=0):
    """B1's inputs for an edge case: coinrun's shapes, the entries of
    edge_entries on a grid of kinds 0, 1, 2, 3, -5 and 7 (7 matches no
    entry), env themes in [-1, EDGE_THEMES] (both ends match no themed
    entry), windows that leave the padded grid, backgrounds in range, and
    the case's groups (edge_groups)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 2000)

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)

    kinds, themes = edge_entries()
    ne, nb, gp, obs, qp, pad = len(kinds), 3, 96, 64, 4, 16
    palette = torch.tensor([0, 1, 2, 3, -5, 7], dtype=torch.int8, device=dev)
    gridp = palette[ri(0, len(palette), (n, gp, gp)).long()]
    ty0, tx0 = ri(-pad - 8, 64 + 8, (n,)), ri(-pad - 8, 64 + 8, (n,))
    jy, jx = ri(0, qp, (n,)), ri(0, qp, (n,))
    bg_i, theme = ri(0, nb, (n,)), ri(-1, EDGE_THEMES + 1, (n,))
    bg_bank = ri(0, 256, (nb, 3, gp, gp)).to(torch.bfloat16)
    a = torch.rand((qp * qp, ne, 1, obs, obs), generator=g, device=dev)
    tile_bank = torch.cat([torch.rand((qp * qp, ne, 3, obs, obs), generator=g,
                                      device=dev) * 255 * a, a],
                          dim=2).to(torch.bfloat16)
    tr_tab = coinrun._scene_tensors(qp, str(dev))["tr_tab"]
    return (gridp, ty0, tx0, jy, jx, bg_i, theme, bg_bank, tr_tab, tile_bank,
            kinds, themes, edge_groups(case, n, dev, seed), obs, qp, pad)


# kinds of edge_field's kind channel: integers in int8 (-0.0 among them),
# fractions, integers beyond int8, infinities and a NaN
ODD_KINDS = (0.0, -0.0, 1.0, 2.0, 3.0, -5.0, 7.0, -128.0, 127.0, 0.5, -0.5,
             1.5, -2.25, 127.5, 128.0, -130.0, 200.0, 1000.0, float("inf"),
             float("-inf"), float("nan"))
BIG_KINDS = (128, -130, 1000)  # entry kinds beyond int8, unthemed


def edge_field(n, dev, seed=0):
    """B5's inputs at the edges of its kind lookup: the entries of
    edge_entries, then unthemed entries of the kinds BIG_KINDS; a kind
    channel of ODD_KINDS (as bf16); backgrounds of whole values in
    [0, 255]; joint phases in [-1, NPH] and env themes in
    [-1, EDGE_THEMES]; two random stamp groups (random_group)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 3000)

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)

    kinds, themes = edge_entries()
    kinds, themes = kinds + BIG_KINDS, themes + (-1,) * len(BIG_KINDS)
    obs, nph, ne = 64, 4, len(kinds)
    palette = torch.tensor(ODD_KINDS, device=dev)
    X = torch.cat([palette[ri(0, len(ODD_KINDS), (n, 1, obs, obs)).long()],
                   ri(0, 256, (n, 3, obs, obs)).float()],
                  dim=1).to(torch.bfloat16)
    a = torch.rand((nph, ne, 1, obs, obs), generator=g, device=dev)
    tile_bank = torch.cat([torch.rand((nph, ne, 3, obs, obs), generator=g,
                                      device=dev) * 255 * a, a],
                          dim=2).to(torch.bfloat16)
    groups = [random_group(g, n, dev, 6, 8, 5, obs),
              random_group(g, n, dev, 4, 12, 2, obs)]
    return (X, ri(-1, nph + 1, (n,)), ri(-1, EDGE_THEMES + 1, (n,)),
            tile_bank, kinds, themes, groups, obs)


SUM_GROUP_SHAPES = ((6, 8, 17), (5, 12, 9), (4, 20, 5))  # (V, P, K)


def random_sum_groups(n, dev, seed=0):
    """Random stamp-sum inputs: one group per (V, P, K) of
    SUM_GROUP_SHAPES (random_group)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return [random_group(g, n, dev, V, P, K, 64) for V, P, K in SUM_GROUP_SHAPES]


def random_field(n, dev, seed=0):
    """Random inputs of `scene` (B5), shaped like the JAX package's
    tests/test_scene_kernel.py::_random_scene: 5 tile entries (two themed),
    a kind field of values 0..5 and a background of whole values in
    [0, 255]; joint phases in [-1, NPH] (both ends out of range), themes 0
    and 1; two stamp groups (random_group)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)

    obs, nph, ne = 64, 16, 5
    kinds, themes = tuple(range(1, ne + 1)), (-1, -1, 0, 1, -1)
    X = torch.cat([ri(0, ne + 1, (n, 1, obs, obs)),
                   ri(0, 256, (n, 3, obs, obs))], dim=1).to(torch.bfloat16)
    a = torch.rand((nph, ne, 1, obs, obs), generator=g, device=dev)
    tile_bank = torch.cat([torch.rand((nph, ne, 3, obs, obs), generator=g,
                                      device=dev) * 255 * a, a],
                          dim=2).to(torch.bfloat16)
    groups = [random_group(g, n, dev, 6, 8, 5, obs),
              random_group(g, n, dev, 4, 12, 2, obs)]
    return (X, ri(-1, nph + 1, (n,)), ri(0, 2, (n,)), tile_bank, kinds,
            themes, groups, obs)


def vs_plain(what, kernel, plain, args, iters):
    """Bitwise check and times of a kernel's wrapper vs its plain version
    on `args` (a tuple result is compared as one tensor). These launches
    are not the main path's and are not counted there."""
    def run(fn):
        out = fn(*args)
        return torch.cat(out, dim=1) if isinstance(out, tuple) else out

    got, want = run(kernel), run(plain)
    torch.cuda.synchronize()
    ndiff, err = bitwise_diff(got, want)
    if ndiff:
        raise AssertionError(f"{what} differs from its plain version in "
                             f"{ndiff} values (max abs err {err})")
    ms = cuda_ms(lambda: kernel(*args), iters)
    plain_ms = cuda_ms(lambda: plain(*args), 3)
    return err, ms, plain_ms


def edges_vs_plain(n, dev):
    """Each kernel on the edge cases of its staged slot table at n envs,
    bitwise equal to its plain version: B3 and B1 on edge_stamps and
    edge_scene, B4 on edge_sum_group, for each case; B5 on edge_field's
    odd kinds. These launches are not the main path's and are not counted
    there."""
    def same(what, kernel, plain, args, case):
        got, want = kernel(*args), plain(*args)
        if isinstance(got, tuple):
            got, want = torch.cat(got, dim=1), torch.cat(want, dim=1)
        torch.cuda.synchronize()
        ndiff, err = bitwise_diff(got, want)
        if ndiff:
            raise AssertionError(f"{what} differs from its plain version on "
                                 f"edge case {case} in {ndiff} values (max "
                                 f"abs err {err})")

    for case in EDGE_CASES:
        same("stamp kernel", stamp_kernel.composite,
             stamp_kernel.composite_reference, edge_stamps(case, n, dev), case)
        same("scene kernel", scene_kernel.scene_raw,
             scene_kernel.scene_raw_reference, edge_scene(case, n, dev), case)
        same("stamp-sum kernel", stamp_kernel.stamps,
             stamp_kernel.stamps_reference,
             (*edge_sum_group(case, n, dev), 64), case)
    same("expanded-field scene kernel", scene_kernel.scene,
         scene_kernel.scene_reference, edge_field(n, dev), "odd kinds")
    log(f"edge cases {', '.join(EDGE_CASES)} at N={n}: the stamp, scene and "
        f"stamp-sum kernels bitwise equal to their plain versions; the "
        f"expanded-field scene kernel on odd kinds ({len(ODD_KINDS)} kind "
        f"values: fractions, -0.0, beyond int8, infinities, NaN) too")


def off_kernel_groups(n, dev):
    """Stamp groups off the kernel path (compositor.stamp_kernel_ok false:
    chaser's (P, K) of (8, 6), (7, 6) and (6, 6)) through
    `stamps_from_pixel_bank` and `composite_stamps` on the card, with
    overlapping stamps and alphas 1, 0.7 and 0.3: no kernel launches, and
    the results bitwise equal to the same functions on the CPU (the
    reference's matmul semantics)."""
    g = torch.Generator(device=dev)
    g.manual_seed(4000)
    for P in (8, 7, 6):
        K = 6
        if compositor.stamp_kernel_ok(P, K):
            raise AssertionError(f"(P, K) = ({P}, {K}) is on the kernel path")
        bank, var, _, r0, c0 = random_group(g, n, dev, 5, P, K, 64)
        r0 = (r0[:, :1] + torch.randint(0, 6, (n, K), generator=g,
                                        device=dev)).to(torch.int32)
        c0 = (c0[:, :1] + torch.randint(0, 6, (n, K), generator=g,
                                        device=dev)).to(torch.int32)
        alives = torch.rand((n, K), generator=g, device=dev) < 0.8
        alpha = torch.tensor([1.0, 0.7, 0.3], device=dev)[torch.randint(
            0, 3, (n, K), generator=g, device=dev)]
        img = torch.randint(0, 256, (n, 3, 64, 64), generator=g, device=dev,
                            dtype=torch.int32).to(torch.bfloat16)
        args = (bank, var, r0, c0)
        kw = dict(alives=alives, alpha=alpha)
        before = (stamp_kernel.stamps.launches, stamp_kernel.composite.launches)
        got = (*compositor.stamps_from_pixel_bank(*args, **kw),
               compositor.composite_stamps(img, *args, **kw))
        torch.cuda.synchronize()
        if (stamp_kernel.stamps.launches,
                stamp_kernel.composite.launches) != before:
            raise AssertionError(f"an off-kernel group (P = {P}) launched a "
                                 "stamp kernel")
        cpu = [t.cpu() for t in args]
        ckw = {k: v.cpu() for k, v in kw.items()}
        want = (*compositor.stamps_from_pixel_bank(*cpu, **ckw),
                compositor.composite_stamps(img.cpu(), *cpu, **ckw))
        for a, b in zip(got, want):
            ndiff, err = bitwise_diff(a.cpu(), b)
            if ndiff:
                raise AssertionError(f"an off-kernel group (P = {P}) differs "
                                     f"on the card from the CPU in {ndiff} "
                                     f"values (max abs err {err})")
        if not bool((got[1] != 0).any()):
            raise AssertionError("the off-kernel groups drew nothing")
    log(f"off-kernel stamp groups (P, K) = (8, 6), (7, 6), (6, 6) at N={n}: "
        f"no kernel launched; stamps_from_pixel_bank and composite_stamps "
        f"bitwise equal to the CPU's matmul semantics")


def scene_vs_plain(args, iters):
    return vs_plain("scene kernel", scene_kernel.scene_raw,
                    scene_kernel.scene_raw_reference, args, iters)


def sum_vs_plain(group, iters):
    return vs_plain("stamp-sum kernel", stamp_kernel.stamps,
                    stamp_kernel.stamps_reference, (*group, 64), iters)


def field_vs_plain(args, iters):
    return vs_plain("expanded-field scene kernel", scene_kernel.scene,
                    scene_kernel.scene_reference, args, iters)


def ablations(field, group, iters=20):
    """Where B5's and B4's time goes on these inputs, by taking work out of
    the inputs (the kernels run as they are): B5 with no stamp groups,
    with entry kinds that match no pixel (no tile blend), and with
    neither (X read, masks found, output written); B4 with every slot
    dead (the frame written as zeros). Returns {name: ms}."""
    X, p_joint, theme, tile_bank, kinds, themes, groups, obs = field
    no_match = tuple(1000 + i for i in range(len(kinds)))
    bank, var, scale, r0, c0 = group
    cases = {
        "B5 without stamps": (scene_kernel.scene, (
            X, p_joint, theme, tile_bank, kinds, themes, [], obs)),
        "B5 without tile blends": (scene_kernel.scene, (
            X, p_joint, theme, tile_bank, no_match, themes, groups, obs)),
        "B5 without either": (scene_kernel.scene, (
            X, p_joint, theme, tile_bank, no_match, themes, [], obs)),
        "B4 with every slot dead": (stamp_kernel.stamps, (
            bank, var, torch.zeros_like(scale), r0, c0, obs)),
    }
    return {name: cuda_ms(lambda: fn(*args), iters)
            for name, (fn, args) in cases.items()}


def stamps_vs_plain(img, groups, iters):
    """Bitwise check and times of the stamp kernel vs its plain version,
    and one launch over all groups against one launch per group in turn.
    These launches are not the main path's and are not counted there."""
    got = stamp_kernel.composite(img, groups)
    seq = img
    for group in groups:
        seq = stamp_kernel.composite(seq, [group])
    torch.cuda.synchronize()
    if bitwise_diff(got, seq)[0]:
        raise AssertionError("one stamp-kernel launch over all groups "
                             "differs from one launch per group")
    return vs_plain("stamp kernel", stamp_kernel.composite,
                    stamp_kernel.composite_reference, (img, groups), iters)


def place_on_hazards(gs, n):
    """Of the first n lanes of a coinrun State: lane 0 on its coin, the
    first other lane with a live saw on that saw, the first other lane
    with lava standing in it; their velocities zeroed. The lanes chosen
    depend only on the first n lanes, so a state and its first n lanes on
    another device get the same placement. Returns (state, lanes)."""
    lv = gs.level
    pos, vel = gs.pos.clone(), gs.vel.clone()
    up = torch.tensor([0.0, 0.5], device=pos.device)
    pos[0] = lv.coin_pos[0] + up
    lanes = [0]
    alive = lv.saw_alive[:n].cpu()
    saws = [i for i in range(1, n) if bool(alive[i].any())]
    if saws:
        i = saws[0]
        pos[i] = lv.saw_pos[i, int(alive[i].int().argmax())] + up
        lanes.append(i)
    lava_top = (lv.grid[:n] == coinrun.LAVA_TOP).cpu()
    lava = [i for i in range(1, n) if i not in lanes and bool(lava_top[i].any())]
    if lava:
        i = lava[0]
        ry, x = torch.nonzero(lava_top[i])[0].tolist()
        pos[i] = torch.tensor([x + 0.5, ry + 1.0], device=pos.device)
        lanes.append(i)
    vel[lanes] = 0.0
    return dataclasses.replace(gs, pos=pos, vel=vel), lanes


def place_boss_deaths(gs):
    """Of a bossfight State: lane 0's agent on its boss (contact: -10 on
    the first sub-step), and lane 1's boss in its last phase (5) with no
    hit points left and its damage show over, mid-phase so that no
    phase-start re-roll restores them (+10 on the first sub-step).
    Returns (state, lanes)."""
    pos, phase_index = gs.pos.clone(), gs.phase_index.clone()
    phase_timer, hp = gs.phase_timer.clone(), gs.hp.clone()
    damage_timer = gs.damage_timer.clone()
    pos[0] = gs.boss_pos[0]
    phase_index[1], phase_timer[1], hp[1] = 5, 1.0, 0
    damage_timer[1] = bossfight.DAMAGE_TIME
    return dataclasses.replace(
        gs, pos=pos, phase_index=phase_index, phase_timer=phase_timer, hp=hp,
        damage_timer=damage_timer), [0, 1]


def place_climber_lanes(gs, n):
    """Of the first n lanes of a climber State: the first lane with a live
    mob on that mob (its rect 0.3 below the mob's centre: contact, and no
    crystal), the first other lane on its last crystal with every other
    crystal taken (+1 + 10); their velocities zeroed. The lanes chosen
    depend only on the first n lanes. Returns (state, lanes)."""
    lv = gs.level
    pos, vel, taken = gs.pos.clone(), gs.vel.clone(), gs.point_taken.clone()
    alive = lv.mob_alive[:n].cpu()
    mob = next(i for i in range(n) if bool(alive[i].any()))
    pos[mob] = (gs.mob_pos[mob, int(alive[mob].int().argmax())]
                + torch.tensor([0.0, 0.3], device=pos.device))
    crys = next(i for i in range(n) if i != mob)
    last = int(lv.point_exists[crys].sum()) - 1
    taken[crys] = lv.point_exists[crys]
    taken[crys, last] = False
    pos[crys] = lv.point_pos[crys, last] + torch.tensor([0.0, 0.5],
                                                        device=pos.device)
    vel[[mob, crys]] = 0.0
    return dataclasses.replace(gs, pos=pos, vel=vel, point_taken=taken), \
        [mob, crys]


def place_caveflyer_lanes(gs, n):
    """Of the first n lanes of a caveflyer State: lane 0's ship on its
    goal (+10), and the first other lane with a meteor, else a live
    target, else an enemy ship, on that hazard (death, 0). Their
    velocities are zeroed. The lanes chosen depend only on the first n
    lanes. Raises ValueError if none of lanes 1..n-1 has a hazard (an
    easy cave often has none; after a reset every existing target is
    alive, so no state the game reaches has one to place). Returns
    (state, lanes)."""
    lv = gs.level
    pos, vel = gs.pos.clone(), gs.vel.clone()
    pos[0] = lv.goal_pos[0]
    hazards = ((lv.obst_pos, lv.obst_exists), (lv.target_pos, gs.target_alive),
               (gs.enemy_pos, lv.enemy_exists))
    found = [(i, where[i, int(alive[i].int().argmax())])
             for i in range(1, n) for where, alive in hazards
             if bool(alive[i].any())]
    if not found:
        raise ValueError(f"no hazard in caveflyer lanes 1..{n - 1}")
    lane, spot = found[0]
    pos[lane] = spot
    lanes = [0, lane]
    vel[lanes] = 0.0
    return dataclasses.replace(gs, pos=pos, vel=vel), lanes


def place_jumper_lanes(gs, n):
    """Of the first n lanes of a jumper State: lane 0's agent on its carrot
    (half a unit below the goal's centre, so its rect lies in the goal
    cell: +10), and the first other lane whose level has a spike, on that
    spike ((x + 0.5, ry + 0.9) for the spike at render cell (ry, x): its
    rect overlaps the spike's whatever the first action; death, 0), a
    spike whose cell above is not the goal's. Velocities are zeroed. The
    lanes chosen depend only on the first n lanes. Raises ValueError if
    none of lanes 1..n-1 has such a spike. Returns (state, lanes)."""
    lv = gs.level
    pos, vel = gs.pos.clone(), gs.vel.clone()
    pos[0] = lv.goal_pos[0] + torch.tensor([0.0, 0.5], device=pos.device)
    spikes = lv.spike_grid[:n].cpu()
    goal = lv.goal_pos[:n].cpu()
    found = [(i, ry, x) for i in range(1, n)
             for ry, x in torch.nonzero(spikes[i]).tolist()
             if (x + 0.5, ry - 0.5) != tuple(goal[i].tolist())]
    if not found:
        raise ValueError(f"no spike in jumper lanes 1..{n - 1}")
    lane, ry, x = found[0]
    pos[lane] = torch.tensor([x + 0.5, ry + 0.9], device=pos.device)
    lanes = [0, lane]
    vel[lanes] = 0.0
    return dataclasses.replace(gs, pos=pos, vel=vel), lanes


def place_chaser_lanes(gs):
    """Of a chaser State: lane 0 with every pellet eaten and every orb
    taken (nothing left: +10, done) and lane 1 with its first enemy
    hatched on the agent while nothing is eaten (death, 0). Both take a
    first action that does not move (`hold_first_action`), so lane 1
    collects nothing as it dies. Returns (state, lanes)."""
    points, orbs = gs.point_grid.clone(), gs.orb_taken.clone()
    points[0] = False
    orbs[0] = True
    mob_pos, hatch = gs.mob_pos.clone(), gs.hatch_timer.clone()
    eat = gs.eat_timer.clone()
    mob_pos[1, 0] = gs.pos[1]
    hatch[1, 0] = chaser.HATCH_TIME
    eat[1] = 0.0
    return dataclasses.replace(gs, point_grid=points, orb_taken=orbs,
                               mob_pos=mob_pos, hatch_timer=hatch,
                               eat_timer=eat), [0, 1]


def place_maze_lanes(gs, cfg):
    """Of a maze State: lane 0's agent on its goal (+10 with a first
    action that does not move, `hold_first_action`) and lane 1 at its
    last step before the timeout (terminated with 0: its start is never
    the goal). Returns (state, lanes)."""
    pos, t = gs.pos.clone(), gs.t.clone()
    pos[0] = gs.level.goal_pos[0]
    t[1] = cfg.timeout - 1
    return dataclasses.replace(gs, pos=pos, t=t), [0, 1]


def hold_first_action(actions, lanes):
    """`actions` [T, N] with the placed lanes' first action 4 (no move)."""
    actions = actions.clone()
    actions[0, lanes] = 4
    return actions


def wall_ms(fn, iters=5):
    """Mean host wall time of fn() in ms, device synchronised, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def breakdown(env, bank, state, action, obs_buf, render_parts):
    """Where one env step's time goes: host wall ms of each part of
    `Environment.step` on the same state (the render's parts from
    `render_parts`), then the device kernels and summed device time of two
    whole steps under torch.profiler, and the device's idle share of the
    step (1 - device ms / (2 x the whole step's wall ms)). Returns
    {"step_ms", "device_ms", "kernels", "idle"} (device numbers None
    where the profiler saw no device events)."""
    game, cfg, gs = env.game, env.cfg, state.game
    n_levels = env._num_levels(bank)
    n_envs = state.ep_length.shape[0]
    done = torch.zeros_like(state.ep_length, dtype=torch.bool)
    done[::7] = True
    k = prng.split(state.rng, 3)
    planar = game.observe_batch(cfg, gs)

    def auto_reset():
        kk = prng.split(state.rng, 3)
        idx = prng.randint(kk[:, 1], (), 0, n_levels)
        fresh = game.reset(cfg, bank_gather(bank, idx.long()), kk[:, 2])
        return tree_select(done, fresh, gs)

    parts = [
        ("env.step (whole step, render included)",
         lambda: env.step(bank, state, action)),
        ("game step (physics)",
         lambda: game.step(cfg, gs, action)),
        ("auto-reset: split + randint + gather + reset + select", auto_reset),
        ("  of which one randint draw",
         lambda: prng.randint(k[:, 1], (), 0, n_levels)),
        *render_parts,
        ("hwc copy into the obs buffer",
         lambda: obs_buf[0].copy_(planar.permute(0, 2, 3, 1))),
    ]
    log(f"{game.NAME} breakdown at {n_envs} envs (host wall ms per call, "
        "mean of 5):")
    times = {}
    for name, fn in parts:
        times[name] = wall_ms(fn)
        log(f"  {name}: {times[name]:.3f} ms")
    step_ms = times[parts[0][0]]

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        st = state
        for _ in range(2):
            st, _ = env.step(bank, st, action)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    out = dict(step_ms=step_ms, device_ms=None, kernels=None, idle=None)
    if kernels:
        dev_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
        out.update(device_ms=dev_ms, kernels=len(kernels),
                   idle=1.0 - dev_ms / (2 * step_ms))
        log(f"{game.NAME} profiler, 2 env steps: {len(kernels)} device "
            f"kernels, {dev_ms:.3f} ms summed device time; device idle "
            f"{100 * out['idle']:.1f}% of 2 x {step_ms:.3f} ms")
        by_name = {}
        for e in kernels:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
        for name, (n, us) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][1])[:4]:
            log(f"  device time by kernel: {us / 1e3:.3f} ms in {n} "
                f"launches of {name[:100]}")
    else:
        log(f"{game.NAME} profiler, 2 env steps: no device events (device "
            "time not measured)")
    return out


def same_tree(a, b, what):
    bad = []
    tree_map(lambda x, y: bad.append(tuple(x.shape))
             if not torch.equal(x.cpu(), y.cpu()) else None, a, b)
    if bad:
        raise AssertionError(f"{what}: GPU and CPU differ in leaves of "
                             f"shapes {bad}")


def make_bank(env, n_levels=NUM_LEVELS):
    """generate_bank(n_levels) twice from key(0): the second call's bank;
    prints both calls' times and the second's levels/s."""
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bank = env.generate_bank(pt.random.key(0, env.device), n_levels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    log(f"{env.game.NAME} generate_bank({n_levels}): first call "
        f"{times[0]:.3f} s, second {times[1]:.3f} s -> "
        f"{n_levels / times[1]:.1f} levels/s")
    return bank


KERNEL_WRAPPERS = (scene_kernel.scene_raw, scene_kernel.scene,
                   stamp_kernel.composite, stamp_kernel.stamps)


def drive(env, bank, actions, obs_buf, place, *counters, silent=(),
          n_envs=NUM_ENVS):
    """The main path, twice: reset(n_envs), `place` the special lanes,
    T steps writing obs into `obs_buf`. The first run warms up; the
    `counters` (kernel wrappers) and the `silent` ones are set to 0 just
    before the second and read just after: each counter must have
    launched at least T + 1 times, each silent one never. Returns
    ([state after each step], [(reward, done)], lanes, [launches of each
    counter])."""
    def run():
        state, _ = env.reset(bank, pt.random.key(1, env.device), n_envs)
        gs, lanes = place(state.game)
        state = dataclasses.replace(state, game=gs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states, out = [], []
        for t in range(T):
            state, ts = env.step(bank, state, actions[t])
            obs_buf[t].copy_(ts.obs)
            states.append(state)
            out.append((ts.reward, ts.terminated))
        torch.cuda.synchronize()
        return states, out, lanes, time.perf_counter() - t0

    run()
    torch.cuda.synchronize()
    for counter in counters + tuple(silent):
        counter.launches = 0
    states, out, lanes, step_s = run()
    launches = [counter.launches for counter in counters]
    quiet = {c.__name__: c.launches for c in silent}
    log(f"{env.game.NAME} main path: {T} steps x {n_envs} envs in "
        f"{step_s:.4f} s -> {T * n_envs / step_s:.1f} env-steps/s (obs "
        f"written to the buffer); kernel launches "
        f"{dict(zip((c.__name__ for c in counters), launches)) | quiet}")
    for counter, n in zip(counters, launches):
        if n < T + 1:
            raise AssertionError(f"the {env.game.NAME} main path launched "
                                 f"{counter.__name__} {n} times, expected "
                                 f">= {T + 1}")
    if any(quiet.values()):
        raise AssertionError(f"the {env.game.NAME} main path launched a "
                             f"kernel it does not run: {quiet}")
    return states, out, lanes, launches


def check_outputs(obs_buf, out, allowed, n_envs=NUM_ENVS):
    """Shapes, dtypes and reward values of a main-path run, and no
    constant frame. Returns (rewards [T, N], dones [T, N])."""
    rewards = torch.stack([r for r, _ in out])
    dones = torch.stack([d for _, d in out])
    if obs_buf.shape != (T, n_envs, 64, 64, 3) or obs_buf.dtype != torch.uint8:
        raise AssertionError("obs buffer shape/dtype")
    if rewards.dtype != torch.float32 or dones.dtype != torch.bool:
        raise AssertionError("reward/termination dtypes")
    if not bool(torch.isfinite(rewards).all()):
        raise AssertionError("non-finite reward")
    if not bool(torch.isin(rewards, torch.tensor(
            allowed, dtype=torch.float32, device=rewards.device)).all()):
        raise AssertionError(f"reward outside {allowed}")
    lo, hi = torch.aminmax(obs_buf.reshape(T * n_envs, -1), dim=1)
    if bool((lo == hi).any()):
        raise AssertionError("a frame is constant")
    return rewards, dones


def cpu_rerun(game, bank, actions, obs_buf, states, out, place, lanes,
              steps=T, **cfg):
    """The first CPU_ENVS envs through the port on the CPU (`make(game,
    **cfg)`), from the same keys and placement: bank, states, rewards,
    terminations and obs must be identical at each of `steps` steps,
    auto-resets included."""
    cenv = pt.make(game, device="cpu", **cfg)
    cbank = cenv.generate_bank(pt.random.key(0), cenv._num_levels(bank))
    same_tree(bank, cbank, f"{game} level bank")
    cstate, _ = cenv.reset(cbank, pt.random.key(1), CPU_ENVS)
    cgs, clanes = place(cstate.game)
    if clanes != lanes:
        raise AssertionError(f"placed lanes differ: CPU {clanes}, GPU {lanes}")
    cstate = dataclasses.replace(cstate, game=cgs)
    for t in range(steps):
        cstate, cts = cenv.step(cbank, cstate, actions[t, :CPU_ENVS].cpu())
        if not torch.equal(cts.obs, obs_buf[t, :CPU_ENVS].cpu()):
            raise AssertionError(f"{game} step {t}: CPU and GPU obs differ")
        if not (torch.equal(cts.reward, out[t][0][:CPU_ENVS].cpu())
                and torch.equal(cts.terminated, out[t][1][:CPU_ENVS].cpu())):
            raise AssertionError(f"{game} step {t}: CPU and GPU rewards differ")
        same_tree(tree_map(lambda x: x[:CPU_ENVS], states[t]), cstate,
                  f"{game} step {t}: env state")


def build_kernels():
    """Build both kernels from this checkout, one nvcc process each,
    started together; print their times and ptxas registers/spills."""
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        recs = list(pool.map(lambda m: m.build(), (scene_kernel, stamp_kernel)))
    for rec in recs:
        log(f"build: {rec['name']} {rec['seconds']:.1f} s "
            f"({'cached' if rec['cached'] else 'nvcc'})")
        for line in rec["log"].splitlines():
            if ("registers" in line or "spill" in line
                    or "entry function" in line):
                log(f"  ptxas: {line.strip()}")


def coinrun_path(actions):
    """Coinrun's main path, its checks, the CPU re-run, the scene kernel
    against its plain version on the real inputs, and the breakdown.
    Returns the kernel's JSON entry (without the random-input numbers)."""
    env = pt.make("coinrun")  # the documented entry point: on the card
    bank = make_bank(env)
    obs_buf = torch.empty((T, NUM_ENVS, 64, 64, 3), dtype=torch.uint8,
                          device=env.device)

    def place(gs):
        return place_on_hazards(gs, CPU_ENVS)

    states, out, lanes, [launches] = drive(env, bank, actions, obs_buf,
                                           place, scene_kernel.scene_raw)
    rewards, dones = check_outputs(obs_buf, out, (0.0, 10.0))
    # the coin lane ends its episode on step 0 and restarts from the bank
    if not (bool(dones[0, 0]) and float(rewards[0, 0]) == 10.0
            and int(states[0].game.t[0]) == 0
            and int(states[0].ep_length[0]) == 0):
        raise AssertionError("the lane placed on its coin did not end its "
                             "episode and restart on step 0")
    hit = [i for i in lanes if bool(dones[:, i].any())]
    log(f"coinrun checks: obs {tuple(obs_buf.shape)} uint8 mean "
        f"{float(obs_buf.float().mean()):.3f}; rewards of 10: "
        f"{int((rewards == 10).sum())}; terminations: {int(dones.sum())}; "
        f"hazard lanes {lanes}, of which terminated {hit}")
    cpu_rerun("coinrun", bank, actions, obs_buf, states, out, place, lanes)
    log(f"coinrun CPU re-run of the first {CPU_ENVS} envs: bank, states, "
        f"rewards, terminations and obs identical at every step "
        f"({int(dones[:, :CPU_ENVS].sum())} auto-resets)")

    state = states[-1]
    inputs = coinrun._scene_inputs(env.cfg, state.game)
    err, ms, plain_ms = scene_vs_plain(inputs, 20)
    bound_ms, bound_by = scene_bound(inputs)
    log(f"scene kernel vs plain, coinrun inputs N={NUM_ENVS}: bitwise equal; "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} "
        f"ms ({bound_by}); blend operations {scene_work(inputs)[1]}")

    img = scene_kernel.scene_raw(*inputs)
    breakdown(env, bank, state, actions[-1], obs_buf, [
        ("scene inputs (coinrun._scene_inputs)",
         lambda: coinrun._scene_inputs(env.cfg, state.game)),
        ("scene kernel (scene_raw)", lambda: scene_kernel.scene_raw(*inputs)),
        ("round / clip / uint8",
         lambda: torch.clamp(torch.round(img), 0, 255).to(torch.uint8)),
    ])
    return dict(name="scene_raw", route="cuda",
                source="procgen2_tpu_torch/render/csrc/scene_kernel.cu",
                replaces="procgen2_tpu/render/scene_kernel.py:206",
                launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def bossfight_path(actions):
    """Bossfight's main path, its checks, the CPU re-run, the stamp kernel
    against its plain version on the real render inputs, and the
    breakdown. Returns the kernel's JSON entry."""
    env = pt.make("bossfight")
    bank = make_bank(env)
    obs_buf = torch.empty((T, NUM_ENVS, 64, 64, 3), dtype=torch.uint8,
                          device=env.device)

    states, out, lanes, [launches] = drive(env, bank, actions, obs_buf,
                                           place_boss_deaths,
                                           stamp_kernel.composite)
    rewards, dones = check_outputs(obs_buf, out, (-10.0, 0.0, 10.0))
    # both lanes end their episodes on step 0 and restart from the bank
    g0 = states[0].game
    for lane, want in ((0, -10.0), (1, 10.0)):
        if not (bool(dones[0, lane]) and float(rewards[0, lane]) == want
                and int(g0.t[lane]) == 0 and int(states[0].ep_length[lane]) == 0
                and int(g0.phase_index[lane]) == 0
                and int(g0.hp[lane]) == bossfight.BOSS_HP):
            raise AssertionError(f"bossfight lane {lane} did not end its "
                                 f"episode with {want} and restart on step 0")
    g = states[-1].game
    live = (bossfight._window(g.bb_next, g.bb_num, bossfight.NUM_B_BULLETS)
            & (g.bb_frame == 0.0))
    # from a reset, weapons 1 and 3 (half the envs) fire first within 8
    # steps (at attack_timer 5 and 4); weapons 0 and 2 fire at 8 and 10
    frac = float(live.any(1).float().mean())
    if frac < 0.4:
        raise AssertionError(f"boss bullets live in only {frac:.3f} of the "
                             "envs after 8 steps")
    log(f"bossfight checks: obs {tuple(obs_buf.shape)} uint8 mean "
        f"{float(obs_buf.float().mean()):.3f}; rewards of -10: "
        f"{int((rewards == -10).sum())}, of 10: {int((rewards == 10).sum())}; "
        f"terminations: {int(dones.sum())}; lanes 0 and 1 ended and "
        f"restarted on step 0; envs with live boss bullets after step {T}: "
        f"{int(live.any(1).sum())} of {NUM_ENVS} ({int(live.sum())} bullets)")
    cpu_rerun("bossfight", bank, actions, obs_buf, states, out,
              place_boss_deaths, lanes)
    log(f"bossfight CPU re-run of the first {CPU_ENVS} envs: bank, states, "
        f"rewards, terminations and obs identical at every step "
        f"({int(dones[:, :CPU_ENVS].sum())} auto-resets)")

    gs = states[-1].game
    img, groups = bossfight._stamp_groups(env.cfg, gs)
    err, ms, plain_ms = stamps_vs_plain(img, groups, 20)
    bound_ms, bound_by = stamp_bound(img, groups)
    log(f"stamp kernel vs plain, bossfight inputs N={NUM_ENVS}: bitwise "
        f"equal, one launch = one per group; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); stamp "
        f"blends {stamp_blends(groups, 64)}")

    out_img = stamp_kernel.composite(img, groups)
    breakdown(env, bank, states[-1], actions[-1], obs_buf, [
        ("render inputs (bossfight._stamp_groups: _cull_alive, _r0c0)",
         lambda: bossfight._stamp_groups(env.cfg, gs)),
        ("stamp kernel (composite, 4 groups)",
         lambda: stamp_kernel.composite(img, groups)),
        ("round / clip / uint8",
         lambda: torch.clamp(torch.round(out_img), 0, 255).to(torch.uint8)),
    ])
    return dict(name="composite", route="cuda",
                source="procgen2_tpu_torch/render/csrc/stamp_kernel.cu",
                replaces="procgen2_tpu/render/stamp_kernel.py:182",
                launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def climber_path(actions):
    """Climber's main path, its checks and the CPU re-run; then the render
    entry points of B4 and B5 on its real inputs, each kernel against its
    plain version there, B5 against B1, and the breakdown. Returns the
    JSON entries of B4 and B5, and B1's main-path launches and error."""
    env = pt.make("climber")
    bank = make_bank(env)
    obs_buf = torch.empty((T, NUM_ENVS, 64, 64, 3), dtype=torch.uint8,
                          device=env.device)

    def place(gs):
        return place_climber_lanes(gs, CPU_ENVS)

    states, out, lanes, [launches] = drive(env, bank, actions, obs_buf,
                                           place, scene_kernel.scene_raw)
    if launches != T + 1:
        raise AssertionError(f"climber's main path launched the scene kernel "
                             f"{launches} times, expected {T + 1}")
    rewards, dones = check_outputs(obs_buf, out,
                                   (0.0, 1.0, 2.0, 10.0, 11.0, 12.0))
    g0 = states[0].game
    for lane, want in zip(lanes, (0.0, 11.0)):
        if not (bool(dones[0, lane]) and float(rewards[0, lane]) == want
                and int(g0.t[lane]) == 0 and int(states[0].ep_length[lane]) == 0
                and not bool(g0.point_taken[lane].any())):
            raise AssertionError(f"climber lane {lane} did not end its "
                                 f"episode with {want} and restart on step 0")
    log(f"climber checks: obs {tuple(obs_buf.shape)} uint8 mean "
        f"{float(obs_buf.float().mean()):.3f}; crystal rewards: "
        f"{int((rewards > 0).sum())}; terminations: {int(dones.sum())}; "
        f"mob lane {lanes[0]} ended with 0, last-crystal lane {lanes[1]} "
        f"with 11, both restarted on step 0")
    cpu_rerun("climber", bank, actions, obs_buf, states, out, place, lanes)
    log(f"climber CPU re-run of the first {CPU_ENVS} envs: bank, states, "
        f"rewards, terminations and obs identical at every step "
        f"({int(dones[:, :CPU_ENVS].sum())} auto-resets)")

    # ---- 9. the render entry points of B4 and B5 on climber's inputs ----
    cfg, gs = env.cfg, states[-1].game
    inputs = climber._scene_inputs(cfg, gs)
    field = climber._scene_field(cfg, gs)
    bank_, var, scale, r0, c0 = field[6][0]
    if not compositor.stamp_kernel_ok(bank_.shape[-1], var.shape[1]):
        raise AssertionError("climber's merged group is off the kernel path")
    stamp_kernel.stamps.launches = 0
    scene_kernel.scene.launches = 0
    summed = compositor.stamps_from_pixel_bank(bank_, var, r0, c0,
                                               alives=scale)
    img5 = scene_kernel.scene(*field)
    torch.cuda.synchronize()
    sum_launches = stamp_kernel.stamps.launches
    field_launches = scene_kernel.scene.launches
    if sum_launches != 1 or field_launches != 1:
        raise AssertionError(f"the entry points launched B4 {sum_launches} "
                             f"and B5 {field_launches} times, expected 1")
    if summed[0].shape != (NUM_ENVS, 3, 64, 64) or not bool(
            torch.isfinite(summed[0].float()).all()):
        raise AssertionError("stamps_from_pixel_bank: shape or values")
    log(f"climber entry points: stamps_from_pixel_bank launched B4 "
        f"{sum_launches}x, scene launched B5 {field_launches}x")

    img1 = scene_kernel.scene_raw(*inputs)
    torch.cuda.synchronize()
    if bitwise_diff(img5, img1)[0]:
        raise AssertionError("B5 on climber's expanded field differs from B1 "
                             "on the raw inputs of the same state")
    err1, ms1, plain1 = scene_vs_plain(inputs, 20)
    b1, by1 = scene_bound(inputs)
    log(f"scene kernel vs plain, climber inputs N={NUM_ENVS}: bitwise equal; "
        f"kernel {ms1:.4f} ms, plain {plain1:.4f} ms, bound {b1:.4f} ms "
        f"({by1})")
    group = (bank_, var, scale, r0, c0)
    err4, ms4, plain4 = sum_vs_plain(group, 20)
    b4, by4 = sum_bound(group, 64)
    log(f"stamp-sum kernel vs plain, climber's merged group N={NUM_ENVS}: "
        f"bitwise equal; kernel {ms4:.4f} ms, plain {plain4:.4f} ms, bound "
        f"{b4:.4f} ms ({by4}); summed texels {stamp_blends([group], 64)}")
    err5, ms5, plain5 = field_vs_plain(field, 20)
    b5, by5 = bound(*field_work(field))
    log(f"expanded-field scene kernel vs plain, climber inputs N={NUM_ENVS}: "
        f"bitwise equal, and bitwise equal to the raw scene kernel on the "
        f"same state; kernel {ms5:.4f} ms, plain {plain5:.4f} ms, bound "
        f"{b5:.4f} ms ({by5})")

    for name, ms in ablations(field, group).items():
        log(f"ablation, climber inputs N={NUM_ENVS}: {name} {ms:.4f} ms")

    breakdown(env, bank, states[-1], actions[-1], obs_buf, [
        ("scene inputs (climber._scene_inputs)",
         lambda: climber._scene_inputs(cfg, gs)),
        ("scene kernel (scene_raw)", lambda: scene_kernel.scene_raw(*inputs)),
        ("round / clip / uint8",
         lambda: torch.clamp(torch.round(img1), 0, 255).to(torch.uint8)),
    ])
    stamps_entry = dict(
        name="stamps", route="cuda",
        source="procgen2_tpu_torch/render/csrc/stamp_kernel.cu",
        replaces="procgen2_tpu/render/stamp_kernel.py:234",
        launches=sum_launches, max_abs_err=err4, ms=ms4, plain_ms=plain4,
        bound_ms=b4, bound_by=by4, library_ms=None)
    scene_entry = dict(
        name="scene", route="cuda",
        source="procgen2_tpu_torch/render/csrc/scene_kernel.cu",
        replaces="procgen2_tpu/render/scene_kernel.py:327",
        launches=field_launches, max_abs_err=err5, ms=ms5, plain_ms=plain5,
        bound_ms=b5, bound_by=by5, library_ms=None)
    return stamps_entry, scene_entry, launches, err1


# envs of the first caveflyer steps with a live bullet: random actions fire
# with probability 1/15 a step, so about 1 - (14/15)**8 = 40% of the envs
# fire in 8 steps; a bullet lives until it strikes something, a step or
# more in the cave
CAVEFLYER_LIVE_BULLETS = 0.2


def caveflyer_rewards():
    """Every reward a caveflyer step can give: +10 at the goal and +3 per
    target destroyed, in the last active sub-step."""
    m = caveflyer.Config().max_obj
    return tuple(sorted({10.0 * g + 3.0 * k for g in (0, 1)
                         for k in range(3 * m + 1)}))


def caveflyer_path(actions):
    """Caveflyer's main path, its checks, the CPU re-run, the scene kernel
    against its plain version on caveflyer's real inputs (four groups, the
    smoke at fractional scales) and on a hard-mode render, and the
    breakdown. Returns B1's main-path launches, error, and the times and
    bounds on caveflyer's easy and hard inputs."""
    env = pt.make("caveflyer")
    bank = make_bank(env)
    obs_buf = torch.empty((T, NUM_ENVS, 64, 64, 3), dtype=torch.uint8,
                          device=env.device)

    def place(gs):
        return place_caveflyer_lanes(gs, CPU_ENVS)

    states, out, lanes, [launches] = drive(env, bank, actions, obs_buf,
                                           place, scene_kernel.scene_raw)
    if launches != T + 1:
        raise AssertionError(f"caveflyer's main path launched the scene "
                             f"kernel {launches} times, expected {T + 1}")
    rewards, dones = check_outputs(obs_buf, out, caveflyer_rewards())
    g0 = states[0].game
    for lane, want in zip(lanes, (10.0, 0.0)):
        if not (bool(dones[0, lane]) and float(rewards[0, lane]) == want
                and int(g0.t[lane]) == 0 and int(states[0].ep_length[lane]) == 0
                and int(g0.num_bullets[lane]) == 0):
            raise AssertionError(f"caveflyer lane {lane} did not end its "
                                 f"episode with {want} and restart on step 0")
    live = torch.zeros(NUM_ENVS, dtype=torch.bool, device=env.device)
    for st in states:
        g = st.game
        live |= (caveflyer._ring_window(g.next_bullet, g.num_bullets)
                 & (g.b_frame == 0.0)).any(1)
    frac = float(live.float().mean())
    if frac < CAVEFLYER_LIVE_BULLETS:
        raise AssertionError(f"only {frac:.3f} of the caveflyer envs had a "
                             f"live bullet in {T} steps")
    log(f"caveflyer checks: obs {tuple(obs_buf.shape)} uint8 mean "
        f"{float(obs_buf.float().mean()):.3f}; rewards of 10: "
        f"{int((rewards >= 10).sum())}, with targets destroyed: "
        f"{int((torch.remainder(rewards, 10) > 0).sum())}; terminations: "
        f"{int(dones.sum())}; goal lane {lanes[0]} ended with 10, hazard "
        f"lane {lanes[1]} with 0, both restarted on step 0; envs with a "
        f"live bullet in {T} steps: {int(live.sum())} of {NUM_ENVS}")
    cpu_rerun("caveflyer", bank, actions, obs_buf, states, out, place, lanes)
    log(f"caveflyer CPU re-run of the first {CPU_ENVS} envs: bank, states, "
        f"rewards, terminations and obs identical at every step "
        f"({int(dones[:, :CPU_ENVS].sum())} auto-resets)")

    cfg, gs = env.cfg, states[-1].game
    inputs = caveflyer._scene_inputs(cfg, gs)
    smoke = inputs[12][0][2]
    frac_scales = int(((smoke > 0) & (smoke < 1)).sum())
    if frac_scales == 0:
        raise AssertionError("no smoke stamp at a fractional scale")
    err, ms, plain_ms = scene_vs_plain(inputs, 20)
    b, by = scene_bound(inputs)
    log(f"scene kernel vs plain, caveflyer inputs N={NUM_ENVS} (groups K = "
        f"{[g[1].shape[1] for g in inputs[12]]}, {frac_scales} smoke stamps "
        f"at fractional scales): bitwise equal; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {b:.4f} ms ({by})")

    # hard mode: D = 40, M = 21 (107 slots), a 256-level bank, 2 steps
    henv = pt.make("caveflyer", mode="hard")
    hbank = henv.generate_bank(pt.random.key(0, henv.device), 256)
    hstate, _ = henv.reset(hbank, pt.random.key(1, henv.device), NUM_ENVS)
    for t in range(2):
        hstate, _ = henv.step(hbank, hstate, actions[t], render=False)
    hinputs = caveflyer._scene_inputs(henv.cfg, hstate.game)
    herr, hms, hplain = scene_vs_plain(hinputs, 20)
    hb, hby = scene_bound(hinputs)
    log(f"scene kernel vs plain, caveflyer hard-mode inputs N={NUM_ENVS} "
        f"(K = {[g[1].shape[1] for g in hinputs[12]]}): bitwise equal; "
        f"kernel {hms:.4f} ms, plain {hplain:.4f} ms, bound {hb:.4f} ms "
        f"({hby})")

    img = scene_kernel.scene_raw(*inputs)
    breakdown(env, bank, states[-1], actions[-1], obs_buf, [
        ("scene inputs (caveflyer._scene_inputs)",
         lambda: caveflyer._scene_inputs(cfg, gs)),
        ("scene kernel (scene_raw, 4 groups)",
         lambda: scene_kernel.scene_raw(*inputs)),
        ("round / clip / uint8",
         lambda: torch.clamp(torch.round(img), 0, 255).to(torch.uint8)),
    ])
    return launches, max(err, herr)


def jumper_path(actions):
    """Jumper's main path, its checks, the CPU re-run, B1 and B3 against
    their plain versions on jumper's real inputs (the dust at fractional
    scales; the needle, one P = 32 stamp over the blended frame), and the
    breakdown. Returns B1's and B3's main-path launches and errors."""
    env = pt.make("jumper")
    bank = make_bank(env)
    obs_buf = torch.empty((T, NUM_ENVS, 64, 64, 3), dtype=torch.uint8,
                          device=env.device)

    def place(gs):
        return place_jumper_lanes(gs, CPU_ENVS)

    states, out, lanes, (b1_launches, b3_launches) = drive(
        env, bank, actions, obs_buf, place, scene_kernel.scene_raw,
        stamp_kernel.composite)
    rewards, dones = check_outputs(obs_buf, out, (0.0, 10.0))
    g0 = states[0].game
    for lane, want in zip(lanes, (10.0, 0.0)):
        if not (bool(dones[0, lane]) and float(rewards[0, lane]) == want
                and int(g0.t[lane]) == 0 and int(states[0].ep_length[lane]) == 0
                and not bool((g0.part_life[lane] > 0).any())):
            raise AssertionError(f"jumper lane {lane} did not end its "
                                 f"episode with {want} and restart on step 0")
    log(f"jumper checks: obs {tuple(obs_buf.shape)} uint8 mean "
        f"{float(obs_buf.float().mean()):.3f}; rewards of 10: "
        f"{int((rewards == 10).sum())}; terminations: {int(dones.sum())}; "
        f"carrot lane {lanes[0]} ended with 10, spike lane {lanes[1]} with 0, "
        f"both restarted on step 0")
    cpu_rerun("jumper", bank, actions, obs_buf, states, out, place, lanes)
    log(f"jumper CPU re-run of the first {CPU_ENVS} envs: bank, states, "
        f"rewards, terminations and obs identical at every step "
        f"({int(dones[:, :CPU_ENVS].sum())} auto-resets)")

    cfg, gs = env.cfg, states[-1].game
    inputs = jumper._scene_inputs(cfg, gs)
    dust = inputs[12][0][2]
    frac = int(((dust > 0) & (dust < 1)).sum())
    if frac == 0:
        raise AssertionError("no dust stamp at a fractional scale")
    err1, ms1, plain1 = scene_vs_plain(inputs, 20)
    b1, by1 = scene_bound(inputs)
    log(f"scene kernel vs plain, jumper inputs N={NUM_ENVS} (groups K = "
        f"{[g[1].shape[1] for g in inputs[12]]}, {frac} dust stamps at "
        f"fractional scales): bitwise equal; kernel {ms1:.4f} ms, plain "
        f"{plain1:.4f} ms, bound {b1:.4f} ms ({by1}); blend operations "
        f"{scene_work(inputs)[1]}")
    ST = jumper._scene_tensors(cfg.scene_phases, cfg.world_dim,
                               str(env.device))
    img = scene_kernel.scene_raw(*inputs)
    blended = jumper._compass(img, ST)
    needle = [compositor.stamp_group(ST["banks"]["needle"],
                                     *jumper._needle_stamp(gs))]
    err3, ms3, plain3 = stamps_vs_plain(blended, needle, 20)
    b3, by3 = stamp_bound(blended, needle)
    log(f"stamp kernel vs plain, jumper's needle N={NUM_ENVS} (P = 32, K = "
        f"1): bitwise equal; kernel {ms3:.4f} ms, plain {plain3:.4f} ms, "
        f"bound {b3:.4f} ms ({by3}); stamp blends "
        f"{stamp_blends(needle, 64)}")

    final = stamp_kernel.composite(blended, needle)
    breakdown(env, bank, states[-1], actions[-1], obs_buf, [
        ("scene inputs (jumper._scene_inputs)",
         lambda: jumper._scene_inputs(cfg, gs)),
        ("scene kernel (scene_raw, 2 groups)",
         lambda: scene_kernel.scene_raw(*inputs)),
        ("compass blend (bf16 ops)", lambda: jumper._compass(img, ST)),
        ("needle inputs (jumper._needle_stamp)",
         lambda: jumper._needle_stamp(gs)),
        ("stamp kernel (composite, the needle)",
         lambda: stamp_kernel.composite(blended, needle)),
        ("round / clip / uint8",
         lambda: torch.clamp(torch.round(final), 0, 255).to(torch.uint8)),
    ])
    return b1_launches, b3_launches, err1, err3


def lanes_restarted(states, dones, rewards, lanes, wants, fresh):
    """Each placed lane ended on step 0 with its reward and restarted:
    step counter 0, episode length 0, `fresh(game_state, lane)` true."""
    g0 = states[0].game
    for lane, want in zip(lanes, wants):
        if not (bool(dones[0, lane]) and float(rewards[0, lane]) == want
                and int(g0.t[lane]) == 0
                and int(states[0].ep_length[lane]) == 0 and fresh(g0, lane)):
            raise AssertionError(f"{g0.__module__} lane {lane} did not end "
                                 f"its episode with {want} and restart on "
                                 "step 0")


def peak_gib():
    return torch.cuda.max_memory_allocated() / 2 ** 30


def chaser_rewards():
    """Every reward a chaser step can give: +0.04 per pellet or orb (a
    sub-step collects at most 8), +10 once nothing is left."""
    d = torch.arange(9, dtype=torch.int32)
    return tuple(sorted(set(chaser._reward(d, torch.ones_like(d)).tolist())
                        | set(chaser._reward(d, torch.zeros_like(d)).tolist())))


def chaser_kind_parts(cfg, gs, device):
    """The render's parts of a chaser state as breakdown entries: the kind
    field, the background, the three kind blends, the stamp group and the
    rounding."""
    R = chaser._render_tensors(cfg.mode, str(device))
    G = chaser._kind_grid(gs)[:, R["t"]][:, :, R["t"]][:, None]
    img = R["bg_bank"][gs.level.bg_index.long()].to(torch.bfloat16)
    blend = compositor.blend_kind

    def blends():
        out = blend(img, G == chaser.WALL, *R["wall"])
        out = blend(out, G == chaser.PELLET, *R["pellet"])
        return blend(out, G == chaser.ORB, *R["orb"])

    def stamp_group():
        var, r0, c0, alive = chaser._stamp_slots(cfg, gs)
        return compositor.composite_stamps(
            img, R["bank"], var, torch.round(r0).to(torch.int32),
            torch.round(c0).to(torch.int32), alives=alive)

    final = stamp_group()
    return [
        ("kind field (kind grid + gather)",
         lambda: chaser._kind_grid(gs)[:, R["t"]][:, :, R["t"]]),
        ("background gather (bf16)",
         lambda: R["bg_bank"][gs.level.bg_index.long()].to(torch.bfloat16)),
        ("3 kind blends (bf16 ops)", blends),
        ("stamp group (slots, matmul semantics, K = 6)", stamp_group),
        ("round / clip / uint8",
         lambda: torch.clamp(torch.round(final), 0, 255).to(torch.uint8)),
    ]


def chaser_path(actions):
    """Chaser's main path at its default Config (easy, 11 x 11), its
    checks (no kernel launched: its render is a kind field and one stamp
    group off the kernel path), the CPU re-run, and the breakdown."""
    torch.cuda.reset_peak_memory_stats()
    env = pt.make("chaser")
    bank = make_bank(env)
    obs_buf = torch.empty((T, NUM_ENVS, 64, 64, 3), dtype=torch.uint8,
                          device=env.device)
    actions = hold_first_action(actions, [0, 1])
    states, out, lanes, _ = drive(env, bank, actions, obs_buf,
                                  place_chaser_lanes, silent=KERNEL_WRAPPERS)
    peak = peak_gib()
    rewards, dones = check_outputs(obs_buf, out, chaser_rewards())
    lanes_restarted(states, dones, rewards, lanes, (10.0, 0.0), lambda g, i: (
        torch.equal(g.pos[i], g.level.agent_pos[i])
        and torch.equal(g.point_grid[i], g.level.point_grid0[i])))
    log(f"chaser checks: obs {tuple(obs_buf.shape)} uint8 mean "
        f"{float(obs_buf.float().mean()):.3f}; rewards of 10 or more: "
        f"{int((rewards >= 10).sum())}, pellets or orbs collected: "
        f"{int(((rewards % 10) > 0).sum())}; terminations: "
        f"{int(dones.sum())}; completion lane {lanes[0]} ended with 10, "
        f"death lane {lanes[1]} with 0, both restarted on step 0; peak "
        f"device memory {peak:.3f} GiB")
    cpu_rerun("chaser", bank, actions, obs_buf, states, out,
              place_chaser_lanes, lanes)
    log(f"chaser CPU re-run of the first {CPU_ENVS} envs: bank, states, "
        f"rewards, terminations and obs identical at every step "
        f"({int(dones[:, :CPU_ENVS].sum())} auto-resets)")

    parts = chaser_kind_parts(env.cfg, states[-1].game, env.device)
    numbers = breakdown(env, bank, states[-1], actions[-1], obs_buf, parts)
    return dict(numbers, peak_gib=peak)


def maze_kind_parts(cfg, gs, device):
    """The render's parts of a maze state as breakdown entries: the kind
    field, the background, the four kind blends, and the rounding."""
    R = maze._render_tensors(cfg.mode, str(device))
    G = maze._kind_field(gs, R)
    img = R["bg_bank"][gs.level.bg_index.long()].to(torch.bfloat16)
    blend = compositor.blend_kind

    def blends():
        out = blend(img, G == maze.WALL, *R["wall"])
        out = blend(out, (G == maze.CHEESE) | (G >= maze.MOUSE_ON_CHEESE),
                    *R["cheese"])
        out = blend(out, (G == maze.MOUSE) | (G == maze.MOUSE_ON_CHEESE),
                    *R["mouse"])
        return blend(out, (G == maze.MOUSE_FLIP)
                     | (G == maze.MOUSE_FLIP_ON_CHEESE), *R["mouse_flip"])

    bf = blends()
    return [
        ("kind field (kind grid + gather)", lambda: maze._kind_field(gs, R)),
        ("background gather (bf16)",
         lambda: R["bg_bank"][gs.level.bg_index.long()].to(torch.bfloat16)),
        ("4 kind blends (bf16 ops)", blends),
        ("round / clip / uint8",
         lambda: torch.clamp(torch.round(bf), 0, 255).to(torch.uint8)),
    ]


def maze_path(dev):
    """Maze's main path at the bench's shape (procgen2_tpu/bench.py:31:
    easy, 2048 levels, 8192 envs, T = 8), its checks (no kernel launched:
    its render is a kind field), the CPU re-run, and the breakdown."""
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    actions = hold_first_action(torch.randint(
        0, maze.NUM_ACTIONS, (T, MAZE_ENVS), generator=g, device=dev,
        dtype=torch.int32), [0, 1])
    torch.cuda.reset_peak_memory_stats()
    env = pt.make("maze", mode="easy")
    bank = make_bank(env, MAZE_LEVELS)
    obs_buf = torch.empty((T, MAZE_ENVS, 64, 64, 3), dtype=torch.uint8,
                          device=env.device)

    def place(gs):
        return place_maze_lanes(gs, env.cfg)

    states, out, lanes, _ = drive(env, bank, actions, obs_buf, place,
                                  silent=KERNEL_WRAPPERS, n_envs=MAZE_ENVS)
    peak = peak_gib()
    rewards, dones = check_outputs(obs_buf, out, (0.0, 10.0), MAZE_ENVS)
    lanes_restarted(states, dones, rewards, lanes, (10.0, 0.0), lambda g, i: (
        torch.equal(g.pos[i], g.level.agent_pos[i])))
    log(f"maze checks: obs {tuple(obs_buf.shape)} uint8 mean "
        f"{float(obs_buf.float().mean()):.3f}; rewards of 10: "
        f"{int((rewards == 10).sum())}; terminations: {int(dones.sum())}; "
        f"goal lane {lanes[0]} ended with 10, timeout lane {lanes[1]} "
        f"with 0, both restarted on step 0; peak device memory "
        f"{peak:.3f} GiB")
    cpu_rerun("maze", bank, actions, obs_buf, states, out, place, lanes,
              mode="easy")
    log(f"maze CPU re-run of the first {CPU_ENVS} envs: bank, states, "
        f"rewards, terminations and obs identical at every step "
        f"({int(dones[:, :CPU_ENVS].sum())} auto-resets)")
    parts = maze_kind_parts(env.cfg, states[-1].game, env.device)
    numbers = breakdown(env, bank, states[-1], actions[-1], obs_buf, parts)
    return dict(numbers, peak_gib=peak)


def maze_modes_path(dev):
    """Maze hard (the default Config, 25 x 25) and memory (31 x 31 under
    the agent-centred camera): a 256-level bank, reset(NUM_ENVS), 2 steps
    with the placed lanes, no kernel launched, and the CPU re-run of the
    first 8 envs."""
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    actions = hold_first_action(torch.randint(
        0, maze.NUM_ACTIONS, (2, NUM_ENVS), generator=g, device=dev,
        dtype=torch.int32), [0, 1])
    for mode in ("hard", "memory"):
        env = pt.make("maze", mode=mode)
        bank = env.generate_bank(pt.random.key(0, env.device), 256)
        state, _ = env.reset(bank, pt.random.key(1, env.device), NUM_ENVS)

        def place(gs):
            return place_maze_lanes(gs, env.cfg)

        gs, lanes = place(state.game)
        state = dataclasses.replace(state, game=gs)
        for w in KERNEL_WRAPPERS:
            w.launches = 0
        states, out, obs = [], [], torch.empty(
            (2, NUM_ENVS, 64, 64, 3), dtype=torch.uint8, device=env.device)
        for t in range(2):
            state, ts = env.step(bank, state, actions[t])
            obs[t].copy_(ts.obs)
            states.append(state)
            out.append((ts.reward, ts.terminated))
        if any(w.launches for w in KERNEL_WRAPPERS):
            raise AssertionError(f"maze {mode} launched a kernel")
        rewards = torch.stack([r for r, _ in out])
        dones = torch.stack([d for _, d in out])
        lanes_restarted(states, dones, rewards, lanes, (10.0, 0.0),
                        lambda g, i: True)
        cpu_rerun("maze", bank, actions, obs, states, out, place, lanes,
                  steps=2, mode=mode)
        log(f"maze {mode}: 256 levels, {NUM_ENVS} envs, 2 steps, no kernel "
            f"launched; obs mean {float(obs.float().mean()):.3f}; both "
            f"placed lanes restarted; the CPU re-run of the first "
            f"{CPU_ENVS} envs identical at both steps")


# The exact-camera main paths (scene_phases=0): each game's placement of
# its default-camera phase, the rewards a step can give, the placed lanes'
# first rewards (coinrun: lane 0 on its coin; the hazard lanes vary), and
# the stamp groups per render on the stamp kernel's path (B3, one launch
# each; `compositor.stamp_kernel_ok`).
EXACT_GAMES = {
    "coinrun": (lambda gs: place_on_hazards(gs, CPU_ENVS), (0.0, 10.0),
                (10.0,), 2),
    "climber": (lambda gs: place_climber_lanes(gs, CPU_ENVS),
                (0.0, 1.0, 2.0, 10.0, 11.0, 12.0), (0.0, 11.0), 1),
    "caveflyer": (lambda gs: place_caveflyer_lanes(gs, CPU_ENVS),
                  caveflyer_rewards(), (10.0, 0.0), 4),
    "jumper": (lambda gs: place_jumper_lanes(gs, CPU_ENVS), (0.0, 10.0),
               (10.0, 0.0), 1),
}


def exact_render_calls(game, cfg, gs):
    """[(frame, groups)] of every stamp-kernel call of one exact render of
    the state gs (`observe_batch` with scene_phases=0), in order."""
    calls = []
    orig = stamp_kernel.composite

    def recording(img, groups):
        calls.append((img, groups))
        return orig(img, groups)
    # the wrapper counts its launches on the module's `composite`
    recording.launches = orig.launches
    stamp_kernel.composite = recording
    try:
        game.observe_batch(cfg, gs)
    finally:
        stamp_kernel.composite = orig
        orig.launches = recording.launches
    return calls


def exact_path(name, actions):
    """One game's exact-camera main path: make(name, scene_phases=0) ->
    generate_bank(1024) -> reset(4096) -> its default phase's lanes
    placed -> T steps into the uint8 buffer. B3 must launch once per
    kernel-path stamp group per render, and nothing else; the placed
    lanes end on step 0 and restart; the first 8 envs are re-run on the
    CPU; then B3 on every stamp group of the last state's render, held
    against its plain version and timed against its bound, and the host
    wall time of the whole render. Returns B3's launches and numbers."""
    place, allowed, wants, per_render = EXACT_GAMES[name]
    env = pt.make(name, scene_phases=0)
    bank = make_bank(env)
    obs_buf = torch.empty((T, NUM_ENVS, 64, 64, 3), dtype=torch.uint8,
                          device=env.device)
    silent = tuple(w for w in KERNEL_WRAPPERS if w is not stamp_kernel.composite)
    states, out, lanes, [launches] = drive(env, bank, actions, obs_buf, place,
                                           stamp_kernel.composite,
                                           silent=silent)
    if launches != per_render * (T + 1):
        raise AssertionError(f"{name} exact path launched B3 {launches} "
                             f"times, expected {per_render} x {T + 1}")
    rewards, dones = check_outputs(obs_buf, out, allowed)
    lanes_restarted(states, dones, rewards,
                    [0] if name == "coinrun" else lanes, wants,
                    lambda g, i: True)
    cpu_rerun(name, bank, actions, obs_buf, states, out, place, lanes,
              scene_phases=0)
    log(f"{name} exact path checks: obs mean "
        f"{float(obs_buf.float().mean()):.3f}, terminations "
        f"{int(dones.sum())}, placed lanes ended on step 0 and restarted; "
        f"the CPU re-run of the first {CPU_ENVS} envs identical at every "
        f"step ({int(dones[:, :CPU_ENVS].sum())} auto-resets)")

    cfg, gs = env.cfg, states[-1].game
    calls = exact_render_calls(env.game, cfg, gs)
    if len(calls) != per_render:
        raise AssertionError(f"{name} exact render made {len(calls)} B3 "
                             f"calls, expected {per_render}")
    err = ms = plain_ms = bound_ms = 0.0
    for img, groups in calls:
        e, m, p = stamps_vs_plain(img, groups, 20)
        b, by = stamp_bound(img, groups)
        err, ms, plain_ms, bound_ms = (max(err, e), ms + m, plain_ms + p,
                                       bound_ms + b)
        log(f"stamp kernel vs plain, {name} exact-path group (P, K) = "
            f"{[(g[0].shape[-1], g[1].shape[1]) for g in groups]} "
            f"N={NUM_ENVS}: bitwise equal; kernel {m:.4f} ms, plain "
            f"{p:.4f} ms, bound {b:.4f} ms ({by}); stamp blends "
            f"{stamp_blends(groups, 64)}")
    render_ms = wall_ms(lambda: env.game.observe_batch(cfg, gs))
    step_ms = wall_ms(lambda: env.step(bank, states[-1], actions[-1]))
    log(f"{name} exact render at {NUM_ENVS} envs: host wall {render_ms:.3f} "
        f"ms per render (env.step {step_ms:.3f} ms); B3 per render "
        f"{ms:.4f} ms over {per_render} launches, bound {bound_ms:.4f} ms")
    return dict(launches=launches, err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, render_ms=render_ms, step_ms=step_ms)


def window_render_check(name, dev, n=16, steps=6, size=512):
    """`Environment.render(state, size, env_index)` of one game on the
    card, for env_index 0 and 1 of n envs after `steps` random steps: no
    kernel launched, uint8 [size, size, 3] on the card, not constant, and
    bitwise equal to the port's render of the same state on the CPU.
    Returns the host wall ms of one render."""
    env = pt.make(name)
    bank = env.generate_bank(pt.random.key(0, env.device), 64)
    state, _ = env.reset(bank, pt.random.key(1, env.device), n)
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    for _ in range(steps):
        state, _ = env.step(bank, state, torch.randint(
            0, 15, (n,), generator=g, device=dev, dtype=torch.int32),
            render=False)
    for w in KERNEL_WRAPPERS:
        w.launches = 0
    frames = [env.render(state, size, i) for i in (0, 1)]
    torch.cuda.synchronize()
    if any(w.launches for w in KERNEL_WRAPPERS):
        raise AssertionError(f"{name} window render launched a kernel")
    cenv = pt.make(name, device="cpu")
    cstate = tree_map(lambda x: x.cpu(), state)
    for i, f in enumerate(frames):
        if (f.shape != (size, size, 3) or f.dtype != torch.uint8
                or f.device != env.device):
            raise AssertionError(f"{name} window render: {f.shape} "
                                 f"{f.dtype} {f.device}")
        if int(f.max()) == int(f.min()):
            raise AssertionError(f"{name} window render {i} is constant")
        if not torch.equal(cenv.render(cstate, size, i), f.cpu()):
            raise AssertionError(f"{name} window render {i}: card and CPU "
                                 "differ")
    return wall_ms(lambda: env.render(state, size, 0), iters=3)


def window_renders(dev):
    """`Environment.render` at 512 px for all seven games (see
    `window_render_check`); logs each one's wall time."""
    for name in pt.GAMES:
        ms = window_render_check(name, dev)
        log(f"{name} Environment.render(state, 512, i) on the card: "
            f"uint8 [512, 512, 3], no kernel launched, bitwise equal to the "
            f"CPU for env 0 and 1; host wall {ms:.3f} ms per render")



def main():
    t_start = time.perf_counter()
    # ---- 1. device ----
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device")
    dev = pt.make("coinrun").device  # on the card by default
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)  # the card's name and power limit, as nvidia-smi prints them
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    # ---- 2. build ----
    build_kernels()

    # ---- 3. kernels vs plain, random inputs ----
    scene_args = random_scene(NUM_ENVS, dev)
    err_r, ms_r, plain_r = scene_vs_plain(scene_args, 20)
    bound_r, by_r = scene_bound(scene_args)
    log(f"scene kernel vs plain, random inputs N={NUM_ENVS}: bitwise equal; "
        f"kernel {ms_r:.4f} ms, plain {plain_r:.4f} ms, bound {bound_r:.4f} "
        f"ms ({by_r})")
    img, groups = random_stamps(NUM_ENVS, dev)
    serr_r, sms_r, splain_r = stamps_vs_plain(img, groups, 20)
    sbound_r, sby_r = stamp_bound(img, groups)
    log(f"stamp kernel vs plain, random bossfight-shaped inputs N={NUM_ENVS}: "
        f"bitwise equal, one launch = one per group; kernel {sms_r:.4f} ms, "
        f"plain {splain_r:.4f} ms, bound {sbound_r:.4f} ms ({sby_r})")
    err4_r = 0.0
    for (V, P, K), group in zip(SUM_GROUP_SHAPES, random_sum_groups(NUM_ENVS,
                                                                    dev)):
        e, ms, plain = sum_vs_plain(group, 20)
        b, by = sum_bound(group, 64)
        err4_r = max(err4_r, e)
        log(f"stamp-sum kernel vs plain, random group V={V} P={P} K={K} "
            f"N={NUM_ENVS}: bitwise equal; kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms, bound {b:.4f} ms ({by})")
    edges_vs_plain(EDGE_ENVS, dev)
    off_kernel_groups(EDGE_ENVS, dev)
    field_args = random_field(NUM_ENVS, dev)
    err5_r, ms, plain = field_vs_plain(field_args, 20)
    b, by = bound(*field_work(field_args))
    log(f"expanded-field scene kernel vs plain, random scene N={NUM_ENVS}: "
        f"bitwise equal; kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
        f"{b:.4f} ms ({by})")

    g = torch.Generator(device=dev)
    g.manual_seed(2)
    actions = torch.randint(0, coinrun.NUM_ACTIONS, (T, NUM_ENVS),
                            generator=g, device=dev, dtype=torch.int32)

    # ---- 4, 5. coinrun: main path, checks, breakdown ----
    scene = coinrun_path(actions)
    # ---- 6, 7. bossfight: main path, checks, breakdown ----
    stamp = bossfight_path(actions)
    # ---- 8, 9, 10. climber: main path, entry points, breakdown ----
    sums, field, climber_launches, err1 = climber_path(actions)
    # ---- 11, 12. caveflyer: main path, easy and hard B1, breakdown ----
    cave_launches, err_c = caveflyer_path(actions)
    # ---- 13, 14. jumper: main path, B1 and B3, breakdown ----
    jump_b1, jump_b3, err_j1, err_j3 = jumper_path(actions)
    # ---- 15, 16. chaser: main path (no kernel), breakdown ----
    chase = chaser_path(actions)
    # ---- 17, 18. maze at the bench's shape, then hard and memory ----
    mz = maze_path(dev)
    maze_modes_path(dev)
    for name, nb in (("chaser", chase), ("maze", mz)):
        log(f"{name} summary: step {nb['step_ms']:.3f} ms wall, device "
            f"{nb['device_ms']} ms per 2 steps, idle share {nb['idle']}, "
            f"peak device memory {nb['peak_gib']:.3f} GiB")
    # ---- 19. the exact-camera main paths (scene_phases=0), B3 on them ----
    exact = {name: exact_path(name, actions) for name in EXACT_GAMES}
    for name, ex in exact.items():
        log(f"{name} exact summary: B3 launches {ex['launches']}, per render "
            f"{ex['ms']:.4f} ms (bound {ex['bound_ms']:.4f} ms), render "
            f"{ex['render_ms']:.3f} ms wall")
    # ---- 20. Environment.render at 512 px, every game ----
    window_renders(dev)

    # ---- 21. result ----
    # the main paths that run B1: coinrun, climber, caveflyer and jumper;
    # B3: bossfight and jumper, and the four exact-camera paths
    scene["launches"] += climber_launches + cave_launches + jump_b1
    scene["max_abs_err"] = max(scene["max_abs_err"], err_r, err1, err_c,
                               err_j1)
    stamp["launches"] += jump_b3 + sum(ex["launches"] for ex in exact.values())
    stamp["max_abs_err"] = max(stamp["max_abs_err"], serr_r, err_j3,
                               *(ex["err"] for ex in exact.values()))
    sums["max_abs_err"] = max(sums["max_abs_err"], err4_r)
    field["max_abs_err"] = max(field["max_abs_err"], err5_r)
    log(f"chip_smoke total wall time: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": [scene, stamp, sums, field]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
