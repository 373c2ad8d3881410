"""Smoke test of the PyTorch port on one CUDA card: builds the port's
kernels from this checkout, holds each against its plain torch version,
drives the main paths of coinrun, bossfight, climber, caveflyer, jumper,
chaser and maze (maze at the bench's 8192 envs) at full width, drives
the render entry points of the stamp-sum and expanded-field scene kernels
on climber's real inputs, the exact-camera renders (scene_phases=0) of
coinrun, climber, caveflyer and jumper, every game's window render
(Environment.render at 512 px), the rollout of every game as one CUDA
graph of T steps, the rollout's graph table under fresh policies, the
main paths at the other configs (hard, memory, easy_mode, coinrun's
features off), `make_vec` and `make` of a game module, the
Gym adapter, a checkpoint and the guards, the reference's own levels
played by the parity suites' bots at full width, and every game under a
PNG overlay with fixtures recorded on the card and replayed on the CPU,
and checks the results.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero and the final
`ok` line is not printed):
  1. device: a CUDA card must be visible; prints nvidia-smi's name and
     power limit; make("coinrun") (on the card by default);
  2. build: builds the scene kernels (B1, B5), the stamp kernels (B3,
     B4), coinrun's and bossfight's step kernels and maze's render (M1)
     from their five sources (nvcc, sm_90a, one compiler process each,
     started together) and prints their times
     and, per kernel, ptxas's registers, shared memory and spills;
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
     uint8 [8, 4096, 64, 64, 3] buffer; the launch counts show the path
     ran the scene kernel and the step kernel (one launch a step);
     shapes, dtypes, rewards and obs are checked, and the coin lane must
     have terminated and restarted; the first 8 envs are re-run on the
     CPU through the port (the plain step) and must match exactly,
     auto-resets included; the scene kernel and the step kernel are then
     held against their plain versions on the real inputs and timed
     beside their bounds;
  5. where the time goes (coinrun): host wall time of each part of one
     env step, and the device kernels and device time of two steps
     (torch.profiler);
  6. bossfight main path: make("bossfight") -> generate_bank(1024) ->
     reset(4096) -> lane 0's agent placed on the boss (death, -10) and
     lane 1's boss in its last phase with its hit points gone (death, +10)
     -> 8 steps writing obs into the uint8 buffer; the stamp kernel's and
     the step kernel's launch counts (the step kernel: one a step), shapes,
     dtypes, rewards, both lanes' termination and restart, live boss
     bullets and obs are checked; the first 8 envs are re-run on the CPU
     and must match exactly at every step; the stamp kernel and the step
     kernel are then held against their plain versions on the real inputs
     and timed beside their bounds;
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
     re-run and peak device memory, its render M1 launched once a render
     and no other kernel; M1 against the plain render on the last states
     (bitwise), timed eagerly and in a graph beside the plain render and
     its bytes bound (CUDA events); where the time goes, as in 16 (M1,
     then the plain render's kind field, background, 4 kind blends and
     rounding); then maze hard and memory (the agent-centred camera): 256
     levels, reset(4096), 2 steps, M1 once a step in hard mode and never
     in memory mode, no other kernel, the CPU re-run of 8 envs;
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
 21. the rollout (`dist.rollout`, T = 8, one CUDA graph of the T steps)
     of every game at its main path's shape and of coinrun with
     scene_phases=0: captured, then equal bitwise to an eager
     `Environment.step` loop on the same state and the buffer's actions
     (every buffer field, the final state) and a second replay to the
     first; a rollout of 64 envs on the card equal to the same rollout on
     the CPU; the profiler's count of B1/B3 launches in one replay (8 per
     kernel group) and of coinrun's and bossfight's step kernels and
     maze's render M1 (8 each); the graph's and the
     eager loop's env-steps/s, the capture's seconds and the graph's pool,
     the device's idle share of a replay;
 22. the rollout's graph table (ROADMAP C3): 20 coinrun rollouts at 256
     envs, T = 4, each with a fresh `functools.partial(policy, params)`,
     each equal to its eager loop and reading its own params, with
     `memory_reserved` after call 20 within the first graph's pool plus
     10% of that after call 2, GRAPHS_PER_ENV graphs kept in one pool;
     then graphs A and B (two banks, two policies) in that pool replayed
     A, B, A, B, each equal to its eager loop;
 23. the main paths at the other configs (MODE_CASES: caveflyer and
     jumper hard and memory, climber and coinrun easy_mode, coinrun with
     its features off) at 1024 levels, 4096 envs, T = 8: the kernels'
     launches counted (B1, and B3 for jumper, T + 1 times), the placed
     lanes ending and restarting on step 0, peak device memory over bank,
     reset and 8 steps; B1 (and B3 on jumper's needle) bitwise against
     its plain version on the real inputs, timed beside its bound; then
     the checks of phase 21 from the same bank and placed state (graph
     vs eager, 64 envs on the card vs the CPU, the profiler's 8 B1 (and
     B3) launches per replay, env-steps/s, pool, idle share);
 24. `make_vec("maze", 8192 envs, 2048 levels, mode="easy")` in one
     process: bank, reset and rollout equal to `make("maze")`'s with
     fold_in(key, 17) bitwise; `metrics` against float64 on the host;
     the rollout's env-steps/s;
 25. `make(wave_game)` (a game module, not a name) on the card equal to
     the CPU over 45 steps, no kernel launched;
 27. the surface: `GymEnv("maze")` on the card equal to the CPU over 20
     steps; a checkpoint saved on the card between two rollouts, restored
     and continued, equal to the live continuation; `guards.checked_step`
     over 3 clean coinrun steps, then raising on a NaN in the state;
 28. the reference's own levels (tools/reference_levels, the mt19937
     oracle's layouts) at full width, the runs of the parity suites
     (REFERENCE_CASES): each game's test seeds as a bank tiled with
     bank_gather to 4096 envs (maze easy: 8192), every replica keyed by
     its seed (reset_pinned), driven through `dist.rollout` graphs: the
     closed-loop bots (coinrun, climber, caveflyer, jumper) on the n
     distinct lanes, read back after each T = 1 replay, each replica
     given its seed's action; the open-loop plans (bossfight's NOOPs,
     chaser's full-clear route, maze's BFS route) T = 8 steps a replay;
     every replica's rewards and terminations up to its seed's end equal
     the seed's CPU run (each case's CPU run in a process of its own,
     started together), which the predictors' streams equal (coinrun,
     jumper, bossfight, chaser, maze's route); the bots' actions and the
     first 8 steps' frames of the n lanes equal the CPU's; B1 and B3
     launch on the games that render with them (the wrappers at capture,
     the profiler per replay), neither of them for chaser and maze; B1 and B3
     bitwise equal to their plain versions on the last render's inputs,
     timed beside their bounds; each game's wall seconds, env-steps/s
     and the device's idle share;
 29. the PNG overlay (render/png_assets) at full width: a synthetic
     reference assets/ tree (`synthetic_assets`: every mapped sprite and
     background as seeded random RGBA with fractional alpha, clear texels
     and non-square backgrounds) installed through `png_assets.install`;
     every game's main path (OVERLAY_GAMES, 1024 levels / 4096 envs, maze
     easy 2048 / 8192) run from one bank with procedural art and then under
     the overlay: reset and 2 steps, B1 and B3 counted (3 launches each
     where the game renders with them, none elsewhere), the same states,
     every frame other than the procedural one, the first 8 envs re-run on
     the CPU under the overlay and equal, B1 and B3 bitwise against their
     plain versions on the last render's inputs, timed beside their
     bounds; after `uninstall` a new env renders the final states'
     procedural frames again, bitwise. Then fixtures recorded on the card
     (`tools.difference.record_engine_fixture`: maze seed 7's route across
     the episode boundary, coinrun seed 0's bot run through B1) and
     replayed on the CPU (`run_fixture_diff`): agreement 1.0, no pixel
     difference. Then `gen.kruskal.boruvka_maze` at maze easy's dims
     (2048 levels, per-level dims) and jumper's (1024 levels), bitwise
     equal to `kruskal_maze` on the card and to the CPU, both timed
     (levels/s);
 30. the script's total wall time, then the kernels' JSON line (with
     each kernel's least possible time on this card, `bound_ms`), then
     the `ok` line last.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import gc
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
# the inputs, lanes and assets this script shares with the tests
sys.path.insert(0, str(ROOT / "tests"))

import procgen2_tpu_torch as pt  # noqa: E402
from procgen2_tpu_torch import random as prng  # noqa: E402
from procgen2_tpu_torch.games import (bossfight, caveflyer, chaser,  # noqa: E402
                                     climber, coinrun, jumper, maze)
from procgen2_tpu_torch.physics import bossfight_step, coinrun_step  # noqa: E402
from procgen2_tpu_torch.render import compositor  # noqa: E402
from procgen2_tpu_torch.render import (maze_render, scene_kernel,  # noqa: E402
                                      stamp_kernel)
from procgen2_tpu_torch.utils import (bank_gather, tree_map,  # noqa: E402
                                      tree_select)
from benchmark.roofline import stamp_composite  # noqa: E402
from benchmark.roofline.peaks import bound  # noqa: E402
from benchmark.roofline.scene_raw import (STAMP_OPS, TILE_OPS,  # noqa: E402
                                          stamp_blends, tensor_bytes,
                                          tile_work)
from benchmark.roofline.scene_raw import work as scene_work  # noqa: E402
from game_lanes import (MODE_CASES, T, coinrun_bot_actions,  # noqa: E402
                        hold_first_action, maze_route_actions,
                        place_boss_deaths, place_caveflyer_lanes,
                        place_chaser_lanes, place_climber_lanes,
                        place_jumper_lanes, place_maze_lanes,
                        place_on_hazards)
from kernel_inputs import (EDGE_CASES, ODD_KINDS,  # noqa: E402
                           SUM_GROUP_SHAPES, edge_field, edge_scene,
                           edge_stamps, edge_sum_group, random_field,
                           random_group, random_scene, random_stamps,
                           random_sum_groups)
from overlay_assets import synthetic_assets  # noqa: E402

# procgen2_tpu/tools/bench_cli.py:18 (its T = 8 is game_lanes.T)
NUM_LEVELS, NUM_ENVS = 1024, 4096
CPU_ENVS = 8
MAZE_LEVELS, MAZE_ENVS = 2048, 8192  # procgen2_tpu/bench.py:31, the headline
EDGE_ENVS = 257  # envs of the edge cases of phase 3


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


# 8 f32 ops per summed stamp texel (4 texel * scale, 4 adds); the stamp
# and tile blends' counts are the roofline copies' STAMP_OPS and TILE_OPS
SUM_OPS = 8


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
    return bound(*stamp_composite.work(img, groups))


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
        raise AssertionError(f"{what}: the two differ in leaves of shapes "
                             f"{bad}")


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
    same_tree(bank, cbank, f"{game} level bank, card vs CPU")
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
                  f"{game} step {t}: env state, card vs CPU")


def build_kernels():
    """Build the kernels from this checkout (the scene and stamp kernels,
    coinrun's and bossfight's steps, maze's render M1), one nvcc process
    per source, started together; print their times and ptxas
    registers/spills."""
    mods = (scene_kernel, stamp_kernel, coinrun_step, bossfight_step,
            maze_render)
    with concurrent.futures.ThreadPoolExecutor(len(mods)) as pool:
        recs = list(pool.map(lambda m: m.build(), mods))
    for rec in recs:
        log(f"build: {rec['name']} {rec['seconds']:.1f} s "
            f"({'cached' if rec['cached'] else 'nvcc'})")
        for line in rec["log"].splitlines():
            if ("registers" in line or "spill" in line
                    or "entry function" in line):
                log(f"  ptxas: {line.strip()}")


def step_bound(gs):
    """Least time in ms of coinrun's step kernel on State gs: bytes, each
    input other than the grid read once, each output written once, and
    one 3x3 window of the grid per env (the agent's first; the kernel
    reads more cells, so this bounds from below)."""
    lv = gs.level
    n = gs.pos.shape[0]
    ins = tensor_bytes(gs.pos, gs.vel, gs.on_ground, gs.face_forward,
                       gs.anim_t, gs.mob_pos, gs.mob_vx, lv.mob_alive,
                       lv.saw_pos, lv.saw_alive, lv.coin_pos, gs.t) + 4 * n
    outs = tensor_bytes(gs.pos, gs.vel, gs.on_ground, gs.face_forward,
                        gs.anim_t, gs.mob_pos, gs.mob_vx, gs.t) + 5 * n
    return bound(ins + outs + 9 * n, 0)


def boss_step_bound(gs):
    """Least time in ms of bossfight's step kernel on State gs: bytes, the
    state's fields read once and written once, the barriers and the action
    read, reward and done written."""
    lv = gs.level
    n = gs.pos.shape[0]
    fields = [getattr(gs, name) for name in bossfight._STEP_FIELDS]
    return bound(2 * tensor_bytes(fields)
                 + tensor_bytes(lv.barrier_pos, lv.barrier_exists) + 9 * n, 0)


def graph_ms(fn, iters):
    """Mean device time of fn() in ms with no host time between calls: one
    call captured in a CUDA graph (after a warm-up on a side stream),
    replayed between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, iters)


def step_vs_plain(game, cfg, gs, action, iters):
    """A game's step kernel (`game.step` on the card) against its plain
    step on State gs and int32 action [N]: every output bitwise equal
    (raises otherwise). Returns (kernel ms eagerly, kernel ms in a graph,
    plain ms), CUDA events; the eager time includes the wrapper's host
    time where that is the longer."""
    got = game.step(cfg, gs, action)
    want = game.step_reference(cfg, gs, action)
    same_tree(got[:3], want[:3], f"{game.NAME} step kernel vs plain")
    ms = cuda_ms(lambda: game.step(cfg, gs, action), iters)
    in_graph = graph_ms(lambda: game.step(cfg, gs, action), iters)
    plain_ms = cuda_ms(lambda: game.step_reference(cfg, gs, action), 3)
    return ms, in_graph, plain_ms


def coinrun_path(actions):
    """Coinrun's main path, its checks, the CPU re-run, the scene kernel
    and the step kernel against their plain versions on the real inputs,
    and the breakdown. Returns both kernels' JSON entries (the scene
    kernel's without the random-input numbers)."""
    env = pt.make("coinrun")  # the documented entry point: on the card
    bank = make_bank(env)
    obs_buf = torch.empty((T, NUM_ENVS, 64, 64, 3), dtype=torch.uint8,
                          device=env.device)

    def place(gs):
        return place_on_hazards(gs, CPU_ENVS)

    coinrun_step.step.launches = 0
    states, out, lanes, [launches] = drive(env, bank, actions, obs_buf,
                                           place, scene_kernel.scene_raw)
    step_launches = coinrun_step.step.launches
    if step_launches != 2 * T:  # drive's two runs, one launch a step
        raise AssertionError(f"the coinrun main path launched the step "
                             f"kernel {step_launches} times, expected {2 * T}")
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

    step_ms, step_graph, step_plain = step_vs_plain(
        coinrun, env.cfg, state.game, actions[-1], 20)
    step_b, step_by = step_bound(state.game)
    log(f"coinrun step kernel vs plain on the last step's state, "
        f"N={NUM_ENVS}: bitwise equal; kernel {step_ms:.4f} ms eagerly, "
        f"{step_graph:.4f} ms in a graph, plain {step_plain:.4f} ms, bound "
        f"{step_b:.4f} ms ({step_by}); launches {step_launches} over the "
        f"main path's two runs of {T} steps")

    img = scene_kernel.scene_raw(*inputs)
    breakdown(env, bank, state, actions[-1], obs_buf, [
        ("scene inputs (coinrun._scene_inputs)",
         lambda: coinrun._scene_inputs(env.cfg, state.game)),
        ("scene kernel (scene_raw)", lambda: scene_kernel.scene_raw(*inputs)),
        ("round / clip / uint8",
         lambda: torch.clamp(torch.round(img), 0, 255).to(torch.uint8)),
    ])
    return (dict(name="scene_raw", route="cuda",
                 source="procgen2_tpu_torch/render/csrc/scene_kernel.cu",
                 replaces="procgen2_tpu/render/scene_kernel.py:206",
                 launches=launches, max_abs_err=err, ms=ms,
                 plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                 library_ms=None),
            dict(name="coinrun_step", route="cuda",
                 source="procgen2_tpu_torch/render/csrc/coinrun_step.cu",
                 replaces=None, launches=step_launches, max_abs_err=0.0,
                 ms=step_ms, graph_ms=step_graph, plain_ms=step_plain,
                 bound_ms=step_b, bound_by=step_by, library_ms=None))


def bossfight_path(actions):
    """Bossfight's main path, its checks, the CPU re-run, the stamp kernel
    and the step kernel against their plain versions on the real inputs,
    and the breakdown. Returns both kernels' JSON entries."""
    env = pt.make("bossfight")
    bank = make_bank(env)
    obs_buf = torch.empty((T, NUM_ENVS, 64, 64, 3), dtype=torch.uint8,
                          device=env.device)

    bossfight_step.step.launches = 0
    states, out, lanes, [launches] = drive(env, bank, actions, obs_buf,
                                           place_boss_deaths,
                                           stamp_kernel.composite)
    step_launches = bossfight_step.step.launches
    if step_launches != 2 * T:  # drive's two runs, one launch a step
        raise AssertionError(f"the bossfight main path launched the step "
                             f"kernel {step_launches} times, expected {2 * T}")
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

    step_ms, step_graph, step_plain = step_vs_plain(
        bossfight, env.cfg, gs, actions[-1], 20)
    step_b, step_by = boss_step_bound(gs)
    log(f"bossfight step kernel vs plain on the last step's state, "
        f"N={NUM_ENVS}: bitwise equal; kernel {step_ms:.4f} ms eagerly, "
        f"{step_graph:.4f} ms in a graph, plain {step_plain:.4f} ms, bound "
        f"{step_b:.4f} ms ({step_by}); launches {step_launches} over the "
        f"main path's two runs of {T} steps")

    out_img = stamp_kernel.composite(img, groups)
    breakdown(env, bank, states[-1], actions[-1], obs_buf, [
        ("render inputs (bossfight._stamp_groups: _cull_alive, _r0c0)",
         lambda: bossfight._stamp_groups(env.cfg, gs)),
        ("stamp kernel (composite, 4 groups)",
         lambda: stamp_kernel.composite(img, groups)),
        ("round / clip / uint8",
         lambda: torch.clamp(torch.round(out_img), 0, 255).to(torch.uint8)),
    ])
    return (dict(name="composite", route="cuda",
                 source="procgen2_tpu_torch/render/csrc/stamp_kernel.cu",
                 replaces="procgen2_tpu/render/stamp_kernel.py:182",
                 launches=launches, max_abs_err=err, ms=ms,
                 plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                 library_ms=None),
            dict(name="bossfight_step", route="cuda",
                 source="procgen2_tpu_torch/render/csrc/bossfight_step.cu",
                 replaces=None, launches=step_launches, max_abs_err=0.0,
                 ms=step_ms, graph_ms=step_graph, plain_ms=step_plain,
                 bound_ms=step_b, bound_by=step_by, library_ms=None))


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
    """The render's parts of a maze state as breakdown entries: M1, the
    whole render in one launch; then the plain render's kind field, the
    background, the four kind blends, and the rounding."""
    R = maze._render_tensors(cfg.mode, str(device))
    G = maze._kind_field(gs, R)
    img = R["bg_bank"][gs.level.bg_index.long()].to(torch.bfloat16)

    def blends():
        out = img
        for name, on in maze._LAYERS:
            out = compositor.blend_kind(out, on(G), *R[name])
        return out

    bf = blends()
    return [
        ("M1 (maze_render_kernel, the whole render)",
         lambda: maze.observe_batch(cfg, gs)),
        ("kind field (kind grid + gather)", lambda: maze._kind_field(gs, R)),
        ("background gather (bf16)",
         lambda: R["bg_bank"][gs.level.bg_index.long()].to(torch.bfloat16)),
        ("4 kind blends (bf16 ops)", blends),
        ("round / clip / uint8",
         lambda: torch.clamp(torch.round(bf), 0, 255).to(torch.uint8)),
    ]


def m1_bound(gs, consts):
    """(bound_ms, bound_by) of one M1 call on State gs: bytes, the obs
    written once, each env's grid, positions, facing and background index
    read once, and the constants (backgrounds, walled backgrounds, kind
    images, tables) read once."""
    lv = gs.level
    n = gs.pos.shape[0]
    ins = tensor_bytes(lv.grid, lv.goal_pos, gs.pos, gs.face_forward,
                       lv.bg_index, consts.tables, consts.bg_bank,
                       consts.walled, consts.kinds, consts.layer_lut)
    return bound(ins + n * 3 * 64 * 64, 0)


def m1_vs_plain(cfg, gs, iters=20):
    """M1 (`maze.observe_batch` on the card) against the plain render
    (`maze.observe_batch_reference`) on State gs: the obs bitwise equal
    (raises otherwise), then the kernel's time eagerly and in a graph, the
    plain render's, and the bytes bound, by CUDA events. Returns the
    kernel's JSON entry."""
    got = maze.observe_batch(cfg, gs)
    want = maze.observe_batch_reference(cfg, gs)
    torch.cuda.synchronize()
    ndiff = int((got != want).sum())
    if ndiff:
        raise AssertionError(f"M1 differs from the plain render in {ndiff} "
                             f"obs bytes")
    ms = cuda_ms(lambda: maze.observe_batch(cfg, gs), iters)
    in_graph = graph_ms(lambda: maze.observe_batch(cfg, gs), iters)
    plain_ms = cuda_ms(lambda: maze.observe_batch_reference(cfg, gs), 3)
    consts = maze._render_tensors(cfg.mode, str(gs.pos.device))["m1"]
    bound_ms, bound_by = m1_bound(gs, consts)
    n = gs.pos.shape[0]
    log(f"M1 vs the plain render on the main path's last states, {cfg.mode} "
        f"N={n}: bitwise equal; kernel {ms:.4f} ms eagerly, {in_graph:.4f} "
        f"ms in a graph, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by})")
    return dict(name="maze_render", route="cuda",
                source="procgen2_tpu_torch/render/csrc/maze_render.cu",
                replaces=None, max_abs_err=0.0, ms=ms, graph_ms=in_graph,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


def maze_path(dev):
    """Maze's main path at the bench's shape (procgen2_tpu/bench.py:31:
    easy, 2048 levels, 8192 envs, T = 8), its checks (M1 launched once a
    render, no other kernel), the CPU re-run, M1 against the plain render
    on the last states, and the breakdown."""
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

    states, out, lanes, launches = drive(
        env, bank, actions, obs_buf, place, maze_render.render,
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
    m1 = dict(m1_vs_plain(env.cfg, states[-1].game), launches=launches[0])
    parts = maze_kind_parts(env.cfg, states[-1].game, env.device)
    numbers = breakdown(env, bank, states[-1], actions[-1], obs_buf, parts)
    return dict(numbers, peak_gib=peak, m1=m1)


def maze_modes_path(dev):
    """Maze hard (the default Config, 25 x 25) and memory (31 x 31 under
    the agent-centred camera): a 256-level bank, reset(NUM_ENVS), 2 steps
    with the placed lanes, M1 launched once a step in hard mode and never
    in memory mode (its plain render), no other kernel, and the CPU re-run
    of the first 8 envs."""
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
        for w in KERNEL_WRAPPERS + (maze_render.render,):
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
        m1_want = 0 if env.cfg.agent_centered else 2
        if maze_render.render.launches != m1_want:
            raise AssertionError(f"maze {mode} launched M1 "
                                 f"{maze_render.render.launches} times, "
                                 f"expected {m1_want}")
        rewards = torch.stack([r for r, _ in out])
        dones = torch.stack([d for _, d in out])
        lanes_restarted(states, dones, rewards, lanes, (10.0, 0.0),
                        lambda g, i: True)
        cpu_rerun("maze", bank, actions, obs, states, out, place, lanes,
                  steps=2, mode=mode)
        log(f"maze {mode}: 256 levels, {NUM_ENVS} envs, 2 steps, M1 launched "
            f"{m1_want} times and no other kernel; obs mean {float(obs.float().mean()):.3f}; both "
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



# The rollout phase: (game, config, levels, envs) at chip_smoke's shapes,
# and the kernels one replay of T steps must launch, by the name of their
# __global__ function (B1 scene_raw_kernel, B3 stamp_composite_kernel):
# one per step and kernel group (coinrun's exact path: two B3 groups).
ROLLOUT_CASES = (
    ("coinrun", {}, {"scene_raw_kernel": T}),
    ("bossfight", {}, {"stamp_composite_kernel": T}),
    ("climber", {}, {"scene_raw_kernel": T}),
    ("caveflyer", {}, {"scene_raw_kernel": T}),
    ("jumper", {}, {"scene_raw_kernel": T, "stamp_composite_kernel": T}),
    ("chaser", {}, {}),
    ("maze", {"mode": "easy"}, {}),
    ("coinrun", {"scene_phases": 0}, {"stamp_composite_kernel": 2 * T}),
)
# each kernel's name in a profile, and its wrapper
KERNEL_OF = {"scene_raw_kernel": scene_kernel.scene_raw,
             "scene_kernel": scene_kernel.scene,
             "stamp_composite_kernel": stamp_kernel.composite,
             "stamp_sum_kernel": stamp_kernel.stamps}
ROLLOUT_KERNELS = tuple(KERNEL_OF)
# the games with a kernel of their own launched once a step (coinrun's
# and bossfight's step, maze's render M1), by the name of its __global__
# function: one per step of a replay
STEP_KERNEL_OF = {"coinrun": "coinrun_step_kernel",
                  "bossfight": "bossfight_step_kernel",
                  "maze": "maze_render_kernel"}
ROLLOUT_CPU_ENVS = 64


def same_buffers(a, b, what):
    """Two (final state, RolloutBuffer) pairs bitwise equal."""
    same_tree(a[0], b[0], f"{what}: final state")
    same_tree(a[1], b[1], f"{what}: rollout buffer")


def graph_pool_bytes(graph):
    """Bytes of the memory segments of a CUDA graph's private pool (the
    allocator's snapshot), or None where the snapshot does not say."""
    pool = tuple(graph.pool())
    segs = torch.cuda.memory_snapshot()
    if not segs or "segment_pool_id" not in segs[0]:
        return None
    return sum(s["total_size"] for s in segs
               if tuple(s["segment_pool_id"]) == pool)


def replay_profile(fn):
    """torch.profiler over one call of fn, a rollout: ({kernel name:
    launches}, summed device ms), or (None, None) where it saw no device
    events. The first rollout under a profiler captures the graph with its
    layer marks (`utils/trace.py`), so fn runs once under a profiler
    first, and the second call, a replay of that graph, is the one read."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):
        fn()
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return None, None
    counts = {}
    for e in kernels:
        for k in ROLLOUT_KERNELS + tuple(STEP_KERNEL_OF.values()):
            if k + "(" in e.name or e.name == k or k + "<" in e.name:
                counts[k] = counts.get(k, 0) + 1
    return counts, sum(e.time_range.elapsed_us() for e in kernels) / 1e3


def rollout_path(name, cfg, kernels, n_levels=NUM_LEVELS, n_envs=NUM_ENVS,
                 replays=5, label=None, made=None):
    """`dist.rollout` of T steps as one CUDA graph: captured (warm-up and
    capture timed, the graph's pool measured), then held bitwise against
    an eager `Environment.step` loop on the same state and the buffer's
    actions (every buffer field and the final state); a rollout of 64
    envs on the card against the same rollout on the CPU; the kernels of
    one replay counted by the profiler (`kernels`: {name: launches}; the
    wrappers' counters see only the warm-up and the capture); the graph's
    and the eager loop's env-steps/s; the device's idle share of a
    replay. `made`: (env, bank, state) to start from instead of make,
    generate_bank and reset. Returns the numbers."""
    from procgen2_tpu_torch.dist import rollout
    from procgen2_tpu_torch.dist.rollout import graphs
    from types import SimpleNamespace

    if label is None:
        label = name + ("" if not cfg.get("scene_phases", 1) == 0
                        else " scene_phases=0")
    if made is None:
        env = pt.make(name, **cfg)
        bank = env.generate_bank(pt.random.key(0, env.device), n_levels)
        state, _ = env.reset(bank, pt.random.key(1, env.device), n_envs)
    else:
        env, bank, state = made
    dev = env.device
    vec = SimpleNamespace(env=env, bank=bank)
    key = pt.random.key(5, dev)
    for w in KERNEL_WRAPPERS:
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graph_out = rollout(vec, state, key, T)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    counted = {w.__name__: w.launches for w in KERNEL_WRAPPERS}
    [g] = graphs(env).values()
    pool = graph_pool_bytes(g.graph)

    # the eager loop on the same state and the buffer's actions
    buf = graph_out[1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, outs = state, []
    for t in range(T):
        st, ts = env.step(bank, st, buf.actions[t])
        outs.append((ts.obs, buf.actions[t], ts.reward, ts.terminated,
                     ts.info["returned_episode_return"],
                     ts.info["returned_episode_length"]))
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    eager = (st, type(buf)(*(torch.stack(x) for x in zip(*outs))))
    same_buffers(graph_out, eager, f"{label} rollout: graph vs eager")
    again = rollout(vec, state, key, T)  # a replay from the same inputs
    same_buffers(graph_out, again, f"{label} rollout: replay vs capture")
    if int(buf.obs.flatten(1).float().std(1).eq(0).sum()):
        raise AssertionError(f"{label} rollout: a constant frame")

    # replays, chained, and one replay under the profiler
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = graph_out[0]
    for _ in range(replays):
        st, _ = rollout(vec, st, key, T)
    torch.cuda.synchronize()
    replay_s = (time.perf_counter() - t0) / replays
    if len(graphs(env)) != 1:
        raise AssertionError(f"{label} rollout: the replays captured "
                             f"{len(graphs(env)) - 1} more graphs")
    counts, dev_ms = replay_profile(lambda: rollout(vec, st, key, T))
    if counts is not None:
        want = {k: kernels.get(k, 0) for k in ROLLOUT_KERNELS}
        got = {k: counts.get(k, 0) for k in ROLLOUT_KERNELS}
        for game, k in STEP_KERNEL_OF.items():
            want[k] = T if name == game else 0
            got[k] = counts.get(k, 0)
        if got != want:
            raise AssertionError(f"{label} rollout: one replay launched "
                                 f"{got}, expected {want}")
    idle = None if dev_ms is None else 1.0 - dev_ms / (replay_s * 1e3)

    # 64 envs on the card against the CPU
    cbank = tree_map(lambda x: x[:n_levels].cpu(), bank)
    cenv = pt.make(name, device="cpu", **cfg)
    s64, _ = env.reset(bank, pt.random.key(7, dev), ROLLOUT_CPU_ENVS)
    c64, _ = cenv.reset(cbank, pt.random.key(7), ROLLOUT_CPU_ENVS)
    card = rollout(vec, s64, pt.random.key(8, dev), T)
    host = rollout(SimpleNamespace(env=cenv, bank=cbank), c64,
                   pt.random.key(8), T)
    same_buffers(card, host, f"{label} rollout of {ROLLOUT_CPU_ENVS} envs: "
                 "card vs CPU")

    out = dict(game=label, capture_s=capture_s, pool_bytes=pool,
               graph_steps_per_s=T * n_envs / replay_s,
               eager_steps_per_s=T * n_envs / eager_s, replay_ms=replay_s * 1e3,
               device_ms=dev_ms, idle=idle, launches=counts,
               counted=counted)
    log(f"{label} rollout at {n_envs} envs, T = {T}: graph == eager loop "
        f"bitwise (every buffer field, final state; "
        f"{int(buf.dones.sum())} episode ends), a replay == the capture, "
        f"{ROLLOUT_CPU_ENVS} envs on the card == the CPU; capture "
        f"{capture_s:.3f} s (warm-up included), graph pool "
        f"{'not measured' if pool is None else f'{pool / 2**20:.1f} MiB'}; "
        f"graph {out['graph_steps_per_s']:.1f} env-steps/s "
        f"({out['replay_ms']:.3f} ms per rollout), eager "
        f"{out['eager_steps_per_s']:.1f} env-steps/s; one replay: kernels "
        f"{counts} (wrapper counts over warm-up + capture {counted}), device "
        f"{'not measured' if dev_ms is None else f'{dev_ms:.3f} ms'}, idle "
        f"{'not measured' if idle is None else f'{100 * idle:.1f}%'}")
    return out


def gym_check(steps=20):
    """`GymEnv("maze")` on the card against the same on the CPU, the same
    seed: the reset's and every step's obs, reward, termination and
    truncation equal (the episode reset by the caller when it ends)."""
    card = pt.GymEnv("maze", num_levels=64, seed=7)
    host = pt.GymEnv("maze", num_levels=64, seed=7, device="cpu")
    g = torch.Generator()
    g.manual_seed(11)
    a0, b0 = card.reset(), host.reset()
    if not (a0[0]["screen"] == b0[0]["screen"]).all():
        raise AssertionError("GymEnv: card and CPU reset frames differ")
    ends = 0
    for t, a in enumerate(torch.randint(0, 15, (steps,), generator=g)):
        x, y = card.step(int(a)), host.step({"action": [int(a)]})
        if not ((x[0]["screen"] == y[0]["screen"]).all() and x[1:4] == y[1:4]):
            raise AssertionError(f"GymEnv step {t}: card and CPU differ")
        if x[2]:
            ends += 1
            card.reset(), host.reset()
    log(f"GymEnv('maze') on the card == on the CPU over {steps} steps "
        f"(seed 7; {ends} episode ends; obs {x[0]['screen'].shape} "
        f"{x[0]['screen'].dtype})")


def checkpoint_check(tmpdir):
    """A state saved on the card between two rollouts, restored onto the
    card and rolled on, equals the live continuation bitwise."""
    from types import SimpleNamespace

    from procgen2_tpu_torch.dist import rollout
    from procgen2_tpu_torch.utils import checkpoint

    env = pt.make("maze", mode="easy", timeout=12)
    dev = env.device
    vec = SimpleNamespace(env=env, bank=env.generate_bank(
        pt.random.key(0, dev), 256))
    state, _ = env.reset(vec.bank, pt.random.key(1, dev), NUM_ENVS)
    state, _ = rollout(vec, state, pt.random.key(2, dev), T)
    path = str(pathlib.Path(tmpdir) / "ck.npz")
    checkpoint.save(path, state=state, bank=vec.bank)
    res = checkpoint.restore(path, state=state, bank=vec.bank)
    live = rollout(vec, state, pt.random.key(3, dev), T)
    back = rollout(SimpleNamespace(env=env, bank=res["bank"]), res["state"],
                   pt.random.key(3, dev), T)
    same_buffers(live, back, "checkpoint: restored vs live continuation")
    log(f"checkpoint: maze state at {NUM_ENVS} envs saved after {T} steps "
        f"on the card, restored and rolled {T} more: equal to the live "
        f"run bitwise ({int(live[1].dones.sum())} episode ends)")


def guards_check():
    """`guards.checked_step` on 3 clean coinrun steps on the card, then on
    a state with a NaN in one position, which must raise."""
    from procgen2_tpu_torch.utils import guards

    env = pt.make("coinrun")
    dev = env.device
    bank = env.generate_bank(pt.random.key(0, dev), 64)
    state, _ = env.reset(bank, pt.random.key(1, dev), 256)
    step = guards.checked_step(env)
    for i in range(3):
        state, ts = step(bank, state, pt.random.randint(
            pt.random.key(i, dev), (256,), 0, 15))
    pos = state.game.pos.clone()
    pos[3, 1] = float("nan")
    bad = dataclasses.replace(state, game=dataclasses.replace(state.game,
                                                              pos=pos))
    try:
        step(bank, bad, torch.zeros(256, dtype=torch.int32, device=dev))
    except guards.GuardError as e:
        log(f"guards: 3 clean coinrun steps at 256 envs passed; a NaN in a "
            f"position raised: {e}")
    else:
        raise AssertionError("guards: a NaN in the state did not raise")


def surface_phase():
    import tempfile
    gym_check()
    with tempfile.TemporaryDirectory() as d:
        checkpoint_check(d)
    guards_check()


# ---- the rollout's graph table under fresh policies (ROADMAP C3) ----

def policy_net(params, policy_state, k):
    """A policy as a learner binds it, `functools.partial(policy_net,
    params)`: it reads params through the partial, not policy_state."""
    return (params + pt.random.randint(k, params.shape, 0, 3)) % 15


def policy_rollout(vec, state, key, policy, params, num_steps):
    """`rollout` with `policy`, a `partial(policy_net, params)`, held
    against the eager loop on its actions (every buffer field and the
    final state), and its actions against the policy's on the same keys.
    Returns the buffer."""
    from procgen2_tpu_torch.dist import rollout
    out = rollout(vec, state, key, num_steps, policy=policy)
    want, st, outs = [], state, []
    for t in range(num_steps):
        key, k_act = pt.random.split(key).unbind(-2)
        want.append(policy_net(params, None, k_act))
        st, ts = vec.env.step(vec.bank, st, out[1].actions[t])
        outs.append((ts.obs, out[1].actions[t], ts.reward, ts.terminated,
                     ts.info["returned_episode_return"],
                     ts.info["returned_episode_length"]))
    if not torch.equal(out[1].actions, torch.stack(want)):
        raise AssertionError("a graph rollout's actions are not its "
                             "policy's")
    same_buffers(out, (st, type(out[1])(*(torch.stack(x) for x in zip(*outs)))),
                 "policy rollout: graph vs eager")
    return out[1]


def fresh_policy_rollouts(calls=20, n_envs=256, num_steps=4):
    """`calls` rollouts of coinrun at n_envs, each with a fresh
    `partial(policy_net, params)` and fresh params, as a learner binds its
    weights per call: each captures a graph and is held by
    `policy_rollout`. The device memory reserved after the last call may
    exceed that after the second by at most the first graph's pool plus
    10%, and once the table is full (the first eviction, call
    GRAPHS_PER_ENV + 1) it grows by at most 10% of that pool: the memory
    of evicted graphs is reused. The env keeps GRAPHS_PER_ENV graphs, all
    in one pool. Returns the numbers."""
    import functools
    from types import SimpleNamespace

    from procgen2_tpu_torch.dist.rollout import graphs
    env = pt.make("coinrun")
    dev = env.device
    bank = env.generate_bank(pt.random.key(0, dev), 64)
    state, _ = env.reset(bank, pt.random.key(1, dev), n_envs)
    vec = SimpleNamespace(env=env, bank=bank)
    torch.cuda.synchronize()
    before = torch.cuda.memory_reserved(dev)
    reserved, pool = [], None
    for i in range(calls):
        params = (torch.arange(n_envs, dtype=torch.int32, device=dev) + i) % 15
        policy_rollout(vec, state, pt.random.key(100 + i, dev),
                       functools.partial(policy_net, params), params,
                       num_steps)
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved(dev))
        if pool is None:
            [g] = graphs(env).values()
            pool = graph_pool_bytes(g.graph)
    log(f"C3: {calls} coinrun rollouts at {n_envs} envs, T = {num_steps}, "
        f"each with a fresh partial(policy, params): each == its eager loop "
        f"bitwise and read its own params; memory_reserved before "
        f"{before / 2**20:.1f} MiB, after each call "
        f"{[r / 2**20 for r in reserved]} MiB; the first graph's pool "
        f"{'not measured' if pool is None else f'{pool / 2**20:.1f} MiB'}")
    if pool is None or reserved[-1] - reserved[1] > 1.1 * pool:
        raise AssertionError(f"C3: memory_reserved grew by "
                             f"{reserved[-1] - reserved[1]} B from call 2 to "
                             f"call {calls}, over 1.1 x the first graph's "
                             f"pool ({pool} B)")
    from procgen2_tpu_torch.dist.rollout import GRAPHS_PER_ENV
    if reserved[-1] - reserved[GRAPHS_PER_ENV] > 0.1 * pool:
        raise AssertionError(f"C3: memory_reserved grew by "
                             f"{reserved[-1] - reserved[GRAPHS_PER_ENV]} B "
                             f"after the table filled, over 0.1 x the first "
                             f"graph's pool ({pool} B)")
    table = graphs(env)
    pools = {tuple(g.graph.pool()) for g in table.values()}
    if len(table) != GRAPHS_PER_ENV or len(pools) != 1:
        raise AssertionError(f"C3: the env keeps {len(table)} graphs in "
                             f"{len(pools)} pools, expected {GRAPHS_PER_ENV} "
                             "in one")
    return dict(before=before, reserved=reserved, pool=pool)


def interleaved_replays(n_envs=64, num_steps=4):
    """Graphs A and B, captured in the env's one pool on two banks with
    two policies, replayed A, B, A, B from other keys: each replay equals
    its eager loop bitwise (`policy_rollout`)."""
    import functools
    from types import SimpleNamespace

    from procgen2_tpu_torch.dist.rollout import graphs
    env = pt.make("coinrun")
    dev = env.device
    vecs = [SimpleNamespace(env=env, bank=env.generate_bank(
        pt.random.key(k, dev), 16)) for k in (0, 9)]
    state, _ = env.reset(vecs[0].bank, pt.random.key(1, dev), n_envs)
    params = [torch.full((n_envs,), v, dtype=torch.int32, device=dev)
              for v in (0, 7)]
    policies = [functools.partial(policy_net, p) for p in params]
    for i in range(4):
        policy_rollout(vecs[i % 2], state, pt.random.key(20 + i, dev),
                       policies[i % 2], params[i % 2], num_steps)
    table = graphs(env)
    if len(table) != 2 or len({tuple(g.graph.pool())
                               for g in table.values()}) != 1:
        raise AssertionError("interleaved replays: expected 2 graphs in one "
                             "pool")
    log(f"C3: graphs A and B in one pool (two banks, two policies, coinrun "
        f"at {n_envs} envs), replayed A, B, A, B: each == its eager loop "
        "bitwise")


def render_kernels_vs_plain(name, env, gs):
    """The kernels of game `name`'s render (B1; B3 for bossfight and
    jumper's needle) against their plain versions on the render inputs
    of game state `gs`, timed beside their bounds: {wrapper name: (err,
    ms, plain ms, bound ms, bound_by)}."""
    game = {"coinrun": coinrun, "climber": climber, "caveflyer": caveflyer,
            "jumper": jumper, "bossfight": bossfight}.get(name)
    out = {}
    if name == "bossfight":
        img, groups = bossfight._stamp_groups(env.cfg, gs)
        out["composite"] = (*stamps_vs_plain(img, groups, 20),
                            *stamp_bound(img, groups))
    elif game is not None:
        inputs = game._scene_inputs(env.cfg, gs)
        out["scene_raw"] = (*scene_vs_plain(inputs, 20), *scene_bound(inputs))
        if name == "jumper":
            ST = jumper._scene_tensors(env.cfg.scene_phases,
                                       env.cfg.world_dim, str(env.device))
            blended = jumper._compass(scene_kernel.scene_raw(*inputs), ST)
            needle = [compositor.stamp_group(ST["banks"]["needle"],
                                             *jumper._needle_stamp(gs))]
            out["composite"] = (*stamps_vs_plain(blended, needle, 20),
                                *stamp_bound(blended, needle))
    return out


# ---- the main paths at other configs (hard, memory, easy_mode, ...) ----

def mode_path(label, n_levels=NUM_LEVELS, n_envs=NUM_ENVS, replays=3):
    """The main path at MODE_CASES[label]: make -> generate_bank(n_levels)
    -> reset(n_envs) -> the lanes placed -> T steps, the kernel wrappers'
    counts set to 0 just before the reset and read after the last step
    (each of the case's kernels T + 1 times, no other), the placed lanes
    ending on step 0 and restarting, peak device memory over bank, reset
    and the T steps; B1 (and for jumper B3 on its needle) held bitwise
    against its plain version on the last step's inputs and timed beside
    its bound; then `rollout_path` from the same bank and placed state.
    Returns the numbers."""
    name, cfg, place, kernels = MODE_CASES[label]
    game = {"caveflyer": caveflyer, "jumper": jumper, "climber": climber,
            "coinrun": coinrun}[name]
    env = pt.make(name, **cfg)
    dev = env.device
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    bank = env.generate_bank(pt.random.key(0, dev), n_levels)
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    actions = torch.randint(0, 15, (T, n_envs), generator=g, device=dev,
                            dtype=torch.int32)
    torch.cuda.synchronize()
    for w in KERNEL_WRAPPERS:
        w.launches = 0
    state, _ = env.reset(bank, pt.random.key(1, dev), n_envs)
    gs, lanes = place(state.game, CPU_ENVS)
    start = dataclasses.replace(state, game=gs)
    st = start
    for t in range(T):
        st, ts = env.step(bank, st, actions[t])
        if t == 0:
            first = (st, ts)
    torch.cuda.synchronize()
    counted = {w.__name__: w.launches for w in KERNEL_WRAPPERS}
    peak = peak_gib()
    want = {KERNEL_OF[k].__name__: T + 1 for k in kernels}
    if counted != {w.__name__: want.get(w.__name__, 0)
                   for w in KERNEL_WRAPPERS}:
        raise AssertionError(f"{label}: the main path launched {counted}, "
                             f"expected {want}")
    st0, ts0 = first
    for lane in lanes:
        if not (bool(ts0.terminated[lane]) and int(st0.ep_length[lane]) == 0
                and int(st0.game.t[lane]) == 0):
            raise AssertionError(f"{label}: lane {lane} did not end and "
                                 "restart on step 0")

    inputs = game._scene_inputs(env.cfg, st.game)
    slots = [grp[1].shape[1] for grp in inputs[12]]
    kern = render_kernels_vs_plain(name, env, st.game)
    err1, ms1, plain1, b1, by1 = kern["scene_raw"]
    out = dict(label=label, lanes=lanes, launches=counted, peak_gib=peak,
               b1=dict(ms=ms1, plain_ms=plain1, bound_ms=b1, bound_by=by1,
                       slots=slots, err=err1))
    log(f"{label}: main path at {n_envs} envs on {n_levels} levels, T = {T}: "
        f"kernel launches {counted}; lanes {lanes} ended on step 0 and "
        f"restarted; peak device memory over bank, reset and {T} steps "
        f"{peak:.3f} GiB; B1 vs plain on its inputs (grid "
        f"{tuple(inputs[0].shape)}, groups K = {slots}): bitwise equal, "
        f"kernel {ms1:.4f} ms, plain {plain1:.4f} ms, bound {b1:.4f} ms "
        f"({by1})")
    if "composite" in kern:  # jumper's needle
        err3, ms3, plain3, b3, by3 = kern["composite"]
        out["b3"] = dict(ms=ms3, plain_ms=plain3, bound_ms=b3, bound_by=by3,
                         err=err3)
        log(f"{label}: B3 vs plain on the needle: bitwise equal, kernel "
            f"{ms3:.4f} ms, plain {plain3:.4f} ms, bound {b3:.4f} ms ({by3})")
    gc.collect()
    out["rollout"] = rollout_path(name, cfg, kernels, n_levels, n_envs,
                                  replays=replays, label=label,
                                  made=(env, bank, start))
    return out


# ---- make_vec on the card, W = 1 ----

def vec_phase(n_envs=MAZE_ENVS, n_levels=MAZE_LEVELS):
    """`make_vec("maze", n_envs, n_levels, mode="easy")` on the card
    (one process): its bank, reset and rollout equal those of
    `make("maze", mode="easy")` with the bank key fold_in(key, 17) and
    the same keys, bitwise; `metrics` of a step with a goal lane and a
    timeout lane ending equals the three numbers computed in float64 on
    the host from the card's TimeStep (episodes_done exactly, the means
    within 2^-22 relative: the sums of maze's 0 and 10 are exact, and each
    mean is one f32 division); the rollout's env-steps/s. Returns them."""
    from types import SimpleNamespace

    from procgen2_tpu_torch.dist import make_vec, rollout
    venv = make_vec("maze", num_envs=n_envs, num_levels=n_levels,
                    mode="easy")
    dev = venv.env.device
    if (venv.world, venv.rank, venv.lo, venv.hi) != (1, 0, 0, n_envs):
        raise AssertionError("make_vec in one process: not one rank over "
                             "the whole batch")
    vstate, vts = venv.reset(pt.random.key(0, dev))
    env = pt.make("maze", mode="easy")
    bank = env.generate_bank(prng.fold_in(pt.random.key(0, dev), 17),
                             n_levels)
    state, ts = env.reset(bank, pt.random.key(0, dev), n_envs)
    same_tree(venv.bank, bank, "make_vec bank vs make")
    same_tree(vstate, state, "make_vec reset state vs make")
    if not torch.equal(vts.obs, ts.obs):
        raise AssertionError("make_vec reset obs differ from make's")
    key = pt.random.key(3, dev)
    vout = rollout(venv, vstate, key, T)
    same_buffers(vout, rollout(SimpleNamespace(env=env, bank=bank), state,
                               key, T), "make_vec rollout vs make")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = vout[0]
    for _ in range(3):
        st, _ = rollout(venv, st, key, T)
    torch.cuda.synchronize()
    sps = 3 * T * n_envs / (time.perf_counter() - t0)

    gs, lanes = place_maze_lanes(st.game, venv.env.cfg)
    a = torch.zeros(n_envs, dtype=torch.int32, device=dev) + 4
    _, sts = venv.step(dataclasses.replace(st, game=gs), a)
    m = venv.metrics(sts)
    r = sts.reward.double().cpu()
    d = sts.terminated.cpu()
    ret = sts.info["returned_episode_return"].double().cpu()
    n = int(d.sum())
    host = dict(reward_mean=float(r.mean()), episodes_done=n,
                episode_return_mean=float((ret * d).sum() / max(n, 1))
                if n else 0.0)
    if int(m["episodes_done"]) != n or n < len(lanes):
        raise AssertionError(f"make_vec metrics: episodes_done "
                             f"{int(m['episodes_done'])}, host {n}")
    for k in ("reward_mean", "episode_return_mean"):
        if abs(float(m[k]) - host[k]) > 2.0 ** -22 * abs(host[k]):
            raise AssertionError(f"make_vec metrics: {k} {float(m[k])!r}, "
                                 f"host float64 {host[k]!r}")
    log(f"vec: make_vec('maze', {n_envs} envs, {n_levels} levels, "
        f"easy) on the card, W = 1: bank, reset and rollout == make('maze') "
        f"with fold_in(key, 17) bitwise; rollout {sps:.1f} env-steps/s "
        f"(3 replays of T = {T}); metrics {({k: float(v) for k, v in m.items()})} "
        f"vs float64 on the host {host}")
    return dict(steps_per_s=sps, metrics={k: float(v) for k, v in m.items()},
                host=host)


# ---- make(module): the example wave game on the card ----

def module_phase(n_envs=256, steps=45):
    """`make(wave_game)` on the card against `make(wave_game,
    device="cpu")` from the same keys and actions: bank, reset obs and
    every step's obs, reward and termination bitwise, past the horizon
    (step 40) and its auto-reset. No kernel launches."""
    from procgen2_tpu_torch.examples import wave_game

    card, host = pt.make(wave_game), pt.make(wave_game, device="cpu")
    dev = card.device
    cbank = card.generate_bank(pt.random.key(0, dev), 8)
    hbank = host.generate_bank(pt.random.key(0), 8)
    same_tree(cbank, hbank, "wave game bank, card vs CPU")
    for w in KERNEL_WRAPPERS:
        w.launches = 0
    cs, cts = card.reset(cbank, pt.random.key(1, dev), n_envs)
    hs, hts = host.reset(hbank, pt.random.key(1), n_envs)
    ends = 0
    for t in range(steps + 1):
        if not (torch.equal(cts.obs.cpu(), hts.obs)
                and torch.equal(cts.reward.cpu(), hts.reward)
                and torch.equal(cts.terminated.cpu(), hts.terminated)):
            raise AssertionError(f"wave game step {t}: card and CPU differ")
        ends += int(hts.terminated.sum())
        if t < steps:
            a = pt.random.randint(pt.random.key(50 + t), (n_envs,), 0, 15)
            cs, cts = card.step(cbank, cs, a.to(dev))
            hs, hts = host.step(hbank, hs, a)
    same_tree(cs, hs, "wave game final state, card vs CPU")
    if any(w.launches for w in KERNEL_WRAPPERS) or ends != n_envs:
        raise AssertionError("wave game: a kernel launched, or not every "
                             "env ended at the horizon")
    log(f"module: make(wave_game) on the card == on the CPU over {steps} "
        f"steps at {n_envs} envs (obs, reward, termination, final state; "
        f"{ends} episode ends at the horizon)")


# ---- the reference's own levels at full width (tools/reference_levels) ----

# The parity suites' runs (tests/test_torch_parity.py), on the
# card: game -> (config, its test's seeds, how it acts ("bot": the game's
# closed-loop bot, one step per replay; else the name of an open-loop
# plan, replayed T steps at a time), step cap, envs, the kernels one
# step launches by __global__ name).
REFERENCE_CASES = {
    "coinrun": ({}, [0, 1, 2, 5, 7, 9, 11, 12, 17, 19, 22, 26, 27, 31, 33],
                "bot", 400, NUM_ENVS, {"scene_raw_kernel": 1}),
    "bossfight": ({}, [1, 2, 3, 4, 5, 6, 7, 8, 9, 12], "noop", 250,
                  NUM_ENVS, {"stamp_composite_kernel": 1}),
    "climber": ({"easy_mode": True},
                [0, 5, 7, 9, 11, 12, 13, 17, 18, 19, 22, 23, 24, 25, 28],
                "bot", 1200, NUM_ENVS, {"scene_raw_kernel": 1}),
    "caveflyer": ({"mode": "hard"},
                  [7, 9, 20, 27, 35, 36, 39, 51, 53, 68, 69, 77], "bot", 900,
                  NUM_ENVS, {"scene_raw_kernel": 1}),
    "jumper": ({"mode": "easy"},
               [0, 6, 8, 9, 11, 12, 14, 15, 19, 20, 21, 22, 25, 26, 37],
               "bot", 500, NUM_ENVS,
               {"scene_raw_kernel": 1, "stamp_composite_kernel": 1}),
    "chaser": ({"mode": "easy"}, [119, 137, 261], "route", 700, NUM_ENVS,
               {}),
    "maze": ({"mode": "easy"}, list(range(20)), "route", 500, MAZE_ENVS, {}),
}
REFERENCE_OBS_STEPS = 8  # steps whose frames are held against the CPU


def reference_levels(name, device):
    """(the bank of REFERENCE_CASES[name]'s seeds on `device`, its levels
    with numpy leaves)."""
    from procgen2_tpu_torch.tools.reference_levels import (host_level,
                                                           reference_bank)
    cfg, seeds = REFERENCE_CASES[name][:2]
    bank = reference_bank(name, seeds, device,
                          **({} if name == "bossfight" else cfg))
    return bank, [host_level(bank, i) for i in range(len(seeds))]


def reference_plan(name, levels):
    """Each seed's open-loop action list: NOOPs (bossfight), the
    full-clear route (chaser) or the BFS route (maze)."""
    from procgen2_tpu_torch.tools import reference_play as rp
    if REFERENCE_CASES[name][2] == "noop":
        return [[4] * REFERENCE_CASES[name][3]] * len(levels)
    return [{"chaser": rp.chaser_plan, "maze": rp.maze_plan}[name](lvl)
            for lvl in levels]


def reference_predict(name, levels, keys0, actions, ends):
    """Each seed's (rewards, terminated) by the independent predictors
    (tools/predict.py, tools/bots.py) for its actions up to its end, or
    None where the game has none (climber, caveflyer); maze's is its
    route: 0 until +10 on the route's last step."""
    from procgen2_tpu_torch.tools import bots, predict
    acts = [actions[: e + 1, i] for i, e in enumerate(ends)]
    if name == "coinrun":
        return [predict.coinrun_predict(lvl, a) for lvl, a in zip(levels,
                                                                   acts)]
    if name == "jumper":
        return [predict.jumper_predict(lvl, a) for lvl, a in zip(levels, acts)]
    if name == "bossfight":
        return predict.bossfight_predict_many(levels, keys0, acts, "hard")
    if name == "chaser":
        return [bots.chaser_predict(lvl, a) for lvl, a in zip(levels, acts)]
    if name == "maze":
        out = []
        for route in reference_plan(name, levels):
            r = np.zeros(len(route), np.float32)
            r[-1] = 10.0
            out.append((r, np.arange(len(route)) == len(route) - 1))
        return out
    return None


def reference_cpu(name):
    """The CPU run of REFERENCE_CASES[name] through the port, one lane per
    seed (`reference_play.play`, step_raw), in a process of its own:
    rewards, dones and actions [steps, n] to the step every seed has
    ended, the first REFERENCE_OBS_STEPS steps' frames, each seed's end
    step and the predicted streams (checked against the run here)."""
    from procgen2_tpu_torch.tools import reference_play as rp
    cfg, seeds, plan, max_steps = REFERENCE_CASES[name][:4]
    env = pt.make(name, device="cpu", **cfg)
    bank, levels = reference_levels(name, "cpu")
    t0 = time.perf_counter()
    out = rp.play(env, bank, seeds,
                  None if plan == "bot" else rp.pad(reference_plan(name,
                                                                   levels)),
                  game=name, levels=levels, max_steps=max_steps,
                  render_steps=REFERENCE_OBS_STEPS, until_done=True)
    R, D, A = out["rewards"], out["dones"], out["actions"]
    if not D.any(0).all():
        raise AssertionError(f"reference {name}: seeds "
                             f"{[s for s, d in zip(seeds, D.any(0)) if not d]}"
                             " never ended on the CPU")
    ends = [int(e) for e in D.argmax(0)]
    preds = reference_predict(name, levels, out["keys0"], A, ends)
    for i, (seed, e) in enumerate(zip(seeds, ends)):
        if preds is not None and not (
                np.array_equal(preds[i][0].view(np.int32),
                               R[: e + 1, i].view(np.int32))
                and np.array_equal(preds[i][1], D[: e + 1, i])):
            raise AssertionError(f"reference {name} seed {seed}: the CPU run "
                                 "differs from the predictor's stream")
    return dict(rewards=R, dones=D, actions=A, ends=ends,
                obs=torch.stack(out["obs"]).numpy(),
                predicted=preds is not None,
                seconds=time.perf_counter() - t0)


class PlanRows:
    """A rollout policy reading its actions through `policy_state`, an
    int32 [T, N] chunk: call t of a T-step trace takes row t mod T."""

    def __init__(self, num_steps):
        self.num_steps, self.calls = num_steps, 0

    def __call__(self, chunk, k_act):
        row = chunk[self.calls % self.num_steps]
        self.calls += 1
        return row


def given_actions(actions, k_act):
    """A rollout policy whose `policy_state` is the step's actions [N]."""
    return actions


def reference_card(name):
    """REFERENCE_CASES[name] on the card at full width through
    `dist.rollout`: the seeds' bank tiled with bank_gather to the case's
    envs (env i on seed i mod n, every replica keyed alike by
    reset_pinned), the bots acting on the n distinct lanes (read back
    after each T = 1 replay, each replica given its seed's action) or
    the plan replayed T steps at a time; stops once the n lanes have
    ended. The wrappers' counts are set to 0 just before and read just
    after. Returns the run and its numbers."""
    from types import SimpleNamespace

    from procgen2_tpu_torch.dist import rollout
    from procgen2_tpu_torch.tools import reference_play as rp
    cfg, seeds, plan, max_steps, n_envs, _ = REFERENCE_CASES[name]
    env = pt.make(name, **cfg)
    dev = env.device
    n = len(seeds)
    base, levels = reference_levels(name, dev)
    seed_of = torch.arange(n_envs, device=dev) % n
    bank = bank_gather(base, seed_of)
    vec = SimpleNamespace(env=env, bank=bank)
    key = pt.random.key(5, dev)
    state = env.reset_pinned(bank, pt.random.key(rp.PIN_KEY, dev),
                             torch.tensor(seeds, device=dev)[seed_of])
    if plan == "bot":
        bots_, fields = rp.make_bots(name, levels), rp.BOTS[name][1]
        steps_per, policy = 1, given_actions
    else:
        chunks = rp.pad(reference_plan(name, levels))
        steps_per, policy = T, PlanRows(T)
    R, D, A, obs = [], [], [], []
    done = np.zeros(n, bool)
    for w in KERNEL_WRAPPERS:
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    replays = 0
    while len(R) < max_steps and not done.all():
        if plan == "bot":
            a = rp.bot_actions(bots_, rp.read(state.game, fields, n), done)
            A.append(a)
            ps = torch.from_numpy(a).to(dev)[seed_of]
        else:
            c = chunks[len(R): len(R) + T]
            c = np.concatenate([c, np.full((T - len(c), n), 4, np.int32)])
            A.extend(c)
            ps = torch.from_numpy(c).to(dev)[:, seed_of]
        state, buf = rollout(vec, state, key, steps_per, policy, ps)
        replays += 1
        if replays == 1:  # the capture (warm-up included)
            torch.cuda.synchronize()
            capture = time.perf_counter() - t0
        R.extend(buf.rewards)
        D.extend(buf.dones)
        if len(obs) < REFERENCE_OBS_STEPS:
            obs.extend(buf.obs[:, :n].clone())
        done |= buf.dones[:, :n].any(0).cpu().numpy()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counted = {w.__name__: w.launches for w in KERNEL_WRAPPERS}
    counts, dev_ms = replay_profile(lambda: rollout(vec, state, key,
                                                    steps_per, policy, ps))
    return dict(env=env, state=state, seed_of=seed_of, rewards=torch.stack(R),
                dones=torch.stack(D), actions=np.stack(A),
                obs=torch.stack(obs[:REFERENCE_OBS_STEPS]).cpu().numpy(),
                wall=wall, capture=capture, steps=len(R), replays=replays,
                counted=counted,
                counts=counts, device_ms=dev_ms, steps_per=steps_per,
                n_envs=n_envs)


def reference_check(name, card, cpu):
    """Every replica's rewards and terminations up to its seed's end equal
    the seed's CPU run (which the predictor's stream equals), the bots'
    actions equal the CPU's, and the n distinct lanes' frames of the
    first steps before their ends equal the CPU's, bitwise."""
    ends = cpu["ends"]
    last = max(ends) + 1
    if card["steps"] < last:
        raise AssertionError(f"reference {name}: the card stopped at step "
                             f"{card['steps']}, the CPU's seeds end by {last}")
    dev = card["rewards"].device
    seed_of = card["seed_of"]
    live = (torch.arange(last, device=dev)[:, None]
            <= torch.tensor(ends, device=dev)[seed_of][None])
    for what, got, want in (
            ("rewards", card["rewards"][:last], cpu["rewards"][:last]),
            ("terminations", card["dones"][:last], cpu["dones"][:last])):
        want = torch.from_numpy(want).to(dev)[:, seed_of]
        if want.dtype == torch.float32:
            got, want = got.view(torch.int32), want.view(torch.int32)
        bad = live & (got != want)
        if bool(bad.any()):
            t, lane = (int(x) for x in bad.nonzero()[0])
            raise AssertionError(f"reference {name}: {int(bad.sum())} "
                                 f"{what} differ from the seed's CPU run, "
                                 f"first at step {t}, env {lane}")
    for i, e in enumerate(ends):
        if not np.array_equal(card["actions"][: e + 1, i],
                              cpu["actions"][: e + 1, i]):
            raise AssertionError(f"reference {name}: seed "
                                 f"{REFERENCE_CASES[name][1][i]}'s actions "
                                 "differ from the CPU's")
        k = min(e, len(card["obs"]), len(cpu["obs"]))
        if not np.array_equal(card["obs"][:k, i], cpu["obs"][:k, i]):
            raise AssertionError(f"reference {name}: seed "
                                 f"{REFERENCE_CASES[name][1][i]}'s frames "
                                 "differ from the CPU's")
    return int(live.sum())


def reference_phase():
    """The reference's own levels at full width: each case's CPU run in a
    process of its own (started together), the card's run of the same
    seeds through rollout graphs, checked against it; the kernels'
    launches (wrappers at capture, the profiler per replay; none for
    chaser and maze), B1 and B3 against their plain versions on the last
    render's inputs. Returns {game: numbers}."""
    import multiprocessing

    results = {}
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(
            len(REFERENCE_CASES), mp_context=ctx,
            initializer=torch.set_num_threads, initargs=(1,)) as pool:
        cpu_runs = {name: pool.submit(reference_cpu, name)
                    for name in REFERENCE_CASES}
        for name, (_, seeds, _, _, n_envs, kernels) in \
                REFERENCE_CASES.items():
            card = reference_card(name)
            want = {KERNEL_OF[k].__name__ for k in kernels}
            for w, c in card["counted"].items():
                if (c > 0) != (w in want):
                    raise AssertionError(f"reference {name}: the run "
                                         f"launched {card['counted']}, "
                                         f"expected {sorted(want)}")
            if card["counts"] is not None:
                per = {k: kernels.get(k, 0) * card["steps_per"]
                       for k in ROLLOUT_KERNELS}
                got = {k: card["counts"].get(k, 0) for k in ROLLOUT_KERNELS}
                if got != per:
                    raise AssertionError(f"reference {name}: one replay "
                                         f"launched {got}, expected {per}")
            cpu = cpu_runs[name].result()
            held = reference_check(name, card, cpu)
            kern = render_kernels_vs_plain(name, card["env"],
                                          card["state"].game)
            # the replays after the capture: env-steps/s and idle share
            after = card["wall"] - card["capture"]
            sps = ((card["steps"] - card["steps_per"]) * n_envs / after
                   if card["replays"] > 1 else None)
            idle = (None if card["device_ms"] is None or sps is None else
                    1.0 - card["device_ms"] * (card["replays"] - 1)
                    / (after * 1e3))
            results[name] = dict(
                seeds=len(seeds), envs=n_envs, steps=card["steps"],
                replays=card["replays"], wall_s=card["wall"],
                capture_s=card["capture"], steps_per_s=sps, idle=idle, launches=card["counted"],
                per_replay=card["counts"], cpu_s=cpu["seconds"],
                kernels=kern, predicted=cpu["predicted"])
            log(f"reference {name}: {len(seeds)} seeds x {n_envs} envs, "
                f"{card['steps']} steps in {card['replays']} rollout "
                f"replays of T = {card['steps_per']}: {card['wall']:.3f} s "
                f"(the capture {card['capture']:.3f} s), after the capture "
                f"{sps} env-steps/s; device "
                f"{card['device_ms']} ms per replay, idle share "
                f"{'not measured' if idle is None else f'{100 * idle:.1f}%'}; "
                f"launches at capture {card['counted']}, per replay "
                f"{card['counts']}; {held} (step, env) rewards and "
                f"terminations up to each seed's end == the CPU run "
                f"({cpu['seconds']:.1f} s on the CPU)"
                + (", == the predictor" if cpu["predicted"] else "")
                + f"; actions and first frames == the CPU; ends "
                f"{cpu['ends']}")
            for k, (err, ms, plain, b, by) in kern.items():
                log(f"reference {name}: {k} vs plain on the last render's "
                    f"inputs at {n_envs} envs: bitwise equal, kernel "
                    f"{ms:.4f} ms, plain {plain:.4f} ms, bound {b:.4f} ms "
                    f"({by})")
            del card
            gc.collect()
    return results


# ---- 29. the PNG overlay, fixtures across devices, boruvka_maze ----

OVERLAY_GAMES = ("coinrun", "bossfight", "climber", "caveflyer", "jumper",
                 "chaser", "maze")
# the kernels each game's main path launches (KERNEL_WRAPPERS' names)
OVERLAY_KERNELS = {"coinrun": ("scene_raw",), "climber": ("scene_raw",),
                   "caveflyer": ("scene_raw",), "jumper": ("scene_raw",
                                                           "composite"),
                   "bossfight": ("composite",), "chaser": (), "maze": ()}
OVERLAY_STEPS = 2
# Pillow decodes PNGs on the card's machine as it does here, so the phase
# installs its synthetic tree through png_assets.install, as a user does.
PNG_ROUTE = "png_assets.install (Pillow decodes the synthetic tree)"


def overlay_case(name):
    """(game, cfg, levels, envs) of `name`'s main path."""
    if name == "maze":
        return "maze", {"mode": "easy"}, MAZE_LEVELS, MAZE_ENVS
    return name, {}, NUM_LEVELS, NUM_ENVS


def overlay_run(env, bank, actions, n_envs):
    """reset(n_envs) from key(1), then OVERLAY_STEPS steps: (final state,
    [the reset's obs, each step's obs])."""
    state, ts = env.reset(bank, pt.random.key(1, env.device), n_envs)
    obs = [ts.obs]
    for t in range(OVERLAY_STEPS):
        state, ts = env.step(bank, state, actions[t, :n_envs])
        obs.append(ts.obs)
    return state, obs


def overlay_games():
    """Every game's main path at full width with procedural art, then with
    the synthetic overlay installed (B1/B3 counted, the same states, other
    frames, the first CPU_ENVS envs re-run on the CPU, B1/B3 against plain
    on the last render's inputs), then after `uninstall` (a new env's
    render of the final state equals the procedural one). Returns {game:
    numbers}."""
    import tempfile

    from procgen2_tpu_torch.render import png_assets

    runs = {}
    for name in OVERLAY_GAMES:
        game, cfg, n_levels, n_envs = overlay_case(name)
        env = pt.make(game, **cfg)
        bank = env.generate_bank(pt.random.key(0, env.device), n_levels)
        g = torch.Generator(device=env.device)
        g.manual_seed(3)
        actions = torch.randint(0, 15, (OVERLAY_STEPS, n_envs), generator=g,
                                device=env.device, dtype=torch.int32)
        state, obs = overlay_run(env, bank, actions, n_envs)
        runs[name] = dict(bank=bank, actions=actions, plain_obs=obs,
                          plain_state=state, plain_final=env.observe(state))
    with tempfile.TemporaryDirectory() as root:
        synthetic_assets(root)
        t0 = time.perf_counter()
        installed = png_assets.install(root, strict=True)
        log(f"overlay: route {PNG_ROUTE}: {len(installed)} entries installed "
            f"in {time.perf_counter() - t0:.3f} s")
        try:
            for name, r in runs.items():
                r.update(overlay_game(name, r))
                gc.collect()
        finally:
            png_assets.uninstall()
    for name, r in runs.items():
        game, cfg, _, _ = overlay_case(name)
        again = pt.make(game, **cfg).observe(r["state"])
        if not torch.equal(again, r["plain_final"]):
            raise AssertionError(f"overlay {name}: after uninstall a new env "
                                 f"does not render the procedural frames")
        for k in ("plain_obs", "plain_state", "plain_final", "bank"):
            del r[k]
    log("overlay: after uninstall, a new env of every game renders the "
        "procedural frames of the final states again, bitwise")
    return runs


def overlay_game(name, r):
    """One game's main path under the installed overlay (see
    overlay_games)."""
    game, cfg, _, n_envs = overlay_case(name)
    env = pt.make(game, **cfg)
    bank, actions = r["bank"], r["actions"]
    torch.cuda.synchronize()
    for c in KERNEL_WRAPPERS:
        c.launches = 0
    t0 = time.perf_counter()
    state, obs = overlay_run(env, bank, actions, n_envs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in KERNEL_WRAPPERS}
    want = {k: OVERLAY_STEPS + 1 for k in OVERLAY_KERNELS[name]}
    if {k: v for k, v in launches.items() if v} != want:
        raise AssertionError(f"overlay {name}: launches {launches}, "
                             f"expected {want}")
    same_tree(state, r["plain_state"], f"overlay {name}: the state under "
              f"the overlay vs procedural art")
    for t, (o, p) in enumerate(zip(obs, r["plain_obs"])):
        if not bool((o != p).reshape(n_envs, -1).any(1).all()):
            raise AssertionError(f"overlay {name} render {t}: a frame equals "
                                 f"its procedural-art frame")
    cenv = pt.make(game, device="cpu", **cfg)
    cstate, cobs = overlay_run(cenv, tree_map(lambda x: x.cpu(), bank),
                               actions.cpu(), CPU_ENVS)
    for t, (o, c) in enumerate(zip(obs, cobs)):
        if not torch.equal(o[:CPU_ENVS].cpu(), c):
            raise AssertionError(f"overlay {name} render {t}: CPU and card "
                                 f"frames differ")
    same_tree(tree_map(lambda x: x[:CPU_ENVS], state), cstate,
              f"overlay {name}: state, card vs CPU")
    kern = render_kernels_vs_plain(name, env, state.game)
    log(f"overlay {name}: bank, reset and {OVERLAY_STEPS} steps x {n_envs} "
        f"envs under the overlay in {wall:.3f} s; launches "
        f"{ {k: v for k, v in launches.items() if v} }; states == the "
        f"procedural run's, every frame differs from its procedural frame; "
        f"the first {CPU_ENVS} envs == the CPU at every render"
        + "".join(f"; {k} vs plain on the last render's inputs: bitwise "
                  f"equal, kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
                  f"{b:.4f} ms ({by})"
                  for k, (err, ms, plain, b, by) in kern.items()))
    return dict(state=state, launches=launches, kernels=kern, wall_s=wall)


def fixtures_across_devices():
    """Fixtures recorded on the card (maze seed 7 across the episode
    boundary; coinrun seed 0, the bot to the coin and on, through B1) and
    replayed on the CPU: agreement 1.0 and no pixel difference. Returns
    the B1 launches of the coinrun recording."""
    import tempfile

    from procgen2_tpu_torch.tools import difference

    cases = (("maze", 7, maze_route_actions(7), {"mode": "easy"}),
             ("coinrun", 0, coinrun_bot_actions(0), {}))
    b1 = 0
    with tempfile.TemporaryDirectory() as root:
        for game, seed, actions, cfg in cases:
            path = f"{root}/{game}.npz"
            torch.cuda.synchronize()
            scene_kernel.scene_raw.launches = 0
            t0 = time.perf_counter()
            difference.record_engine_fixture(game, path, actions, seed=seed,
                                             device="cuda", **cfg)
            rec_s = time.perf_counter() - t0
            launches = scene_kernel.scene_raw.launches
            if (launches > 0) != (game == "coinrun"):
                raise AssertionError(f"fixture {game}: B1 launched "
                                     f"{launches} times")
            b1 += launches
            rep = difference.run_fixture_diff(path, episodes="all",
                                              device="cpu", **cfg)
            with np.load(path) as fx:
                ends = int(fx["terminated"].sum())
            if not (rep["steps_compared"] == len(actions) and ends >= 1
                    and rep["reward_agreement"] == 1.0
                    and rep["termination_agreement"] == 1.0
                    and rep["pixel"].max_abs_diff == 0.0):
                raise AssertionError(f"fixture {game}: the CPU replay of the "
                                     f"card's recording differs: {rep}")
            log(f"fixture {game} seed {seed}: {len(actions)} steps recorded "
                f"on the card in {rec_s:.3f} s ({ends} episode end(s), B1 "
                f"launches {launches}), replayed on the CPU: reward and "
                f"termination agreement 1.0, max |pixel| diff 0")
    return b1


def boruvka_check(smi, dev="cuda"):
    """boruvka_maze against kruskal_maze on the card (bitwise) and against
    the CPU, at maze easy's dims (2048 levels, per-level odd dims, max 15)
    and jumper's (1024 levels, 6); levels/s of both on the card."""
    from procgen2_tpu_torch.gen import kruskal

    out = {}
    for label, n, dim, max_dim in (("maze easy", MAZE_LEVELS, "per-level",
                                    maze.Config(mode="easy").world_dim),
                                   ("jumper", NUM_LEVELS, *(
                                       [jumper.Config().world_dim
                                        // jumper.MAZE_SCALE] * 2))):
        keys = pt.random.split(pt.random.key(5, dev), n)
        if dim == "per-level":
            g = torch.Generator(device=dev)
            g.manual_seed(5)
            dim = torch.randint(0, (max_dim - 1) // 2, (n,), generator=g,
                                device=dev) * 2 + 3
        walls, rates = {}, {}
        for fn in (kruskal.kruskal_maze, kruskal.boruvka_maze):
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                w = fn(keys, dim, max_dim)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            walls[fn.__name__] = w
            rates[fn.__name__] = n / min(times[1:])
        if not torch.equal(walls["kruskal_maze"], walls["boruvka_maze"]):
            raise AssertionError(f"boruvka_maze {label}: != kruskal_maze")
        cpu = kruskal.boruvka_maze(keys.cpu(), dim if isinstance(dim, int)
                                   else dim.cpu(), max_dim)
        if not torch.equal(cpu, walls["boruvka_maze"].cpu()):
            raise AssertionError(f"boruvka_maze {label}: card != CPU")
        log(f"boruvka_maze {label} ({n} levels, max_dim {max_dim}): == "
            f"kruskal_maze on the card and == the CPU, bitwise; "
            f"kruskal_maze {rates['kruskal_maze']:.1f} levels/s, "
            f"boruvka_maze {rates['boruvka_maze']:.1f} levels/s "
            f"({rates['boruvka_maze'] / rates['kruskal_maze']:.2f}x) on "
            f"{smi}")
        out[label] = rates
    return out


def overlay_phase(smi, dev):
    """Phase 29: the overlay on every game, fixtures across devices and
    boruvka_maze. Returns its numbers."""
    t0 = time.perf_counter()
    games = overlay_games()
    fixture_b1 = fixtures_across_devices()
    mazes = boruvka_check(smi, dev)
    wall = time.perf_counter() - t0
    log(f"overlay phase: {wall:.1f} s")
    return dict(games=games, fixture_b1=fixture_b1, mazes=mazes, wall_s=wall)


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
    scene, step = coinrun_path(actions)
    # ---- 6, 7. bossfight: main path, checks, breakdown ----
    stamp, boss_step = bossfight_path(actions)
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
    # ---- 21. the rollout as one CUDA graph of T steps, every game ----
    rolls = []
    for name, cfg, kernels in ROLLOUT_CASES:
        levels, envs = ((MAZE_LEVELS, MAZE_ENVS) if name == "maze"
                        else (NUM_LEVELS, NUM_ENVS))
        rolls.append(rollout_path(name, cfg, kernels, levels, envs))
        gc.collect()
    for r in rolls:
        log(f"rollout summary {r['game']}: graph "
            f"{r['graph_steps_per_s']:.1f} env-steps/s, eager "
            f"{r['eager_steps_per_s']:.1f} "
            f"({r['graph_steps_per_s'] / r['eager_steps_per_s']:.2f}x), "
            f"capture {r['capture_s']:.3f} s, pool {r['pool_bytes']} B, "
            f"replay {r['replay_ms']:.3f} ms, device {r['device_ms']} ms, "
            f"idle {r['idle']}")
    # ---- 22. the rollout's graph table under fresh policies (C3) ----
    fresh_policy_rollouts()
    interleaved_replays()
    gc.collect()
    # ---- 23. the main paths at other configs, B1 and B3 on them ----
    modes = []
    for label in MODE_CASES:
        modes.append(mode_path(label))
        gc.collect()
    for m in modes:
        r = m["rollout"]
        b3 = m.get("b3")
        log(f"mode summary {m['label']}: graph {r['graph_steps_per_s']:.1f} "
            f"env-steps/s, eager {r['eager_steps_per_s']:.1f}, replay "
            f"{r['replay_ms']:.3f} ms, device {r['device_ms']} ms, idle "
            f"{r['idle']}, pool {r['pool_bytes']} B, peak "
            f"{m['peak_gib']:.3f} GiB; B1 {m['b1']['ms']:.4f} ms (bound "
            f"{m['b1']['bound_ms']:.4f}, plain {m['b1']['plain_ms']:.4f}, K = "
            f"{m['b1']['slots']})" + ("" if b3 is None else
                                      f"; B3 {b3['ms']:.4f} ms (bound "
                                      f"{b3['bound_ms']:.4f}, plain "
                                      f"{b3['plain_ms']:.4f})"))
    # ---- 24. make_vec on the card (one process) ----
    vec_phase()
    gc.collect()
    # ---- 25. make(module): the example wave game ----
    module_phase()
    # ---- 27. the Gym adapter, a checkpoint, the guards ----
    surface_phase()
    # ---- 28. the reference's own levels at full width ----
    ref = reference_phase()
    for name, r in ref.items():
        log(f"reference summary {name}: {r['seeds']} seeds x {r['envs']} "
            f"envs, {r['steps']} steps, {r['wall_s']:.3f} s (capture "
            f"{r['capture_s']:.3f} s), {r['steps_per_s']} env-steps/s after "
            f"the capture, idle {r['idle']}, "
            f"CPU run {r['cpu_s']:.1f} s; "
            + "; ".join(f"{k} {v[1]:.4f} ms (bound {v[3]:.4f}, plain "
                        f"{v[2]:.4f})" for k, v in r["kernels"].items()))

    # ---- 29. the PNG overlay, fixtures across devices, boruvka_maze ----
    over = overlay_phase(smi, dev)

    # ---- 30. result ----
    # the main paths that run B1: coinrun, climber, caveflyer and jumper,
    # and the other configs; B3: bossfight and jumper, the four
    # exact-camera paths and jumper's other modes
    scene["launches"] += (climber_launches + cave_launches + jump_b1
                          + sum(m["launches"]["scene_raw"] for m in modes))
    scene["max_abs_err"] = max(scene["max_abs_err"], err_r, err1, err_c,
                               err_j1, *(m["b1"]["err"] for m in modes))
    stamp["launches"] += (jump_b3
                          + sum(ex["launches"] for ex in exact.values())
                          + sum(m["launches"]["composite"] for m in modes))
    stamp["max_abs_err"] = max(stamp["max_abs_err"], serr_r, err_j3,
                               *(ex["err"] for ex in exact.values()),
                               *(m["b3"]["err"] for m in modes if "b3" in m))
    # and the reference's levels (B1: coinrun, climber, caveflyer, jumper;
    # B3: bossfight, jumper)
    scene["launches"] += sum(r["launches"]["scene_raw"] for r in ref.values())
    stamp["launches"] += sum(r["launches"]["composite"] for r in ref.values())
    scene["max_abs_err"] = max(scene["max_abs_err"], *(
        r["kernels"]["scene_raw"][0] for r in ref.values()
        if "scene_raw" in r["kernels"]))
    stamp["max_abs_err"] = max(stamp["max_abs_err"], *(
        r["kernels"]["composite"][0] for r in ref.values()
        if "composite" in r["kernels"]))
    # and the overlay's art (B1: coinrun, climber, caveflyer, jumper, the
    # coinrun fixture's recording; B3: bossfight, jumper)
    for r in over["games"].values():
        scene["launches"] += r["launches"]["scene_raw"]
        stamp["launches"] += r["launches"]["composite"]
        for k, entry in (("scene_raw", scene), ("composite", stamp)):
            if k in r["kernels"]:
                entry["max_abs_err"] = max(entry["max_abs_err"],
                                           r["kernels"][k][0])
    scene["launches"] += over["fixture_b1"]
    sums["max_abs_err"] = max(sums["max_abs_err"], err4_r)
    field["max_abs_err"] = max(field["max_abs_err"], err5_r)
    log(f"chip_smoke total wall time: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": [scene, stamp, sums, field, step,
                                boss_step, mz["m1"]]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
