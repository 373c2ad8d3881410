"""Smoke test of the PyTorch port on one CUDA card: builds the port's
kernels from this checkout, holds each against its plain torch version,
drives coinrun's main path at full width, and checks the result.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero and the final
`ok` line is not printed):
  1. device: a CUDA card must be visible; prints nvidia-smi's name and
     power limit; make("coinrun", device="cuda");
  2. build: builds the scene kernel (nvcc, sm_90a) and prints the time;
  3. kernel vs plain on random scene inputs at 4096 envs: bitwise equal;
  4. main path: generate_bank(1024) -> reset(4096) -> lanes 0-2 placed on
     the coin, a saw and lava -> 8 steps writing obs into a uint8
     [8, 4096, 64, 64, 3] buffer; the launch count shows the path ran the
     kernel; shapes, dtypes, rewards and obs are checked, and the coin lane
     must have terminated and restarted; the first 8 envs are re-run on
     the CPU through the port and must match exactly, auto-resets
     included; the scene kernel is then held against its plain version
     on the real scene inputs;
  5. where the time goes: host wall time of each part of one env step,
     and the device kernels and device time of two steps
     (torch.profiler);
  6. prints the kernels' JSON line, then the `ok` line last.
"""
from __future__ import annotations

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
from procgen2_tpu_torch.games import coinrun  # noqa: E402
from procgen2_tpu_torch.render import scene_kernel  # noqa: E402
from procgen2_tpu_torch.utils import (bank_gather, tree_map,  # noqa: E402
                                      tree_select)

NUM_LEVELS, NUM_ENVS, T = 1024, 4096, 8  # procgen2_tpu/tools/bench_cli.py:18
CPU_ENVS = 8


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
    scales = torch.tensor([0.0, 1.0, 1.0, 1.0, 0.5, 0.3], device=dev)

    def group(V, P, K):
        a = rf((V, 1, P, P))
        bank = torch.cat([rf((V, 3, P, P)) * 255 * a, a],
                         dim=1).to(torch.bfloat16)
        return (bank, ri(-1, V + 1, (n, K)),
                scales[ri(0, len(scales), (n, K)).long()].contiguous(),
                ri(-P - 2, obs + 3, (n, K)), ri(-P - 2, obs + 3, (n, K)))

    groups = [group(39, 8, 17), group(40, 12, 1)]
    return (gridp, ty0, tx0, jy, jx, bg_i, theme, bg_bank, ST["tr_tab"],
            tile_bank, kinds, themes, groups, obs, qp, pad)


def kernel_vs_plain(args, iters):
    """Bitwise check and times of the scene kernel vs its plain version.
    These launches are not the main path's and are not counted there."""
    got = scene_kernel.scene_raw(*args)
    want = scene_kernel.scene_raw_reference(*args)
    torch.cuda.synchronize()
    ndiff, err = bitwise_diff(got, want)
    if ndiff:
        raise AssertionError(f"scene kernel differs from its plain version "
                             f"in {ndiff} values (max abs err {err})")
    ms = cuda_ms(lambda: scene_kernel.scene_raw(*args), iters)
    plain_ms = cuda_ms(lambda: scene_kernel.scene_raw_reference(*args), 3)
    return err, ms, plain_ms


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


def breakdown(env, bank, state, action, obs_buf):
    """Where one env step's time goes: host wall ms of each part of
    `Environment.step` on the same state, then the device kernels and
    summed device time of two whole steps under torch.profiler."""
    cfg, gs, n_levels = env.cfg, state.game, NUM_LEVELS
    done = torch.zeros_like(state.ep_length, dtype=torch.bool)
    done[::7] = True
    k = prng.split(state.rng, 3)
    inputs = coinrun._scene_inputs(cfg, gs)
    img = scene_kernel.scene_raw(*inputs)
    planar = coinrun._observe_scene(cfg, gs)

    def auto_reset():
        kk = prng.split(state.rng, 3)
        idx = prng.randint(kk[:, 1], (), 0, n_levels)
        fresh = coinrun.reset(cfg, bank_gather(bank, idx.long()), kk[:, 2])
        return tree_select(done, fresh, gs)

    parts = [
        ("env.step (whole step, render included)",
         lambda: env.step(bank, state, action)),
        ("game step (physics, 4 sub-steps)",
         lambda: coinrun.step(cfg, gs, action)),
        ("auto-reset: split + randint + gather + reset + select", auto_reset),
        ("  of which one randint draw",
         lambda: prng.randint(k[:, 1], (), 0, n_levels)),
        ("scene inputs (coinrun._scene_inputs)",
         lambda: coinrun._scene_inputs(cfg, gs)),
        ("scene kernel (scene_raw)", lambda: scene_kernel.scene_raw(*inputs)),
        ("round / clip / uint8",
         lambda: torch.clamp(torch.round(img), 0, 255).to(torch.uint8)),
        ("hwc copy into the obs buffer",
         lambda: obs_buf[0].copy_(planar.permute(0, 2, 3, 1))),
    ]
    log(f"breakdown at {NUM_ENVS} envs (host wall ms per call, mean of 5):")
    for name, fn in parts:
        log(f"  {name}: {wall_ms(fn):.3f} ms")

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
    if kernels:
        dev_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
        log(f"profiler, 2 env steps: {len(kernels)} device kernels, "
            f"{dev_ms:.3f} ms summed device time")
    else:
        log("profiler, 2 env steps: no device events (device time not "
            "measured)")


def same_tree(a, b, what):
    bad = []
    tree_map(lambda x, y: bad.append(tuple(x.shape))
             if not torch.equal(x.cpu(), y.cpu()) else None, a, b)
    if bad:
        raise AssertionError(f"{what}: GPU and CPU differ in leaves of "
                             f"shapes {bad}")


def main():
    # ---- 1. device ----
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device")
    env = pt.make("coinrun", device="cuda")  # the documented entry point
    dev = env.device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)  # the card's name and power limit, as nvidia-smi prints them
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    # ---- 2. build ----
    rec = scene_kernel.build()
    log(f"build: scene_kernel {rec['seconds']:.1f} s "
        f"({'cached' if rec['cached'] else 'nvcc'})")
    for line in rec["log"].splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # ---- 3. kernel vs plain, random inputs ----
    err_r, ms_r, plain_r = kernel_vs_plain(random_scene(NUM_ENVS, dev), 20)
    log(f"scene kernel vs plain, random inputs N={NUM_ENVS}: bitwise equal; "
        f"kernel {ms_r:.4f} ms, plain {plain_r:.4f} ms")

    # ---- 4. main path ----
    key = pt.random.key
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bank = env.generate_bank(key(0, env.device), NUM_LEVELS)
    torch.cuda.synchronize()
    gen_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    bank = env.generate_bank(key(0, env.device), NUM_LEVELS)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    log(f"generate_bank({NUM_LEVELS}): first call {gen_first:.3f} s, "
        f"second {gen_s:.3f} s -> {NUM_LEVELS / gen_s:.1f} levels/s")

    g = torch.Generator(device=dev)
    g.manual_seed(2)
    actions = torch.randint(0, coinrun.NUM_ACTIONS, (T, NUM_ENVS),
                            generator=g, device=dev, dtype=torch.int32)
    obs_buf = torch.empty((T, NUM_ENVS, 64, 64, 3), dtype=torch.uint8,
                          device=dev)

    def run():
        """reset, hazard lanes, T steps; returns ([state after each step],
        [(reward, done)], hazard lanes, step seconds)."""
        state, ts = env.reset(bank, key(1, env.device), NUM_ENVS)
        gs, lanes = place_on_hazards(state.game, CPU_ENVS)
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

    run()  # warm-up (allocator, caches); its launches are not counted
    torch.cuda.synchronize()
    scene_kernel.scene_raw.launches = 0
    states, out, lanes, step_s = run()
    launches = scene_kernel.scene_raw.launches
    state = states[-1]
    log(f"main path: {T} steps x {NUM_ENVS} envs in {step_s:.4f} s -> "
        f"{T * NUM_ENVS / step_s:.1f} env-steps/s (obs written to the "
        f"buffer); scene kernel launches {launches}")
    if launches < T + 1:
        raise AssertionError(f"the main path launched the scene kernel "
                             f"{launches} times, expected >= {T + 1}")

    rewards = torch.stack([r for r, _ in out])
    dones = torch.stack([d for _, d in out])
    if obs_buf.shape != (T, NUM_ENVS, 64, 64, 3) or obs_buf.dtype != torch.uint8:
        raise AssertionError("obs buffer shape/dtype")
    if rewards.dtype != torch.float32 or dones.dtype != torch.bool:
        raise AssertionError("reward/termination dtypes")
    if not bool(torch.isfinite(rewards).all()):
        raise AssertionError("non-finite reward")
    if not bool(((rewards == 0) | (rewards == 10)).all()):
        raise AssertionError("reward outside {0, 10}")
    if int(obs_buf.amax()) == int(obs_buf.amin()):
        raise AssertionError("obs are constant")
    per_frame = obs_buf.reshape(T * NUM_ENVS, -1).float().std(dim=1)
    if bool((per_frame == 0).any()):
        raise AssertionError("a frame is constant")
    # the coin lane ends its episode on step 0 and restarts from the bank
    if not (bool(dones[0, 0]) and float(rewards[0, 0]) == 10.0
            and int(states[0].game.t[0]) == 0
            and int(states[0].ep_length[0]) == 0):
        raise AssertionError("the lane placed on its coin did not end its "
                             "episode and restart on step 0")
    hit = [i for i in lanes if bool(dones[:, i].any())]
    log(f"checks: obs {tuple(obs_buf.shape)} uint8 mean "
        f"{float(obs_buf.float().mean()):.3f}; rewards of 10: "
        f"{int((rewards == 10).sum())}; terminations: {int(dones.sum())}; "
        f"hazard lanes {lanes}, of which terminated {hit}")

    # first CPU_ENVS envs through the port on the CPU: identical, auto-
    # resets included
    cpu = torch.device("cpu")
    cenv = pt.make("coinrun", device=cpu)
    cbank = cenv.generate_bank(key(0), NUM_LEVELS)
    same_tree(bank, cbank, "level bank")
    cstate, _ = cenv.reset(cbank, key(1), CPU_ENVS)
    cgs, clanes = place_on_hazards(cstate.game, CPU_ENVS)
    if clanes != lanes:
        raise AssertionError(f"hazard lanes differ: CPU {clanes}, GPU {lanes}")
    cstate = dataclasses.replace(cstate, game=cgs)
    for t in range(T):
        cstate, cts = cenv.step(cbank, cstate, actions[t, :CPU_ENVS].cpu())
        if not torch.equal(cts.obs, obs_buf[t, :CPU_ENVS].cpu()):
            raise AssertionError(f"step {t}: CPU and GPU obs differ")
        if not (torch.equal(cts.reward, out[t][0][:CPU_ENVS].cpu())
                and torch.equal(cts.terminated, out[t][1][:CPU_ENVS].cpu())):
            raise AssertionError(f"step {t}: CPU and GPU rewards differ")
        same_tree(tree_map(lambda x: x[:CPU_ENVS], states[t]), cstate,
                  f"step {t}: env state")
    log(f"CPU re-run of the first {CPU_ENVS} envs: bank, states, rewards, "
        f"terminations and obs identical at every step "
        f"({int(dones[:, :CPU_ENVS].sum())} auto-resets)")

    # the kernel against its plain version on the real scene inputs
    err_c, ms_c, plain_c = kernel_vs_plain(
        coinrun._scene_inputs(env.cfg, state.game), 20)
    log(f"scene kernel vs plain, coinrun inputs N={NUM_ENVS}: bitwise equal; "
        f"kernel {ms_c:.4f} ms, plain {plain_c:.4f} ms")

    # ---- 5. where the time goes ----
    breakdown(env, bank, state, actions[-1], obs_buf)

    # ---- 6. result ----
    log(json.dumps({"kernels": [{
        "name": "scene_raw",
        "route": "cuda",
        "source": "procgen2_tpu_torch/render/csrc/scene_kernel.cu",
        "replaces": "procgen2_tpu/render/scene_kernel.py:86",
        "launches": launches,
        "max_abs_err": max(err_r, err_c),
        "ms": ms_c,
        "plain_ms": plain_c,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
