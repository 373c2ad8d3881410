"""Tests of the port that need a CUDA card: the scene kernels (B1, B5)
and the stamp kernels (B3, B4) against their plain torch versions
(bitwise, B1, B3 and B4 also on the edge cases of their staged slot
tables, B5 on odd kinds), stamp groups off the kernel path, the kernel
wrappers' checks, threefry words, cos32/sin32 and atan2f on the card,
B1 on jumper's scene and B3 on jumper's needle group (P = 32, K = 1) at
every offset across the frame's edges, and coinrun, bossfight, climber,
caveflyer, jumper, chaser and maze (every mode) on the card against the
same games on the CPU, chaser and maze launching no kernel; the exact
renders: coinrun, climber, caveflyer and jumper with scene_phases=0
against the CPU (B3 launched once per kernel-path stamp group), B3 on
their render inputs against its plain version, and every game's
Environment.render at 512 px against the CPU; the learner-facing
surface: `dist.rollout` as one CUDA graph against eager steps, a graph
per bank, the graph table's bound and shared pool under fresh policies
and interleaved replays, and a checkpoint round trip on the card; the
main paths at the other configs (game_lanes.MODE_CASES), make_vec in one
process and make(wave_game) on the card; the reference's own levels
(two seeds of each kernel game at 256 envs) through rollout graphs
against the CPU; and coinrun's step kernel against the plain torch step,
bit for bit: 64 auto-resetting steps at 1, 37 and 4096 envs in four
configs, the crafted lanes of tests/coinrun_lanes.py, and a T = 8 rollout
graph against its eager loops; bossfight's step kernel against the plain
torch step, bit for bit: 64 auto-resetting steps at 1, 37 and 4096 envs in
easy and hard mode, the crafted lanes of tests/bossfight_lanes.py and its
crowded rings, and a T = 8 rollout graph against its eager loops;
bossfight's T = 8 rollout graph in easy mode at 4096 envs, late in its
episodes and with rings past the render's cull, against the benchmark's
plain reference on sampled rows; the render's spans of a profiled
bossfight step; and maze's render kernel M1 against the plain render, bit
for bit: easy and hard mode at 1, 7 and 8192 envs with the mouse on and
off its cheese facing both ways and on its start cell, every background,
and its wrapper's refusals.

They skip without a card. This file imports no jax, so it runs on a
machine without it; there, skip the repo's conftest (which sets jax up):

    python -m pytest --noconftest tests/test_torch_cuda.py
"""
import dataclasses

import pytest
import torch

import game_lanes
import kernel_inputs
import procgen2_tpu_torch as pt
from procgen2_tpu_torch import random as R
from procgen2_tpu_torch import trig
from procgen2_tpu_torch.games import (bossfight, caveflyer, climber, coinrun,
                                      jumper, maze)
from procgen2_tpu_torch.physics import bossfight_step, coinrun_step
from procgen2_tpu_torch.render import compositor, maze_render
from procgen2_tpu_torch.render import scene_kernel as sk
from procgen2_tpu_torch.render import stamp_kernel as stk
from procgen2_tpu_torch.utils import tree_map

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


@pytest.fixture
def smoke(dev):
    """chip_smoke.py, whose phases some card tests drive at a small size.
    It is loaded only on a card (after `dev`), never at collection."""
    import chip_smoke
    return chip_smoke


def _bits(x):
    return x.view(torch.int16)


@pytest.mark.parametrize("n,seed", [(1, 0), (257, 1)])
def test_scene_kernel_matches_plain(dev, n, seed):
    args = kernel_inputs.random_scene(n, dev, seed)
    before = sk.scene_raw.launches
    got = sk.scene_raw(*args)
    torch.cuda.synchronize()
    assert sk.scene_raw.launches == before + 1
    assert torch.equal(_bits(got), _bits(sk.scene_raw_reference(*args)))


def test_scene_kernel_edge_cases(dev):
    """No stamp groups; windows wholly outside the grid; every stamp
    off the frame."""
    args = list(kernel_inputs.random_scene(64, dev, 2))
    args[1] = torch.full_like(args[1], -1000)  # ty0
    got = sk.scene_raw(*args[:12], [], *args[13:])
    assert torch.equal(_bits(got), _bits(
        sk.scene_raw_reference(*args[:12], [], *args[13:])))
    assert not got.any()  # nothing inside the grid: black
    args = list(kernel_inputs.random_scene(64, dev, 3))
    off = [(b, v, s, torch.full_like(r, 70), c) for b, v, s, r, c in args[12]]
    got = sk.scene_raw(*args[:12], off, *args[13:])
    assert torch.equal(_bits(got), _bits(
        sk.scene_raw_reference(*args[:12], [], *args[13:])))


def test_scene_kernel_rejects_bad_inputs(dev):
    args = list(kernel_inputs.random_scene(8, dev, 4))
    bad = list(args)
    bad[1] = args[1].long()
    with pytest.raises(TypeError):
        sk.scene_raw(*bad)
    bad = list(args)
    bad[0] = args[0].transpose(1, 2)
    with pytest.raises(ValueError):
        sk.scene_raw(*bad)
    bad = list(args)
    bad[1] = args[1].cpu()
    with pytest.raises(ValueError):
        sk.scene_raw(*bad)
    with pytest.raises(ValueError):  # more stamp groups than the kernel takes
        sk.scene_raw(*args[:12], args[12] * 3, *args[13:])


@pytest.mark.parametrize("n,seed", [(1, 0), (257, 1), (4096, 2)])
def test_stamp_kernel_matches_plain(dev, n, seed):
    """Bossfight's four stamp groups (kernel_inputs.random_stamps: variants
    out of range, scale 0, fractional scales, stamps off every edge,
    overlaps): one launch, bitwise equal to the plain version and to one
    launch per group in turn."""
    img, groups = kernel_inputs.random_stamps(n, dev, seed)
    before = stk.composite.launches
    got = stk.composite(img, groups)
    torch.cuda.synchronize()
    assert stk.composite.launches == before + 1
    assert torch.equal(_bits(got), _bits(stk.composite_reference(img, groups)))
    seq = img
    for group in groups:
        seq = stk.composite(seq, [group])
    assert torch.equal(_bits(got), _bits(seq))


def test_stamp_kernel_edge_cases(dev):
    """Every stamp off the frame, or every slot dead: the frame passes
    through unchanged."""
    img, groups = kernel_inputs.random_stamps(64, dev, 3)
    off = [(b, v, s, torch.full_like(r, 64), c) for b, v, s, r, c in groups]
    assert torch.equal(_bits(stk.composite(img, off)), _bits(img))
    dead = [(b, v, torch.zeros_like(s), r, c) for b, v, s, r, c in groups]
    assert torch.equal(_bits(stk.composite(img, dead)), _bits(img))


def test_stamp_kernel_rejects_bad_inputs(dev):
    img, groups = kernel_inputs.random_stamps(8, dev, 4)
    with pytest.raises(TypeError):
        stk.composite(img.float(), groups)
    bank, var, scale, r0, c0 = groups[0]
    with pytest.raises(TypeError):
        stk.composite(img, [(bank, var.long(), scale, r0, c0)])
    with pytest.raises(ValueError):
        stk.composite(img, [(bank, var, scale, r0.t().contiguous().t(), c0)])
    with pytest.raises(ValueError):
        stk.composite(img, [(bank, var[:4], scale, r0, c0)])
    with pytest.raises(ValueError):
        stk.composite(img, [(bank.cpu(), var, scale, r0, c0)])
    with pytest.raises(ValueError):  # more stamp groups than the kernel takes
        stk.composite(img, groups * 2)
    with pytest.raises(ValueError):
        stk.composite(img, [])


@pytest.mark.parametrize("n", [1, 257, 4097])
@pytest.mark.parametrize("case", kernel_inputs.EDGE_CASES)
def test_stamp_kernel_edge_slots(dev, case, n):
    """B3 on the edge cases of its staged slot tables (kernel_inputs.
    edge_groups: K = 300 in one group, over more than one staging pass;
    40 live slots stacked on one pixel with dead slots between them; P = 40
    at every offset across the lanes' 8-pixel runs and the warps' 16 x 16
    regions): one launch, bitwise equal to the plain version."""
    img, groups = kernel_inputs.edge_stamps(case, n, dev, seed=n)
    before = stk.composite.launches
    got = stk.composite(img, groups)
    torch.cuda.synchronize()
    assert stk.composite.launches == before + 1
    assert torch.equal(_bits(got), _bits(stk.composite_reference(img, groups)))


@pytest.mark.parametrize("n", [1, 257, 4097])
@pytest.mark.parametrize("case", kernel_inputs.EDGE_CASES)
def test_scene_kernel_edge_slots(dev, case, n):
    """B1 on the same edge cases, with themed and unthemed tile entries
    for every theme (kernel_inputs.edge_scene): bitwise equal to the plain
    version."""
    args = kernel_inputs.edge_scene(case, n, dev, seed=n)
    before = sk.scene_raw.launches
    got = sk.scene_raw(*args)
    torch.cuda.synchronize()
    assert sk.scene_raw.launches == before + 1
    assert torch.equal(_bits(got), _bits(sk.scene_raw_reference(*args)))


def _scene_at(obs, n, dev, seed):
    """scene_raw inputs at frame size obs (coinrun's other shapes): a
    nondecreasing phase table like the games', 5 tile entries (two
    themed), and a stamp group of K = 300 (more than one staging pass)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)

    gp, qp, pad, ne = 96, 4, 16, 5
    gridp = ri(0, ne + 1, (n, gp, gp)).to(torch.int8)
    steps = torch.rand((qp, 1, obs), generator=g, device=dev) < 0.2
    tr_tab = steps.int().cumsum(-1).to(torch.int32).contiguous()
    a = torch.rand((qp * qp, ne, 1, obs, obs), generator=g, device=dev)
    tile_bank = torch.cat([torch.rand((qp * qp, ne, 3, obs, obs),
                                      generator=g, device=dev) * 255 * a, a],
                          dim=2).to(torch.bfloat16)
    groups = [kernel_inputs.random_group(g, n, dev, 6, 8, 300, obs)]
    return (gridp, ri(-pad, 70, (n,)), ri(-pad, 70, (n,)), ri(0, qp, (n,)),
            ri(0, qp, (n,)), ri(0, 3, (n,)), ri(0, 2, (n,)),
            ri(0, 256, (3, 3, gp, gp)).to(torch.bfloat16), tr_tab, tile_bank,
            (1, 2, 3, 4, 5), (-1, -1, 0, 1, -1), groups, obs, qp, pad)


@pytest.mark.parametrize("obs", [8, 24, 72, 136])
def test_tiled_kernels_at_other_frame_sizes(dev, obs):
    """B1 and B3 at frame sizes other than the games' 64: warp regions
    cut by the frame's edge (obs not a multiple of 16), more regions than
    one pass of the block's warps, and a 300-slot table staged anew in
    every pass; bitwise equal to the plain versions."""
    g = torch.Generator(device=dev)
    g.manual_seed(obs)
    img = torch.randint(0, 256, (33, 3, obs, obs), generator=g, device=dev,
                        dtype=torch.int32).to(torch.bfloat16)
    groups = [kernel_inputs.random_group(g, 33, dev, 6, 8, 300, obs),
              kernel_inputs.random_group(g, 33, dev, 3, 40, 7, obs)]
    assert torch.equal(_bits(stk.composite(img, groups)),
                       _bits(stk.composite_reference(img, groups)))
    args = _scene_at(obs, 33, dev, obs + 1)
    assert torch.equal(_bits(sk.scene_raw(*args)),
                       _bits(sk.scene_raw_reference(*args)))


def _misaligned(t):
    """A contiguous copy of t that starts 2 bytes past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    out = flat[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def test_tiled_kernels_reject_shapes_they_do_not_take(dev):
    """B1 and B3 read and write frame rows 8 bf16 at a time: an obs that is
    not a multiple of 8, a frame or tile bank off a 16-byte boundary, and
    (B1) an obs above scene_kernel.MAX_OBS raise ValueError; nothing is
    sent to the plain version."""
    img, groups = kernel_inputs.random_stamps(8, dev, 5)
    before = stk.composite.launches
    with pytest.raises(ValueError):
        stk.composite(_misaligned(img), groups)
    with pytest.raises(ValueError):
        stk.composite(img[..., :60, :60].contiguous(), groups)
    assert stk.composite.launches == before
    args = list(kernel_inputs.random_scene(8, dev, 6))
    before = sk.scene_raw.launches
    bad = list(args)
    bad[9] = _misaligned(args[9])
    with pytest.raises(ValueError):
        sk.scene_raw(*bad)
    for obs in (60, sk.MAX_OBS + 8):
        bad = list(args)
        bad[8] = torch.zeros((args[14], 1, obs), dtype=torch.int32,
                             device=dev)
        bad[9] = torch.zeros((args[14] ** 2, len(args[10]), 4, obs, obs),
                             dtype=torch.bfloat16, device=dev)
        bad[13] = obs
        with pytest.raises(ValueError):
            sk.scene_raw(*bad)
    assert sk.scene_raw.launches == before


@pytest.mark.parametrize("n,seed", [(1, 0), (257, 1), (4096, 2)])
def test_stamp_sum_kernel_matches_plain(dev, n, seed):
    """B4 on groups with P = 8, 12 and 20 (kernel_inputs.random_sum_groups:
    variants out of range, scale 0, fractional scales, stamps off every
    edge, overlaps): one launch each, bitwise equal to the plain version."""
    for group in kernel_inputs.random_sum_groups(n, dev, seed):
        before = stk.stamps.launches
        got = stk.stamps(*group, 64)
        torch.cuda.synchronize()
        assert stk.stamps.launches == before + 1
        want = stk.stamps_reference(*group, 64)
        for g, w in zip(got, want):
            assert torch.equal(_bits(g), _bits(w))


def test_stamp_sum_kernel_edge_cases(dev):
    """Every stamp off the frame, every slot dead, or no slot: zeros."""
    for b, v, s, r, c in kernel_inputs.random_sum_groups(64, dev, 3):
        for group in ((b, v, s, torch.full_like(r, 64), c),
                      (b, v, torch.zeros_like(s), r, c),
                      (b, v[:, :0].contiguous(), s[:, :0].contiguous(),
                       r[:, :0].contiguous(), c[:, :0].contiguous())):
            rgb, a = stk.stamps(*group, 64)
            assert not rgb.any() and not a.any()


def test_stamp_sum_kernel_rejects_bad_inputs(dev):
    bank, var, scale, r0, c0 = kernel_inputs.random_sum_groups(8, dev, 4)[0]
    with pytest.raises(TypeError):
        stk.stamps(bank.float(), var, scale, r0, c0, 64)
    with pytest.raises(TypeError):
        stk.stamps(bank, var, scale.double(), r0, c0, 64)
    with pytest.raises(ValueError):
        stk.stamps(bank, var, scale, r0[:4], c0, 64)
    with pytest.raises(ValueError):
        stk.stamps(bank.cpu(), var, scale, r0, c0, 64)


@pytest.mark.parametrize("n", [1, 257])
@pytest.mark.parametrize("case", kernel_inputs.EDGE_CASES)
def test_stamp_sum_kernel_edge_slots(dev, case, n):
    """B4 on the edge cases of its staged slot table (kernel_inputs.
    edge_sum_group: K = 300 over more than one staging pass, 40 live slots
    stacked on one pixel in one group, P = 40 at every offset): one
    launch, bitwise equal to the plain version."""
    group = kernel_inputs.edge_sum_group(case, n, dev, seed=n)
    before = stk.stamps.launches
    got = stk.stamps(*group, 64)
    torch.cuda.synchronize()
    assert stk.stamps.launches == before + 1
    for g, w in zip(got, stk.stamps_reference(*group, 64)):
        assert torch.equal(_bits(g), _bits(w))


@pytest.mark.parametrize("n", [1, 257])
def test_field_scene_kernel_odd_kinds(dev, n):
    """B5 on a kind field of fractions, -0.0, negative kinds, kinds beyond
    int8 (with entries of their own), infinities and NaN
    (kernel_inputs.edge_field): bitwise equal to the plain version."""
    args = kernel_inputs.edge_field(n, dev, seed=n)
    before = sk.scene.launches
    got = sk.scene(*args)
    torch.cuda.synchronize()
    assert sk.scene.launches == before + 1
    assert torch.equal(_bits(got), _bits(sk.scene_reference(*args)))


def _field_at(obs, n, dev, seed):
    """scene inputs at frame size obs: kinds 0-5, 2.5 and 200 (a fraction
    and a kind beyond int8), the entries of kernel_inputs.random_field plus
    kind 200, and a stamp group of K = 300 (more than one staging
    pass)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)

    nph, kinds, themes = 4, (1, 2, 3, 4, 5, 200), (-1, -1, 0, 1, -1, -1)
    palette = torch.tensor([0, 1, 2, 3, 4, 5, 2.5, 200], device=dev)
    X = torch.cat([palette[ri(0, 8, (n, 1, obs, obs)).long()],
                   ri(0, 256, (n, 3, obs, obs)).float()],
                  dim=1).to(torch.bfloat16)
    a = torch.rand((nph, len(kinds), 1, obs, obs), generator=g, device=dev)
    tile_bank = torch.cat([torch.rand((nph, len(kinds), 3, obs, obs),
                                      generator=g, device=dev) * 255 * a, a],
                          dim=2).to(torch.bfloat16)
    groups = [kernel_inputs.random_group(g, n, dev, 6, 8, 300, obs)]
    return (X, ri(0, nph, (n,)), ri(0, 2, (n,)), tile_bank, kinds, themes,
            groups, obs)


@pytest.mark.parametrize("obs", [8, 24, 72, 136])
def test_sum_and_field_kernels_at_other_frame_sizes(dev, obs):
    """B4 and B5 at frame sizes other than the games' 64, as
    test_tiled_kernels_at_other_frame_sizes holds B1 and B3: warp regions
    cut by the frame's edge, more regions than one pass of the block's
    warps, a 300-slot table staged anew in every pass; bitwise equal to
    the plain versions."""
    g = torch.Generator(device=dev)
    g.manual_seed(obs)
    group = kernel_inputs.random_group(g, 33, dev, 6, 8, 300, obs)
    for a, b in zip(stk.stamps(*group, obs),
                    stk.stamps_reference(*group, obs)):
        assert torch.equal(_bits(a), _bits(b))
    big = kernel_inputs.random_group(g, 33, dev, 3, 40, 7, obs)
    for a, b in zip(stk.stamps(*big, obs), stk.stamps_reference(*big, obs)):
        assert torch.equal(_bits(a), _bits(b))
    args = _field_at(obs, 33, dev, obs + 1)
    assert torch.equal(_bits(sk.scene(*args)),
                       _bits(sk.scene_reference(*args)))


def test_sum_and_field_kernels_reject_shapes_they_do_not_take(dev):
    """B4 and B5 move frame rows 8 bf16 at a time: an obs that is not a
    multiple of 8, and (B5) an X or tile bank off a 16-byte boundary,
    raise ValueError; nothing is launched or sent to the plain version."""
    group = kernel_inputs.random_sum_groups(8, dev, 5)[0]
    before = stk.stamps.launches
    for obs in (60, 4, 65):
        with pytest.raises(ValueError):
            stk.stamps(*group, obs)
    assert stk.stamps.launches == before
    X, p, theme, tb, kinds, themes, groups, obs = kernel_inputs.random_field(
        8, dev, 6)
    before = sk.scene.launches
    with pytest.raises(ValueError):
        sk.scene(_misaligned(X), p, theme, tb, kinds, themes, groups, obs)
    with pytest.raises(ValueError):
        sk.scene(X, p, theme, _misaligned(tb), kinds, themes, groups, obs)
    with pytest.raises(ValueError):
        sk.scene(X[..., :60, :60].contiguous(), p, theme,
                 tb[..., :60, :60].contiguous(), kinds, themes, groups, 60)
    assert sk.scene.launches == before


def test_off_kernel_stamp_groups_on_card(dev, smoke):
    """Chaser's (P, K) through stamps_from_pixel_bank and composite_stamps
    on the card: no kernel launched, bitwise equal to the CPU
    (chip_smoke.off_kernel_groups raises otherwise)."""
    smoke.off_kernel_groups(64, dev)


@pytest.mark.parametrize("n,seed", [(1, 0), (257, 1), (4096, 2)])
def test_field_scene_kernel_matches_plain(dev, n, seed):
    """B5 on random scenes (kernel_inputs.random_field: 5 tile entries, two
    themed; joint phases out of range at both ends; two stamp groups)."""
    args = kernel_inputs.random_field(n, dev, seed)
    before = sk.scene.launches
    got = sk.scene(*args)
    torch.cuda.synchronize()
    assert sk.scene.launches == before + 1
    assert torch.equal(_bits(got), _bits(sk.scene_reference(*args)))


def test_field_scene_kernel_edge_cases(dev):
    """No stamp groups; joint phases past either end read the end
    phases."""
    X, p, theme, tb, kinds, themes, groups, obs = kernel_inputs.random_field(
        64, dev, 3)
    got = sk.scene(X, p, theme, tb, kinds, themes, [], obs)
    assert torch.equal(_bits(got), _bits(
        sk.scene_reference(X, p, theme, tb, kinds, themes, [], obs)))
    nph = tb.shape[0]
    for out_of_range, end in ((-5, 0), (nph + 3, nph - 1)):
        a = sk.scene(X, torch.full_like(p, out_of_range), theme, tb, kinds,
                     themes, groups, obs)
        b = sk.scene(X, torch.full_like(p, end), theme, tb, kinds, themes,
                     groups, obs)
        assert torch.equal(_bits(a), _bits(b))


def test_field_scene_kernel_rejects_bad_inputs(dev):
    X, p, theme, tb, kinds, themes, groups, obs = kernel_inputs.random_field(
        8, dev, 4)
    with pytest.raises(TypeError):
        sk.scene(X.float(), p, theme, tb, kinds, themes, groups, obs)
    with pytest.raises(TypeError):
        sk.scene(X, p.long(), theme, tb, kinds, themes, groups, obs)
    with pytest.raises(ValueError):
        sk.scene(X, p, theme, tb[:, :2], kinds, themes, groups, obs)
    with pytest.raises(ValueError):
        sk.scene(X, p, theme.cpu(), tb, kinds, themes, groups, obs)
    with pytest.raises(ValueError):
        sk.scene(X, p, theme, tb, kinds, themes[:3], groups, obs)


def test_key_words_same_on_cuda(dev):
    k = R.split(R.key(17), 64)
    cpu = (R.split(k, 3), R.fold_in(k, 5), R.randint(k, (4,), -3, 1000),
           R.uniform(k, (4,)), R.uniform(k, (4,), 0.7, 1.2))
    kd = k.to(dev)
    gpu = (R.split(kd, 3), R.fold_in(kd, 5), R.randint(kd, (4,), -3, 1000),
           R.uniform(kd, (4,)), R.uniform(kd, (4,), 0.7, 1.2))
    for a, b in zip(cpu, gpu):
        assert torch.equal(a, b.cpu())


def test_make_cuda_names_the_card(dev):
    """The default device (the card, "cuda" with no index) is the
    documented entry point: keys made on env.device, or on "cuda", are
    accepted by every keyed call."""
    env = pt.make("coinrun")
    assert env.device == torch.device("cuda", torch.cuda.current_device())
    bank = env.generate_bank(R.key(0, "cuda"), 4)
    state, ts = env.reset(bank, R.key(1, env.device), 4)
    assert ts.obs.device == env.device and ts.obs.shape == (4, 64, 64, 3)
    pinned = env.reset_pinned(bank, R.key(2, "cuda"))
    assert pinned.rng.device == env.device


def test_coinrun_on_card_matches_cpu(dev):
    """make(device="cuda") against make(device="cpu"), with lanes placed on
    the coin, a saw and lava so that auto-reset fires on the card: the
    card's step kernel (one launch a step) against the CPU's plain step."""
    n = 16
    out = {}
    launches = coinrun_step.step.launches
    for d in ("cpu", "cuda"):
        env = pt.make("coinrun", device=d)
        bank = env.generate_bank(R.key(5, env.device), n)
        state, ts = env.reset(bank, R.key(6, env.device), n)
        gs, lanes = game_lanes.place_on_hazards(state.game, n)
        state = dataclasses.replace(state, game=gs)
        frames, states, rewards = [ts.obs.cpu()], [], []
        g = torch.Generator().manual_seed(0)
        for _ in range(4):
            a = torch.randint(0, 15, (n,), generator=g, dtype=torch.int32)
            state, ts = env.step(bank, state, a.to(env.device))
            frames.append(ts.obs.cpu())
            states.append(tree_map(lambda x: x.cpu(), state))
            rewards.append((ts.reward.cpu(), ts.terminated.cpu()))
        out[d] = (states, rewards, frames, lanes)
    assert coinrun_step.step.launches == launches + 4
    cpu, gpu = out["cpu"], out["cuda"]
    assert cpu[3] == gpu[3]  # the same hazard lanes
    (reward0, done0), state0 = gpu[1][0], gpu[0][0]
    assert bool(done0[0]) and float(reward0[0]) == 10.0
    assert int(state0.game.t[0]) == 0  # the coin lane restarted
    bad = []
    for a, b in zip(cpu[0], gpu[0]):
        tree_map(lambda x, y: None if torch.equal(x, y)
                 else bad.append(x.shape), a, b)
    assert not bad, bad
    for (ra, da), (rb, db) in zip(cpu[1], gpu[1]):
        assert torch.equal(ra, rb) and torch.equal(da, db)
    for a, b in zip(cpu[2], gpu[2]):
        assert torch.equal(a, b)


def test_bossfight_on_card_matches_cpu(dev):
    """make("bossfight") on the card against make(device="cpu"), with lane
    0's agent on its boss and lane 1's boss dying, so that both lanes end
    and auto-reset on the card."""
    n = 16
    out = {}
    for d in ("cpu", "cuda"):
        env = pt.make("bossfight", device=d)
        bank = env.generate_bank(R.key(5, env.device), n)
        state, ts = env.reset(bank, R.key(6, env.device), n)
        gs, _ = game_lanes.place_boss_deaths(state.game)
        state = dataclasses.replace(state, game=gs)
        frames, states, rewards = [ts.obs.cpu()], [], []
        g = torch.Generator().manual_seed(0)
        for _ in range(6):
            a = torch.randint(0, 15, (n,), generator=g, dtype=torch.int32)
            state, ts = env.step(bank, state, a.to(env.device))
            frames.append(ts.obs.cpu())
            states.append(tree_map(lambda x: x.cpu(), state))
            rewards.append((ts.reward.cpu(), ts.terminated.cpu()))
        out[d] = (states, rewards, frames)
    cpu, gpu = out["cpu"], out["cuda"]
    (reward0, done0), state0 = gpu[1][0], gpu[0][0]
    assert done0[:2].all() and reward0[:2].tolist() == [-10.0, 10.0]
    assert state0.game.t[:2].tolist() == [0, 0]  # both lanes restarted
    bad = []
    for a, b in zip(cpu[0], gpu[0]):
        tree_map(lambda x, y: None if torch.equal(x, y)
                 else bad.append(x.shape), a, b)
    assert not bad, bad
    for (ra, da), (rb, db) in zip(cpu[1], gpu[1]):
        assert torch.equal(ra, rb) and torch.equal(da, db)
    for a, b in zip(cpu[2], gpu[2]):
        assert torch.equal(a, b)


def test_climber_on_card_matches_cpu(dev):
    """make("climber") on the card against make(device="cpu"), with a lane
    on a mob (death, 0) and a lane on its last crystal (+11), so that both
    end and auto-reset on the card."""
    n = 16
    out = {}
    for d in ("cpu", "cuda"):
        env = pt.make("climber", device=d)
        bank = env.generate_bank(R.key(5, env.device), n)
        state, ts = env.reset(bank, R.key(6, env.device), n)
        gs, lanes = game_lanes.place_climber_lanes(state.game, n)
        state = dataclasses.replace(state, game=gs)
        frames, states, rewards = [ts.obs.cpu()], [], []
        g = torch.Generator().manual_seed(0)
        for _ in range(4):
            a = torch.randint(0, 15, (n,), generator=g, dtype=torch.int32)
            state, ts = env.step(bank, state, a.to(env.device))
            frames.append(ts.obs.cpu())
            states.append(tree_map(lambda x: x.cpu(), state))
            rewards.append((ts.reward.cpu(), ts.terminated.cpu()))
        out[d] = (states, rewards, frames, lanes)
    cpu, gpu = out["cpu"], out["cuda"]
    assert cpu[3] == gpu[3]
    (reward0, done0), state0 = gpu[1][0], gpu[0][0]
    assert done0[gpu[3]].all() and reward0[gpu[3]].tolist() == [0.0, 11.0]
    assert state0.game.t[gpu[3]].tolist() == [0, 0]  # both lanes restarted
    bad = []
    for a, b in zip(cpu[0], gpu[0]):
        tree_map(lambda x, y: None if torch.equal(x, y)
                 else bad.append(x.shape), a, b)
    assert not bad, bad
    for (ra, da), (rb, db) in zip(cpu[1], gpu[1]):
        assert torch.equal(ra, rb) and torch.equal(da, db)
    for a, b in zip(cpu[2], gpu[2]):
        assert torch.equal(a, b)


def test_climber_entry_points_on_card(dev):
    """On climber's states: B5 on the expanded field equals B1 on the raw
    inputs, and stamps_from_pixel_bank (B4) its plain version, bitwise."""
    env = pt.make("climber", device=dev)
    bank = env.generate_bank(R.key(5, env.device), 32)
    state, _ = env.reset(bank, R.key(6, env.device), 64)
    for _ in range(3):
        state, _ = env.step(bank, state,
                            torch.full((64,), 7, dtype=torch.int32, device=dev))
    gs = state.game
    field = climber._scene_field(env.cfg, gs)
    raw = sk.scene_raw(*climber._scene_inputs(env.cfg, gs))
    assert torch.equal(_bits(sk.scene(*field)), _bits(raw))
    b, v, s, r0, c0 = field[6][0]
    got = compositor.stamps_from_pixel_bank(b, v, r0, c0, alives=s)
    want = stk.stamps_reference(b, v, s, r0, c0, 64)
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))


def test_trig_same_on_cuda(dev):
    """cos32/sin32 (glibc's sincosf in float64 ops) give the same bits on
    the card as on the CPU, across both reductions and the special
    values."""
    g = torch.Generator().manual_seed(0)
    x = torch.cat([
        (torch.rand(200000, generator=g) - 0.5) * 14,
        (torch.rand(200000, generator=g) - 0.5) * 400,
        (torch.rand(100000, generator=g) - 0.5) * 2e4,
        torch.exp((torch.rand(100000, generator=g) - 0.3) * 80),
        torch.tensor([0.0, -0.0, 2.0 ** -13, 0.75, 120.0, -120.0,
                      float("inf"), float("nan"), 3.4e38])]).float()
    c, s = trig.sincos32(x.to(dev))
    for want, got in ((trig.cos32(x), c), (trig.sin32(x), s)):
        assert torch.equal(want.view(torch.int32), got.cpu().view(torch.int32))


def test_caveflyer_scene_kernel_matches_plain(dev):
    """B1 on caveflyer's real inputs, easy and hard: four stamp groups,
    smoke at fractional scales (hard: 107 slots), bitwise."""
    g = torch.Generator(device=dev).manual_seed(1)
    for mode in ("easy", "hard"):
        env = pt.make("caveflyer", device=dev, mode=mode)
        bank = env.generate_bank(R.key(5, env.device), 16)
        state, _ = env.reset(bank, R.key(6, env.device), 257)
        for _ in range(4):
            a = torch.randint(0, 15, (257,), generator=g, device=dev)
            state, _ = env.step(bank, state, a, render=False)
        args = caveflyer._scene_inputs(env.cfg, state.game)
        smoke = args[12][0][2]
        assert len(args[12]) == 4 and ((smoke > 0) & (smoke < 1)).any()
        got = sk.scene_raw(*args)
        assert torch.equal(_bits(got), _bits(sk.scene_raw_reference(*args)))


def test_caveflyer_on_card_matches_cpu(dev):
    """make("caveflyer") on the card against make(device="cpu"), with a
    lane on its goal (+10) and a lane on a hazard (death, 0), so that both
    end and auto-reset on the card; 2 steps, then 2 more."""
    n = 16
    out = {}
    for d in ("cpu", "cuda"):
        env = pt.make("caveflyer", device=d)
        bank = env.generate_bank(R.key(5, env.device), n)
        state, ts = env.reset(bank, R.key(6, env.device), n)
        gs, lanes = game_lanes.place_caveflyer_lanes(state.game, n)
        state = dataclasses.replace(state, game=gs)
        frames, states, rewards = [ts.obs.cpu()], [], []
        g = torch.Generator().manual_seed(0)
        for _ in range(4):
            a = torch.randint(0, 15, (n,), generator=g, dtype=torch.int32)
            state, ts = env.step(bank, state, a.to(env.device))
            frames.append(ts.obs.cpu())
            states.append(tree_map(lambda x: x.cpu(), state))
            rewards.append((ts.reward.cpu(), ts.terminated.cpu()))
        out[d] = (states, rewards, frames, lanes)
    cpu, gpu = out["cpu"], out["cuda"]
    assert cpu[3] == gpu[3]
    (reward0, done0), state0 = gpu[1][0], gpu[0][0]
    assert done0[gpu[3]].all() and reward0[gpu[3]].tolist() == [10.0, 0.0]
    assert state0.game.t[gpu[3]].tolist() == [0, 0]  # both lanes restarted
    bad = []
    for a, b in zip(cpu[0], gpu[0]):
        tree_map(lambda x, y: None if torch.equal(x, y)
                 else bad.append(x.shape), a, b)
    assert not bad, bad
    for (ra, da), (rb, db) in zip(cpu[1], gpu[1]):
        assert torch.equal(ra, rb) and torch.equal(da, db)
    for a, b in zip(cpu[2], gpu[2]):
        assert torch.equal(a, b)


def test_atan2f_same_on_cuda(dev):
    """atan2f (glibc's atan2f in f32 ops, subnormals flushed) gives the
    same bits on the card as on the CPU: random exponents, the axes,
    zeros, infinities and NaN."""
    g = torch.Generator().manual_seed(0)
    e = torch.randint(-150, 128, (2, 300000), generator=g).double()
    m = 1 + torch.rand((2, 300000), generator=g, dtype=torch.float64)
    sign = torch.where(torch.rand((2, 300000), generator=g) < 0.5, -1.0, 1.0)
    y, x = (m * 2.0 ** e * sign).float()
    special = torch.tensor([0.0, -0.0, 1.0, -1.0, 2.5, float("inf"),
                            float("-inf"), float("nan"), 1e-40])
    sy, sx = torch.meshgrid(special, special, indexing="ij")
    y, x = torch.cat([y, sy.flatten()]), torch.cat([x, sx.flatten()])
    want = trig.atan2f(y, x)
    got = trig.atan2f(y.to(dev), x.to(dev)).cpu()
    same = (want.view(torch.int32) == got.view(torch.int32)) | (
        want.isnan() & got.isnan())
    assert same.all()


def test_jumper_kernels_match_plain(dev):
    """B1 on jumper's real scene inputs (two stamp groups, dust at
    fractional scales) and B3 on its needle group, easy and hard, at 257
    envs after 4 steps, bitwise."""
    g = torch.Generator(device=dev).manual_seed(1)
    for mode in ("easy", "hard"):
        env = pt.make("jumper", device=dev, mode=mode)
        bank = env.generate_bank(R.key(5, env.device), 16)
        state, _ = env.reset(bank, R.key(6, env.device), 257)
        for _ in range(4):
            a = torch.randint(0, 15, (257,), generator=g, device=dev)
            state, _ = env.step(bank, state, a, render=False)
        args = jumper._scene_inputs(env.cfg, state.game)
        assert [grp[1].shape[1] for grp in args[12]] == [11, 1]
        img = sk.scene_raw(*args)
        assert torch.equal(_bits(img), _bits(sk.scene_raw_reference(*args)))
        group = compositor.stamp_group(
            jumper._scene_tensors(4, env.cfg.world_dim, str(dev))["banks"][
                "needle"], *jumper._needle_stamp(state.game))
        got = stk.composite(img, [group])
        assert torch.equal(_bits(got), _bits(stk.composite_reference(
            img, [group])))


def test_needle_group_at_every_edge_offset(dev):
    """B3 on one K = 1, P = 32 group (jumper's needle bank) with the
    needle at every row and every column offset from -P - 1 to obs + 1,
    every variant, over a frame of whole values, bitwise against the
    plain version."""
    bank = jumper._scene_tensors(4, 20, str(dev))["banks"]["needle"]
    P, obs = 32, 64
    span = obs + P + 3
    e = torch.arange(2 * span, device=dev)
    r0 = (-P - 1 + e % span).to(torch.int32)[:, None]
    c0 = (-P - 1 + (e * 37) % span).to(torch.int32)[:, None]
    var = (e % 64).to(torch.int32)[:, None]
    g = torch.Generator(device=dev).manual_seed(2)
    img = torch.randint(0, 256, (2 * span, 3, obs, obs), generator=g,
                        device=dev, dtype=torch.int32).to(torch.bfloat16)
    assert compositor.stamp_kernel_ok(P, 1)
    before = stk.composite.launches
    got = compositor.composite_stamps(img, bank, var, r0, c0)
    torch.cuda.synchronize()
    assert stk.composite.launches == before + 1
    group = compositor.stamp_group(bank, var, r0, c0)
    assert torch.equal(_bits(got), _bits(stk.composite_reference(img, [group])))


def test_jumper_on_card_matches_cpu(dev):
    """make("jumper") on the card against make(device="cpu"): the bank
    (the maze generator, spikes and breakup on the card), and with lane 0
    on its carrot (+10) and a lane on a spike (death, 0), so that both end
    and auto-reset on the card; 4 steps."""
    n = 16
    out = {}
    for d in ("cpu", "cuda"):
        env = pt.make("jumper", device=d)
        bank = env.generate_bank(R.key(5, env.device), n)
        state, ts = env.reset(bank, R.key(6, env.device), n)
        gs, lanes = game_lanes.place_jumper_lanes(state.game, n)
        state = dataclasses.replace(state, game=gs)
        frames, states, rewards = [ts.obs.cpu()], [], []
        g = torch.Generator().manual_seed(0)
        for _ in range(4):
            a = torch.randint(0, 15, (n,), generator=g, dtype=torch.int32)
            state, ts = env.step(bank, state, a.to(env.device))
            frames.append(ts.obs.cpu())
            states.append(tree_map(lambda x: x.cpu(), state))
            rewards.append((ts.reward.cpu(), ts.terminated.cpu()))
        out[d] = (tree_map(lambda x: x.cpu(), bank), states, rewards, frames,
                  lanes)
    cpu, gpu = out["cpu"], out["cuda"]
    assert cpu[4] == gpu[4]
    (reward0, done0), state0 = gpu[2][0], gpu[1][0]
    assert done0[gpu[4]].all() and reward0[gpu[4]].tolist() == [10.0, 0.0]
    assert state0.game.t[gpu[4]].tolist() == [0, 0]  # both lanes restarted
    bad = []
    for a, b in zip([cpu[0]] + cpu[1], [gpu[0]] + gpu[1]):
        tree_map(lambda x, y: None if torch.equal(x, y)
                 else bad.append(x.shape), a, b)
    assert not bad, bad
    for (ra, da), (rb, db) in zip(cpu[2], gpu[2]):
        assert torch.equal(ra, rb) and torch.equal(da, db)
    for a, b in zip(cpu[3], gpu[3]):
        assert torch.equal(a, b)


def _kind_field_run(game, dev_name, n, steps, place, **cfg):
    """make(game) on `dev_name` (a bank of n levels, n envs, the lanes
    placed by `place(state, env)`, `steps` steps whose placed lanes first
    hold still), all on the CPU: (bank, states, rewards, frames, lanes,
    launches of the four render kernel wrappers and of maze's M1)."""
    wrappers = (sk.scene_raw, sk.scene, stk.composite, stk.stamps,
                maze_render.render)
    for w in wrappers:
        w.launches = 0
    env = pt.make(game, device=dev_name, **cfg)
    bank = env.generate_bank(R.key(5, env.device), n)
    state, ts = env.reset(bank, R.key(6, env.device), n)
    gs, lanes = place(state.game, env)
    state = dataclasses.replace(state, game=gs)
    g = torch.Generator().manual_seed(0)
    actions = game_lanes.hold_first_action(torch.randint(
        0, 15, (steps, n), generator=g, dtype=torch.int32), lanes)
    frames, states, rewards = [ts.obs.cpu()], [], []
    for t in range(steps):
        state, ts = env.step(bank, state, actions[t].to(env.device))
        frames.append(ts.obs.cpu())
        states.append(tree_map(lambda x: x.cpu(), state))
        rewards.append((ts.reward.cpu(), ts.terminated.cpu()))
    return (tree_map(lambda x: x.cpu(), bank), states, rewards, frames, lanes,
            [w.launches for w in wrappers])


def _same_runs(cpu, gpu):
    assert cpu[4] == gpu[4]
    bad = []
    for a, b in zip([cpu[0]] + cpu[1], [gpu[0]] + gpu[1]):
        tree_map(lambda x, y: None if torch.equal(x, y)
                 else bad.append(x.shape), a, b)
    assert not bad, bad
    for (ra, da), (rb, db) in zip(cpu[2], gpu[2]):
        assert torch.equal(ra, rb) and torch.equal(da, db)
    for a, b in zip(cpu[3], gpu[3]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["easy", "hard", "extreme"])
def test_chaser_on_card_matches_cpu(dev, mode):
    """make("chaser") on the card against make(device="cpu"): the bank,
    and with lane 0 left with nothing to collect (+10) and lane 1's agent
    under a hatched enemy (death, 0), so that both end and auto-reset on
    the card; 4 steps, every field, reward and obs pixel equal."""
    def place(gs, env):
        return game_lanes.place_chaser_lanes(gs)

    cpu, gpu = (_kind_field_run("chaser", d, 16, 4, place, mode=mode)
                for d in ("cpu", "cuda"))
    _same_runs(cpu, gpu)
    (reward0, done0), state0 = gpu[2][0], gpu[1][0]
    assert done0[gpu[4]].all() and reward0[gpu[4]].tolist() == [10.0, 0.0]
    assert state0.game.t[gpu[4]].tolist() == [0, 0]


@pytest.mark.parametrize("mode", ["easy", "hard", "memory"])
def test_maze_on_card_matches_cpu(dev, mode):
    """make("maze") on the card against make(device="cpu"): the bank (the
    per-level maze sizes on the card), and with lane 0 on its goal (+10)
    and lane 1 at its last step (terminated with 0), so that both end and
    auto-reset on the card; 4 steps, every field, reward and obs pixel
    equal (memory mode's camera on the map centre, then on the agent)."""
    def place(gs, env):
        return game_lanes.place_maze_lanes(gs, env.cfg)

    cpu, gpu = (_kind_field_run("maze", d, 16, 4, place, mode=mode)
                for d in ("cpu", "cuda"))
    _same_runs(cpu, gpu)
    (reward0, done0), state0 = gpu[2][0], gpu[1][0]
    assert done0[gpu[4]].all() and reward0[gpu[4]].tolist() == [10.0, 0.0]
    assert state0.game.t[gpu[4]].tolist() == [0, 0]


def test_chaser_and_maze_launch_no_kernel(dev):
    """Neither game's main path reaches a TPU kernel in the JAX package,
    so neither launches one of their ports here: no scene, stamp or
    stamp-sum kernel on the card over reset and 4 steps (chaser's stamp
    group is off the kernel path, `compositor.stamp_kernel_ok`); maze's
    render is its own kernel M1, once a render, chaser's plain torch."""
    runs = [_kind_field_run("chaser", "cuda", 64, 4,
                            lambda gs, env: game_lanes.place_chaser_lanes(gs)),
            _kind_field_run("maze", "cuda", 64, 4,
                            lambda gs, env: game_lanes.place_maze_lanes(
                                gs, env.cfg), mode="easy")]
    assert runs[0][5] == [0, 0, 0, 0, 0]
    assert runs[1][5] == [0, 0, 0, 0, 5]  # reset + 4 steps


# ---------------------------------------------------------------------------
# The exact renders: scene_phases=0 through B3, and Environment.render
# ---------------------------------------------------------------------------

# the games of chip_smoke.EXACT_GAMES, named here so that collection
# imports no root script
EXACT_GAMES = ("caveflyer", "climber", "coinrun", "jumper")


@pytest.mark.parametrize("game", sorted(EXACT_GAMES))
def test_exact_render_on_card_matches_cpu(dev, smoke, game):
    """make(game, scene_phases=0) on the card against the CPU: bank,
    states, rewards and every obs pixel over reset and 4 steps of 16
    envs; the card launches B3 once per kernel-path stamp group per
    render and no other kernel."""
    assert sorted(smoke.EXACT_GAMES) == list(EXACT_GAMES)
    per_render = smoke.EXACT_GAMES[game][3]

    def place(gs, env):
        return gs, []

    cpu, gpu = (_kind_field_run(game, d, 16, 4, place, scene_phases=0)
                for d in ("cpu", "cuda"))
    _same_runs(cpu, gpu)
    assert gpu[5] == [0, 0, per_render * 5, 0, 0]  # reset + 4 steps


@pytest.mark.parametrize("game", sorted(EXACT_GAMES))
def test_stamp_kernel_on_exact_inputs(dev, smoke, game):
    """B3 on every stamp group of an exact render (64 envs, 4 steps in),
    bitwise equal to its plain version."""
    env = pt.make(game, scene_phases=0)
    bank = env.generate_bank(R.key(5, env.device), 64)
    state, _ = env.reset(bank, R.key(6, env.device), 64)
    g = torch.Generator(device=dev).manual_seed(0)
    for _ in range(4):
        state, _ = env.step(bank, state, torch.randint(
            0, 15, (64,), generator=g, device=dev, dtype=torch.int32),
            render=False)
    calls = smoke.exact_render_calls(env.game, env.cfg, state.game)
    assert len(calls) == smoke.EXACT_GAMES[game][3]
    for img, groups in calls:
        got = stk.composite(img, groups)
        want = stk.composite_reference(img, groups)
        assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("game", pt.GAMES)
def test_window_render_on_card_matches_cpu(dev, smoke, game):
    """Environment.render(state, 512, env_index) on the card for env 0
    and 1: no kernel launched, bitwise equal to the CPU's render of the
    same state."""
    smoke.window_render_check(game, dev, n=4, steps=4)


# ---- the learner-facing surface on the card ----------------------------

def _rollout_env(name, n_levels=16, n_envs=64, key=0, **cfg):
    from types import SimpleNamespace
    env = pt.make(name, **cfg)
    bank = env.generate_bank(R.key(key, env.device), n_levels)
    state, _ = env.reset(bank, R.key(1, env.device), n_envs)
    return SimpleNamespace(env=env, bank=bank), state


def _eager(vec, state, actions):
    outs = []
    for a in actions:
        state, ts = vec.env.step(vec.bank, state, a)
        outs.append((ts.obs, a, ts.reward, ts.terminated,
                     ts.info["returned_episode_return"],
                     ts.info["returned_episode_length"]))
    return state, [torch.stack(x) for x in zip(*outs)]


def _same(a, b):
    tree_map(lambda x, y: None if torch.equal(x.cpu(), y.cpu())
             else pytest.fail("differs"), a, b)


@pytest.mark.parametrize("name,cfg", [("maze", {"mode": "easy"}),
                                      ("coinrun", {})])
def test_graph_rollout_equals_eager_steps(dev, name, cfg):
    """One CUDA graph of T steps, replayed, equals `Environment.step` in a
    loop on the same state and actions: every buffer field and the final
    state; a second replay from the same inputs equals the first."""
    from procgen2_tpu_torch.dist import rollout
    from procgen2_tpu_torch.dist.rollout import graphs
    vec, state = _rollout_env(name, **cfg)
    key = R.key(5, dev)
    final, buf = rollout(vec, state, key, 4)
    efinal, efields = _eager(vec, state, buf.actions)
    _same(final, efinal)
    _same([buf.obs, buf.actions, buf.rewards, buf.dones, buf.ep_returns,
           buf.ep_lengths], efields)
    again = rollout(vec, state, key, 4)
    _same((final, buf), again)
    assert len(graphs(vec.env)) == 1


def test_graph_rollout_reads_a_new_bank(dev):
    """A bank with other tensors captures its own graph: the replay reads
    the new bank, not the old one's addresses."""
    from types import SimpleNamespace
    from procgen2_tpu_torch.dist import rollout
    from procgen2_tpu_torch.dist.rollout import graphs
    vec, state = _rollout_env("maze", mode="easy", timeout=3)
    key = R.key(5, dev)
    rollout(vec, state, key, 4)
    other = SimpleNamespace(env=vec.env, bank=vec.env.generate_bank(
        R.key(9, dev), 16))
    final, buf = rollout(other, state, key, 4)
    assert len(graphs(other.env)) == 2
    efinal, efields = _eager(other, state, buf.actions)
    _same(final, efinal)
    _same([buf.obs, buf.rewards, buf.dones], [efields[0], efields[2],
                                              efields[3]])
    assert bool(buf.dones.any())  # the timeout restarts from the new bank


def test_fresh_policies_stay_within_one_pool(dev, smoke):
    """20 rollouts of coinrun at 256 envs, T = 4, each with a fresh
    `functools.partial(policy, params)` and fresh params, as a learner
    binds its weights per call: each captures a graph, equals the eager
    loop bitwise and reads its own params; the device memory reserved
    after call 20 exceeds that after call 2 by at most the first graph's
    pool plus 10%, and grows by at most 10% of it once the table is full;
    the env keeps GRAPHS_PER_ENV graphs in one pool
    (chip_smoke.fresh_policy_rollouts). With a pool per graph and every
    graph kept, each call reserved one more pool."""
    smoke.fresh_policy_rollouts()


def test_graphs_sharing_a_pool_replay_interleaved(dev, smoke):
    """Graphs A and B, captured in the env's one pool on two banks with
    two policies, replayed A, B, A, B from other keys: each replay equals
    its eager loop bitwise, though B's capture may have placed its
    intermediates where A's were freed (chip_smoke.interleaved_replays)."""
    smoke.interleaved_replays()


@pytest.mark.parametrize("label", list(game_lanes.MODE_CASES))
def test_mode_on_card(dev, smoke, label):
    """A main path at a config other than the default (hard, memory,
    easy_mode, coinrun's features off) at 256 envs on 64 levels
    (chip_smoke.mode_path): the kernels launched T + 1 times, the placed
    lanes ending and restarting, B1 (and jumper's B3) bitwise equal to
    its plain version on the last step's inputs, the graph rollout equal
    to the eager loop, and 64 envs on the card equal to the CPU."""
    smoke.mode_path(label, n_levels=64, n_envs=256, replays=1)


def test_make_vec_on_card(dev, smoke):
    """make_vec in one process on the card: bank, reset and rollout equal
    make's bitwise; metrics equal float64 on the host (chip_smoke.
    vec_phase at 512 envs on 64 levels)."""
    smoke.vec_phase(n_envs=512, n_levels=64)


def test_wave_game_on_card(dev, smoke):
    """make(wave_game) on the card equals the CPU over 45 steps
    (chip_smoke.module_phase)."""
    smoke.module_phase(n_envs=16)


def test_checkpoint_round_trip_on_card(dev, tmp_path):
    """A state saved on the card restores onto the card and continues as
    the live state does."""
    from procgen2_tpu_torch.utils import checkpoint
    vec, state = _rollout_env("coinrun")
    a = torch.zeros(64, dtype=torch.int32, device=dev)
    state, _ = vec.env.step(vec.bank, state, a + 7)
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, state=state, bank=vec.bank)
    res = checkpoint.restore(path, state=state, bank=vec.bank)
    assert res["state"].rng.device == state.rng.device
    _same(state, res["state"])
    live, _ = vec.env.step(vec.bank, state, a + 5)
    back, _ = vec.env.step(res["bank"], res["state"], a + 5)
    _same(live, back)


@pytest.mark.parametrize("name", ["coinrun", "bossfight", "climber",
                                  "caveflyer", "jumper"])
def test_reference_levels_on_card_match_cpu(dev, smoke, name, monkeypatch):
    """Two seeds of the game's reference bank (the parity suite's first
    two) tiled to 256 envs through `dist.rollout` graphs, played by its
    bot or plan (chip_smoke.reference_card): every replica's rewards and
    terminations up to its seed's end, the actions and the first frames
    equal the CPU run (chip_smoke.reference_cpu, which the predictor's
    stream equals), and B1 / B3 launch on the games that render with
    them."""
    cfg, seeds, plan, max_steps, _, kernels = smoke.REFERENCE_CASES[name]
    monkeypatch.setitem(smoke.REFERENCE_CASES, name,
                        (cfg, seeds[:2], plan, max_steps, 256, kernels))
    card = smoke.reference_card(name)
    cpu = smoke.reference_cpu(name)
    assert smoke.reference_check(name, card, cpu) >= 256
    assert {w for w, c in card["counted"].items() if c} == {
        smoke.KERNEL_OF[k].__name__ for k in kernels}


# ---- coinrun's step kernel against the plain torch step ----------------

STEP_CONFIGS = {"default": {}, "easy_mode": {"easy_mode": True},
                "features off": game_lanes.FEATURES_OFF,
                "scene_phases=0": {"scene_phases": 0}}
_INT_OF_SIZE = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}


def _bits_same(a, b, what):
    """Two trees of tensors equal bit for bit (floats by their bits, so
    that -0.0 is not 0.0 and a NaN equals only its own bits)."""
    def one(x, y):
        if x.dtype != y.dtype or x.shape != y.shape:
            pytest.fail(f"{what}: {x.dtype} {tuple(x.shape)} against "
                        f"{y.dtype} {tuple(y.shape)}")
        if x.is_floating_point():
            x = x.view(_INT_OF_SIZE[x.element_size()])
            y = y.view(_INT_OF_SIZE[y.element_size()])
        if not torch.equal(x.cpu(), y.cpu()):
            pytest.fail(f"{what}: a leaf of shape {tuple(x.shape)} differs")
    tree_map(one, a, b)


@pytest.mark.parametrize("n", [1, 37, 4096])
@pytest.mark.parametrize("config", sorted(STEP_CONFIGS))
def test_coinrun_step_kernel_equals_plain_step(dev, config, n):
    """64 `Environment.step`s with random actions from a state with lanes
    on the coin, a saw and lava, auto-reset included: at each step the
    env's step (the kernel, one launch) and the same step with the plain
    torch step (`coinrun.step_reference`) from the same state give the
    same next state, reward and done bit for bit."""
    env = pt.make("coinrun", **STEP_CONFIGS[config])
    bank = env.generate_bank(R.key(3, dev), 64)
    state, _ = env.reset(bank, R.key(4, dev), n)
    gs, _ = game_lanes.place_on_hazards(state.game, n)
    state = dataclasses.replace(state, game=gs)
    g = torch.Generator(device=dev)
    g.manual_seed(n)
    ends = 0
    for i in range(64):
        a = torch.randint(0, coinrun.NUM_ACTIONS, (n,), generator=g,
                          device=dev, dtype=torch.int32)
        before = coinrun_step.step.launches
        got, ts = env.step(bank, state, a, render=False)
        assert coinrun_step.step.launches == before + 1
        with pytest.MonkeyPatch.context() as m:
            m.setattr(coinrun, "step", coinrun.step_reference)
            want, wts = env.step(bank, state, a, render=False)
        assert coinrun_step.step.launches == before + 1
        _bits_same((got, ts.reward, ts.terminated),
                   (want, wts.reward, wts.terminated), f"{config}, step {i}")
        ends += int(ts.terminated.sum())
        state = got
    assert ends > 0  # lane 0 sits on its coin


def test_coinrun_step_kernel_on_crafted_lanes(dev):
    """The crafted lanes (tests/coinrun_lanes.py: the coin, a saw and lava
    reached in sub-steps 1, 2 and 3, the one-way crate landed on, fallen
    through and passed from below, a mob walked into, mobs turning at a
    wall and at a ledge, a dead mob, slots beyond the first 32) stepped
    10 times: the kernel equals the plain step bit for bit at each."""
    import coinrun_lanes as lanes
    env = pt.make("coinrun")
    bank = env.generate_bank(R.key(0, dev), 4)
    state, _ = env.reset(bank, R.key(1, dev), lanes.N)
    gs, a = lanes.crafted(state.game)
    for i in range(10):
        got = coinrun.step(env.cfg, gs, a)
        want = coinrun.step_reference(env.cfg, gs, a)
        _bits_same(got[:3], want[:3], f"crafted lanes, step {i}")
        if i == 0:
            k = lanes.active_sub_steps(got[0].anim_t)
            assert set(k[lanes.group("coin")].tolist()) >= {1, 2, 3}
        gs = got[0]
    assert bool((gs.mob_vx[:, :2] < 0).any(0).all())  # both mobs turned


def test_coinrun_rollout_graph_runs_the_step_kernel(dev):
    """A T = 8 `dist.rollout` graph of coinrun in easy mode on 200 levels
    at 1024 envs, each step one launch of the step kernel, equals its
    eager loop of `Environment.step`, and that loop equals the same loop
    on the plain torch step, bit for bit: every buffer field and the
    final state."""
    from procgen2_tpu_torch.dist import rollout
    vec, state = _rollout_env("coinrun", n_levels=200, n_envs=1024,
                              easy_mode=True)
    before = coinrun_step.step.launches
    final, buf = rollout(vec, state, R.key(5, dev), 8)
    assert coinrun_step.step.launches > before  # warm-up and capture
    fields = [buf.obs, buf.actions, buf.rewards, buf.dones, buf.ep_returns,
              buf.ep_lengths]
    efinal, efields = _eager(vec, state, buf.actions)
    _bits_same((final, fields), (efinal, efields), "graph vs eager loop")
    with pytest.MonkeyPatch.context() as m:
        m.setattr(coinrun, "step", coinrun.step_reference)
        pfinal, pfields = _eager(vec, state, buf.actions)
    _bits_same((efinal, efields), (pfinal, pfields),
               "eager loop vs the plain step's")


def _boss_actions(g, n, dev):
    """Random actions with fire (9) in about a third of the envs, so that
    the agent's ring fills."""
    a = torch.randint(0, bossfight.NUM_ACTIONS, (n,), generator=g,
                      device=dev, dtype=torch.int32)
    fire = torch.rand((n,), generator=g, device=dev) < 0.3
    return torch.where(fire, 9, a).to(torch.int32)


@pytest.mark.parametrize("n", [1, 37, 4096])
@pytest.mark.parametrize("mode", ["easy", "hard"])
def test_bossfight_step_kernel_equals_plain_step(dev, mode, n):
    """64 `Environment.step`s with random actions from a state with lane 0's
    agent on its boss and (n > 1) lane 1's boss dying, auto-reset
    included: at each step the env's step (the kernel, one launch) and the
    same step with the plain torch step (`bossfight.step_reference`) from
    the same state give the same next state, reward and done bit for
    bit."""
    env = pt.make("bossfight", mode=mode)
    bank = env.generate_bank(R.key(3, dev), 64)
    state, _ = env.reset(bank, R.key(4, dev), n)
    gs = state.game
    gs = (game_lanes.place_boss_deaths(gs)[0] if n > 1
          else dataclasses.replace(gs, pos=gs.boss_pos.clone()))
    state = dataclasses.replace(state, game=gs)
    g = torch.Generator(device=dev)
    g.manual_seed(n)
    ends = 0
    for i in range(64):
        a = _boss_actions(g, n, dev)
        before = bossfight_step.step.launches
        got, ts = env.step(bank, state, a, render=False)
        assert bossfight_step.step.launches == before + 1
        with pytest.MonkeyPatch.context() as m:
            m.setattr(bossfight, "step", bossfight.step_reference)
            want, wts = env.step(bank, state, a, render=False)
        assert bossfight_step.step.launches == before + 1
        _bits_same((got, ts.reward, ts.terminated),
                   (want, wts.reward, wts.terminated), f"{mode}, step {i}")
        ends += int(ts.terminated.sum())
        state = got
    assert ends > 0  # lane 0 sits on its boss


@pytest.mark.parametrize("case", ["crafted", "crowd"])
def test_bossfight_step_kernel_on_crafted_lanes(dev, case):
    """The crafted lanes (tests/bossfight_lanes.py: deaths in sub-steps 1-4
    with the boss ring moving on, a shield bounce and its timeout, HP 0 and
    the explosion pool, barrier and off-screen hits, both rings full,
    every volley and the passive shot), or 32 rows of 64 crowded past the
    render's cull (`crowd`), stepped 10 times in easy mode: the kernel
    equals the plain step bit for bit at each, one launch a step."""
    import bossfight_lanes as lanes
    env = pt.make("bossfight", mode="easy")
    bank = env.generate_bank(R.key(0, dev), 4)
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    if case == "crafted":
        state, _ = env.reset(bank, R.key(1, dev), lanes.N)
        gs, a = lanes.crafted(state.game)
    else:
        state, _ = env.reset(bank, R.key(1, dev), 64)
        gs = lanes.crowd(state.game, range(32))
        a = _boss_actions(g, 64, dev)
    for i in range(10):
        before = bossfight_step.step.launches
        got = bossfight.step(env.cfg, gs, a)
        assert bossfight_step.step.launches == before + 1
        want = bossfight.step_reference(env.cfg, gs, a)
        _bits_same(got[:3], want[:3], f"{case}, step {i}")
        if i == 0 and case == "crafted":
            k = lanes.active_sub_steps(gs, got[0])
            assert k[lanes.group("death")].tolist() == [1, 2, 3, 4, 4, 1, 1, 4]
        gs = got[0]
        if case == "crowd":
            a = _boss_actions(g, 64, dev)


def test_bossfight_rollout_graph_runs_the_step_kernel(dev):
    """A T = 8 `dist.rollout` graph of bossfight in easy mode on 200 levels
    at 1024 envs, each step one launch of the step kernel, equals its
    eager loop of `Environment.step`, and that loop equals the same loop
    on the plain torch step, bit for bit: every buffer field and the
    final state."""
    from procgen2_tpu_torch.dist import rollout
    vec, state = _rollout_env("bossfight", n_levels=200, n_envs=1024,
                              mode="easy")
    before = bossfight_step.step.launches
    final, buf = rollout(vec, state, R.key(5, dev), 8)
    assert bossfight_step.step.launches > before  # warm-up and capture
    fields = [buf.obs, buf.actions, buf.rewards, buf.dones, buf.ep_returns,
              buf.ep_lengths]
    efinal, efields = _eager(vec, state, buf.actions)
    _bits_same((final, fields), (efinal, efields), "graph vs eager loop")
    with pytest.MonkeyPatch.context() as m:
        m.setattr(bossfight, "step", bossfight.step_reference)
        pfinal, pfields = _eager(vec, state, buf.actions)
    _bits_same((efinal, efields), (pfinal, pfields),
               "eager loop vs the plain step's")


def test_bossfight_easy_graph_rollout_equals_the_benchmark_reference(dev):
    """A T = 8 `dist.rollout` graph of bossfight in easy mode on 200 levels
    at 4096 envs, from a state 24 calls into the loop with rows 0 and 1
    ending their episodes (`game_lanes.place_boss_deaths`) and rows 2-33
    crowded past the render's 36-bullet cull (tests/bossfight_lanes.py),
    equals the benchmark's plain reference on sampled rows, bit for bit:
    every buffer field and the final state. The sample holds the crafted
    rows, the rows past the cull by play, and 64 drawn rows."""
    import bossfight_lanes as lanes
    from benchmark import check
    from benchmark.reference import env as ref_env
    from procgen2_tpu_torch.dist import make_vec, rollout
    n, levels, T = 4096, 200, 8
    vec = make_vec("bossfight", num_envs=n, num_levels=levels, device=dev,
                   mode="easy")
    state, _ = vec.reset(R.key(21, dev))
    for c in range(24):
        state, _ = rollout(vec, state, R.fold_in(R.key(22, dev), c), T)
    played = (lanes.drawn_bullets(state.game) > lanes.CULL).nonzero()[:, 0]
    game = lanes.crowd(game_lanes.place_boss_deaths(state.game)[0],
                       range(2, 34))
    state = dataclasses.replace(state, game=game)
    drawn = torch.randperm(n, generator=torch.Generator().manual_seed(3))[:64]
    rows = torch.cat([torch.arange(34), played[:64].cpu(), drawn])
    rows = rows.unique().to(dev)
    key = R.key(23, dev)
    final, buf = rollout(vec, state, key, T)
    assert buf.dones[0, :2].all()
    ref = ref_env.Env("bossfight", {"mode": "easy"}, n, levels, dev)
    ref_state, _ = ref.reset(vec.bank, R.key(21, dev), rows)
    start = tree_map(lambda _, p: p[rows], ref_state, state)
    ref_final, ref_buf = ref.rollout(vec.bank, start, key, T, rows)
    for f in ("obs", "actions", "rewards", "dones", "ep_returns",
              "ep_lengths"):
        assert check.differ(getattr(buf, f)[:, rows], getattr(ref_buf, f)) \
            == 0, f
    assert check.tree_differ(ref_env.rows_of(final, rows), ref_final) == 0


def test_bossfight_render_spans_on_card(dev, monkeypatch):
    """A profiled eager bossfight step on the card holds the render's spans
    in order (`env.render`, `render.stamp_groups`, `render.b3`); with no
    profiler the step enters no range."""
    from torch.profiler import ProfilerActivity, profile

    from procgen2_tpu_torch.dist import make_vec
    vec = make_vec("bossfight", num_envs=64, num_levels=8, device=dev,
                   mode="easy")
    state, _ = vec.reset(R.key(3, dev))
    a = torch.zeros(64, dtype=torch.int32, device=dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        vec.step(state, a)
        torch.cuda.synchronize()
    names = [e.name() for e in sorted(prof.profiler.kineto_results.events(),
                                      key=lambda e: e.start_ns())
             if e.device_type() == torch.autograd.DeviceType.CPU
             and e.name().startswith(("env.render", "render."))]
    assert names == ["env.render", "render.stamp_groups", "render.b3"]

    def refuse(*args, **kwargs):
        raise AssertionError("a range was entered with no profiler")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    vec.step(state, a)
    torch.cuda.synchronize()


# ---- maze's render kernel M1 against the plain render ------------------

@pytest.mark.parametrize("n", [1, 7, 8192])
@pytest.mark.parametrize("mode", ["easy", "hard"])
def test_maze_render_kernel_equals_plain_render(dev, mode, n):
    """`maze.observe_batch` on the card (M1, one launch) against the plain
    render (`maze.observe_batch_reference`) on the card, bit for bit, at 3
    and 9 steps in: the mouse on its cheese and off it facing both ways,
    on its start cell (a corner of the maze, beside the wall margin or on
    the grid's edge) and where its steps took it, on every background
    (n >= 9), with `game_lanes.place_maze_render_lanes`."""
    env = pt.make("maze", mode=mode)
    bank = env.generate_bank(R.key(3, dev), 200)
    state, _ = env.reset(bank, R.key(4, dev), n)
    g = torch.Generator(device=dev)
    g.manual_seed(n)
    kinds = set()
    for i in range(9):
        a = torch.randint(0, maze.NUM_ACTIONS, (n,), generator=g, device=dev,
                          dtype=torch.int32)
        state, _ = env.step(bank, state, a, render=False)
        if i not in (2, 8):
            continue
        gs = game_lanes.place_maze_render_lanes(state.game)
        before = maze_render.render.launches
        got = maze.observe_batch(env.cfg, gs)
        assert maze_render.render.launches == before + 1
        want = maze.observe_batch_reference(env.cfg, gs)
        assert maze_render.render.launches == before + 1
        assert torch.equal(got, want), f"{mode}, step {i}"
        kinds |= set(maze._augmented(gs).unique().tolist())
    if n >= 9:
        assert kinds == set(range(7))
        assert set(gs.level.bg_index.tolist()) == set(range(maze.NUM_BGS))


def test_maze_render_kernel_rejects_bad_inputs(dev):
    """The wrapper refuses state tensors of another dtype, shape or device
    and constants of another dtype, shape or device or off a 16-byte
    boundary, before anything launches."""
    env = pt.make("maze", mode="easy")
    bank = env.generate_bank(R.key(3, dev), 8)
    state, _ = env.reset(bank, R.key(4, dev), 8)
    gs, lv = state.game, state.game.level
    c = maze._render_tensors("easy", str(dev))["m1"]
    ok = dict(grid=lv.grid, goal_pos=lv.goal_pos, pos=gs.pos,
              face_forward=gs.face_forward, bg_index=lv.bg_index, consts=c)
    assert torch.equal(maze_render.render(**ok),
                       maze.observe_batch_reference(env.cfg, gs))
    bad = [("grid", lv.grid.int()), ("grid", lv.grid[:, :, 1:]),
           ("grid", torch.zeros((8, 65, 65), dtype=torch.int8, device=dev)),
           ("goal_pos", lv.goal_pos.double()), ("goal_pos", lv.goal_pos.cpu()),
           ("pos", gs.pos[:4]), ("face_forward", gs.face_forward.int()),
           ("bg_index", lv.bg_index.long()),
           ("consts", dataclasses.replace(c, kinds=c.kinds.cpu())),
           ("consts", dataclasses.replace(c, walled=c.walled[:, :2])),
           ("consts", dataclasses.replace(c, layer_lut=c.layer_lut[:128])),
           ("consts", dataclasses.replace(c, bg_bank=torch.empty(
               c.bg_bank.numel() + 1, dtype=torch.uint8, device=dev)[
                   1:].view(c.bg_bank.shape)))]
    before = maze_render.render.launches
    for name, value in bad:
        with pytest.raises(ValueError):
            maze_render.render(**dict(ok, **{name: value}))
    assert maze_render.render.launches == before
