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
Environment.render at 512 px against the CPU.

They skip without a card. This file imports no jax, so it runs on a
machine without it; there, skip the repo's conftest (which sets jax up):

    python -m pytest --noconftest tests/test_torch_cuda.py
"""
import dataclasses

import pytest
import torch

import chip_smoke
import procgen2_tpu_torch as pt
from procgen2_tpu_torch import random as R
from procgen2_tpu_torch import trig
from procgen2_tpu_torch.games import caveflyer, climber, jumper
from procgen2_tpu_torch.render import compositor
from procgen2_tpu_torch.render import scene_kernel as sk
from procgen2_tpu_torch.render import stamp_kernel as stk
from procgen2_tpu_torch.utils import tree_map

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _bits(x):
    return x.view(torch.int16)


@pytest.mark.parametrize("n,seed", [(1, 0), (257, 1)])
def test_scene_kernel_matches_plain(dev, n, seed):
    args = chip_smoke.random_scene(n, dev, seed)
    before = sk.scene_raw.launches
    got = sk.scene_raw(*args)
    torch.cuda.synchronize()
    assert sk.scene_raw.launches == before + 1
    assert torch.equal(_bits(got), _bits(sk.scene_raw_reference(*args)))


def test_scene_kernel_edge_cases(dev):
    """No stamp groups; windows wholly outside the grid; every stamp
    off the frame."""
    args = list(chip_smoke.random_scene(64, dev, 2))
    args[1] = torch.full_like(args[1], -1000)  # ty0
    got = sk.scene_raw(*args[:12], [], *args[13:])
    assert torch.equal(_bits(got), _bits(
        sk.scene_raw_reference(*args[:12], [], *args[13:])))
    assert not got.any()  # nothing inside the grid: black
    args = list(chip_smoke.random_scene(64, dev, 3))
    off = [(b, v, s, torch.full_like(r, 70), c) for b, v, s, r, c in args[12]]
    got = sk.scene_raw(*args[:12], off, *args[13:])
    assert torch.equal(_bits(got), _bits(
        sk.scene_raw_reference(*args[:12], [], *args[13:])))


def test_scene_kernel_rejects_bad_inputs(dev):
    args = list(chip_smoke.random_scene(8, dev, 4))
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
    """Bossfight's four stamp groups (chip_smoke.random_stamps: variants
    out of range, scale 0, fractional scales, stamps off every edge,
    overlaps): one launch, bitwise equal to the plain version and to one
    launch per group in turn."""
    img, groups = chip_smoke.random_stamps(n, dev, seed)
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
    img, groups = chip_smoke.random_stamps(64, dev, 3)
    off = [(b, v, s, torch.full_like(r, 64), c) for b, v, s, r, c in groups]
    assert torch.equal(_bits(stk.composite(img, off)), _bits(img))
    dead = [(b, v, torch.zeros_like(s), r, c) for b, v, s, r, c in groups]
    assert torch.equal(_bits(stk.composite(img, dead)), _bits(img))


def test_stamp_kernel_rejects_bad_inputs(dev):
    img, groups = chip_smoke.random_stamps(8, dev, 4)
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
@pytest.mark.parametrize("case", chip_smoke.EDGE_CASES)
def test_stamp_kernel_edge_slots(dev, case, n):
    """B3 on the edge cases of its staged slot tables (chip_smoke.
    edge_groups: K = 300 in one group, over more than one staging pass;
    40 live slots stacked on one pixel with dead slots between them; P = 40
    at every offset across the lanes' 8-pixel runs and the warps' 16 x 16
    regions): one launch, bitwise equal to the plain version."""
    img, groups = chip_smoke.edge_stamps(case, n, dev, seed=n)
    before = stk.composite.launches
    got = stk.composite(img, groups)
    torch.cuda.synchronize()
    assert stk.composite.launches == before + 1
    assert torch.equal(_bits(got), _bits(stk.composite_reference(img, groups)))


@pytest.mark.parametrize("n", [1, 257, 4097])
@pytest.mark.parametrize("case", chip_smoke.EDGE_CASES)
def test_scene_kernel_edge_slots(dev, case, n):
    """B1 on the same edge cases, with themed and unthemed tile entries
    for every theme (chip_smoke.edge_scene): bitwise equal to the plain
    version."""
    args = chip_smoke.edge_scene(case, n, dev, seed=n)
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
    groups = [chip_smoke.random_group(g, n, dev, 6, 8, 300, obs)]
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
    groups = [chip_smoke.random_group(g, 33, dev, 6, 8, 300, obs),
              chip_smoke.random_group(g, 33, dev, 3, 40, 7, obs)]
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
    img, groups = chip_smoke.random_stamps(8, dev, 5)
    before = stk.composite.launches
    with pytest.raises(ValueError):
        stk.composite(_misaligned(img), groups)
    with pytest.raises(ValueError):
        stk.composite(img[..., :60, :60].contiguous(), groups)
    assert stk.composite.launches == before
    args = list(chip_smoke.random_scene(8, dev, 6))
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
    """B4 on groups with P = 8, 12 and 20 (chip_smoke.random_sum_groups:
    variants out of range, scale 0, fractional scales, stamps off every
    edge, overlaps): one launch each, bitwise equal to the plain version."""
    for group in chip_smoke.random_sum_groups(n, dev, seed):
        before = stk.stamps.launches
        got = stk.stamps(*group, 64)
        torch.cuda.synchronize()
        assert stk.stamps.launches == before + 1
        want = stk.stamps_reference(*group, 64)
        for g, w in zip(got, want):
            assert torch.equal(_bits(g), _bits(w))


def test_stamp_sum_kernel_edge_cases(dev):
    """Every stamp off the frame, every slot dead, or no slot: zeros."""
    for b, v, s, r, c in chip_smoke.random_sum_groups(64, dev, 3):
        for group in ((b, v, s, torch.full_like(r, 64), c),
                      (b, v, torch.zeros_like(s), r, c),
                      (b, v[:, :0].contiguous(), s[:, :0].contiguous(),
                       r[:, :0].contiguous(), c[:, :0].contiguous())):
            rgb, a = stk.stamps(*group, 64)
            assert not rgb.any() and not a.any()


def test_stamp_sum_kernel_rejects_bad_inputs(dev):
    bank, var, scale, r0, c0 = chip_smoke.random_sum_groups(8, dev, 4)[0]
    with pytest.raises(TypeError):
        stk.stamps(bank.float(), var, scale, r0, c0, 64)
    with pytest.raises(TypeError):
        stk.stamps(bank, var, scale.double(), r0, c0, 64)
    with pytest.raises(ValueError):
        stk.stamps(bank, var, scale, r0[:4], c0, 64)
    with pytest.raises(ValueError):
        stk.stamps(bank.cpu(), var, scale, r0, c0, 64)


@pytest.mark.parametrize("n", [1, 257])
@pytest.mark.parametrize("case", chip_smoke.EDGE_CASES)
def test_stamp_sum_kernel_edge_slots(dev, case, n):
    """B4 on the edge cases of its staged slot table (chip_smoke.
    edge_sum_group: K = 300 over more than one staging pass, 40 live slots
    stacked on one pixel in one group, P = 40 at every offset): one
    launch, bitwise equal to the plain version."""
    group = chip_smoke.edge_sum_group(case, n, dev, seed=n)
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
    (chip_smoke.edge_field): bitwise equal to the plain version."""
    args = chip_smoke.edge_field(n, dev, seed=n)
    before = sk.scene.launches
    got = sk.scene(*args)
    torch.cuda.synchronize()
    assert sk.scene.launches == before + 1
    assert torch.equal(_bits(got), _bits(sk.scene_reference(*args)))


def _field_at(obs, n, dev, seed):
    """scene inputs at frame size obs: kinds 0-5, 2.5 and 200 (a fraction
    and a kind beyond int8), the entries of chip_smoke.random_field plus
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
    groups = [chip_smoke.random_group(g, n, dev, 6, 8, 300, obs)]
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
    group = chip_smoke.random_group(g, 33, dev, 6, 8, 300, obs)
    for a, b in zip(stk.stamps(*group, obs),
                    stk.stamps_reference(*group, obs)):
        assert torch.equal(_bits(a), _bits(b))
    big = chip_smoke.random_group(g, 33, dev, 3, 40, 7, obs)
    for a, b in zip(stk.stamps(*big, obs), stk.stamps_reference(*big, obs)):
        assert torch.equal(_bits(a), _bits(b))
    args = _field_at(obs, 33, dev, obs + 1)
    assert torch.equal(_bits(sk.scene(*args)),
                       _bits(sk.scene_reference(*args)))


def test_sum_and_field_kernels_reject_shapes_they_do_not_take(dev):
    """B4 and B5 move frame rows 8 bf16 at a time: an obs that is not a
    multiple of 8, and (B5) an X or tile bank off a 16-byte boundary,
    raise ValueError; nothing is launched or sent to the plain version."""
    group = chip_smoke.random_sum_groups(8, dev, 5)[0]
    before = stk.stamps.launches
    for obs in (60, 4, 65):
        with pytest.raises(ValueError):
            stk.stamps(*group, obs)
    assert stk.stamps.launches == before
    X, p, theme, tb, kinds, themes, groups, obs = chip_smoke.random_field(
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


def test_off_kernel_stamp_groups_on_card(dev):
    """Chaser's (P, K) through stamps_from_pixel_bank and composite_stamps
    on the card: no kernel launched, bitwise equal to the CPU
    (chip_smoke.off_kernel_groups raises otherwise)."""
    chip_smoke.off_kernel_groups(64, dev)


@pytest.mark.parametrize("n,seed", [(1, 0), (257, 1), (4096, 2)])
def test_field_scene_kernel_matches_plain(dev, n, seed):
    """B5 on random scenes (chip_smoke.random_field: 5 tile entries, two
    themed; joint phases out of range at both ends; two stamp groups)."""
    args = chip_smoke.random_field(n, dev, seed)
    before = sk.scene.launches
    got = sk.scene(*args)
    torch.cuda.synchronize()
    assert sk.scene.launches == before + 1
    assert torch.equal(_bits(got), _bits(sk.scene_reference(*args)))


def test_field_scene_kernel_edge_cases(dev):
    """No stamp groups; joint phases past either end read the end
    phases."""
    X, p, theme, tb, kinds, themes, groups, obs = chip_smoke.random_field(
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
    X, p, theme, tb, kinds, themes, groups, obs = chip_smoke.random_field(
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
    the coin, a saw and lava so that auto-reset fires on the card."""
    n = 16
    out = {}
    for d in ("cpu", "cuda"):
        env = pt.make("coinrun", device=d)
        bank = env.generate_bank(R.key(5, env.device), n)
        state, ts = env.reset(bank, R.key(6, env.device), n)
        gs, lanes = chip_smoke.place_on_hazards(state.game, n)
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
        gs, _ = chip_smoke.place_boss_deaths(state.game)
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
        gs, lanes = chip_smoke.place_climber_lanes(state.game, n)
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
        gs, lanes = chip_smoke.place_caveflyer_lanes(state.game, n)
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
        gs, lanes = chip_smoke.place_jumper_lanes(state.game, n)
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
    launches of the four kernel wrappers)."""
    wrappers = (sk.scene_raw, sk.scene, stk.composite, stk.stamps)
    for w in wrappers:
        w.launches = 0
    env = pt.make(game, device=dev_name, **cfg)
    bank = env.generate_bank(R.key(5, env.device), n)
    state, ts = env.reset(bank, R.key(6, env.device), n)
    gs, lanes = place(state.game, env)
    state = dataclasses.replace(state, game=gs)
    g = torch.Generator().manual_seed(0)
    actions = chip_smoke.hold_first_action(torch.randint(
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
        return chip_smoke.place_chaser_lanes(gs)

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
        return chip_smoke.place_maze_lanes(gs, env.cfg)

    cpu, gpu = (_kind_field_run("maze", d, 16, 4, place, mode=mode)
                for d in ("cpu", "cuda"))
    _same_runs(cpu, gpu)
    (reward0, done0), state0 = gpu[2][0], gpu[1][0]
    assert done0[gpu[4]].all() and reward0[gpu[4]].tolist() == [10.0, 0.0]
    assert state0.game.t[gpu[4]].tolist() == [0, 0]


def test_chaser_and_maze_launch_no_kernel(dev):
    """Neither game's main path reaches a TPU kernel in the JAX package,
    so neither launches one here: no scene, stamp or stamp-sum kernel on
    the card over reset and 4 steps (chaser's stamp group is off the
    kernel path, `compositor.stamp_kernel_ok`)."""
    runs = [_kind_field_run("chaser", "cuda", 64, 4,
                            lambda gs, env: chip_smoke.place_chaser_lanes(gs)),
            _kind_field_run("maze", "cuda", 64, 4,
                            lambda gs, env: chip_smoke.place_maze_lanes(
                                gs, env.cfg), mode="easy")]
    for r in runs:
        assert r[5] == [0, 0, 0, 0]


# ---------------------------------------------------------------------------
# The exact renders: scene_phases=0 through B3, and Environment.render
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("game", sorted(chip_smoke.EXACT_GAMES))
def test_exact_render_on_card_matches_cpu(dev, game):
    """make(game, scene_phases=0) on the card against the CPU: bank,
    states, rewards and every obs pixel over reset and 4 steps of 16
    envs; the card launches B3 once per kernel-path stamp group per
    render and no other kernel."""
    per_render = chip_smoke.EXACT_GAMES[game][3]

    def place(gs, env):
        return gs, []

    cpu, gpu = (_kind_field_run(game, d, 16, 4, place, scene_phases=0)
                for d in ("cpu", "cuda"))
    _same_runs(cpu, gpu)
    assert gpu[5] == [0, 0, per_render * 5, 0]  # reset + 4 steps


@pytest.mark.parametrize("game", sorted(chip_smoke.EXACT_GAMES))
def test_stamp_kernel_on_exact_inputs(dev, game):
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
    calls = chip_smoke.exact_render_calls(env.game, env.cfg, state.game)
    assert len(calls) == chip_smoke.EXACT_GAMES[game][3]
    for img, groups in calls:
        got = stk.composite(img, groups)
        want = stk.composite_reference(img, groups)
        assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("game", pt.GAMES)
def test_window_render_on_card_matches_cpu(dev, game):
    """Environment.render(state, 512, env_index) on the card for env 0
    and 1: no kernel launched, bitwise equal to the CPU's render of the
    same state."""
    chip_smoke.window_render_check(game, dev, n=4, steps=4)
