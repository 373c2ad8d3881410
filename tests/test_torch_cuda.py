"""Tests of the port that need a CUDA card: the scene kernel and the
stamp kernel against their plain torch versions (bitwise), the kernel
wrappers' checks, threefry words on the card, and coinrun and bossfight on
the card against the same games on the CPU.

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
