"""The benchmark's plain bossfight (`benchmark/reference/games/bossfight.py`)
against the port, on the CPU at bossfight_easy's configuration and 8 envs:
the bank, the reset, every rollout buffer field and the final states bit
for bit over 3 rollouts of T = 8, with two episodes ended in the first
rows (auto-reset) and rings past the render's 36-bullet cull; the cull's
stamp groups and frames on a crafted crowd; a subset of rows against the
whole batch; the reference's banks and cos/sin against the port's; the
B3 work count against a walk over every pixel; and the render's span
`render.stamp_groups` under a profiler only.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import check, spec, traffic
from benchmark.reference import env as ref_env
from benchmark.reference import trig as ref_trig
from benchmark.reference.games import bossfight as ref_bf
from benchmark.roofline import stamp_composite
from procgen2_tpu_torch import trig
from procgen2_tpu_torch.dist import make_vec, rollout
from procgen2_tpu_torch.games import bossfight as bf

import bossfight_lanes as lanes
import game_lanes
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N, LEVELS, CALLS, T = 8, 12, 3, 8
FIELDS = ("obs", "actions", "rewards", "dones", "ep_returns", "ep_lengths")


def _config():
    conf = {c["name"]: c for c in spec.load_spec()["configs"]}
    return json.loads((spec.ROOT / conf["bossfight_easy"]["file"]).read_text())


def _pair(seed):
    """The port's make_vec and the reference at bossfight_easy's config
    with N envs: (venv, state, obs, ref, bank, ref_state, ref_obs)."""
    cfg = _config()
    keys = traffic.Keys(seed, "cpu")
    venv = make_vec(cfg["game"], num_envs=N, num_levels=LEVELS, device="cpu",
                    **cfg["config"])
    state, ts = venv.reset(keys.reset)
    ref = ref_env.Env(cfg["game"], cfg["config"], N, LEVELS, "cpu")
    bank = ref.generate_bank(keys.reset)
    ref_state, ref_obs = ref.reset(bank, keys.reset, torch.arange(N))
    return keys, venv, state, ts.obs, ref, bank, ref_state, ref_obs


def _with_game(state, fn):
    return dataclasses.replace(state, game=fn(state.game))


def test_reference_equals_the_port():
    keys, venv, state, obs, ref, bank, ref_state, ref_obs = _pair(1)
    assert check.tree_differ(venv.bank, bank) == 0
    assert check.tree_differ(state, ref_state) == 0
    assert torch.equal(obs, ref_obs)

    def craft(gs):
        return lanes.crowd(game_lanes.place_boss_deaths(gs)[0], [2, 3])

    state, ref_state = _with_game(state, craft), _with_game(ref_state, craft)
    rows = torch.arange(N)
    dones = []
    for c in range(CALLS):
        state, buf = rollout(venv, state, keys.call(c), T)
        ref_state, ref_buf = ref.rollout(bank, ref_state, keys.call(c), T,
                                         rows)
        for f in FIELDS:
            assert check.differ(getattr(buf, f), getattr(ref_buf, f)) == 0, f
        assert check.tree_differ(state, ref_state) == 0
        dones.append(buf.dones)
    assert dones[0][0, :2].all()  # rows 0 and 1 ended at the first step
    assert int(sum(d.sum() for d in dones)) >= 2  # auto-reset ran


def test_the_cull_drops_the_same_bullets():
    """Every row crowded past the cull: the port's stamp groups, its frame
    and its next step equal the reference's, and each row's boss-bullet
    slots in the group are exactly the cull's 36."""
    _, venv, state, _, ref, bank, ref_state, _ = _pair(3)
    cfg = venv.env.cfg
    gs = lanes.crowd(state.game, torch.arange(N), live=58, exploding=5)
    rgs = lanes.crowd(ref_state.game, torch.arange(N), live=58, exploding=5)
    assert (lanes.drawn_bullets(gs) == 63).all()
    img, groups = bf._stamp_groups(cfg, gs)
    rimg, rgroups = ref_bf._stamp_groups(ref.cfg, rgs)
    assert torch.equal(img, rimg)
    for g, rg in zip(groups, rgroups):
        for x, y in zip(g, rg):
            assert check.differ(x, y) == 0
    barbb = groups[0]
    assert barbb[1].shape == (N, bf.MAX_BARRIERS + bf.BB_CULL)
    assert (barbb[2][:, bf.MAX_BARRIERS:] == 1).all()  # 36 drawn, 27 dropped
    assert torch.equal(bf.observe_batch(cfg, gs),
                       ref_bf.observe_batch(ref.cfg, rgs))
    a = torch.arange(N, dtype=torch.int32) % bf.NUM_ACTIONS
    got = bf.step(cfg, gs, a)
    want = ref_bf.step(ref.cfg, rgs, a)
    assert check.tree_differ(got[0], want[0]) == 0
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


def test_rows_follow_their_whole_batch_trajectory():
    keys = traffic.Keys(77, "cpu")
    cfg = _config()
    ref = ref_env.Env(cfg["game"], cfg["config"], N, LEVELS, "cpu")
    bank = ref.generate_bank(keys.reset)
    whole, _ = ref.reset(bank, keys.reset, torch.arange(N))
    sub = torch.tensor([6, 1, 3])
    part, _ = ref.reset(bank, keys.reset, sub)
    whole = _with_game(whole, lambda gs: lanes.crowd(gs, [1, 6]))
    part = _with_game(part, lambda gs: lanes.crowd(gs, [1, 0]))
    whole, wbuf = ref.rollout(bank, whole, keys.call(1), 4, torch.arange(N))
    part, pbuf = ref.rollout(bank, part, keys.call(1), 4, sub)
    assert check.tree_differ(ref_env.rows_of(whole, sub), part) == 0
    for f in FIELDS:
        assert torch.equal(getattr(wbuf, f)[:, sub], getattr(pbuf, f)), f


def test_the_reference_art_and_trig_equal_the_ports():
    want, got = bf._stamp_banks(), ref_bf._stamp_banks()
    assert sorted(want) == sorted(got)
    for k in want:
        assert np.array_equal(want[k], got[k]), k
    assert np.array_equal(bf._bg_bank(), ref_bf._bg_bank())
    x = torch.cat([torch.linspace(-300.0, 300.0, 20001),
                   torch.tensor([0.0, -0.0, 1e-5, float("inf"), float("nan")])])
    for a, b in zip(trig.sincos32(x), ref_trig.sincos32(x)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_b3_work_counts_each_blend_once():
    """The frozen B3 work count against a walk over every pixel of the
    kernel's blends: live slots (scale != 0, var in the bank) over the
    part of their P x P patch inside the frame, 11 f32 operations each;
    the frame and the groups read once, the frame written once."""
    rng = np.random.default_rng(8)
    n, obs = 2, 64

    def group(V, P, K):
        bank = torch.rand((V, 4, P, P)).to(torch.bfloat16)
        var = torch.from_numpy(rng.integers(-1, V + 1, (n, K))).int()
        scale = torch.from_numpy(rng.choice(np.float32([0, 1, 1, 0.7]),
                                            (n, K)))
        r0 = torch.from_numpy(rng.integers(-P - 2, obs + 3, (n, K))).int()
        c0 = torch.from_numpy(rng.integers(-P - 2, obs + 3, (n, K))).int()
        return bank, var, scale, r0, c0

    groups = [group(56, 8, 40), group(8, 40, 1), group(5, 20, 8),
              group(12, 8, 13)]
    img = torch.zeros((n, 3, obs, obs), dtype=torch.bfloat16)
    blends = 0
    for bank, var, scale, r0, c0 in groups:
        P = bank.shape[-1]
        for e, k in np.ndindex(tuple(var.shape)):
            if scale[e, k] != 0 and 0 <= var[e, k] < bank.shape[0]:
                blends += sum(0 <= int(r0[e, k]) + i < obs
                              and 0 <= int(c0[e, k]) + j < obs
                              for i in range(P) for j in range(P))
    nbytes = 2 * img.numel() * 2 + sum(x.numel() * x.element_size()
                                       for g in groups for x in g)
    assert blends > 0
    assert stamp_composite.work(img, groups) == (nbytes, 11 * blends)


def test_the_stamp_groups_span_only_under_a_profiler(monkeypatch):
    vec = make_vec("bossfight", num_envs=4, num_levels=3, device="cpu",
                   mode="easy")
    state, _ = vec.reset(torch.tensor([0, 5], dtype=torch.int64))
    actions = torch.zeros(4, dtype=torch.int32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        vec.step(state, actions)
    names = [e.name() for e in sorted(prof.profiler.kineto_results.events(),
                                      key=lambda e: e.start_ns())
             if e.name().startswith(("env.", "render."))]
    assert names == ["env.game_step", "env.auto_reset", "env.render",
                     "render.stamp_groups"]

    def refuse(*args, **kwargs):
        raise AssertionError("a range was entered with no profiler")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    vec.step(state, actions)
