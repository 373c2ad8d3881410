"""The plain torch versions of the stamp kernels
(procgen2_tpu_torch/render/stamp_kernel.py) against the JAX package's
Pallas kernels run in interpret mode, bitwise, and the port's stamp
dispatch (procgen2_tpu_torch/render/compositor.py) against the JAX
package's:
  * B3, `composite_reference` against `stamp_kernel.composite_tpu`:
    bossfight's four stamp-group shapes and a random case with
    out-of-range variants, scale 0, fractional scales, stamps off every
    edge and overlapping stamps. Also: one call over several groups equals
    one call per group in order, and `compositor.composite_stamps` equals
    the JAX function on its kernel path;
  * B4, `stamps_reference` against `stamp_kernel.stamps_tpu`, at every
    patch size of tests/test_stamp_kernel.py, with the same kinds of
    random groups, and on the edge cases of the kernels' staged slot
    tables (more than 256 slots among them);
  * the dispatch: `compositor.stamp_kernel_ok` equals the JAX package's
    `_stamp_kernel_ok` as it evaluates on the TPU; off the kernel path,
    `stamps_from_pixel_bank` and `composite_stamps` equal the JAX
    functions' matmul path on the CPU, and on it, the JAX functions with
    the Pallas kernels in interpret mode.

The CUDA kernel itself cannot run here; tests/test_torch_cuda.py and
chip_smoke.py hold it against this plain version on the card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kernel_inputs
from procgen2_tpu.render import compositor as jC
from procgen2_tpu.render import stamp_kernel as jsk
from procgen2_tpu_torch.games import bossfight as tboss
from procgen2_tpu_torch.render import compositor as tC
from procgen2_tpu_torch.render import stamp_kernel as tsk
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

OBS, N = 64, 8
BOSS_GROUPS = ("barbb", "bosshield", "dmg", "abship")  # in painter order
shapes = kernel_inputs.bossfight_group_shapes  # (V, P, K) of each


def _bf16(a):
    """numpy -> torch bf16 (the values rounded to bf16)."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16)


def _to_jax(t):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    return jnp.asarray(t.numpy())


def random_img(rng):
    """A non-negative frame (the kernels' frames are backgrounds in
    [0, 255]; a -0.0 would come out of the TPU kernel's window as +0.0)."""
    return _bf16(rng.uniform(0, 255, (N, 3, OBS, OBS)))


def random_group(rng, V, P, K):
    """Premultiplied bank; var in [-1, V]; scales 0, 1, 0.5, 0.3 and random
    fractions; r0/c0 in [-P - 2, OBS + 2]; slot 1 overlaps slot 0."""
    a = rng.random((V, 1, P, P))
    bank = _bf16(np.concatenate([rng.random((V, 3, P, P)) * 255 * a, a], 1))
    var = rng.integers(-1, V + 1, (N, K)).astype(np.int32)
    scale = np.where(rng.random((N, K)) < 0.5,
                     rng.choice(np.float32([0, 1, 1, 0.5, 0.3]), (N, K)),
                     rng.random((N, K))).astype(np.float32)
    r0 = rng.integers(-P - 2, OBS + 3, (N, K)).astype(np.int32)
    c0 = rng.integers(-P - 2, OBS + 3, (N, K)).astype(np.int32)
    if K > 1:
        r0[:, 1], c0[:, 1] = r0[:, 0] + 2, c0[:, 0] + 2
    # pinned corners: every edge crossed, and stamps just off the frame
    r0[0, 0], c0[0, 0] = -P + 1, -P + 1
    r0[1, 0], c0[1, 0] = OBS - 1, OBS - 1
    r0[2, 0], c0[2, 0] = -P, OBS
    r0[3, 0], c0[3, 0] = -1, OBS - P
    var[:4, 0], scale[:4, 0] = 0, 1.0
    return (bank, torch.from_numpy(var), torch.from_numpy(scale),
            torch.from_numpy(r0), torch.from_numpy(c0))


def pallas(img, group):
    bank, var, scale, r0, c0 = (_to_jax(t) for t in group)
    return jsk.composite_tpu(_to_jax(img), bank, var, scale, r0, c0, OBS,
                             interpret=True)


def bits(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy().view(np.int32)
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("g", range(len(BOSS_GROUPS)), ids=BOSS_GROUPS)
def test_reference_matches_pallas_interpret(g):
    rng = np.random.default_rng(10 + g)
    img = random_img(rng)
    group = random_group(rng, *shapes()[g])
    want = pallas(img, group)
    got = tsk.composite_reference(img, [group])
    assert got.dtype == torch.bfloat16 and got.shape == (N, 3, OBS, OBS)
    np.testing.assert_array_equal(bits(want), bits(got))


def test_reference_matches_pallas_random_case():
    """A bank and slot count of no game: V=5, P=12, K=9."""
    rng = np.random.default_rng(3)
    img = random_img(rng)
    group = random_group(rng, 5, 12, 9)
    np.testing.assert_array_equal(bits(pallas(img, group)),
                                  bits(tsk.composite_reference(img, [group])))


def test_multi_group_call_equals_calls_in_order():
    """One call over bossfight's four groups equals one Pallas call per
    group in painter order, and one plain call per group."""
    rng = np.random.default_rng(4)
    img = random_img(rng)
    groups = [random_group(rng, *s) for s in shapes()]
    got = tsk.composite(img, groups)
    want, seq = _to_jax(img), img
    for group in groups:
        want = pallas(torch.from_numpy(np.asarray(want, np.float32)).to(
            torch.bfloat16), group)
        seq = tsk.composite(seq, [group])
    np.testing.assert_array_equal(bits(want), bits(got))
    assert torch.equal(got.view(torch.int16), seq.view(torch.int16))


def test_composite_stamps_matches_jax(monkeypatch):
    """compositor.composite_stamps (bank premultiplied once, alives and
    alpha folded into the slot scale) against the JAX function on its TPU
    kernel path."""
    orig = jsk.composite_tpu
    monkeypatch.setattr(jC, "_use_stamp_kernel", lambda: True)
    monkeypatch.setattr(jsk, "composite_tpu",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    rng = np.random.default_rng(5)
    img = random_img(rng)
    pbank = tboss._stamp_banks()["abship"]  # u8 [12, 4, 8, 8]
    V, K = pbank.shape[0], tboss.AB_CULL + 1
    var = rng.integers(0, V, (N, K)).astype(np.int32)
    r0 = rng.integers(-10, 70, (N, K)).astype(np.int32)
    c0 = rng.integers(-10, 70, (N, K)).astype(np.int32)
    alives = rng.random((N, K)) < 0.6
    alpha = rng.choice(np.float32([1.0, 0.7]), (N, K))
    want = jC.composite_stamps(_to_jax(img), pbank, jnp.asarray(var),
                               jnp.asarray(r0), jnp.asarray(c0),
                               alives=jnp.asarray(alives),
                               alpha=jnp.asarray(alpha))
    got = tC.composite_stamps(img, tC._premultiply_bank(pbank),
                              torch.from_numpy(var), torch.from_numpy(r0),
                              torch.from_numpy(c0),
                              alives=torch.from_numpy(alives),
                              alpha=torch.from_numpy(alpha))
    np.testing.assert_array_equal(bits(want), bits(got))


def test_cpu_tensors_take_the_plain_path():
    rng = np.random.default_rng(6)
    img = random_img(rng)
    groups = [random_group(rng, *s) for s in shapes()]
    before = tsk.composite.launches
    got = tsk.composite(img, groups)
    assert torch.equal(got.view(torch.int16),
                       tsk.composite_reference(img, groups).view(torch.int16))
    assert tsk.composite.launches == before  # only kernel launches count


def test_other_devices_raise():
    rng = np.random.default_rng(7)
    img = random_img(rng).to("meta")
    group = tuple(t.to("meta") for t in random_group(rng, *shapes()[0]))
    with pytest.raises(ValueError):
        tsk.composite(img, [group])


def pallas_stamps(group):
    bank, var, scale, r0, c0 = (_to_jax(t) for t in group)
    return jsk.stamps_tpu(bank, var, scale, r0, c0, OBS, interpret=True)


@pytest.mark.parametrize("P", [8, 12, 20, 28, 40])
def test_stamps_reference_matches_pallas_interpret(P):
    """B4's plain version against the Pallas stamp-sum kernel, bitwise.
    Every P here has its aligned row window inside the frame
    (jsk._win(P) <= 64), where the Pallas kernel is defined."""
    assert jsk._win(P) <= OBS
    rng = np.random.default_rng(20 + P)
    group = random_group(rng, 4, P, 6)
    want_rgb, want_a = pallas_stamps(group)
    got_rgb, got_a = tsk.stamps_reference(*group, OBS)
    assert got_rgb.dtype == torch.bfloat16 and got_rgb.shape == (N, 3, OBS, OBS)
    assert got_a.shape == (N, 1, OBS, OBS)
    np.testing.assert_array_equal(bits(want_rgb), bits(got_rgb))
    np.testing.assert_array_equal(bits(want_a), bits(got_a))


def test_stamps_reference_on_climber_group_matches_pallas():
    """Climber's merged crystal/mob/agent group (V=37, P=8, K=35) with
    many stamps on the frame at once."""
    from procgen2_tpu_torch.games import climber as tclimb

    rng = np.random.default_rng(9)
    bank = tC._premultiply_bank(tclimb._merged_bank())
    V, K = bank.shape[0], tclimb.MAX_POINTS + tclimb.MAX_MOBS + 1
    group = (bank, torch.from_numpy(rng.integers(-1, V + 1, (N, K)).astype(np.int32)),
             torch.from_numpy((rng.random((N, K)) < 0.7).astype(np.float32)),
             torch.from_numpy(rng.integers(-8, 66, (N, K)).astype(np.int32)),
             torch.from_numpy(rng.integers(-8, 66, (N, K)).astype(np.int32)))
    want_rgb, want_a = pallas_stamps(group)
    got_rgb, got_a = tsk.stamps_reference(*group, OBS)
    np.testing.assert_array_equal(bits(want_rgb), bits(got_rgb))
    np.testing.assert_array_equal(bits(want_a), bits(got_a))


def _jax_kernels_in_interpret_mode(monkeypatch):
    """The JAX compositor on its TPU kernel path, with the Pallas kernels
    run in interpret mode."""
    monkeypatch.setattr(jC, "_use_stamp_kernel", lambda: True)
    for name in ("composite_tpu", "stamps_tpu"):
        orig = getattr(jsk, name)
        monkeypatch.setattr(
            jsk, name,
            lambda *a, _orig=orig, **k: _orig(*a, **{**k, "interpret": True}))


def _pixel_bank_case(rng, P, K, V=5):
    """A u8 bank [V, 4, P, P] with alpha > 0 everywhere, and var in
    [-1, V], r0/c0 in [-P - 2, OBS + 2], alives and alphas 1 and 0.7 for N
    envs; slot 1 overlaps slot 0."""
    pbank = rng.integers(0, 256, (V, 4, P, P)).astype(np.uint8)
    pbank[:, 3] = rng.integers(64, 256, (V, P, P))
    var = rng.integers(-1, V + 1, (N, K)).astype(np.int32)
    r0 = rng.integers(-P - 2, OBS + 3, (N, K)).astype(np.int32)
    c0 = rng.integers(-P - 2, OBS + 3, (N, K)).astype(np.int32)
    r0[:, 1], c0[:, 1] = r0[:, 0] + 2, c0[:, 0] + 2  # overlaps
    alives = rng.random((N, K)) < 0.7
    alpha = rng.choice(np.float32([1.0, 0.7]), (N, K))
    return pbank, var, r0, c0, alives, alpha


def _both_stamps(pbank, var, r0, c0, alives, alpha):
    """stamps_from_pixel_bank of the JAX package and of the port."""
    want = jC.stamps_from_pixel_bank(
        jnp.asarray(pbank), jnp.asarray(var), jnp.asarray(r0),
        jnp.asarray(c0), alives=jnp.asarray(alives), alpha=jnp.asarray(alpha))
    got = tC.stamps_from_pixel_bank(
        tC._premultiply_bank(pbank), torch.from_numpy(var),
        torch.from_numpy(r0), torch.from_numpy(c0),
        alives=torch.from_numpy(alives), alpha=torch.from_numpy(alpha))
    return want, got


@pytest.mark.parametrize("P", [8, 12, 20])
def test_stamps_from_pixel_bank_matches_jax(P, monkeypatch):
    """compositor.stamps_from_pixel_bank (premultiplied bank, alives and
    alpha folded in) against the JAX function, bitwise. K = 7: P = 8 is
    off the kernel path (K * P < 96), compared with the JAX function on
    the CPU (its matmul path); P = 12 and 20 are on it, compared with the
    JAX function on its TPU kernel path, the Pallas kernel in interpret
    mode."""
    K = 7
    assert tC.stamp_kernel_ok(P, K) == (P != 8)
    if tC.stamp_kernel_ok(P, K):
        _jax_kernels_in_interpret_mode(monkeypatch)
    rng = np.random.default_rng(30 + P)
    (want_rgb, want_a), (got_rgb, got_a) = _both_stamps(
        *_pixel_bank_case(rng, P, K))
    assert (got_a.float() != 0).any()
    np.testing.assert_array_equal(bits(want_rgb), bits(got_rgb))
    np.testing.assert_array_equal(bits(want_a), bits(got_a))


def test_stamp_dispatch_matches_jax(monkeypatch):
    """compositor.stamp_kernel_ok equals the JAX package's
    _stamp_kernel_ok on the TPU (_use_stamp_kernel true) for P in 1..48
    and K in 1..300; both paths occur at every P up to 11."""
    monkeypatch.setattr(jC, "_use_stamp_kernel", lambda: True)
    for P in range(1, 49):
        got = [tC.stamp_kernel_ok(P, K) for K in range(1, 301)]
        assert got == [jC._stamp_kernel_ok(P, K) for K in range(1, 301)], P
        if P < 12:
            assert any(got) and not all(got), P


OFF_KERNEL = ((8, 6), (7, 6), (6, 6))  # chaser's stamp group per mode


@pytest.mark.parametrize("P,K", OFF_KERNEL)
def test_off_kernel_groups_match_jax(P, K):
    """Off the kernel path (chaser's (P, K)), stamps_from_pixel_bank and
    composite_stamps bitwise equal to the JAX functions on the CPU (their
    matmul path: f32 sums of the bf16 stamps rounded once, one blend),
    with stamps overlapping within a 6-pixel square and alphas 1, 0.7 and
    0.3."""
    assert not tC.stamp_kernel_ok(P, K)
    rng = np.random.default_rng(40 + P)
    pbank, var, r0, c0, alives, _ = _pixel_bank_case(rng, P, K)
    r0 = (r0[:, :1] + rng.integers(0, 6, (N, K))).astype(np.int32)
    c0 = (c0[:, :1] + rng.integers(0, 6, (N, K))).astype(np.int32)
    r0[:2, 0], c0[:2, 0] = 30, 30  # two envs with a stack on the frame
    alpha = rng.choice(np.float32([1.0, 0.7, 0.3]), (N, K))
    (want_rgb, want_a), (got_rgb, got_a) = _both_stamps(
        pbank, var, r0, c0, alives, alpha)
    assert (got_a.float() != 0).any()
    np.testing.assert_array_equal(bits(want_rgb), bits(got_rgb))
    np.testing.assert_array_equal(bits(want_a), bits(got_a))
    img = random_img(rng)
    want = jC.composite_stamps(_to_jax(img), pbank, jnp.asarray(var),
                               jnp.asarray(r0), jnp.asarray(c0),
                               alives=jnp.asarray(alives),
                               alpha=jnp.asarray(alpha))
    got = tC.composite_stamps(img, tC._premultiply_bank(pbank),
                              torch.from_numpy(var), torch.from_numpy(r0),
                              torch.from_numpy(c0),
                              alives=torch.from_numpy(alives),
                              alpha=torch.from_numpy(alpha))
    np.testing.assert_array_equal(bits(want), bits(got))
    assert not torch.equal(got, img)


def test_off_kernel_groups_launch_nothing(monkeypatch):
    """Off the kernel path the stamp functions are plain torch ops: the
    stamp kernels' wrappers are not called."""
    rng = np.random.default_rng(13)
    pbank, var, r0, c0, alives, alpha = _pixel_bank_case(rng, 8, 6)
    calls = []
    monkeypatch.setattr(tsk, "stamps", lambda *a: calls.append("stamps"))
    monkeypatch.setattr(tsk, "composite",
                        lambda *a: calls.append("composite"))
    args = (tC._premultiply_bank(pbank), torch.from_numpy(var),
            torch.from_numpy(r0), torch.from_numpy(c0))
    tC.stamps_from_pixel_bank(*args)
    tC.composite_stamps(random_img(rng), *args)
    assert calls == []


def test_stamps_cpu_tensors_take_the_plain_path():
    rng = np.random.default_rng(11)
    group = random_group(rng, 4, 12, 5)
    before = tsk.stamps.launches
    got = tsk.stamps(*group, OBS)
    want = tsk.stamps_reference(*group, OBS)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int16), w.view(torch.int16))
    assert tsk.stamps.launches == before  # only kernel launches count


def test_stamps_other_devices_raise():
    rng = np.random.default_rng(12)
    group = tuple(t.to("meta") for t in random_group(rng, 4, 8, 3))
    with pytest.raises(ValueError):
        tsk.stamps(*group, OBS)


def _pallas_groups(img, groups):
    """The Pallas kernel (interpret mode) once per group, in order."""
    out = img
    for group in groups:
        out = torch.from_numpy(np.asarray(pallas(out, group), np.float32)).to(
            torch.bfloat16)
    return out


@pytest.mark.parametrize("case", kernel_inputs.EDGE_CASES)
def test_reference_matches_pallas_on_edge_slots(case):
    """The card tests' yardstick on the edge cases of B3's staged slot
    tables (kernel_inputs.edge_groups: K = 300, 40 live slots stacked on one
    pixel between dead ones, P = 40 at every offset), at 4 envs: the plain
    version bitwise equal to the Pallas kernel, one group after another."""
    img, groups = kernel_inputs.edge_stamps(case, 4, "cpu", seed=3)
    want = _pallas_groups(img, groups)
    got = tsk.composite_reference(img, groups)
    np.testing.assert_array_equal(bits(want), bits(got))
    assert not torch.equal(got, img)  # the stamps drew something


@pytest.mark.parametrize("case", kernel_inputs.EDGE_CASES)
def test_stamps_reference_matches_pallas_on_edge_slots(case):
    """The card tests' yardstick for B4 on the edge cases of its staged
    slot table (kernel_inputs.edge_sum_group: K = 300, 40 live slots stacked
    on one pixel in one group between dead ones, P = 40 at every offset),
    at 4 envs: the plain version bitwise equal to the Pallas kernel."""
    group = kernel_inputs.edge_sum_group(case, 4, "cpu", seed=7)
    want_rgb, want_a = pallas_stamps(group)
    got_rgb, got_a = tsk.stamps_reference(*group, OBS)
    np.testing.assert_array_equal(bits(want_rgb), bits(got_rgb))
    np.testing.assert_array_equal(bits(want_a), bits(got_a))
    assert got_a.any()  # the stamps summed something


def _live_cover(group, r, c, obs=OBS):
    """bool [N, K]: slot k of env n is live and covers pixel (r, c)."""
    bank, var, scale, r0, c0 = group
    V, P = bank.shape[0], bank.shape[-1]
    r0 = r0.long().clamp(-P, obs)
    c0 = c0.long().clamp(-P, obs)
    return ((scale != 0) & (var >= 0) & (var < V) & (r0 <= r) & (r < r0 + P)
            & (c0 <= c) & (c < c0 + P))


def test_edge_groups_reach_the_staging_edges():
    """What each edge case promises: K = 300 with live slots stacked across
    the 256-slot pass boundary; 40 live slots on pixel (29, 35) with only
    dead slots between them; P = 40 slots at every row and column offset
    from -P-1 to obs+1 in every env."""
    n = 4
    (k300,) = kernel_inputs.edge_groups("k300", n, "cpu")
    assert k300[1].shape == (n, 300)
    stack = k300[2][:, 250:262] != 0
    assert stack.all() and (k300[1][:, 250:262] >= 0).all()
    assert _live_cover(k300, 23, 33)[:, 250:262].sum(1).min() >= 2

    stacked = kernel_inputs.edge_groups("stacked", n, "cpu")
    live = torch.cat([_live_cover(g, 29, 35) for g in stacked], dim=1)
    assert (live.sum(1) == 40).all()
    for g in stacked:
        cover = _live_cover(g, 29, 35)
        assert cover[:, 0::2].all() and not cover[:, 1::2].any()
        # no odd slot is live anywhere in the frame
        any_pixel = torch.zeros_like(cover[:, 1::2])
        for r in range(0, OBS, 4):
            for c in range(0, OBS, 4):
                any_pixel |= _live_cover(g, r, c)[:, 1::2]
        assert not any_pixel.any()

    (p40,) = kernel_inputs.edge_groups("p40", n, "cpu")
    bank, var, scale, r0, c0 = p40
    assert bank.shape[-1] == 40
    offsets = set(range(-41, OBS + 2))
    for e in range(n):
        assert set(r0[e].tolist()) == offsets
        assert set(c0[e].tolist()) == offsets
    assert (scale != 0).all()


def test_edge_sum_groups_reach_the_staging_edges():
    """B4's edge groups keep their promises in one group: K = 300 with
    live slots across the 256-slot pass boundary; 40 live slots on pixel
    (29, 35), the odd slots between them dead everywhere; P = 40 at every
    offset."""
    n = 4
    k300 = kernel_inputs.edge_sum_group("k300", n, "cpu")
    assert k300[1].shape == (n, 300)
    assert _live_cover(k300, 23, 33)[:, 250:262].all()  # across slot 256

    stacked = kernel_inputs.edge_sum_group("stacked", n, "cpu")
    assert stacked[1].shape == (n, 80)
    cover = _live_cover(stacked, 29, 35)
    assert (cover.sum(1) == 40).all()
    assert cover[:, 0::2].all() and not cover[:, 1::2].any()
    any_pixel = torch.zeros_like(cover[:, 1::2])
    for r in range(0, OBS, 4):
        for c in range(0, OBS, 4):
            any_pixel |= _live_cover(stacked, r, c)[:, 1::2]
    assert not any_pixel.any()

    p40 = kernel_inputs.edge_sum_group("p40", n, "cpu")
    assert p40[0].shape[-1] == 40 and (p40[2] != 0).all()
    for e in range(n):
        assert set(p40[3][e].tolist()) == set(range(-41, OBS + 2))
        assert set(p40[4][e].tolist()) == set(range(-41, OBS + 2))


def test_check_tiles_takes_rows_of_8_on_16_byte_boundaries():
    """The kernels' wrappers refuse, on the card, an obs that is not a
    multiple of 8 and a tensor that does not start on a 16-byte boundary:
    the kernels read and write frame rows 8 bf16 at a time."""
    x = torch.zeros(64, dtype=torch.bfloat16)
    tsk.check_tiles(64, ("img", x))
    tsk.check_tiles(8)
    for obs in (60, 4, 65):
        with pytest.raises(ValueError):
            tsk.check_tiles(obs)
    with pytest.raises(ValueError):
        tsk.check_tiles(64, ("img", x[1:]))
    tsk.check_tiles(64, ("img", x[8:]))
