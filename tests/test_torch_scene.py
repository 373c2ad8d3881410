"""The plain torch versions of the scene kernels
(procgen2_tpu_torch/render/scene_kernel.py) against the JAX package, all
bitwise:
  * B1, `scene_raw_reference`: against the Pallas kernel
    `scene_tpu_raw` run in interpret mode on random inputs, and against
    coinrun's CPU scene path on real levels;
  * B5, `scene_reference`: against the Pallas kernel `scene_tpu` run in
    interpret mode and against the JAX package's `scene_reference` on
    random expanded fields shaped like tests/test_scene_kernel.py's, and
    its joint phase clamped into the tile bank; against `scene_tpu` on a
    kind field of fractions, -0.0, negative kinds, kinds beyond int8,
    infinities and NaN (kernel_inputs.edge_field).

The CUDA kernel itself cannot run here; tests/test_torch_cuda.py and
chip_smoke.py hold it against this plain version on the card."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmark.roofline import scene_raw
import kernel_inputs
from procgen2_tpu.games import coinrun as jcoin
from procgen2_tpu.render import phases as jphases
from procgen2_tpu.render import scene_kernel as jsk
from procgen2_tpu_torch.games import coinrun as tcoin
from procgen2_tpu_torch.render import scene_kernel as tsk
from procgen2_tpu_torch.utils import convert
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

OBS, QP = 64, 4


def _bf16(a):
    """numpy f32 -> (the same values rounded to bf16, as torch bf16)."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16)


def _random_raw(seed, N=4, GP=40, pad=8):
    rng = np.random.default_rng(seed)
    kinds, themes = (1, 2, 3, 4, 5), (-1, -1, 0, 1, -1)
    TR, _, _ = jphases.phase_tables(jcoin.PPU, OBS, QP)
    i32 = lambda a: np.asarray(a, np.int32)  # noqa: E731
    gridp = rng.integers(0, 6, (N, GP, GP)).astype(np.int8)
    # window origins reaching past both edges of the padded grid
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


def _to_jax(x):
    if isinstance(x, torch.Tensor):
        return jnp.asarray(x.float().numpy(), jnp.bfloat16)
    return jnp.asarray(x)


def _to_torch(x):
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(x)


@pytest.mark.parametrize("seed", [0, 1])
def test_reference_matches_pallas_interpret(seed):
    args = _random_raw(seed)
    (gridp, ty0, tx0, jy, jx, bg_i, theme, bg_bank, tr_tab, tile_bank,
     kinds, themes, groups, obs, qp, pad) = args
    want = jsk.scene_tpu_raw(
        *(_to_jax(a) for a in (gridp, ty0, tx0, jy, jx, bg_i, theme,
                               bg_bank, tr_tab, tile_bank)),
        kinds, themes, [tuple(_to_jax(x) for x in g) for g in groups],
        obs, qp, pad, interpret=True)
    got = tsk.scene_raw(
        *(_to_torch(a) for a in (gridp, ty0, tx0, jy, jx, bg_i, theme,
                                 bg_bank, tr_tab, tile_bank)),
        kinds, themes, [tuple(_to_torch(x) for x in g) for g in groups],
        obs, qp, pad)
    assert got.dtype == torch.bfloat16 and got.shape == (4, 3, OBS, OBS)
    np.testing.assert_array_equal(
        np.asarray(want, np.float32).view(np.int32),
        got.float().numpy().view(np.int32))


def test_cpu_tensors_take_the_plain_path():
    args = _random_raw(2, N=2)
    targs = [_to_torch(a) if isinstance(a, np.ndarray) else a
             for a in args[:10]]
    groups = [tuple(_to_torch(x) for x in g) for g in args[12]]
    before = tsk.scene_raw.launches
    got = tsk.scene_raw(*targs, args[10], args[11], groups, *args[13:])
    want = tsk.scene_raw_reference(*targs, args[10], args[11], groups,
                                   *args[13:])
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert tsk.scene_raw.launches == before  # only kernel launches count


def test_other_devices_raise():
    args = _random_raw(3, N=1)
    targs = [_to_torch(a).to("meta") if isinstance(a, np.ndarray)
             else a.to("meta") for a in args[:10]]
    with pytest.raises(ValueError):
        tsk.scene_raw(*targs, args[10], args[11], [], *args[13:])


def test_chip_smoke_scene_work_counts_each_read_once():
    """chip_smoke.py's bound of the scene kernel (`scene_work`, the
    benchmark's roofline/scene_raw.work) counts the elements the kernel
    reads, each once, and the blends it does, as a walk over every pixel
    of the kernel's reads (csrc/scene_kernel.cu) finds them."""
    args = _random_raw(4, N=2)
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
    # the windows read a small part of the padded grid
    assert len(cells) < gridp.size // 2


@pytest.fixture(scope="module")
def jax_bank():
    gen = jax.jit(jax.vmap(functools.partial(jcoin.generate, jcoin.Config())))
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(7), i))(
        jnp.arange(8, dtype=jnp.uint32))
    return jax.tree.map(np.asarray, gen(keys))


def _random_states(bank, seed):
    """Game states on the bank's levels with the agent, mobs, poses and
    animation frames spread over the whole level."""
    rng = np.random.default_rng(seed)
    n = bank.grid.shape[0]
    f32 = np.float32
    mob_pos = bank.mob_pos0.copy()
    mob_pos[..., 0] += rng.uniform(-0.4, 0.4, mob_pos.shape[:2])
    return jcoin.State(
        level=bank,
        pos=np.stack([rng.uniform(1.0, 63.0, n), rng.uniform(1.5, 63.0, n)],
                     -1).astype(f32),
        vel=rng.choice(f32([0.0, 0.005, -0.3, 0.3]), (n, 2)),
        on_ground=rng.random(n) < 0.5,
        face_forward=rng.random(n) < 0.5,
        anim_t=rng.random(n).astype(f32),
        mob_pos=mob_pos.astype(f32),
        mob_vx=rng.choice(f32([-0.15, 0.15]), mob_pos.shape[:2]),
        t=rng.integers(0, 20, n).astype(np.int32),
        rng=np.zeros((n, 2), np.uint32),
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coinrun_scene_matches_jax(jax_bank, seed):
    """The port's coinrun scene render (CPU: the plain version) against
    the JAX package's CPU scene path, which tests/test_scene_kernel.py
    holds bitwise equal to the Pallas kernel."""
    st = _random_states(jax_bank, seed)
    jst = jax.tree.map(jnp.asarray,
                       st.replace(rng=jax.random.wrap_key_data(st.rng)))
    cfg = jcoin.Config()
    want = np.asarray(jax.jit(functools.partial(jcoin._observe_scene, cfg))(jst))
    got = tcoin._observe_scene(tcoin.Config(),
                               convert.state(tcoin, st, "cpu"))
    assert got.dtype == torch.uint8 and got.shape == (8, 3, OBS, OBS)
    np.testing.assert_array_equal(want, got.numpy())


def _random_field(seed, N=8, ne=5, fractional=True):
    """Random inputs of `scene`, shaped like tests/test_scene_kernel.py::
    _random_scene: 5 tile entries (two themed), a kind field with values
    0..5, a background of whole values, two stamp groups with variants
    out of range and stamps off every edge. `fractional`: slot scales
    include 0.5 and 0.3 (else 0 or 1)."""
    rng = np.random.default_rng(seed)
    i32 = lambda a: np.asarray(a, np.int32)  # noqa: E731
    kinds, themes = tuple(range(1, ne + 1)), (-1, -1, 0, 1, -1)[:ne]
    X = _bf16(np.concatenate([rng.integers(0, ne + 1, (N, 1, OBS, OBS)),
                              rng.integers(0, 256, (N, 3, OBS, OBS))], 1))
    p = i32(rng.integers(0, QP * QP, N))
    theme = i32(rng.integers(0, 2, N))
    tb = _bf16(np.round(rng.random((QP * QP, ne, 4, OBS, OBS)) * 4) / 4)
    scales = np.float32([0, 1, 1, 0.5, 0.3] if fractional else [0, 1, 1])

    def group(V, K, P):
        bank = _bf16(np.round(rng.random((V, 4, P, P)) * 4) / 4)
        return (bank, i32(rng.integers(-1, V + 1, (N, K))),
                rng.choice(scales, (N, K)),
                i32(rng.integers(-P, OBS + 2, (N, K))),
                i32(rng.integers(-P, OBS + 2, (N, K))))

    return X, p, theme, tb, kinds, themes, [group(6, 5, 8), group(4, 2, 12)]


def _field_to(conv, args):
    X, p, theme, tb, kinds, themes, groups = args
    return (conv(X), conv(p), conv(theme), conv(tb), kinds, themes,
            [tuple(conv(x) for x in g) for g in groups])


@pytest.mark.parametrize("seed", [0, 1])
def test_scene_reference_matches_pallas_interpret(seed):
    args = _random_field(seed)
    want = jsk.scene_tpu(*_field_to(_to_jax, args), OBS, interpret=True)
    got = tsk.scene(*_field_to(_to_torch, args), OBS)
    assert got.dtype == torch.bfloat16 and got.shape == (8, 3, OBS, OBS)
    np.testing.assert_array_equal(
        np.asarray(want, np.float32).view(np.int32),
        got.float().numpy().view(np.int32))


def test_scene_reference_matches_jax_reference():
    """Against the JAX package's jnp mirror, whose stamp placement is a
    one-hot einsum (equal to the kernel's for slot scales of 0 or 1)."""
    args = _random_field(2, fractional=False)
    want = jsk.scene_reference(*_field_to(_to_jax, args), OBS)
    got = tsk.scene_reference(*_field_to(_to_torch, args), OBS)
    np.testing.assert_array_equal(
        np.asarray(want, np.float32).view(np.int32),
        got.float().numpy().view(np.int32))


def test_scene_clamps_the_joint_phase():
    """p_joint past the tile bank reads its last phase, as the JAX
    mirror's gather clamps; a negative p_joint reads phase 0."""
    X, p, theme, tb, kinds, themes, groups = _random_field(3, N=4,
                                                          fractional=False)
    NPH = QP * QP
    high = np.int32([NPH, NPH + 5, 1000, NPH - 1])
    args = (X, high, theme, tb, kinds, themes, groups)
    want = jsk.scene_reference(*_field_to(_to_jax, args), OBS)
    got = tsk.scene(*_field_to(_to_torch, args), OBS)
    np.testing.assert_array_equal(
        np.asarray(want, np.float32).view(np.int32),
        got.float().numpy().view(np.int32))
    t = _field_to(_to_torch, (X, np.int32([-1, -7, 0, 0]), theme, tb, kinds,
                              themes, groups))
    zero = tsk.scene(*t[:1], torch.zeros(4, dtype=torch.int32), *t[2:], OBS)
    assert torch.equal(tsk.scene(*t, OBS).view(torch.int16),
                       zero.view(torch.int16))
    # the clamp matters: phase 0 and the last phase render differently
    assert not torch.equal(zero, got)


def test_scene_cpu_tensors_take_the_plain_path():
    t = _field_to(_to_torch, _random_field(4, N=2))
    before = tsk.scene.launches
    got = tsk.scene(*t, OBS)
    assert torch.equal(got.view(torch.int16),
                       tsk.scene_reference(*t, OBS).view(torch.int16))
    assert tsk.scene.launches == before  # only kernel launches count


def test_scene_other_devices_raise():
    t = _field_to(lambda x: _to_torch(x).to("meta"), _random_field(5, N=1))
    with pytest.raises(ValueError):
        tsk.scene(*t, OBS)


def _torch_to_jax(x):
    """A torch tensor as a JAX array of the same dtype (bf16 kept)."""
    if x.dtype == torch.bfloat16:
        return jnp.asarray(x.float().numpy(), jnp.bfloat16)
    return jnp.asarray(x.numpy())


@pytest.mark.parametrize("case", kernel_inputs.EDGE_CASES)
def test_reference_matches_pallas_on_edge_scene(case):
    """The card tests' yardstick on B1's edge cases (kernel_inputs.edge_scene:
    themed and unthemed tile entries for every theme, a negative kind and
    kind 0 outside the grid, with the stamp groups of
    kernel_inputs.edge_groups: K = 300, 40 live slots stacked on one pixel
    between dead ones, P = 40 at every offset), at 4 envs: the plain
    version bitwise equal to the Pallas kernel in interpret mode."""
    args = kernel_inputs.edge_scene(case, 4, "cpu", seed=5)
    (gridp, ty0, tx0, jy, jx, bg_i, theme, bg_bank, tr_tab, tile_bank,
     kinds, themes, groups, obs, qp, pad) = args
    want = jsk.scene_tpu_raw(
        *(_torch_to_jax(a) for a in (gridp, ty0, tx0, jy, jx, bg_i, theme,
                                     bg_bank, tr_tab, tile_bank)),
        kinds, themes, [tuple(_torch_to_jax(x) for x in g) for g in groups],
        obs, qp, pad, interpret=True)
    got = tsk.scene_raw(*args)
    np.testing.assert_array_equal(
        np.asarray(want, np.float32).view(np.int32),
        got.float().numpy().view(np.int32))


def test_edge_entries_cover_every_theme():
    """kernel_inputs.edge_entries: a themed entry of kinds 1 and 2 for every
    theme, unthemed kind 1 after them (two blends in order on one cell),
    and unthemed kinds 3, -5 and 0; every env theme in [-1, 6] occurs
    among 64 envs of edge_scene."""
    kinds, themes = kernel_inputs.edge_entries()
    assert len(kinds) <= tsk._MAX_ENTRIES
    for t in range(kernel_inputs.EDGE_THEMES):
        assert {k for k, th in zip(kinds, themes) if th == t} == {1, 2}
    unthemed = [k for k, th in zip(kinds, themes) if th < 0]
    assert unthemed == [1, 3, -5, 0]
    assert kinds.index(1) < len(kinds) - 4  # themed kind 1 first
    theme = kernel_inputs.edge_scene("stacked", 64, "cpu")[6]
    assert set(theme.tolist()) == set(range(-1, kernel_inputs.EDGE_THEMES + 1))


def test_scene_reference_matches_pallas_on_odd_kinds():
    """The card tests' yardstick for B5's kind lookup (chip_smoke.
    edge_field: kinds that are fractions, -0.0, negative, beyond int8,
    infinite or NaN; themed and unthemed entries, three of kinds beyond
    int8), at 4 envs: the plain version bitwise equal to the Pallas kernel
    in interpret mode. The joint phases are clamped into the tile bank
    first: the Pallas kernel does not clamp a phase of -1 (an index out
    of its block), where the port and the JAX package's mirror clamp
    (test_scene_clamps_the_joint_phase)."""
    X, p, theme, tb, kinds, themes, groups, obs = kernel_inputs.edge_field(
        4, "cpu", seed=6)
    p = p.clamp(0, tb.shape[0] - 1)
    want = jsk.scene_tpu(
        *(_torch_to_jax(a) for a in (X, p, theme, tb)), kinds, themes,
        [tuple(_torch_to_jax(x) for x in g) for g in groups], obs,
        interpret=True)
    got = tsk.scene(X, p, theme, tb, kinds, themes, groups, obs)
    np.testing.assert_array_equal(
        np.asarray(want, np.float32).view(np.int32),
        got.float().numpy().view(np.int32))


def test_edge_field_reaches_every_kind_path():
    """What kernel_inputs.edge_field promises B5's kind lookup, in every one
    of 4 envs: integer kinds in int8 (the table; -0.0 among them, and a
    negative kind with an entry), fractions, infinities and a NaN (the
    comparison with every entry, matching none), and integer kinds beyond
    int8 matching their entries; and a tile blend of a themed entry (env
    theme in range) and of an unthemed one, over 64 envs every env theme
    in [-1, EDGE_THEMES]."""
    X, p, theme, tb, kinds, themes, groups, obs = kernel_inputs.edge_field(
        4, "cpu")
    assert len(kinds) <= tsk._MAX_ENTRIES
    assert set(kernel_inputs.BIG_KINDS) <= set(kinds)
    assert all(not -128 <= k <= 127 for k in kernel_inputs.BIG_KINDS)
    G = X[:, 0].float().reshape(4, -1)
    bits = G.view(torch.int32)
    table = (G == G.round()) & (G.abs() <= 128) & (G >= -128) & (G <= 127)
    for e in range(4):
        g, b, t = G[e], bits[e], table[e]
        assert (b == -2 ** 31).any()  # -0.0
        assert (t & (g == -5)).any() and (t & (g == 1)).any()
        assert ((g != g.round()) & g.isfinite()).any()  # fractions
        assert g.isinf().any() and g.isnan().any()
        for k in kernel_inputs.BIG_KINDS:
            assert (g == k).any()
    all_theme = kernel_inputs.edge_field(64, "cpu")[2]
    assert set(all_theme.tolist()) == set(
        range(-1, kernel_inputs.EDGE_THEMES + 1))
    assert ((theme >= 0) & (theme < kernel_inputs.EDGE_THEMES)).any()
