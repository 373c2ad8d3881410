"""Inputs of the port's four render kernels and their plain versions, for
the CPU tests, the card tests and chip_smoke.py: random scenes, stamp
groups, stamp-sum groups and expanded fields, and the edge cases of the
kernels' staged slot tables (csrc/stamps.cuh) and of B5's kind lookup.
Each builder takes the env count, the device and a seed; the same seed
gives the same inputs on every device."""
import torch

from procgen2_tpu_torch.games import bossfight, coinrun


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
