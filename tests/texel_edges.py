"""Rotated sprites on angles crafted onto texel edges, for each game's
test file (`check(case)`, one case per game of CRAFTED).

A rotated sprite's texel fractions u, v (compositor.rotated_frac) are
sums of two products, rounded as XLA CPU fuses them. On random states a
pixel's fraction almost never lies within an ulp of a texel edge, where
the rounding decides the texel; `check` puts one there in every env: an
angle solved for a pixel to land on an edge between two texels that
differ (or on the rect's border, over an opaque texel), then the f32
angle nearest the edge among its neighbours, and compares the game's
observe with the JAX package's, bitwise. The states come from
`render_parity.rollout`, whose JAX programs the game's file shares."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import jax_reference as JR
import render_parity as RP
from procgen2_tpu_torch.render import compositor as tC
from procgen2_tpu_torch.utils import convert

EDGE_REPS = 8  # batches of 8 envs per sprite


def _fracs(theta, wx, wy, cx, cy, w, h):
    """u, v float64 [E, 64, 64] of rects at the f32 angles theta [E] (the
    port's cos and sin) about centres cx, cy [E], pixel maps wx, wy f32
    [E, 64], sizes w, h [E]; and each fraction's distance to its nearest
    texel edge in units of its f32 ulp (at least 2^-26)."""
    c, s = tC.trig.sincos32(torch.as_tensor(theta, dtype=torch.float32))
    c, s = c.double()[:, None, None], s.double()[:, None, None]
    f32 = torch.float32
    rx = (torch.as_tensor(wx)[:, None, :] - torch.as_tensor(
        cx, dtype=f32)[:, None, None]).double()
    ry = (torch.as_tensor(wy)[:, :, None] - torch.as_tensor(
        cy, dtype=f32)[:, None, None]).double()
    w = torch.as_tensor(w, dtype=torch.float64)[:, None, None]
    h = torch.as_tensor(h, dtype=torch.float64)[:, None, None]
    u = (c * rx + s * ry) / w + 0.5
    v = (-s * rx + c * ry) / h + 0.5

    def dist(q):
        q = q.numpy()
        ulp = np.maximum(np.spacing(np.abs(q).astype(np.float32)), 2.0**-26)
        return np.abs(q * tC.S - np.round(q * tC.S)) / (ulp * tC.S)
    return u, v, np.minimum(dist(u), dist(v)).reshape(len(u), -1).min(1)


def _edge_angle(rng, wx, wy, cx, cy, w, h, tex):
    """An angle (float64) that puts a pixel's u or v on a texel edge of
    tex u8 [4, S, S] where the texels on its two sides differ, or on the
    rect's border over an opaque texel; wx, wy [64], cx, cy, w, h
    numbers."""
    S = tC.S
    near = np.argwhere(np.hypot(np.asarray(wx, np.float64)[None, :] - cx,
                                np.asarray(wy, np.float64)[:, None] - cy)
                       < 0.75 * max(w, h))
    for _ in range(20000 if len(near) else 0):
        i, j = near[rng.integers(len(near))]
        rx, ry = float(wx[j]) - cx, float(wy[i]) - cy
        R = np.hypot(rx, ry)
        on_u = rng.random() < 0.5
        k = int(rng.integers(0, S + 1))
        t = (k / S - 0.5) * (w if on_u else h)
        if not 1e-6 < abs(t) < R:
            continue
        phi = np.arctan2(ry, rx) if on_u else np.arctan2(-rx, ry)
        th = phi + rng.choice([-1.0, 1.0]) * np.arccos(t / R)
        u = (np.cos(th) * rx + np.sin(th) * ry) / w + 0.5
        v = (-np.sin(th) * rx + np.cos(th) * ry) / h + 0.5
        o = v if on_u else u
        if not 0 <= o < 1:
            continue
        o = int(o * S)
        side = [tex[:, o, kk] if on_u else tex[:, kk, o]
                for kk in (k - 1, k) if 0 <= kk < S]
        if (len(side) == 1 and side[0][3] > 0) or (
                len(side) == 2 and (side[0] != side[1]).any()):
            return th
    raise AssertionError("no texel edge found")


def _nearest(cands, dist):
    """cands [E, C], dist [E * C] -> the candidate of each env nearest an
    edge."""
    return cands[np.arange(len(cands)), dist.reshape(cands.shape).argmin(1)]


def _rotation_candidates(th, off):
    """f32 rotations r near th - off whose f32 angle r + off is the one
    drawn; [E, 33] with their angles."""
    r0 = (np.asarray(th) - off).astype(np.float32)
    r = (r0[:, None] + np.arange(-16, 17) * np.spacing(r0)[:, None]).astype(
        np.float32)
    return r, (r + np.float32(off)).astype(np.float32)


def _craft_ship(rng, nst, tg):
    """caveflyer: the ship's rotation (drawn at rot + pi/2 about pos +
    (_SHIP_DX, _SHIP_DY), 0.928 x 0.703, camera on the ship)."""
    g = nst.game
    R = tg._observe_assets("cpu")
    tex = R["atlas"][R["idx"]["ship_red"]].numpy()
    pos = torch.from_numpy(g.pos.astype(np.float32))
    wx, wy = tC.camera_coords(tg.PPU, pos[:, 0], pos[:, 1])
    cx = (pos[:, 0] + tg._SHIP_DX).numpy()
    cy = (pos[:, 1] + tg._SHIP_DY).numpy()
    E = len(cx)
    th = [_edge_angle(rng, wx[e].numpy(), wy[e].numpy(), float(cx[e]),
                      float(cy[e]), 0.928, 0.703, tex) for e in range(E)]
    rots, ang = _rotation_candidates(th, np.pi / 2)
    C = rots.shape[1]
    rep = np.repeat
    _, _, d = _fracs(ang.reshape(-1), rep(wx, C, 0), rep(wy, C, 0),
                     rep(cx, C), rep(cy, C), np.full(E * C, 0.928),
                     np.full(E * C, 0.703))
    return dataclasses.replace(g, rot=_nearest(rots, d))


def _craft_boss_bullets(rng, nst, tg):
    """bossfight: one live boss bullet per env (drawn at bb_rot + pi/2
    about its position, 0.3 units, the fixed camera), put in view (an env
    with none gets one)."""
    g = nst.game
    R = tg._observe_assets("cpu")
    E = g.bb_pos.shape[0]
    num, frame = g.bb_num.copy(), g.bb_frame.copy()
    win = tg._window(torch.from_numpy(g.bb_next), torch.from_numpy(num),
                     tg.NUM_B_BULLETS).numpy()
    live = win & (frame == 0.0)
    # an env with none gets the newest slot of its ring live
    slot = np.where(live.any(1), live.argmax(1),
                    (g.bb_next - 1) % tg.NUM_B_BULLETS)
    num = np.where(live.any(1), num, np.maximum(num, 1)).astype(num.dtype)
    frame[np.arange(E), slot] = 0.0
    bolt = R["bolts"][torch.from_numpy(g.level.bullet_tex).long()]
    zero = torch.zeros(E)
    wx, wy = tC.camera_coords(tg.PPU, zero, zero)
    pos = g.bb_pos.copy()
    at = rng.uniform(-1.5, 1.5, (E, 2)).astype(np.float32)
    pos[np.arange(E), slot] = at
    w = np.float32(0.3)
    cx = (at[:, 0] - w * np.float32(0.5)) + np.float32(0.5) * w
    cy = (at[:, 1] - w * np.float32(0.5)) + np.float32(0.5) * w
    th = [_edge_angle(rng, wx[e].numpy(), wy[e].numpy(), float(cx[e]),
                      float(cy[e]), float(w), float(w),
                      R["atlas"][int(bolt[e])].numpy()) for e in range(E)]
    rots, ang = _rotation_candidates(th, np.pi / 2)
    C = rots.shape[1]
    rep = np.repeat
    _, _, d = _fracs(ang.reshape(-1), rep(wx, C, 0), rep(wy, C, 0),
                     rep(cx, C), rep(cy, C), np.full(E * C, w),
                     np.full(E * C, w))
    rot = g.bb_rot.copy()
    rot[np.arange(E), slot] = _nearest(rots, d)
    return dataclasses.replace(g, bb_pos=pos, bb_rot=rot, bb_num=num,
                               bb_frame=frame)


def _needle(tg, tx, ty):
    """jumper's needle at 64 px for to-goal vectors tx, ty f32 tensors:
    (angle, centre x, centre y), as the port draws it."""
    P = tg.prng
    dist = torch.sqrt(P._fma32(tx, tx, ty * ty))
    inv = 1.0 / torch.clamp(dist, min=1e-4)
    cs = tg._CS
    cx = P._fma32(tx * inv, cs * 0.25, tg._folded(64 - cs * 0.75 + tg._OFFX,
                                                  cs * 0.25))
    cy = P._fma32(ty * inv, cs * 0.25, tg._folded(cs * 0.5 + tg._OFFY,
                                                  cs * 0.05))
    return tg.atan2f(ty, tx), cx, cy


def _craft_needle(rng, nst, tg):
    """jumper: the agent placed so that the compass needle (rotated by the
    angle to the goal about a centre that moves with it; cs/2 x cs/10
    pixels of a solid texture, so its border decides) lands on an edge."""
    g = nst.game
    R = tg._observe_assets("cpu")
    tex = R["atlas"][R["idx"]["solid_yellow"]].numpy()
    E = g.pos.shape[0]
    px = np.arange(64, dtype=np.float32) + 0.5
    w, h = tg._CS * 0.5, tg._CS * 0.1
    goal = g.level.goal_pos.astype(np.float32)
    pos = g.pos.copy()
    for e in range(E):
        th, cx, cy = 0.0, 64 - tg._CS * 0.5 + tg._OFFX, tg._CS * 0.5 + tg._OFFY
        for _ in range(4):  # the centre moves with the angle
            th = _edge_angle(np.random.default_rng(int(rng.integers(1 << 30))),
                             px, px, cx, cy, w, h, tex)
            cx = 64 - tg._CS * 0.75 + tg._OFFX + tg._CS * 0.25 * (
                1 + np.cos(th))
            cy = tg._CS * 0.5 + tg._OFFY + tg._CS * 0.25 * np.sin(th)
        L = rng.uniform(2.0, 6.0)
        p0 = (goal[e] - L * np.array([np.cos(th), np.sin(th)])).astype(
            np.float32)
        k = np.arange(-12, 13)
        cand = np.stack(np.broadcast_arrays(
            p0[0] + k[:, None] * np.spacing(p0[0]),
            p0[1] + k[None, :] * np.spacing(p0[1])), -1).reshape(-1, 2)
        cand = cand.astype(np.float32)
        to = torch.from_numpy((goal[e] - cand).astype(np.float32))
        ang, ncx, ncy = _needle(tg, to[:, 0], to[:, 1])
        n = len(cand)
        pxs = np.repeat(px[None], n, 0)
        _, _, d = _fracs(ang, pxs, pxs, ncx, ncy, np.full(n, w),
                         np.full(n, h))
        pos[e] = cand[d.argmin()]
    return dataclasses.replace(g, pos=pos)


CRAFTED = {
    "caveflyer_ship": ("caveflyer", _craft_ship, {}),
    "bossfight_boss_bullets": ("bossfight", _craft_boss_bullets, {}),
    "jumper_needle": ("jumper", _craft_needle, {}),
}


def check(case):
    """Each env's rotated sprite of `case` with a pixel on a texel edge
    (within an ulp): the port's observe equals the JAX package's,
    bitwise."""
    name, craft, roll = CRAFTED[case]
    jst, nst = RP.rollout(name, (), **roll)
    _, tg = RP.games(name)
    rng = np.random.default_rng(sorted(CRAFTED).index(case))
    bad = []
    for rep in range(EDGE_REPS):
        game = craft(rng, nst, tg)
        jgame = type(jst.game)(**{
            f.name: (jax.tree.map(jnp.asarray, getattr(game, f.name))
                     if f.name != "level" else jst.game.level)
            for f in dataclasses.fields(jst.game)})
        want = JR.observe_each(name, (), jgame, 64)
        got = tg.observe(tg.Config(), convert.state(tg, game, "cpu"), 64)
        bad += [(rep, e) for e in np.nonzero(
            (want != got.numpy()).any(axis=(1, 2, 3)))[0]]
    assert not bad, f"{len(bad)} of {8 * EDGE_REPS} envs differ: {bad[:8]}"
