"""What the JAX package's jitted render hands its TPU kernels, computed in
the render's own graph: where XLA CPU folds constants and fuses
multiply-adds depends on that graph (and on the batch: its vectorized
loops and their scalar tails can round differently), so a value is taken
from the render itself, not from a jit of the expression alone.

`render_inputs(game, cfg, state)` runs `game.observe_batch` jitted on the
TPU path with the scene kernel and the stamp kernel replaced by stand-ins
that hand their inputs out of the jitted function (the scene kernel's
stamp groups, the stamp kernel's last call), and with `jnp.round` in the
game's module handing out every value it rounds, in call order.
`onehot_inputs(fn, *args)` runs `fn` jitted with the compositor's
`_onehot` handing out the selector indices (and masks) it takes, in call
order: the kind-field renders of maze and chaser build their constant
tables from them, and the exact renders' selectors are held to them.
Calls made inside a `fori_loop` body (the compositor's `draw_sprites`)
are left out: their values live in the loop, not in the function."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from procgen2_tpu.render import compositor as jC
from procgen2_tpu.render import scene_kernel as jsk
from procgen2_tpu.render import stamp_kernel as jstk


def render_inputs(game, cfg, state):
    """dict(groups=[(var, scale, r0, c0) of each scene-kernel group] or
    None where the render calls no scene kernel,
    composite=(var, scale, r0, c0) of the last stamp-kernel call or None,
    rounded=[every value `jnp.round` took]), numpy; `state` a JAX State
    (keys wrapped)."""
    out = {"rounded": [], "composite": None}

    class Jnp:  # jax.numpy, with `round` handing its argument out
        def __getattr__(self, name):
            return getattr(jnp, name)

        def round(self, x, *a, **k):
            out["rounded"].append(x)
            return jnp.round(x, *a, **k)

    def scene(*args, **kw):
        out["groups"] = [g[1:] for g in args[12]]
        return jnp.zeros((args[0].shape[0], 3, args[13], args[13]),
                         jnp.bfloat16)

    def composite(img, prem, var, scale, r0, c0, *args, **kw):
        out["composite"] = (var, scale, r0, c0)
        return img

    @jax.jit
    def capture(s):
        game.observe_batch(cfg, s)
        # the render's own output rounds last: leave it out
        return dict(groups=out.get("groups"), composite=out["composite"],
                    rounded=out["rounded"][:-1])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(game, "jnp", Jnp())
        mp.setattr(jC, "_use_stamp_kernel", lambda: True)
        mp.setattr(jsk, "scene_tpu_raw", scene)
        mp.setattr(jstk, "composite_tpu", composite)
        got = capture(state)
    return jax.tree.map(np.asarray, got)


def onehot_inputs(fn, *args):
    """[(idx, n, valid)] of every `compositor._onehot(idx, n, valid)` call
    that `fn(*args)` makes, jitted, in call order, numpy (valid None
    where the call gives none)."""
    calls = []
    onehot = jC._onehot
    fori_loop = jax.lax.fori_loop
    depth = [0]

    def handing_out(idx, n, valid=None):
        if depth[0] == 0:
            calls.append((idx, n, valid))
        return onehot(idx, n, valid)

    def counting_loop(lo, hi, body, init):
        def inside(i, x):
            depth[0] += 1
            try:
                return body(i, x)
            finally:
                depth[0] -= 1
        return fori_loop(lo, hi, inside, init)

    @jax.jit
    def capture(*a):
        calls.clear()
        fn(*a)
        return [(i, v) for i, _, v in calls]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jC, "_onehot", handing_out)
        mp.setattr(jax.lax, "fori_loop", counting_loop)
        got = capture(*args)
    return [(np.asarray(i), n, None if v is None else np.asarray(v))
            for (i, v), (_, n, _) in zip(got, calls)]
