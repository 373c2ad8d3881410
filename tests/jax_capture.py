"""What the JAX package's jitted render hands its TPU kernels, computed in
the render's own graph: where XLA CPU folds constants and fuses
multiply-adds depends on that graph (and on the batch: its vectorized
loops and their scalar tails can round differently), so a value is taken
from the render itself, not from a jit of the expression alone.

`render_inputs(game, cfg, state)` runs `game.observe_batch` jitted on the
TPU path with the scene kernel and the stamp kernel replaced by stand-ins
that hand their inputs out of the jitted function (the scene kernel's
stamp groups, the stamp kernel's last call), and with `jnp.round` in the
game's module handing out every value it rounds, in call order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from procgen2_tpu.render import compositor as jC
from procgen2_tpu.render import scene_kernel as jsk
from procgen2_tpu.render import stamp_kernel as jstk


def render_inputs(game, cfg, state):
    """dict(groups=[(var, scale, r0, c0) of each scene-kernel group],
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
        return dict(groups=out["groups"], composite=out["composite"],
                    rounded=out["rounded"][:-1])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(game, "jnp", Jnp())
        mp.setattr(jC, "_use_stamp_kernel", lambda: True)
        mp.setattr(jsk, "scene_tpu_raw", scene)
        mp.setattr(jstk, "composite_tpu", composite)
        got = capture(state)
    return jax.tree.map(np.asarray, got)
