"""Play the reference's own levels (reference_levels) with the bots and
scripted routes: which bot plays each game and which state fields it
reads, the open-loop plans, and `play`, which steps an Environment
through them, one lane per seed.

Envs start from `Environment.reset_pinned(bank, key(123), seeds)`: env i
on level i, keyed by its seed, as the parity tests pin them. `play`
steps with `step_raw` (no auto-reset), reads the lanes' fields back to
the host after each step for the closed-loop bots, and stops once every
lane has ended. On the card, `dist.rollout` replays the same actions
(chip_smoke.py).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import random as prng
from . import bots, scripted

PIN_KEY = 123  # the reset key of every reference-level run

# game -> (closed-loop bot, the State fields its act() reads, in order)
BOTS = {
    "coinrun": (bots.CoinrunBot, ("pos", "vel", "on_ground")),
    "climber": (bots.ClimberBot, ("pos", "vel", "on_ground", "point_taken")),
    "jumper": (bots.JumperBot,
               ("pos", "vel", "on_ground", "jumps_left", "jump_timer")),
    "caveflyer": (bots.CaveflyerBot, ("pos", "vel", "rot", "target_alive")),
    "bossfight": (bots.BossfightBot,
                  ("pos", "vel", "boss_pos", "phase_index", "bb_pos",
                   "bb_vel", "bb_frame")),
}


def maze_plan(level) -> list:
    """The BFS route from the agent's cell to the goal's (numpy level)."""
    ax, ay = level.agent_pos
    gx, gy = level.goal_pos
    return scripted.bfs_actions(np.asarray(level.grid),
                                (int(ay), int(ax)), (int(gy), int(gx)))


def chaser_plan(level) -> list:
    """The full-clear route's actions (bots.chaser_full_route)."""
    return bots.route_to_actions(bots.chaser_full_route(level),
                                 bots.CHASER_STEPS_PER_CELL)


def pad(plans, steps=None) -> np.ndarray:
    """Per-lane action lists -> int32 [T, N], NOOP after each list ends
    (T = the longest list, or `steps`)."""
    T = max(len(a) for a in plans) if steps is None else steps
    A = np.full((T, len(plans)), bots.NOOP, np.int32)
    for i, a in enumerate(plans):
        A[: min(T, len(a)), i] = a[:T]
    return A


def pinned(env, bank, seeds):
    """reset_pinned on the bank, env i keyed by seeds[i]."""
    return env.reset_pinned(bank, prng.key(PIN_KEY, env.device),
                            torch.as_tensor(np.asarray(seeds, np.int64),
                                            device=env.device))


def make_bots(game, levels):
    return [BOTS[game][0](lvl) for lvl in levels]


def read(game_state, fields, n):
    """The first n lanes of each field, as numpy."""
    return [getattr(game_state, f)[:n].cpu().numpy() for f in fields]


def bot_actions(bots_, args, done) -> np.ndarray:
    """Each live lane's bot on its fields; NOOP where `done`."""
    return np.array([bots.NOOP if done[i] else
                     bots_[i].act(*[a[i] for a in args])
                     for i in range(len(bots_))], np.int32)


def play(env, bank, seeds, actions=None, game=None, levels=None,
         max_steps=None, render_steps=0, keep_states=False, until_done=None):
    """Step env i of `pinned(env, bank, seeds)` with `actions` [T, N]
    (open loop), or with `game`'s bot on `levels` (closed loop, up to
    `max_steps`). A closed loop stops once every lane has ended, an open
    one after its T steps (either as `until_done` says). Returns
    dict(rewards f32 [T, N], dones bool [T, N], actions int32 [T, N],
    keys0 (the post-reset game keys), obs (the frames of the first
    `render_steps` steps, uint8 tensors), states (each step's, where
    `keep_states`))."""
    state = pinned(env, bank, seeds)
    keys0 = getattr(state.game, "rng", None)
    n = len(seeds)
    closed = actions is None
    if until_done is None:
        until_done = closed
    if closed:
        bots_ = make_bots(game, levels)
        fields = BOTS[game][1]
    steps = max_steps if closed else len(actions)
    R, D, A, obs, states = [], [], [], [], []
    done = np.zeros(n, bool)
    for t in range(steps):
        a = (bot_actions(bots_, read(state.game, fields, n), done)
             if closed else np.asarray(actions[t], np.int32))
        state, ts = env.step_raw(state, torch.from_numpy(a).to(env.device),
                                 render=t < render_steps)
        A.append(a)
        R.append(ts.reward.cpu().numpy())
        D.append(ts.terminated.cpu().numpy())
        if t < render_steps:
            obs.append(ts.obs)
        if keep_states:
            states.append(state)
        done |= D[-1]
        if until_done and done.all():
            break
    return dict(rewards=np.stack(R), dones=np.stack(D), actions=np.stack(A),
                keys0=keys0, obs=obs, states=states)
