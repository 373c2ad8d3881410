"""Lanes placed so that episodes end on the first step, for the CPU
tests, the card tests and chip_smoke.py: each game's goal and hazard
lanes (the auto-reset's draw from the bank then shows), the first
action that holds them, the main paths at the other configs
(`MODE_CASES`), and scripted runs of the reference's own levels. A
placement picks its lanes from the first n lanes only, so a state and its
first n lanes on another device get the same placement."""
import dataclasses

import torch

import procgen2_tpu_torch as pt
from procgen2_tpu_torch.games import bossfight, chaser, coinrun

T = 8  # steps of one rollout replay on the card (chip_smoke.py's T)


def place_on_hazards(gs, n):
    """Of the first n lanes of a coinrun State: lane 0 on its coin, the
    first other lane with a live saw on that saw, the first other lane
    with lava standing in it; their velocities zeroed. The lanes chosen
    depend only on the first n lanes, so a state and its first n lanes on
    another device get the same placement. Returns (state, lanes)."""
    lv = gs.level
    pos, vel = gs.pos.clone(), gs.vel.clone()
    up = torch.tensor([0.0, 0.5], device=pos.device)
    pos[0] = lv.coin_pos[0] + up
    lanes = [0]
    alive = lv.saw_alive[:n].cpu()
    saws = [i for i in range(1, n) if bool(alive[i].any())]
    if saws:
        i = saws[0]
        pos[i] = lv.saw_pos[i, int(alive[i].int().argmax())] + up
        lanes.append(i)
    lava_top = (lv.grid[:n] == coinrun.LAVA_TOP).cpu()
    lava = [i for i in range(1, n) if i not in lanes and bool(lava_top[i].any())]
    if lava:
        i = lava[0]
        ry, x = torch.nonzero(lava_top[i])[0].tolist()
        pos[i] = torch.tensor([x + 0.5, ry + 1.0], device=pos.device)
        lanes.append(i)
    vel[lanes] = 0.0
    return dataclasses.replace(gs, pos=pos, vel=vel), lanes


def place_boss_deaths(gs):
    """Of a bossfight State: lane 0's agent on its boss (contact: -10 on
    the first sub-step), and lane 1's boss in its last phase (5) with no
    hit points left and its damage show over, mid-phase so that no
    phase-start re-roll restores them (+10 on the first sub-step).
    Returns (state, lanes)."""
    pos, phase_index = gs.pos.clone(), gs.phase_index.clone()
    phase_timer, hp = gs.phase_timer.clone(), gs.hp.clone()
    damage_timer = gs.damage_timer.clone()
    pos[0] = gs.boss_pos[0]
    phase_index[1], phase_timer[1], hp[1] = 5, 1.0, 0
    damage_timer[1] = bossfight.DAMAGE_TIME
    return dataclasses.replace(
        gs, pos=pos, phase_index=phase_index, phase_timer=phase_timer, hp=hp,
        damage_timer=damage_timer), [0, 1]


def place_climber_lanes(gs, n):
    """Of the first n lanes of a climber State: the first lane with a live
    mob on that mob (its rect 0.3 below the mob's centre: contact, and no
    crystal), the first other lane on its last crystal with every other
    crystal taken (+1 + 10); their velocities zeroed. The lanes chosen
    depend only on the first n lanes. Returns (state, lanes)."""
    lv = gs.level
    pos, vel, taken = gs.pos.clone(), gs.vel.clone(), gs.point_taken.clone()
    alive = lv.mob_alive[:n].cpu()
    mob = next(i for i in range(n) if bool(alive[i].any()))
    pos[mob] = (gs.mob_pos[mob, int(alive[mob].int().argmax())]
                + torch.tensor([0.0, 0.3], device=pos.device))
    crys = next(i for i in range(n) if i != mob)
    last = int(lv.point_exists[crys].sum()) - 1
    taken[crys] = lv.point_exists[crys]
    taken[crys, last] = False
    pos[crys] = lv.point_pos[crys, last] + torch.tensor([0.0, 0.5],
                                                        device=pos.device)
    vel[[mob, crys]] = 0.0
    return dataclasses.replace(gs, pos=pos, vel=vel, point_taken=taken), \
        [mob, crys]


def place_caveflyer_lanes(gs, n):
    """Of the first n lanes of a caveflyer State: lane 0's ship on its
    goal (+10), and the first other lane with a meteor, else a live
    target, else an enemy ship, on that hazard (death, 0). Their
    velocities are zeroed. The lanes chosen depend only on the first n
    lanes. Raises ValueError if none of lanes 1..n-1 has a hazard (an
    easy cave often has none; after a reset every existing target is
    alive, so no state the game reaches has one to place). Returns
    (state, lanes)."""
    lv = gs.level
    pos, vel = gs.pos.clone(), gs.vel.clone()
    pos[0] = lv.goal_pos[0]
    hazards = ((lv.obst_pos, lv.obst_exists), (lv.target_pos, gs.target_alive),
               (gs.enemy_pos, lv.enemy_exists))
    found = [(i, where[i, int(alive[i].int().argmax())])
             for i in range(1, n) for where, alive in hazards
             if bool(alive[i].any())]
    if not found:
        raise ValueError(f"no hazard in caveflyer lanes 1..{n - 1}")
    lane, spot = found[0]
    pos[lane] = spot
    lanes = [0, lane]
    vel[lanes] = 0.0
    return dataclasses.replace(gs, pos=pos, vel=vel), lanes


def place_jumper_lanes(gs, n):
    """Of the first n lanes of a jumper State: lane 0's agent on its carrot
    (half a unit below the goal's centre, so its rect lies in the goal
    cell: +10), and the first other lane whose level has a spike, on that
    spike ((x + 0.5, ry + 0.9) for the spike at render cell (ry, x): its
    rect overlaps the spike's whatever the first action; death, 0), a
    spike whose cell above is not the goal's. Velocities are zeroed. The
    lanes chosen depend only on the first n lanes. Raises ValueError if
    none of lanes 1..n-1 has such a spike. Returns (state, lanes)."""
    lv = gs.level
    pos, vel = gs.pos.clone(), gs.vel.clone()
    pos[0] = lv.goal_pos[0] + torch.tensor([0.0, 0.5], device=pos.device)
    spikes = lv.spike_grid[:n].cpu()
    goal = lv.goal_pos[:n].cpu()
    found = [(i, ry, x) for i in range(1, n)
             for ry, x in torch.nonzero(spikes[i]).tolist()
             if (x + 0.5, ry - 0.5) != tuple(goal[i].tolist())]
    if not found:
        raise ValueError(f"no spike in jumper lanes 1..{n - 1}")
    lane, ry, x = found[0]
    pos[lane] = torch.tensor([x + 0.5, ry + 0.9], device=pos.device)
    lanes = [0, lane]
    vel[lanes] = 0.0
    return dataclasses.replace(gs, pos=pos, vel=vel), lanes


def place_jumper_carrot(gs, n):
    """Of a jumper State in `memory` mode, which has no spikes: lane 0's
    agent on its carrot, as `place_jumper_lanes` places it. Returns
    (state, lanes)."""
    pos, vel = gs.pos.clone(), gs.vel.clone()
    pos[0] = gs.level.goal_pos[0] + torch.tensor([0.0, 0.5], device=pos.device)
    vel[0] = 0.0
    return dataclasses.replace(gs, pos=pos, vel=vel), [0]


def place_chaser_lanes(gs):
    """Of a chaser State: lane 0 with every pellet eaten and every orb
    taken (nothing left: +10, done) and lane 1 with its first enemy
    hatched on the agent while nothing is eaten (death, 0). Both take a
    first action that does not move (`hold_first_action`), so lane 1
    collects nothing as it dies. Returns (state, lanes)."""
    points, orbs = gs.point_grid.clone(), gs.orb_taken.clone()
    points[0] = False
    orbs[0] = True
    mob_pos, hatch = gs.mob_pos.clone(), gs.hatch_timer.clone()
    eat = gs.eat_timer.clone()
    mob_pos[1, 0] = gs.pos[1]
    hatch[1, 0] = chaser.HATCH_TIME
    eat[1] = 0.0
    return dataclasses.replace(gs, point_grid=points, orb_taken=orbs,
                               mob_pos=mob_pos, hatch_timer=hatch,
                               eat_timer=eat), [0, 1]


def place_maze_lanes(gs, cfg):
    """Of a maze State: lane 0's agent on its goal (+10 with a first
    action that does not move, `hold_first_action`) and lane 1 at its
    last step before the timeout (terminated with 0: its start is never
    the goal). Returns (state, lanes)."""
    pos, t = gs.pos.clone(), gs.t.clone()
    pos[0] = gs.level.goal_pos[0]
    t[1] = cfg.timeout - 1
    return dataclasses.replace(gs, pos=pos, t=t), [0, 1]


def place_maze_render_lanes(gs):
    """Of a maze State, for its render: rows 0 mod 3 with the mouse on its
    cheese, rows 1 mod 3 on its start cell (a corner of the maze, beside
    the all-wall margin or on the grid's edge), the rest where they are;
    rows 0-2 mod 6 facing forward (the flipped mouse), 3-5 back; row i
    on background i mod 9 (every one where N >= 9)."""
    from procgen2_tpu_torch.games import maze
    lv = gs.level
    i = torch.arange(gs.pos.shape[0], device=gs.pos.device)
    pos = torch.where((i % 3 == 0)[:, None], lv.goal_pos, gs.pos)
    pos = torch.where((i % 3 == 1)[:, None], lv.agent_pos, pos)
    level = dataclasses.replace(lv, bg_index=(i % maze.NUM_BGS).to(
        torch.int32))
    return dataclasses.replace(gs, pos=pos, face_forward=i % 6 < 3,
                               level=level)


def hold_first_action(actions, lanes):
    """`actions` [T, N] with the placed lanes' first action 4 (no move)."""
    actions = actions.clone()
    actions[0, lanes] = 4
    return actions


FEATURES_OFF = {"allow_pit": False, "allow_crate": False, "allow_dy": False,
                "allow_mobs": False}
# The main paths at configs other than the default: the Procgen
# benchmark's hard distribution, memory, easy_mode and coinrun with its
# level features off. label -> (game, config, lane placement, kernel
# launches in one T-step replay). tests/mode_parity.py holds the same
# runs, placement included, against the JAX package on the CPU.
MODE_CASES = {
    "caveflyer hard": ("caveflyer", {"mode": "hard"}, place_caveflyer_lanes,
                       {"scene_raw_kernel": T}),
    "caveflyer memory": ("caveflyer", {"mode": "memory"},
                         place_caveflyer_lanes, {"scene_raw_kernel": T}),
    "jumper hard": ("jumper", {"mode": "hard"}, place_jumper_lanes,
                    {"scene_raw_kernel": T, "stamp_composite_kernel": T}),
    "jumper memory": ("jumper", {"mode": "memory"}, place_jumper_carrot,
                      {"scene_raw_kernel": T, "stamp_composite_kernel": T}),
    "climber easy": ("climber", {"easy_mode": True}, place_climber_lanes,
                     {"scene_raw_kernel": T}),
    "coinrun easy": ("coinrun", {"easy_mode": True}, place_on_hazards,
                     {"scene_raw_kernel": T}),
    "coinrun features off": ("coinrun", FEATURES_OFF, place_on_hazards,
                             {"scene_raw_kernel": T}),
}


def coinrun_bot_actions(seed, max_steps=300):
    """The coinrun bot's closed-loop run to the coin on the reference's
    level `seed`, started as a fixture replay starts it, on the CPU; then
    3 NOOPs into the next episode."""
    from procgen2_tpu_torch.tools.bots import NOOP, CoinrunBot
    from procgen2_tpu_torch.tools.reference_levels import (host_level,
                                                           reference_bank)

    env = pt.make("coinrun", device="cpu")
    bank = reference_bank("coinrun", [seed], "cpu")
    state, _ = env.reset(bank, pt.random.fold_in(pt.random.key(seed), 0), 1)
    bot = CoinrunBot(host_level(bank, 0))
    actions = []
    for _ in range(max_steps):
        gs = state.game
        a = int(bot.act(gs.pos[0].numpy(), gs.vel[0].numpy(),
                        gs.on_ground[0].numpy()))
        actions.append(a)
        state, ts = env.step_raw(state, torch.tensor([a], dtype=torch.int32),
                                 render=False)
        if bool(ts.terminated[0]):
            return actions + [NOOP] * 3
    raise AssertionError(f"coinrun seed {seed}: the bot did not finish")


def maze_route_actions(seed):
    """The BFS route to the goal of the reference's maze level `seed`
    (easy), then 4 NOOPs into the next episode."""
    from procgen2_tpu_torch.tools.bots import NOOP
    from procgen2_tpu_torch.tools.reference_levels import (host_level,
                                                           reference_bank)
    from procgen2_tpu_torch.tools.rng_oracle import reference_maze_layout
    from procgen2_tpu_torch.tools.scripted import bfs_actions

    grid = host_level(reference_bank("maze", [seed], "cpu", mode="easy"),
                      0).grid
    lay = reference_maze_layout(seed, "easy")
    m = lay["margin"]
    gi, gj = lay["goal"]
    return bfs_actions(grid, (14 - m, m), (14 - (gj + m), gi + m)) + [NOOP] * 4
