"""The call `step`: one `ShardedEnv.step` (steps_per_call 1), its uniform
actions drawn here on the device as the rollout draws them (key, k_act =
split(key); actions = randint(k_act, (N,)))."""
from benchmark.reference import random as prng


def program(mix: dict, system, num_envs: int, num_actions: int):
    if int(mix["steps_per_call"]) != 1:
        raise ValueError("a step call makes one step (steps_per_call 1)")

    def step(state, key):
        _, k_act = prng.split(key).unbind(-2)
        actions = prng.randint(k_act, (num_envs,), 0, num_actions)
        return system.step(state, actions)
    return step


def reference(env, bank, state, key, mix: dict, rows):
    return env.rollout(bank, state, key, 1, rows)
