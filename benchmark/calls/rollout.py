"""The call `rollout`: `dist.rollout(env, state, key, steps_per_call)`, one
CUDA graph of T steps with the program's uniform on-device actions (each
step: key, k_act = split(key); actions = randint(k_act, (N,)))."""


def program(mix: dict, system, num_envs: int, num_actions: int):
    steps = int(mix["steps_per_call"])
    return lambda state, key: system.rollout(state, key, steps)


def reference(env, bank, state, key, mix: dict, rows):
    return env.rollout(bank, state, key, int(mix["steps_per_call"]), rows)
