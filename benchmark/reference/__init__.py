"""Plain reference of the benchmark: a frozen copy of the plain paths of maze and coinrun, the env and the rollout loop."""
