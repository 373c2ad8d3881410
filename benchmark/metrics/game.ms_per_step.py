"""game.ms_per_step: the device time of the game's step (its physics and the
episode accumulators): the time of the kernels that run between each
`trace_mark_game_step` kernel and the next mark, summed over the profiled
slice, over its batched steps (`benchmark/layers.py`). Nothing is read
where the program launches no marks."""
from benchmark import layers


def read(run):
    return layers.ms_per_step(run, "game_step")
