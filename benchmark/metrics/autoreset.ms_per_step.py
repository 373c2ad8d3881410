"""autoreset.ms_per_step: the device time of the auto-reset (the split of the
env keys, the level draw, the bank gather, the game's reset, the selects):
the time of the kernels that run between each `trace_mark_auto_reset`
kernel and the next mark, summed over the profiled slice, over its batched
steps (`benchmark/layers.py`). Nothing is read where the program launches
no marks."""
from benchmark import layers


def read(run):
    return layers.ms_per_step(run, "auto_reset")
