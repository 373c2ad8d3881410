"""b3.ms_per_step: the profiler's device time of the stamp kernel B3
(`stamp_composite_kernel`) in the profiled slice, over its batched steps.
Beside `render.ms_per_step` it splits the render into B3 and the plain
torch work around it (bossfight: the cull and the stamp groups). Nothing
is read where no such kernel ran."""
KERNELS = ("stamp_composite_kernel",)


def read(run):
    s = run.trace
    if s is None or not s.steps:
        return None
    t_us = s.kernel_us(KERNELS)
    return t_us / 1e3 / s.steps if t_us > 0 else None
