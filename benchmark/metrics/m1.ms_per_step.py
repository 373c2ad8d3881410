"""m1.ms_per_step: the profiler's device time of maze's render kernel M1
(`maze_render_kernel`) in the profiled slice, over its batched steps.
Beside `render.ms_per_step` it splits maze's render into M1 and the
TimeStep's work around it. Nothing is read where no such kernel ran."""
KERNELS = ("maze_render_kernel",)


def read(run):
    s = run.trace
    if s is None or not s.steps:
        return None
    t_us = s.kernel_us(KERNELS)
    return t_us / 1e3 / s.steps if t_us > 0 else None
