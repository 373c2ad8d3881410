"""device.busy_ms_per_step: the time in which some kernel, copy or set
ran on the device, inside the profiled slice, over the batched steps in
it."""


def read(run):
    s = run.trace
    if s is None or not s.steps or s.busy_us <= 0:
        return None
    return s.busy_us / 1e3 / s.steps
