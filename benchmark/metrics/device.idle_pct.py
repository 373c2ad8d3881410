"""device.idle_pct: the share of the profiled slice's wall time (first
call's start to last read's end, less the gaps that the profiler opens:
its buffer flushes and its slowed graph launches, `trace.PROFILER_OWN`) in
which nothing ran on the device."""


def read(run):
    s = run.trace
    if s is None or s.window_us <= 0 or s.busy_us <= 0:
        return None
    return 100.0 * (1.0 - s.busy_us / s.window_us)
