"""step.kernels: device kernels in the profiled slice over the batched
steps in it (copies and sets left out). The slice is whole calls, so the
count repeats exactly from run to run."""


def read(run):
    s = run.trace
    if s is None or not s.steps:
        return None
    return s.kernel_count() / s.steps
