"""rollout.host_ms: the host's time inside `dist.rollout` per call (copy-in,
the bank's layout key, the replay's launch, the clones of the outputs),
from the call's start to its return, before the host read; no sync. The
mean over the window's calls before the profiler starts (it slows the
host's side of the calls it sees and of those after it)."""
from statistics import fmean


def read(run):
    spans = run.spans.get("call.host")
    if run.traffic["call"] != "rollout" or not spans:
        return None
    return fmean(spans) * 1e3
