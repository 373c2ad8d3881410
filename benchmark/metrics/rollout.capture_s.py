"""rollout.capture_s: the set-up's first rollout call, synced: the graph's
side-stream warm-up, its capture and its first replay, with the call's
host read."""


def read(run):
    spans = run.spans.get("call.first")
    if run.traffic["call"] != "rollout" or not spans:
        return None
    return spans[0]
