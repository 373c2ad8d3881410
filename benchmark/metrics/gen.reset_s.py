"""gen.reset_s: `ShardedEnv.reset` on the host clock, synced: the bank's
generation (the game's `generate` over every level) and the reset of
every env with its first render."""


def read(run):
    spans = run.spans.get("reset")
    return spans[0] if spans else None
