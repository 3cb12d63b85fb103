"""Engine scheduler: the mean share of the engine's slots decoding after
each step of the window (``active_count`` / slots)."""


def read(ctx):
    occ = ctx.get("occupancy")
    if not occ:
        return None
    return 100.0 * sum(occ) / len(occ) / ctx["slots"]
