"""The card in the serving cells: the share of the profiled steps in
which no kernel, copy or set ran on it, in percent."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
