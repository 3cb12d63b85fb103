"""The optimizer (``optimizer.Adam.tree_update``): CUDA events around
it, the mean over the window's steps, in ms."""


def read(ctx):
    t = ctx.get("step_ms")
    return sum(b for _, b in t) / len(t) if t else None
