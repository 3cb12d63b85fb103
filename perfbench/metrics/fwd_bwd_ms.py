"""LM training's forward and backward (``transformer.lm_loss`` and
``backward()``): CUDA events around them, the mean over the window's
steps, in ms."""


def read(ctx):
    t = ctx.get("step_ms")
    return sum(a for a, _ in t) / len(t) if t else None
