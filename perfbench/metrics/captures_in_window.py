"""Step programs: CUDA graphs captured inside the window (the change in
the engine's ``compile_counts()``); set-up warms every program the mix
can reach, so anything here is a capture the window paid for."""


def read(ctx):
    return ctx.get("captures")
