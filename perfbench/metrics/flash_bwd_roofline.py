"""Kernel 6 (``ops/kernels/attention.py``, the flash attention backward,
its dK/dV and dQ kernels together): its least time on the card for the
profiled training steps, over the device time the trace gives
``flash_bwd_*``, in percent."""

from perfbench import costs


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr.get("steps"):
        return None
    b, f = costs.flash_bwd_work(ctx["model"], ctx["batch"], ctx["seq"])
    n = tr["steps"]
    return costs.roofline_percent(n * b, n * f, tr["kernel_s"]["flash_bwd"])
