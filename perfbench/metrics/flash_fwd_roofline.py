"""Kernel 5 (``ops/kernels/attention.py``, the flash attention forward):
its least time on the card for the profiled training steps, over the
device time the trace gives ``flash_fwd_tc_kernel``, in percent."""

from perfbench import costs


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr.get("steps"):
        return None
    b, f = costs.flash_fwd_work(ctx["model"], ctx["batch"], ctx["seq"])
    n = tr["steps"]
    return costs.roofline_percent(n * b, n * f, tr["kernel_s"]["flash_fwd"])
