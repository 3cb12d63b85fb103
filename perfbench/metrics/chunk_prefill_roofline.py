"""Kernel 3 (``ops/kernels/prefill.py``, chunk prefill attention): its
least time on the card for the profiled steps' chunks, over the device
time the trace gives ``chunk_prefill_tc_kernel``, in percent."""

from perfbench import costs


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr.get("prefills"):
        return None
    cfg, bs = ctx["model"], ctx["block_size"]
    nbytes = flops = 0.0
    for off, c in tr["prefills"]:
        b, f = costs.chunk_prefill_work(cfg, off, c, bs)
        nbytes, flops = nbytes + b, flops + f
    return costs.roofline_percent(nbytes, flops, tr["kernel_s"]["prefill"])
