"""Kernel 1 (``ops/kernels/decode.py``, paged decode attention): its
least time on the card for the active rows of the profiled steps, over
the device time the trace gives ``decode_split_kernel``, in percent."""

from perfbench import costs


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr.get("decodes"):
        return None
    cfg, bs = ctx["model"], ctx["block_size"]
    nbytes = flops = 0.0
    for pos in tr["decodes"]:
        b, f = costs.decode_attention_work(cfg, pos.tolist(), bs)
        nbytes, flops = nbytes + b, flops + f
    return costs.roofline_percent(nbytes, flops, tr["kernel_s"]["decode"])
