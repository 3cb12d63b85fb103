"""The whole serving step: the model FLOPs of every prefill chunk and
every active decode row the window ran (``perfbench/costs.py``), over
the window's seconds and the card's bf16 peak, in percent."""

from perfbench import costs


def read(ctx):
    if not ctx.get("decodes") and not ctx.get("prefills"):
        return None
    cfg = ctx["model"]
    flops = sum(costs.decode_step_flops(cfg, p.tolist())
                for p in ctx["decodes"])
    flops += sum(costs.prefill_chunk_flops(cfg, off, c)
                 for off, c in ctx["prefills"])
    return 100.0 * flops / ctx["window_s"] / costs.PEAK_BF16_FLOPS
