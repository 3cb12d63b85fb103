"""The whole training step: ``train_step_flops`` (``perfbench/costs.py``)
of every step of the window, over the window's seconds and the card's
bf16 peak, in percent."""

from perfbench import costs


def read(ctx):
    if not ctx.get("steps"):
        return None
    flops = costs.train_step_flops(ctx["model"], ctx["batch"], ctx["seq"])
    return (100.0 * flops * ctx["steps"] / ctx["window_s"]
            / costs.PEAK_BF16_FLOPS)
