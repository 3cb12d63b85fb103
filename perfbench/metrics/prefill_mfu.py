"""The prefill step: the model FLOPs of the prompts of the requests that
arrived in the window, over the engine's own seconds of their chunk
calls (``EngineRequest.prefill_own_s``, each chunk's host clock ended
by its token's copy to the host) and the card's bf16 peak, in
percent."""

from perfbench import costs


def read(ctx):
    secs = sum(ctx.get("prefill_own_s", ()))
    if secs <= 0:
        return None
    cfg, chunk = ctx["model"], ctx["chunk_tokens"]
    flops = sum(costs.prefill_chunk_flops(cfg, off, min(n - off, chunk))
                for n in ctx["prompt_lens"] for off in range(0, n, chunk))
    return 100.0 * flops / secs / costs.PEAK_BF16_FLOPS
