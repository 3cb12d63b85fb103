"""Token sampling and the paged engine's step functions (counterpart of
``paddle_tpu/serving/sampling.py``)."""

import math

import torch

from paddle_tpu_torch.ops import prng
from paddle_tpu_torch.ops.kernels import decode as kdecode


def sample_tokens(logits: torch.Tensor, key: torch.Tensor,
                  temperature: torch.Tensor,
                  top_k: torch.Tensor) -> torch.Tensor:
    """``paddle_tpu``'s ``sample_tokens``: logits [B, V] fp32, a
    threefry ``key`` (``ops/prng.prng_key``), per-row temperature [B]
    (<= 0 is greedy) and top_k [B] (<= 0 disables the filter) -> ids
    [B] int32. Greedy rows are the first-index argmax; the top-k
    threshold is the k-th value of a descending sort, lanes compared
    with it as floats, ties kept; the draw is
    ``jax.random.categorical(key, z)``, bitwise (``ops/prng.py``), so
    the ids are JAX's for the same key."""
    V = logits.shape[-1]
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1)
    k = top_k.long().clamp(0, V)
    srt = torch.sort(logits, dim=-1, descending=True).values
    kth = srt.gather(-1, (k - 1).clamp(min=0)[:, None])
    keep = (k[:, None] <= 0) | (logits >= kth)
    z = torch.where(keep, logits, -math.inf)
    t = temperature.float()
    z = z / torch.where(t > 0, t, 1.0)[:, None]
    sampled = prng.categorical(key, z)
    return torch.where(t > 0, sampled, greedy).to(torch.int32)


def paged_step_fns(cfg, block_size: int, *, tracker=None):
    """(prefill_fn, decode_fn) of the paged engine, as step programs
    (``core/graphs.StepProgram``, the counterpart of the JAX engine's
    jitted functions) under the tracker names
    ``serving_engine.prefill`` / ``serving_engine.decode``, sharing one
    capture stream and graph memory pool. On a CUDA device each program
    captures one CUDA graph per argument signature and replays it; on
    the CPU it runs its function. ``.raw`` is the function itself:

    prefill(params, pool, tokens [1, C], length, pages [P],
            temperature [1], top_k [1], seed) -> (token [1], pool)
    decode(params, pool, tokens [B], pos [B], active [B] bool,
           pages [B, P], temperature [B], top_k [B], seed)
           -> (tokens [B] int32, pool)

    ``length`` and ``seed`` are 0-d int32 tensors in the raw functions;
    the programs take them as numpy scalars (``np.int32``) and the other
    per-call inputs as numpy arrays, the parameters and the pool as
    tensors. Both tails sample with the ``fused_sample`` kernel wrapper,
    so only int32 ids leave the device, each on ``paddle_tpu``'s
    stream: the prefill tail on the threefry stream, bitwise
    ``paddle_tpu``'s ``sample_tokens(logits, jax.random.PRNGKey(seed),
    ...)``; the decode tail on the hashed stream of ``paddle_tpu``'s
    Pallas ``fused_sample``. The pool is updated in place and returned.
    ``params`` may be the int8-weight tree of
    ``io/lm_serving.quantize_lm_params`` and the pool a quantized one:
    both steps take them as they are (``paddle_tpu``'s ``_prefill_live``
    and ``_decode_live``; the per-layer dequant is in
    ``models/transformer.py``)."""
    from paddle_tpu_torch.core import graphs
    from paddle_tpu_torch.models import transformer

    def prefill_fn(params, pool, tokens, length, pages, temperature,
                   top_k, seed):
        logits, pool = transformer.prefill_into_blocks(
            params, pool, tokens, length, pages, cfg, block_size=block_size)
        return kdecode.fused_sample(logits, seed, temperature, top_k,
                                    stream="threefry"), pool

    def decode_fn(params, pool, tokens, pos, active, pages, temperature,
                  top_k, seed):
        logits, pool = transformer.decode_step_paged(
            params, pool, tokens, pos, active, pages, cfg,
            block_size=block_size)
        return kdecode.fused_sample(logits, seed, temperature, top_k), pool

    from paddle_tpu_torch.observe import compile_tracker
    if tracker is None:
        tracker = compile_tracker.CompileTracker()
    context = graphs.GraphContext()
    return (graphs.StepProgram(prefill_fn, "serving_engine.prefill",
                               tracker, context),
            graphs.StepProgram(decode_fn, "serving_engine.decode", tracker,
                               context))
