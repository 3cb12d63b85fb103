"""Token sampling, the speculative accept/reject tails, and the step
functions of the slot engine, the paged engine and its
speculative-decoding programs (counterpart of
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


def spec_accept(sampled: torch.Tensor, draft: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """The accept fold of one speculative verify window: ``sampled``
    [B, W] are the target's own tokens at each window position, ``draft``
    [B, W-1] the proposals those positions were conditioned on, ``valid``
    [B] the usable window rows -> ``n`` [B] int32, the leading sampled
    tokens to emit: 1 + the run of leading draft matches, at most
    ``valid`` (W = 1 gives min(1, valid)). An accepted draft token equals
    the target's sample at its position, so the emitted tokens are
    ``sampled[:, :n]``. Plain tensor code on the device, no host read."""
    B, W = sampled.shape
    valid = valid.to(torch.int32)
    if W == 1:
        return torch.minimum(torch.ones_like(valid), valid)
    m = ((sampled[:, :W - 1] == draft)
         & (torch.arange(1, W, device=sampled.device)[None, :]
            < valid[:, None]))
    run = torch.cumprod(m.to(torch.int32), dim=1).sum(dim=1)
    return torch.minimum(1 + run, valid).to(torch.int32)


def window_rows(x: torch.Tensor, W: int) -> torch.Tensor:
    """Per-slot values [B, ...] repeated over a window's W rows, element
    by element (``repeat_interleave(W, 0)``, as ``jnp.repeat``): row
    ``b * W + w`` gets slot b's value. Written as an expand, which needs
    no host read."""
    return x[:, None].expand(x.shape[0], W, *x.shape[1:]).reshape(
        x.shape[0] * W, *x.shape[1:])


def spec_verify_tokens(logits: torch.Tensor, draft: torch.Tensor,
                       key: torch.Tensor, temperature: torch.Tensor,
                       top_k: torch.Tensor, valid: torch.Tensor):
    """``paddle_tpu``'s verify tail with its kernels off: logits
    [B, W, V], draft [B, W-1], a threefry ``key``, per-slot temperature
    and top_k [B] (repeated over the window), valid [B] -> (sampled
    [B, W] int32, n [B] int32). Window row (b, w) is row ``b * W + w``
    of one :func:`sample_tokens` call, so its draws are JAX's for the
    same key. The engine does not use it (its tail is
    ``ops/kernels/decode.fused_spec_verify``, on the hashed stream)."""
    B, W, V = logits.shape
    X = sample_tokens(logits.reshape(B * W, V), key,
                      window_rows(temperature, W),
                      window_rows(top_k, W)).reshape(B, W)
    return X, spec_accept(X, draft, valid)


def _programs(fns: dict, tracker, context) -> dict:
    """``{name: fn}`` as step programs ``serving_engine.<name>`` under
    one tracker and graph context (new ones when None)."""
    from paddle_tpu_torch.core import graphs
    from paddle_tpu_torch.observe import compile_tracker
    if tracker is None:
        tracker = compile_tracker.CompileTracker()
    if context is None:
        context = graphs.GraphContext()
    return {name: graphs.StepProgram(fn, f"serving_engine.{name}", tracker,
                                     context)
            for name, fn in fns.items()}


def engine_step_fns(cfg, *, tracker=None, context=None):
    """(prefill_fn, decode_fn) of the row-arena slot engine, as step
    programs under the tracker names ``serving_engine.prefill`` /
    ``serving_engine.decode`` sharing one graph ``context``, built as
    :func:`paged_step_fns` builds the paged pair:

    prefill(params, cache, tokens [1, Tb], length, slot, temperature [1],
            top_k [1], seed) -> (token [1], cache)
    decode(params, cache, tokens [B], pos [B], active [B] bool,
           temperature [B], top_k [B], seed) -> (tokens [B] int32, cache)

    ``length``, ``slot`` and ``seed`` are numpy scalars to the programs
    (0-d device tensors in ``.raw``), so one graph per prompt bucket
    serves every slot. The prefill (``transformer.prefill_into_slot``,
    attention through kernel 5) samples its token on kernel 2's
    threefry stream, ``paddle_tpu``'s ``sample_tokens(logits,
    PRNGKey(seed), ...)``; the decode step
    (``transformer.decode_step_slots``) on its hashed stream, the JAX
    engine's Pallas epilogue. Only int32 ids leave the device; the arena
    is updated in place and returned. ``params`` may be the int8-weight
    tree."""
    from paddle_tpu_torch.models import transformer

    def prefill_fn(params, cache, tokens, length, slot, temperature, top_k,
                   seed):
        logits, cache = transformer.prefill_into_slot(
            params, cache, tokens, length, slot, cfg)
        return kdecode.fused_sample(logits, seed, temperature, top_k,
                                    stream="threefry"), cache

    def decode_fn(params, cache, tokens, pos, active, temperature, top_k,
                  seed):
        logits, cache = transformer.decode_step_slots(
            params, cache, tokens, pos, active, cfg)
        return kdecode.fused_sample(logits, seed, temperature, top_k), cache

    progs = _programs({"prefill": prefill_fn, "decode": decode_fn}, tracker,
                      context)
    return progs["prefill"], progs["decode"]


def paged_step_fns(cfg, block_size: int, *, tracker=None, context=None):
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
    tensors. ``context`` (default: a new one) is the programs'
    ``graphs.GraphContext``. Both tails sample with the
    ``fused_sample`` kernel wrapper, so only int32 ids leave the
    device, each on ``paddle_tpu``'s
    stream: the prefill tail on the threefry stream, bitwise
    ``paddle_tpu``'s ``sample_tokens(logits, jax.random.PRNGKey(seed),
    ...)``; the decode tail on the hashed stream of ``paddle_tpu``'s
    Pallas ``fused_sample``. The pool is updated in place and returned.
    ``params`` may be the int8-weight tree of
    ``io/lm_serving.quantize_lm_params`` and the pool a quantized one:
    both steps take them as they are (``paddle_tpu``'s ``_prefill_live``
    and ``_decode_live``; the per-layer dequant is in
    ``models/transformer.py``)."""
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

    progs = _programs({"prefill": prefill_fn, "decode": decode_fn}, tracker,
                      context)
    return progs["prefill"], progs["decode"]


def paged_spec_fns(cfg, draft_cfg, block_size: int, spec_k: int, *,
                   tracker=None, context=None):
    """The speculative-decoding programs of the paged spec engine,
    beside (never instead of) the :func:`paged_step_fns` pair: a dict of
    four step programs under the JAX tracker names, sharing ``context``
    (the target pair's: one capture stream, one graph memory pool).
    ``spec_k`` fixes the proposal depth; a verify window has
    ``W = spec_k + 1`` rows (the last accepted token and the k
    proposals).

    - ``propose`` (``serving_engine.propose``): ``(draft_params,
      draft_pool, last [B], pos [B], active [B], valid [B], pages [B, P])
      -> (proposals [B, k] int32, draft_pool)`` — k greedy draft decode
      steps and their argmax in one program (one graph on the card, the
      counterpart of the JAX ``lax.scan``). Step j's pool write is masked to
      ``active & (j < valid)``: the engine allocates pages only through
      ``pos + valid - 1``, and a write past that would land through the
      zeroed page-table tail in another slot's block 0. Proposals past
      the mask are unused.
    - ``verify`` (``serving_engine.verify``): ``(params, pool, window
      [B, W], pos, valid, active, pages, temperature [B], top_k [B],
      seed) -> (sampled [B, W], n [B], pool)`` — ``transformer.
      verify_step_paged`` and the accept/reject tail
      ``fused_spec_verify``; only these int32 outputs reach the host.
    - ``draft_verify`` (``serving_engine.draft_verify``): ``(draft_params,
      draft_pool, window, pos, valid, active, pages) -> draft_pool`` —
      the draft's forced-window write on a preempted request's replay,
      where propose's own proposals would differ from the forced
      history. Its logits are unused.
    - ``draft_prefill`` (``serving_engine.draft_prefill``):
      ``(draft_params, draft_pool, tokens [1, C], length, pages [P]) ->
      draft_pool`` — the draft's chunk prefill on the target's chunk
      grid and page vectors (kernels 3 and 4); the first token is the
      target prefill's.

    Every pool is updated in place and, where returned, returned."""
    from paddle_tpu_torch.models import transformer

    k = int(spec_k)
    if k < 1:
        raise ValueError(f"spec_k must be >= 1, got {spec_k}")

    def propose_fn(draft_params, draft_pool, last, pos, active, valid,
                   pages):
        toks, p, props = last, pos, []
        for j in range(k):
            lg, draft_pool = transformer.decode_step_paged(
                draft_params, draft_pool, toks, p, active & (j < valid),
                pages, draft_cfg, block_size=block_size)
            toks = torch.argmax(lg, dim=-1).to(torch.int32)
            props.append(toks)
            p = p + 1
        return torch.stack(props, dim=1), draft_pool

    def verify_fn(params, pool, window, pos, valid, active, pages,
                  temperature, top_k, seed):
        logits, pool = transformer.verify_step_paged(
            params, pool, window, pos, valid, active, pages, cfg,
            block_size=block_size)
        sampled, n = kdecode.fused_spec_verify(
            logits, window[:, 1:], seed, temperature, top_k, valid)
        return sampled, n, pool

    def draft_verify_fn(draft_params, draft_pool, window, pos, valid,
                        active, pages):
        _, draft_pool = transformer.verify_step_paged(
            draft_params, draft_pool, window, pos, valid, active, pages,
            draft_cfg, block_size=block_size)
        return draft_pool

    def draft_prefill_fn(draft_params, draft_pool, tokens, length, pages):
        _, draft_pool = transformer.prefill_into_blocks(
            draft_params, draft_pool, tokens, length, pages, draft_cfg,
            block_size=block_size)
        return draft_pool

    return _programs({"propose": propose_fn, "verify": verify_fn,
                      "draft_verify": draft_verify_fn,
                      "draft_prefill": draft_prefill_fn}, tracker, context)
