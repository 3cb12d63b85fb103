"""Model FLOPs and MFU (counterpart of ``paddle_tpu/observe/costs.py``).

The JAX package takes a step's FLOPs from XLA's lowered cost analysis;
PyTorch runs eagerly and has no such program. The port counts them two
ways:

- for the transformer LM, from the shapes: 2 FLOPs per multiply-add of
  every weight a token touches, plus the attention products over the
  positions it attends to (``decode_step_flops``, ``train_step_flops``);
- for the layer API's graphs, by running the computation once under
  ``torch.utils.flop_counter.FlopCounterMode`` (``counted_flops``): its
  table counts matmuls and convolutions, forward and backward, at 2 FLOPs
  per multiply-add (a [M, K] @ [K, N] product is exactly 2MNK, as XLA's
  cost model counts it); elementwise work is not counted.

MFU divides by the declared peak of ``core/place.py``'s table
(``device_peak_flops``; ``PADDLE_TPU_PEAK_TFLOPS`` overrides it).
"""

from typing import Callable, Iterable, Optional


def matmul_params(cfg) -> int:
    """Weights one token multiplies through: per layer qkv, attn_out,
    mlp_in, mlp_out, plus the tied vocab head."""
    D, F, kvd = cfg.d_model, cfg.d_ff, cfg.kv_heads * cfg.head_dim
    per_layer = D * (D + 2 * kvd) + D * D + 2 * D * F
    return cfg.n_layers * per_layer + D * cfg.vocab


def decode_step_flops(cfg, positions: Iterable[int]) -> float:
    """Model FLOPs of one decode step whose active rows sit at
    ``positions``: 2 x weights touched per row, plus q@K^T and p@V over
    the ``pos + 1`` positions each row attends to (2 FLOPs per
    multiply-add, two products, every query head)."""
    positions = list(positions)
    attn = sum(4 * cfg.n_layers * cfg.n_heads * cfg.head_dim * (p + 1)
               for p in positions)
    return float(2 * matmul_params(cfg) * len(positions) + attn)


def verify_step_flops(cfg, positions: Iterable[int], window: int) -> float:
    """Model FLOPs of one speculative verify step over the slots at
    ``positions``: every one of their ``window`` rows, row j of a slot
    at ``pos + j`` (the program computes them all, valid or not)."""
    return decode_step_flops(cfg, [p + j for p in positions
                                   for j in range(int(window))])


def train_step_flops(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of one training step on ``batch`` x ``seq`` tokens:
    6 x weights touched per token (2 forward, 4 backward), plus causal
    attention: each query sees ``pos + 1`` keys, T(T+1)/2 pairs per
    sequence, and each pair costs 4 Dh FLOPs forward (q.k and p.v) and
    8 Dh backward (four products), per head and layer."""
    tokens = batch * seq
    pairs = batch * seq * (seq + 1) // 2
    attn = 12 * cfg.n_layers * cfg.n_heads * cfg.head_dim * pairs
    return float(6 * matmul_params(cfg) * tokens + attn)


def counted_flops(fn: Callable[[], object]) -> float:
    """FLOPs of running ``fn()`` once, as ``FlopCounterMode`` counts
    them (2 per multiply-add of every matmul and convolution the call
    dispatches, its autograd backward included when ``fn`` takes
    gradients)."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


def device_peak_flops(device=None) -> Optional[float]:
    """Declared peak FLOP/s of ``device`` (default: the first card;
    ``core/place.py``'s table, ``PADDLE_TPU_PEAK_TFLOPS`` overriding
    it); None when unknown or when there is no card."""
    from paddle_tpu_torch.core import place
    try:
        return place.peak_flops(device)
    except RuntimeError:          # no card and no override
        return None


_FIRST_CARD = object()


def mfu(flops: Optional[float], seconds: float,
        peak_flops=_FIRST_CARD) -> Optional[float]:
    """Model-FLOPs utilisation of one step; None when an input is
    unknown (a ``peak_flops`` of None: the CPU has no declared peak).
    Without ``peak_flops``, the first card's (``device_peak_flops()``)."""
    if peak_flops is _FIRST_CARD:
        peak_flops = device_peak_flops()
    if not flops or not peak_flops or seconds <= 0:
        return None
    return flops / (seconds * peak_flops)
