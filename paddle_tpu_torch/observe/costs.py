"""Model FLOPs and MFU (counterpart of ``paddle_tpu/observe/costs.py``).

The JAX package takes a step's FLOPs from XLA's lowered cost analysis;
PyTorch runs eagerly and has no such program, so the port counts them
from the shapes: 2 FLOPs per multiply-add of every weight a token
touches, plus the attention products over the positions it attends to.
"""

from typing import Iterable, Optional


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


def mfu(flops: Optional[float], seconds: float,
        peak_flops: Optional[float]) -> Optional[float]:
    """Model-FLOPs utilisation of one step; None when an input is
    unknown (the CPU has no declared peak)."""
    if not flops or not peak_flops or seconds <= 0:
        return None
    return flops / (seconds * peak_flops)
