"""The benchmark's yardstick: model FLOPs, kernel operations and bytes,
and the card's published peaks.

Frozen copies, so that a change to the program cannot move the
yardstick it is judged by. The model FLOPs are
``paddle_tpu_torch/observe/costs.py``'s arithmetic (``matmul_params``,
``decode_step_flops``, ``train_step_flops``); the kernels' operations
and bytes are the bound formulas of the port's kernel table
(``chip_smoke.py``: ``bound`` and the byte counts beside each kernel),
written here per call from the shapes the window drove. Each input byte
is counted once and each output byte once; only the rows a call needed
count (an inactive decode slot that the kernel still computes is work
the kernel wastes, not work the model needs).

``cfg`` is any object with ``vocab``, ``d_model``, ``n_heads``,
``kv_heads``, ``head_dim``, ``n_layers`` and ``d_ff``.
"""

import math
from typing import Iterable, Sequence

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at the full
# 700 W power limit
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

BF16 = 2      # bytes of a bf16 element
F32 = 4
I32 = 4


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


def prefill_chunk_flops(cfg, off: int, c: int) -> float:
    """Model FLOPs of one prefill chunk of ``c`` prompt tokens after
    ``off`` tokens of context: 2 x the block weights per token, the
    vocab head for the chunk's last token only (the chunk samples one
    token), and the attention products of row i over its ``off + i + 1``
    positions."""
    D, V = cfg.d_model, cfg.vocab
    blocks = matmul_params(cfg) - D * V
    seen = c * off + c * (c + 1) // 2
    attn = 4 * cfg.n_layers * cfg.n_heads * cfg.head_dim * seen
    return float(2 * blocks * c + 2 * D * V + attn)


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


def bound_seconds(nbytes: float, flops: float,
                  peak_flops: float = PEAK_BF16_FLOPS) -> float:
    """The least time the card needs: the larger of bytes over the
    memory rate and operations over the peak rate."""
    return max(nbytes / HBM_BYTES_PER_S, flops / peak_flops)


def decode_attention_work(cfg, positions: Sequence[int], block_size: int):
    """(bytes, flops) of kernel 1 (paged decode attention) over every
    layer of one decode step whose active rows sit at ``positions``: each
    row reads its query, the k and v rows of its ``pos + 1`` positions
    and the page-table entries that cover them, its position, and writes
    an fp32 output row."""
    H, Hkv, Dh, L = cfg.n_heads, cfg.kv_heads, cfg.head_dim, cfg.n_layers
    n = len(positions)
    seen = sum(p + 1 for p in positions)
    pages = sum(-(-(p + 1) // block_size) for p in positions)
    per_layer = (n * H * Dh * BF16 + 2 * seen * Hkv * Dh * BF16
                 + pages * I32 + n * I32 + n * H * Dh * F32)
    return float(L * per_layer), float(L * 4 * seen * H * Dh)


def chunk_prefill_work(cfg, off: int, c: int, block_size: int):
    """(bytes, flops) of kernel 3 (chunk prefill attention) over every
    layer of one chunk of ``c`` tokens after ``off`` tokens of context:
    the chunk's q, k and v, the context's k and v rows and page-table
    entries read once, an fp32 output row per token written; row i
    sees the context and the chunk's rows up to itself."""
    H, Hkv, Dh, L = cfg.n_heads, cfg.kv_heads, cfg.head_dim, cfg.n_layers
    per_layer = (c * H * Dh * BF16 + 2 * c * Hkv * Dh * BF16
                 + 2 * off * Hkv * Dh * BF16
                 + (off // block_size) * I32 + c * H * Dh * F32)
    seen = c * off + c * (c + 1) // 2
    return float(L * per_layer), float(L * 4 * seen * H * Dh)


def flash_fwd_work(cfg, batch: int, seq: int):
    """(bytes, flops) of kernel 5 (causal flash attention forward, bf16)
    over every layer of one step: q, k, v read, out written, the fp32
    log-sum-exp written; q.k and p.v over the T(T+1)/2 causal pairs of
    every (sequence, head)."""
    BH = batch * cfg.n_heads
    n = BH * seq * cfg.head_dim
    pairs = BH * seq * (seq + 1) // 2
    return (float(cfg.n_layers * (4 * n * BF16 + BH * seq * F32)),
            float(cfg.n_layers * 4 * cfg.head_dim * pairs))


def flash_bwd_work(cfg, batch: int, seq: int):
    """(bytes, flops) of kernel 6 (causal flash attention backward,
    bf16) over every layer of one step: q, k, v, out, dout and the
    log-sum-exp read, dq, dk, dv written; five products (q.k, do.v,
    p^T do, ds k, ds^T q) over the causal pairs."""
    BH = batch * cfg.n_heads
    n = BH * seq * cfg.head_dim
    pairs = BH * seq * (seq + 1) // 2
    return (float(cfg.n_layers * (8 * n * BF16 + BH * seq * F32)),
            float(cfg.n_layers * 10 * cfg.head_dim * pairs))


def roofline_percent(nbytes: float, flops: float, device_s: float):
    """A kernel's share of its roofline in percent: its least time on the
    card over the time the trace gives it. None without device time."""
    if not device_s or device_s <= 0 or not math.isfinite(device_s):
        return None
    return 100.0 * bound_seconds(nbytes, flops) / device_s
