"""Chunked-prefill kernels (counterpart of
``paddle_tpu/ops/pallas/prefill.py``).

- :func:`flash_chunk_prefill` — one prompt chunk's attention against
  its pool-resident context (``csrc/chunk_prefill.cu``);
- :func:`paged_span_write` — the chunk's masked span writes into its
  pool pages, in place (``csrc/span_write.cu``).

Wrappers as in ``ops/kernels/decode.py``: a CUDA tensor launches the
hand-written kernel or raises, a CPU tensor runs the ``*_plain``
version, and ``<wrapper>.launches`` counts kernel launches. Quantized
pools raise ``NotImplementedError``.
"""

import math
from typing import Dict

import torch

from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.ops.kernels.decode import (NEG_INF, _no_quant,
                                                 _softmax_exact)

_PREFILL_THREADS = 256         # csrc/chunk_prefill.cu: kThreads
_PREFILL_TILE = 32             # csrc/chunk_prefill.cu: kTile
_PREFILL_MAX_OUT = 16          # csrc/chunk_prefill.cu: kMaxOut
_PREFILL_ROWS = 16             # query rows per CTA, halved to fit smem


# ---------------------------------------------------------------------------
# chunk attention
# ---------------------------------------------------------------------------


def flash_chunk_prefill_plain(q, k_chunk, v_chunk, k, v, pages, *,
                              block_size: int):
    """Plain version: gather the context through ``pages``, append the
    chunk's own K/V, context fully visible and chunk causal, scores
    divided by sqrt(Dh), -1e30 mask, one exact softmax, ``p @ V``.

    q [C, Hkv, G, Dh], k_chunk/v_chunk [C, Hkv, Dh], k/v [Hkv, M, Dh],
    pages [P_ctx] int32 -> fp32 [C, Hkv, G, Dh]."""
    C, Hkv, G, Dh = q.shape
    bs = int(block_size)
    S = pages.shape[0] * bs
    offs = torch.arange(bs, device=q.device)
    gidx = (pages.long()[:, None] * bs + offs).reshape(S)
    kall = torch.cat([k[:, gidx].float(),
                      k_chunk.float().transpose(0, 1)], dim=1)
    vall = torch.cat([v[:, gidx].float(),
                      v_chunk.float().transpose(0, 1)], dim=1)
    s = torch.einsum("ckgd,ktd->ckgt", q.float(), kall) / math.sqrt(Dh)
    attend = torch.cat(
        [torch.ones((C, S), dtype=torch.bool, device=q.device),
         torch.ones((C, C), dtype=torch.bool, device=q.device).tril()],
        dim=1)
    s = torch.where(attend[:, None, None, :], s, NEG_INF)
    return torch.einsum("ckgt,ktd->ckgd", _softmax_exact(s), vall)


def prefill_rows_per_cta(C: int, G: int, Dh: int, S: int):
    """(query rows per CTA, shared-memory bytes) for one chunk: the
    staged q rows, one key/value tile and the rows' exact score rows
    over S + C columns. Halves the rows until they fit; raises when
    even one row's scores exceed the limit."""
    rows = min(_PREFILL_ROWS, max(1, C * G),
               _PREFILL_MAX_OUT * _PREFILL_THREADS // Dh)
    while True:
        smem = 4 * (rows * Dh + _PREFILL_TILE * (Dh + 1) + rows * (S + C))
        if smem <= _build.SMEM_LIMIT:
            return rows, smem
        if rows == 1:
            raise ValueError(f"flash_chunk_prefill: one query row's "
                             f"scores over {S + C} columns need {smem} "
                             f"bytes of shared memory, over the "
                             f"{_build.SMEM_LIMIT}-byte limit")
        rows //= 2


def flash_chunk_prefill(q, k_chunk, v_chunk, k, v, pages, *,
                        block_size: int, kv_dtype: str = "none"):
    """One prefill chunk's attention against its pool-resident context.

    q [C, Hkv, G, Dh] and k_chunk/v_chunk [C, Hkv, Dh] (the chunk's own
    fresh K/V) in the model dtype; k/v the pool [Hkv, M, Dh] in the same
    dtype; pages [P_ctx] int32, the context's pages (context length
    S = P_ctx * block_size; P_ctx = 0 is a cold chunk) -> fp32
    [C, Hkv, G, Dh]."""
    _no_quant(kv_dtype)
    if _build.on_cpu(q, "flash_chunk_prefill"):
        return flash_chunk_prefill_plain(q, k_chunk, v_chunk, k, v, pages,
                                         block_size=block_size)
    C, Hkv, G, Dh = q.shape
    bs = int(block_size)
    dev = q.device
    _build.require(q, "q", device=dev, dtype=tuple(_build.DTYPE_CODES),
                   ndim=4)
    _build.require(k_chunk, "k_chunk", device=dev, dtype=q.dtype,
                   shape=(C, Hkv, Dh))
    _build.require(v_chunk, "v_chunk", device=dev, dtype=q.dtype,
                   shape=(C, Hkv, Dh))
    _build.require(k, "k", device=dev, dtype=q.dtype, ndim=3)
    M = k.shape[1]
    _build.require(k, "k", device=dev, shape=(Hkv, M, Dh))
    _build.require(v, "v", device=dev, dtype=q.dtype, shape=(Hkv, M, Dh))
    _build.require(pages, "pages", device=dev, dtype=torch.int32, ndim=1)
    P_ctx = pages.shape[0]
    rows, smem = prefill_rows_per_cta(C, G, Dh, P_ctx * bs)
    out = torch.empty((C, Hkv, G, Dh), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _build.library().pk_chunk_prefill(
            _build.ptr(q), _build.ptr(k_chunk), _build.ptr(v_chunk),
            _build.ptr(k), _build.ptr(v), _build.ptr(pages), _build.ptr(out),
            C, Hkv, G, Dh, M, P_ctx, bs, rows, math.sqrt(Dh),
            _build.DTYPE_CODES[q.dtype], smem, _build.stream(dev))
    _build.check(err, "flash_chunk_prefill")
    flash_chunk_prefill.launches += 1
    return out


flash_chunk_prefill.launches = 0


# ---------------------------------------------------------------------------
# masked span write
# ---------------------------------------------------------------------------


def _span_names(spans: Dict[str, torch.Tensor]):
    if set(spans) != {"k", "v"}:
        raise NotImplementedError(
            f"paged_span_write: arrays {sorted(spans)}; quantized pools "
            f"(scale tables) are not ported yet — only {{'k', 'v'}}")


def paged_span_write_plain(pool, spans, pages, valid, *, block_size: int):
    """Plain version: indexed assignment of the valid rows only."""
    _span_names(spans)
    bs = int(block_size)
    offs = torch.arange(bs, device=pages.device)
    rows = (pages.long()[:, None] * bs + offs).reshape(-1)
    keep = valid.nonzero()[:, 0]
    for name in ("k", "v"):
        pool[name][:, :, rows[keep]] = spans[name][:, :, keep]
    return pool


def paged_span_write(pool: Dict[str, torch.Tensor],
                     spans: Dict[str, torch.Tensor], pages, valid, *,
                     block_size: int) -> Dict[str, torch.Tensor]:
    """Write one chunk's spans into its pool pages, masked per row, IN
    PLACE (``paddle_tpu``'s version returns new arrays; this one writes
    the pool it is given and returns it).

    ``pool`` {"k", "v"} [L, Hkv, M, Dh]; ``spans`` {"k", "v"}
    [L, Hkv, pc*bs, Dh] in the pool dtype; ``pages`` [pc] int32 the
    chunk's pages; ``valid`` [pc*bs] bool — rows with False keep the
    pool's old bytes."""
    _span_names(spans)
    pk, pv, sk, sv = pool["k"], pool["v"], spans["k"], spans["v"]
    if _build.on_cpu(pk, "paged_span_write"):
        return paged_span_write_plain(pool, spans, pages, valid,
                                      block_size=block_size)
    bs = int(block_size)
    dev = pk.device
    _build.require(pk, "pool['k']", device=dev, ndim=4)
    L, Hkv, M, Dh = pk.shape
    _build.require(pv, "pool['v']", device=dev, dtype=pk.dtype,
                   shape=pk.shape)
    _build.require(pages, "pages", device=dev, dtype=torch.int32, ndim=1)
    pc = pages.shape[0]
    for name, t in (("spans['k']", sk), ("spans['v']", sv)):
        _build.require(t, name, device=dev, dtype=pk.dtype,
                       shape=(L, Hkv, pc * bs, Dh))
    _build.require(valid, "valid", device=dev, dtype=torch.bool,
                   shape=(pc * bs,))
    row_bytes = Dh * pk.element_size()
    if row_bytes % 4 or any(t.data_ptr() % 16 for t in (pk, pv, sk, sv)):
        raise ValueError(f"paged_span_write: needs 4-byte multiple rows "
                         f"({row_bytes} bytes) and 16-byte aligned "
                         f"buffers")
    with torch.cuda.device(dev):
        err = _build.library().pk_span_write(
            _build.ptr(pk), _build.ptr(pv), _build.ptr(sk), _build.ptr(sv),
            _build.ptr(pages), _build.ptr(valid), L * Hkv, pc, M, bs,
            row_bytes, _build.stream(dev))
    _build.check(err, "paged_span_write")
    paged_span_write.launches += 1
    return pool


paged_span_write.launches = 0
