"""Chunked-prefill kernels (counterpart of
``paddle_tpu/ops/pallas/prefill.py``).

- :func:`flash_chunk_prefill` — one prompt chunk's attention against
  its pool-resident context (``csrc/chunk_prefill.cu``, on the tensor
  cores: bf16 queries, and fp32 queries with every operand split into
  three bf16 terms);
- :func:`paged_span_write` — the chunk's masked span writes into its
  pool pages, in place (``csrc/span_write.cu``).

Wrappers as in ``ops/kernels/decode.py``: a CUDA tensor launches the
hand-written kernel or raises, a CPU tensor runs the ``*_plain``
version, and ``<wrapper>.launches`` counts kernel launches per pool
storage (``{"none", "int8", "int4"}``). A cold chunk reads no pool and
counts as ``"none"`` whatever the pool's storage: it runs the
model-dtype instantiation.
"""

import math
from typing import Dict

import torch

from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.ops.kernels.decode import (NEG_INF, _softmax_exact,
                                                 arrival_counters,
                                                 check_scales, gather_rows,
                                                 require_pool)

# the tensor-core kernel (csrc/chunk_prefill.cu, csrc/flash_tc.cuh)
_TC_ROWS = 64                  # kRows: query rows and columns per tile
_TC_SPLIT_TILES = 2            # kSplitTiles: column tiles per CTA
TC_HEAD_DIMS = (32, 64, 96, 128)   # chunk_prefill.cu's head-dim switch


# ---------------------------------------------------------------------------
# chunk attention
# ---------------------------------------------------------------------------


def flash_chunk_prefill_plain(q, k_chunk, v_chunk, k, v, pages, *,
                              block_size: int, k_scale=None, v_scale=None,
                              kv_dtype: str = "none"):
    """Plain version: gather the context through ``pages`` (widened
    through ``dequantize_kv`` for a quantized pool), append the chunk's
    own K/V, context fully visible and chunk causal, scores divided by
    sqrt(Dh), -1e30 mask, one exact softmax, ``p @ V``.

    q [C, Hkv, G, Dh], k_chunk/v_chunk [C, Hkv, Dh], k/v
    [Hkv, M, Dh-stored], k_scale/v_scale [Hkv, M] or None, pages [P_ctx]
    int32 -> fp32 [C, Hkv, G, Dh]."""
    kv = _build.kv_store(kv_dtype, "flash_chunk_prefill")
    check_scales(kv, k_scale, v_scale, "flash_chunk_prefill")
    C, Hkv, G, Dh = q.shape
    bs = int(block_size)
    S = pages.shape[0] * bs
    offs = torch.arange(bs, device=q.device)
    gidx = (pages.long()[:, None] * bs + offs).reshape(S)
    kall = torch.cat([gather_rows(k, k_scale, gidx, kv),
                      k_chunk.float().transpose(0, 1)], dim=1)
    vall = torch.cat([gather_rows(v, v_scale, gidx, kv),
                      v_chunk.float().transpose(0, 1)], dim=1)
    s = torch.einsum("ckgd,ktd->ckgt", q.float(), kall) / math.sqrt(Dh)
    attend = torch.cat(
        [torch.ones((C, S), dtype=torch.bool, device=q.device),
         torch.ones((C, C), dtype=torch.bool, device=q.device).tril()],
        dim=1)
    s = torch.where(attend[:, None, None, :], s, NEG_INF)
    return torch.einsum("ckgt,ktd->ckgd", _softmax_exact(s), vall)


def prefill_tc_splits(C: int, G: int, Dh: int, S: int):
    """(row tiles, splits, partial floats) of the tensor-core kernel,
    either query dtype: the grid is (kv-head, 64-row tile of the C * G
    query rows, split), a split taking 2 consecutive 64-column tiles
    (context tiles, then the chunk's) of its row tile; a row tile whose
    columns span more than one split combines fp32 partials, per
    (kv-head, row tile, split) an unnormalized [64, Dh] output and a
    (max, sum) per row (the counts here are per kv-head)."""
    row_tiles = -(-C * G // _TC_ROWS)
    col_tiles = -(-S // _TC_ROWS) + (C - 1) // _TC_ROWS + 1
    splits = -(-col_tiles // _TC_SPLIT_TILES)
    return row_tiles, splits, row_tiles * splits * _TC_ROWS * (Dh + 2)


def prefill_layout(C: int, G: int, Dh: int, S: int, dtype,
                   kv_dtype: str = "none"):
    """(query rows per CTA, shared-memory bytes) of one chunk's launch
    (``chunk_prefill.cu``'s ``Plan``), head dims ``TC_HEAD_DIMS`` only
    (others raise ValueError): 64 rows, and bytes that do not grow with
    the chunk or the context. bf16 queries: the q tile and two-stage K
    and V rings (head dim padded to whole 64-column blocks) and, for a
    quantized context, a two-stage ring of K and V codes. fp32 queries:
    three bf16 term tiles each of q, K and V (one stage) and one raw
    buffer of the K and V rows in flight, fp32 rows or codes. Then, for
    a quantized context, two stages of K and V row scales; and 1024
    bytes of alignment slack."""
    if Dh not in TC_HEAD_DIMS:
        raise ValueError(f"flash_chunk_prefill: head dim {Dh} not in "
                         f"{TC_HEAD_DIMS}")
    kv = _build.kv_store(kv_dtype, "flash_chunk_prefill")
    fp32 = dtype == torch.float32
    tile = _TC_ROWS * (-(-Dh // 64) * 64) * 2
    terms, stages = (3, 1) if fp32 else (1, 2)
    smem = (terms + 2 * stages * terms) * tile + 1024
    if fp32:
        smem += 2 * _TC_ROWS * 4 * Dh
    elif kv != "none":
        smem += 4 * _TC_ROWS * (Dh // 2 if kv == "int4" else Dh)
    if kv != "none":
        smem += 4 * _TC_ROWS * 4
    return _TC_ROWS, smem


def flash_chunk_prefill(q, k_chunk, v_chunk, k, v, pages, *,
                        block_size: int, k_scale=None, v_scale=None,
                        kv_dtype: str = "none"):
    """One prefill chunk's attention against its pool-resident context.

    q [C, Hkv, G, Dh] and k_chunk/v_chunk [C, Hkv, Dh] (the chunk's own
    fresh K/V, exact) in the model dtype; k/v the pool [Hkv, M, Dh] in
    the same dtype, or for ``kv_dtype`` "int8"/"int4" int8 codes
    [Hkv, M, Dh] / nibble-packed [Hkv, M, Dh/2] with fp32 row scales
    ``k_scale``/``v_scale`` [Hkv, M]; pages [P_ctx] int32, the
    context's pages (context length S = P_ctx * block_size; P_ctx = 0
    is a cold chunk) -> fp32 [C, Hkv, G, Dh]. Any other ``kv_dtype``
    raises ValueError. On the card both query dtypes run the
    tensor-core kernel, which takes head dims 32, 64, 96 and 128 and
    16-byte aligned operands (others raise ValueError; nothing is
    copied) and, like decode, shares the arrival counters of
    ``decode.arrival_counters`` between the launches of one stream."""
    kv = _build.kv_store(kv_dtype, "flash_chunk_prefill")
    check_scales(kv, k_scale, v_scale, "flash_chunk_prefill")
    if _build.on_cpu(q, "flash_chunk_prefill"):
        return flash_chunk_prefill_plain(
            q, k_chunk, v_chunk, k, v, pages, block_size=block_size,
            k_scale=k_scale, v_scale=v_scale, kv_dtype=kv)
    C, Hkv, G, Dh = q.shape
    bs = int(block_size)
    dev = q.device
    _build.require(q, "q", device=dev, dtype=tuple(_build.DTYPE_CODES),
                   ndim=4)
    _build.require(k_chunk, "k_chunk", device=dev, dtype=q.dtype,
                   shape=(C, Hkv, Dh))
    _build.require(v_chunk, "v_chunk", device=dev, dtype=q.dtype,
                   shape=(C, Hkv, Dh))
    M = require_pool(k, v, k_scale, v_scale, kv, q.dtype, Hkv, Dh, dev,
                     "flash_chunk_prefill")
    _build.require(pages, "pages", device=dev, dtype=torch.int32, ndim=1)
    P_ctx = pages.shape[0]
    # a cold chunk reads no pool: the model-dtype instantiation serves it
    branch = kv if P_ctx else "none"
    rows, smem = prefill_layout(C, G, Dh, P_ctx * bs, q.dtype, branch)
    if any(t.data_ptr() % 16 for t in (q, k_chunk, v_chunk, k, v)):
        raise ValueError("flash_chunk_prefill: operands must be 16-byte "
                         "aligned")
    n_out = C * Hkv * G * Dh
    stream = _build.stream(dev)
    row_tiles, _, part = prefill_tc_splits(C, G, Dh, P_ctx * bs)
    part *= Hkv
    counters = arrival_counters(dev, stream, Hkv * row_tiles)
    # the output and the split combine's partials in one allocation
    buf = torch.empty(n_out + part, dtype=torch.float32, device=dev)
    out = buf[:n_out].view(C, Hkv, G, Dh)
    with _build.on_device(dev):
        err = _build.library().pk_chunk_prefill(
            _build.ptr(q), _build.ptr(k_chunk), _build.ptr(v_chunk),
            _build.ptr(k), _build.ptr(v), _build.ptr(k_scale),
            _build.ptr(v_scale), _build.ptr(pages), _build.ptr(out),
            out.data_ptr() + 4 * n_out,
            _build.ptr(counters), C, Hkv, G, Dh, M, P_ctx, bs, rows,
            math.sqrt(Dh),
            _build.DTYPE_CODES[q.dtype], _build.KV_CODES[kv], smem, stream)
    _build.check(err, "flash_chunk_prefill")
    flash_chunk_prefill.launches[branch] += 1
    return out


flash_chunk_prefill.launches = _build.new_launch_counts()


# ---------------------------------------------------------------------------
# masked span write
# ---------------------------------------------------------------------------


def span_names(kv_dtype) -> tuple:
    """The pool arrays one span write covers: k and v, plus the scale
    tables for a quantized pool."""
    if _build.kv_store(kv_dtype, "paged_span_write") == "none":
        return ("k", "v")
    return ("k", "v", "k_scale", "v_scale")


def _check_names(spans, kv_dtype) -> tuple:
    names = span_names(kv_dtype)
    if set(spans) != set(names):
        raise ValueError(f"paged_span_write: arrays {sorted(spans)}, "
                         f"expected {sorted(names)} for kv_dtype "
                         f"{kv_dtype!r}")
    return names


def paged_span_write_plain(pool, spans, pages, valid, *, block_size: int,
                           kv_dtype: str = "none"):
    """Plain version: indexed assignment of the valid rows only, array
    by array."""
    names = _check_names(spans, kv_dtype)
    bs = int(block_size)
    offs = torch.arange(bs, device=pages.device)
    rows = (pages.long()[:, None] * bs + offs).reshape(-1)
    keep = valid.nonzero()[:, 0]
    for name in names:
        pool[name][:, :, rows[keep]] = spans[name][:, :, keep]
    return pool


def paged_span_write(pool: Dict[str, torch.Tensor],
                     spans: Dict[str, torch.Tensor], pages, valid, *,
                     block_size: int,
                     kv_dtype: str = "none") -> Dict[str, torch.Tensor]:
    """Write one chunk's spans into its pool pages, masked per row, IN
    PLACE (``paddle_tpu``'s version returns new arrays; this one writes
    the pool it is given and returns it), every array in one launch.

    ``pool`` {"k", "v"} [L, Hkv, M, Dh] in the model dtype, or for
    ``kv_dtype`` "int8"/"int4" also {"k_scale", "v_scale"} [L, Hkv, M]
    fp32 beside int8 values [L, Hkv, M, Dh] / [L, Hkv, M, Dh/2];
    ``spans`` the same names [L, Hkv, pc*bs, ...] in the same dtypes;
    ``pages`` [pc] int32 the chunk's pages; ``valid`` [pc*bs] bool —
    rows with False keep the pool's old bytes."""
    kv = _build.kv_store(kv_dtype, "paged_span_write")
    names = _check_names(spans, kv)
    k = pool["k"]
    if _build.on_cpu(k, "paged_span_write"):
        return paged_span_write_plain(pool, spans, pages, valid,
                                      block_size=block_size, kv_dtype=kv)
    bs = int(block_size)
    dev = k.device
    if k.dim() != 4:
        _build.require(k, "pool['k']", device=dev, ndim=4)
    L, Hkv, M, _ = k.shape
    pc = pages.shape[0] if pages.dim() == 1 else -1
    # every operand checked in one pass; a failure is named by require
    value_dtype = torch.int8 if kv != "none" else k.dtype
    arrays = [(name, pool[name], spans[name]) for name in names]
    ok = (pages.device == dev and pages.dtype == torch.int32
          and pages.is_contiguous() and valid.device == dev
          and valid.dtype == torch.bool and valid.is_contiguous()
          and valid.shape == (pc * bs,))
    pool_rows, span_rows = (L, Hkv, M), (L, Hkv, pc * bs)
    ptrs, srcs, row_bytes = [None] * 4, [None] * 4, [0] * 4
    for i, (name, p, t) in enumerate(arrays):
        dt = torch.float32 if name.endswith("_scale") else value_dtype
        ptrs[i], srcs[i] = p.data_ptr(), t.data_ptr()
        ok = ok and (p.dtype == dt and t.dtype == dt and p.device == dev
                     and t.device == dev and p.is_contiguous()
                     and t.is_contiguous() and p.dim() <= 4
                     and p.shape[:3] == pool_rows
                     and t.shape == span_rows + p.shape[3:]
                     and not (ptrs[i] | srcs[i]) % 16)
        # contiguous: a row's elements are the stride of the row axis
        row_bytes[i] = p.stride(2) * p.element_size() if ok else 0
    if not ok:
        _span_write_fault(arrays, pages, valid, dev, value_dtype, bs)
    n = len(arrays)
    with _build.on_device(dev):
        err = _build.library().pk_span_write(
            *ptrs, *srcs, *row_bytes, n, pages.data_ptr(), valid.data_ptr(),
            L * Hkv, pc, M, bs, _build.stream(dev))
    _build.check(err, "paged_span_write")
    paged_span_write.launches[kv] += 1
    return pool


def _span_write_fault(arrays, pages, valid, dev, value_dtype, bs):
    """Raise ValueError naming the first operand of a span write that
    the kernel does not take."""
    L, Hkv, M, _ = arrays[0][1].shape
    _build.require(pages, "pages", device=dev, dtype=torch.int32, ndim=1)
    pc = pages.shape[0]
    _build.require(valid, "valid", device=dev, dtype=torch.bool,
                   shape=(pc * bs,))
    for name, p, t in arrays:
        dt = torch.float32 if name.endswith("_scale") else value_dtype
        _build.require(p, f"pool[{name!r}]", device=dev, dtype=dt)
        if tuple(p.shape[:3]) != (L, Hkv, M) or p.dim() > 4:
            raise ValueError(f"paged_span_write: pool[{name!r}] shape "
                             f"{tuple(p.shape)}, expected ({L}, {Hkv}, "
                             f"{M}[, row])")
        _build.require(t, f"spans[{name!r}]", device=dev, dtype=dt,
                       shape=(L, Hkv, pc * bs) + tuple(p.shape[3:]))
        if p.data_ptr() % 16 or t.data_ptr() % 16:
            raise ValueError(f"paged_span_write: {name!r} buffers must be "
                             f"16-byte aligned")
    raise ValueError("paged_span_write: operands the kernel does not take")


paged_span_write.launches = _build.new_launch_counts()
