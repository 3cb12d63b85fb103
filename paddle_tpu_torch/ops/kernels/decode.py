"""Decode-step kernels (counterpart of ``paddle_tpu/ops/pallas/decode.py``).

- :func:`flash_decode_attention` — one decode step's attention straight
  off the head-major paged pool (``csrc/decode_attention.cu``);
- :func:`fused_sample` — greedy / top-k / temperature sampling with no
  sort, on the Pallas kernel's hashed stream or on ``jax.random``'s
  threefry stream (``csrc/fused_sample.cu``);
- :func:`fused_spec_verify` — the speculative verify tail: the same
  kernel over a window's B * W rows, then the accept fold.

Each public function is a wrapper around a hand-written Hopper kernel:
a CUDA tensor launches the kernel (or raises on what the kernel does
not take), a CPU tensor runs the plain PyTorch version beside it
(``*_plain``), which the CPU tests hold against the Pallas kernels in
interpret mode. There is no other path. Each wrapper counts its kernel
launches in ``<wrapper>.launches``; ``flash_decode_attention`` counts
them per pool storage (``{"none", "int8", "int4"}``) and
``fused_sample`` per stream (``{"hash", "threefry"}``), one kernel
instantiation each.
"""

import math

import torch

from paddle_tpu_torch.ops import prng, q8
from paddle_tpu_torch.ops.kernels import _build

NEG_INF = -1e30
MASK32 = 0xFFFFFFFF

_DECODE_THREADS = 128          # csrc/decode_attention.cu: kThreads
_DECODE_MAX_G = 8              # csrc/decode_attention.cu: kMaxG
DECODE_SPLIT = 64              # csrc/decode_attention.cu: kSplit
SAMPLE_CLUSTER = 16            # csrc/fused_sample.cu: kCluster
SAMPLE_CAP = 8192              # csrc/fused_sample.cu: kCap
# the dynamic shared memory of a sampler CTA: its slice of the row and
# two lists of SAMPLE_CAP keys, beside < 3 KB of static shared memory
SAMPLE_SMEM_LIMIT = 224 * 1024


def gather_rows(x, scale, idx, kv_dtype: str) -> torch.Tensor:
    """Pool rows ``x[:, idx]`` as fp32: model-dtype rows cast, quantized
    ones through ``ops/q8.dequantize_kv`` with their scales
    ``scale[:, idx]``."""
    if kv_dtype == "none":
        return x[:, idx].float()
    return q8.dequantize_kv(x[:, idx], scale[:, idx], kv_dtype)


def check_scales(kv: str, k_scale, v_scale, kernel: str):
    """A quantized pool needs both scale tables, a model-dtype one
    neither."""
    if (kv != "none") != (k_scale is not None and v_scale is not None):
        raise ValueError(f"{kernel}: kv_dtype {kv!r} takes k_scale and "
                         f"v_scale exactly when it is quantized")


def require_pool(k, v, k_scale, v_scale, kv: str, dtype, Hkv: int, Dh: int,
                 dev, kernel: str):
    """Validate a per-layer pool view [Hkv, M, Dh-stored] (+ fp32 scale
    tables [Hkv, M] when quantized); returns M."""
    if kv != "none":
        dtype = torch.int8
        if Dh % 2:
            raise ValueError(f"{kernel}: int4 needs an even head dim, got "
                             f"{Dh}")
    _build.require(k, "k", device=dev, dtype=dtype, ndim=3)
    M = k.shape[1]
    shape = (Hkv, M, Dh // 2 if kv == "int4" else Dh)
    _build.require(k, "k", device=dev, shape=shape)
    _build.require(v, "v", device=dev, dtype=dtype, shape=shape)
    if kv != "none":
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            _build.require(t, name, device=dev, dtype=torch.float32,
                           shape=(Hkv, M))
    return M


def _softmax_exact(s: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax``'s chain written out: max, exp, sum, divide."""
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    return e / e.sum(dim=-1, keepdim=True)


# ---------------------------------------------------------------------------
# flash-decode attention
# ---------------------------------------------------------------------------


def flash_decode_attention_plain(q, k, v, pages, pos, *, block_size: int,
                                 k_scale=None, v_scale=None,
                                 kv_dtype: str = "none"):
    """Plain version: gather the slots' logical K/V views through the
    page table (widened through ``dequantize_kv`` for a quantized
    pool), divide the scores by sqrt(Dh), mask positions past
    ``pos[b]`` to -1e30, one exact softmax, ``p @ V``.

    q [B, Hkv, G, Dh], k/v [Hkv, M, Dh-stored], k_scale/v_scale
    [Hkv, M] or None, pages [B, P] int32, pos [B] int32 -> fp32
    [B, Hkv, G, Dh]."""
    kv = _build.kv_store(kv_dtype, "flash_decode_attention")
    check_scales(kv, k_scale, v_scale, "flash_decode_attention")
    B, Hkv, G, Dh = q.shape
    bs = int(block_size)
    T = pages.shape[1] * bs
    offs = torch.arange(bs, device=q.device)
    gidx = (pages.long()[:, :, None] * bs + offs).reshape(B, T)
    kt = gather_rows(k, k_scale, gidx, kv)          # [Hkv, B, T, Dh]
    vt = gather_rows(v, v_scale, gidx, kv)
    s = torch.einsum("bkgd,kbtd->bkgt", q.float(), kt) / math.sqrt(Dh)
    attend = (torch.arange(T, device=q.device)[None, :]
              <= pos.long()[:, None])               # [B, T]
    s = torch.where(attend[:, None, None, :], s, NEG_INF)
    return torch.einsum("bkgt,kbtd->bkgd", _softmax_exact(s), vt)


def decode_split_layout(G: int, Dh: int, P: int, block_size: int,
                        dtype=torch.bfloat16, kv_dtype: str = "none"):
    """(splits, shared-memory bytes, partial floats per (slot, head)) of
    one decode launch. A CTA takes ``DECODE_SPLIT`` consecutive logical
    positions of one (slot, kv-head), so the grid has ``splits =
    ceil(P * block_size / DECODE_SPLIT)`` of them per (slot, head); its
    shared memory holds the split's K and V rows at their stored width,
    the G query rows, the split's [G, DECODE_SPLIT] scores, the p @ V
    partial sums, the split's physical rows and row scales, and its
    (max, sum) per query row. A slot whose positions span more than one
    split combines fp32 partials: per (slot, head, split) G * Dh output
    sums and a (max, sum) per query row. Nothing here grows with the
    context beyond the ``splits`` count."""
    kv = _build.kv_store(kv_dtype, "flash_decode_attention")
    row_bytes = {"none": Dh * dtype.itemsize, "int8": Dh,
                 "int4": Dh // 2}[kv]
    groups = max(1, _DECODE_THREADS // Dh)
    splits = -(-P * int(block_size) // DECODE_SPLIT)
    smem = 2 * DECODE_SPLIT * row_bytes + 4 * (
        G * Dh + G * DECODE_SPLIT + groups * G * Dh + 3 * DECODE_SPLIT
        + 2 * G + 1)
    return splits, smem, splits * G * (Dh + 2)


# per (device, stream): the arrival counters of the split combines,
# zeroed once (the combining CTA leaves its counter at 0) and never
# reallocated, so a captured launch keeps its address
COUNTER_CAPACITY = 1 << 16
_COUNTERS = {}


def arrival_counters(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    """The ``COUNTER_CAPACITY`` zeroed int32 arrival counters of
    (``dev``, ``stream``): launches on one stream run in order and share
    them; launches on two streams never do. Raises ValueError for a
    launch that needs more than ``COUNTER_CAPACITY``."""
    if n > COUNTER_CAPACITY:
        raise ValueError(f"a launch needs {n} arrival counters, more than "
                         f"the {COUNTER_CAPACITY} kept per stream")
    buf = _COUNTERS.get((dev, stream))
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            # made inside a capture, the buffer would come from the
            # graph's pool and its zero-fill would be part of the graph
            raise RuntimeError("arrival counters of a stream must exist "
                               "before a capture on it: launch once first")
        buf = torch.zeros(COUNTER_CAPACITY, dtype=torch.int32, device=dev)
        _COUNTERS[(dev, stream)] = buf
    return buf


def flash_decode_attention(q, k, v, pages, pos, *, block_size: int,
                           k_scale=None, v_scale=None,
                           kv_dtype: str = "none"):
    """One decode step of grouped-query attention over the paged pool.

    q [B, Hkv, G, Dh] (model dtype), k/v the pool [Hkv, M, Dh] in the
    same dtype, pages [B, P] int32 physical block ids, pos [B] int32 ->
    fp32 [B, Hkv, G, Dh]. The caller writes the step's new k/v into the
    pool first: position ``pos[b]`` attends to itself. Positions past
    ``P * block_size`` do not exist; a larger ``pos`` sees all of them.

    A quantized pool (``kv_dtype`` "int8" or "int4") passes int8 codes
    k/v [Hkv, M, Dh] (int4: nibble-packed [Hkv, M, Dh/2]) and their
    fp32 row scales ``k_scale``/``v_scale`` [Hkv, M]; the kernel takes
    the codes as they are and applies the row scales to the q . k
    product and to p. Any other ``kv_dtype`` raises ValueError.

    On the card the positions of a slot are split across CTAs
    (``decode_split_layout``) and the splits combined in a fixed order,
    so a slot's output is bitwise the same whatever the batch. The
    combine's arrival counters belong to the stream (``arrival_counters``),
    so launches on different streams may run at once."""
    kv = _build.kv_store(kv_dtype, "flash_decode_attention")
    check_scales(kv, k_scale, v_scale, "flash_decode_attention")
    if _build.on_cpu(q, "flash_decode_attention"):
        return flash_decode_attention_plain(
            q, k, v, pages, pos, block_size=block_size, k_scale=k_scale,
            v_scale=v_scale, kv_dtype=kv)
    B, Hkv, G, Dh = q.shape
    bs = int(block_size)
    dev = q.device
    _build.require(q, "q", device=dev, dtype=tuple(_build.DTYPE_CODES),
                   ndim=4)
    M = require_pool(k, v, k_scale, v_scale, kv, q.dtype, Hkv, Dh, dev,
                     "flash_decode_attention")
    _build.require(pages, "pages", device=dev, dtype=torch.int32, ndim=2)
    P = pages.shape[1]
    _build.require(pages, "pages", device=dev, shape=(B, P))
    _build.require(pos, "pos", device=dev, dtype=torch.int32, shape=(B,))
    if Dh % 32 or Dh > 256 or not 1 <= G <= _DECODE_MAX_G or P * bs < 1:
        raise ValueError(f"flash_decode_attention: needs head_dim a "
                         f"multiple of 32 up to 256, 1 <= G <= "
                         f"{_DECODE_MAX_G} and P * block_size >= 1; got "
                         f"Dh={Dh}, G={G}, P={P}, block_size={bs}")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("flash_decode_attention: the pool views must be "
                         "16-byte aligned")
    splits, smem, part = decode_split_layout(G, Dh, P, bs, q.dtype, kv)
    if splits > 65535 or smem > _build.SMEM_LIMIT:
        raise ValueError(f"flash_decode_attention: {P * bs} positions "
                         f"({splits} splits) or {smem} bytes of shared "
                         f"memory exceed the launch limits")
    BH = B * Hkv
    # the output and the combine's partials in one allocation
    buf = torch.empty(BH * (G * Dh + part), dtype=torch.float32, device=dev)
    out = buf[:BH * G * Dh].view(B, Hkv, G, Dh)
    stream = _build.stream(dev)
    counters = arrival_counters(dev, stream, BH)
    with _build.on_device(dev):
        err = _build.library().pk_decode_attention(
            _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(k_scale),
            _build.ptr(v_scale), _build.ptr(pages), _build.ptr(pos),
            _build.ptr(out),
            out.data_ptr() + 4 * BH * G * Dh,
            _build.ptr(counters), B, Hkv, G, Dh, M, P, bs, math.sqrt(Dh),
            _build.DTYPE_CODES[q.dtype], _build.KV_CODES[kv], smem, stream)
    _build.check(err, "flash_decode_attention")
    flash_decode_attention.launches[kv] += 1
    return out


flash_decode_attention.launches = _build.new_launch_counts()


# ---------------------------------------------------------------------------
# fused sampling epilogue
# ---------------------------------------------------------------------------


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``a * c mod 2**32`` for int64 ``a`` holding uint32 values, split
    in 16-bit halves so no intermediate leaves int64's range."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def sortable_key(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the order-preserving uint32 image, held in int64 (torch's
    uint32 lacks most arithmetic on the CPU): positive floats get the
    sign bit set, negative floats flip every bit."""
    u = x.float().contiguous().view(torch.int32).long() & MASK32
    return u ^ (((u >> 31) * 0x7FFFFFFF) | 0x80000000)


def kth_key(keys: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The k-th largest key per row (1 <= k <= V) by radix select, as
    ``csrc/fused_sample.cu`` finds it: 4 rounds of 8-bit digits from the
    top; each round counts the keys under the prefix found so far per
    digit and takes the digit where the count from the top reaches the
    rank still needed. (The kernel runs its later rounds on the keys
    under the prefix alone once they are few; the counts are the same.)
    keys [B, V], k [B] -> [B]."""
    B = keys.shape[0]
    prefix = torch.zeros(B, dtype=torch.int64, device=keys.device)
    need = k.long()
    for shift in (24, 16, 8, 0):
        under = (keys >> (shift + 8)) == (prefix >> (shift + 8))[:, None]
        hist = torch.zeros(B, 256, dtype=torch.int64, device=keys.device)
        hist.scatter_add_(1, (keys >> shift) & 255, under.long())
        upto = hist.flip(-1).cumsum(-1).flip(-1)     # count of digits >= d
        above = upto - hist
        hit = (above < need[:, None]) & (upto >= need[:, None])
        digit = hit.long().argmax(-1)
        need = need - above.gather(1, digit[:, None])[:, 0]
        prefix = prefix | (digit << shift)
    return prefix


def key_float(keys: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`sortable_key`: the fp32 values whose keys
    are ``keys``."""
    bits = torch.where(keys >= 0x80000000, keys ^ 0x80000000,
                       keys ^ MASK32)
    return bits.to(torch.int32).view(torch.float32)


def hash_uniform(seed: int, rows: torch.Tensor, V: int) -> torch.Tensor:
    """Counter-based uniforms in (0, 1) for (seed, row, lane): the
    splitmix-style hash of ``paddle_tpu``'s ``_hash_uniform``, in uint32
    wraparound, bitwise the same values. rows [B] -> [B, V] fp32."""
    lane = torch.arange(V, dtype=torch.int64, device=rows.device)
    h = ((int(seed) & MASK32)
         + _mul32(rows.long()[:, None], 0x9E3779B9)
         + _mul32(lane[None, :] + 1, 0x85EBCA6B)) & MASK32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    h = h ^ (h >> 16)
    return ((h >> 8).float() + 0.5) * (1.0 / (1 << 24))


def _first_argmax(x: torch.Tensor) -> torch.Tensor:
    """First-index argmax over the last axis, as max + where + min."""
    V = x.shape[-1]
    iota = torch.arange(V, device=x.device)
    m = x.amax(dim=-1, keepdim=True)
    return torch.where(x == m, iota, V).amin(dim=-1)


def top_k_keep(logits: torch.Tensor, top_k: torch.Tensor,
               compare_floats: bool = False) -> torch.Tensor:
    """The kept-lane mask of the top-k filter: [B, V] bool, ties at the
    k-th value kept; k <= 0 keeps everything. Lanes compare their keys
    with the k-th key, or with ``compare_floats`` their values with the
    k-th value as floats (``sample_tokens``' rule, which also keeps a
    -0.0 that ties a +0.0 threshold)."""
    V = logits.shape[-1]
    k = top_k.long().clamp(0, V)
    keys = sortable_key(logits)
    kstar = kth_key(keys, k.clamp(min=1))
    if compare_floats:
        keep = logits >= key_float(kstar)[:, None]
    else:
        keep = keys >= kstar[:, None]
    return (k[:, None] <= 0) | keep


STREAMS = ("hash", "threefry")


def fused_sample_plain(logits, seed, temperature, top_k, stream="hash"):
    """Plain version of the sampling epilogue: logits [B, V] fp32,
    ``seed`` an int32 value (an int or a 0-d int32 tensor), temperature
    [B], top_k [B] -> ids [B] int32, over the ``stream`` ("hash" or
    "threefry") of :func:`fused_sample`."""
    B, V = logits.shape
    x = logits.float()
    greedy = _first_argmax(x)
    threefry = _stream_code(stream)
    z = torch.where(top_k_keep(x, top_k, threefry), x, -math.inf)
    t = temperature.float()
    z = z / torch.where(t > 0, t, 1.0)[:, None]
    if threefry:
        g = prng.gumbel(prng.prng_key(seed, x.device), (B, V))
    else:
        rows = torch.arange(B, device=x.device)
        g = -torch.log(-torch.log(hash_uniform(seed, rows, V)))
    # a hashed uniform that rounds to 1.0 gives g = +inf; on a filtered
    # lane (z = -inf) that is NaN, which must never win the draw (the JAX
    # kernel's max propagates it and returns the out-of-range id V)
    score = z + g
    sampled = _first_argmax(torch.where(score.isnan(), -math.inf, score))
    return torch.where(t > 0, sampled, greedy).to(torch.int32)


def _stream_code(stream: str) -> int:
    if stream not in STREAMS:
        raise ValueError(f"fused_sample: stream {stream!r}, expected one "
                         f"of {STREAMS}")
    return STREAMS.index(stream)


def fused_sample(logits, seed, temperature, top_k, stream="hash"):
    """Sampling epilogue: logits [B, V] fp32, ``seed`` a 0-d int32
    tensor on the logits' device (on the CPU also an int), per-row
    temperature [B] fp32 (<= 0 is greedy) and top_k [B] int32 (<= 0 or
    >= V disables the filter) -> sampled ids [B] int32. The kernel reads
    the seed from device memory, as the TPU kernel takes a device scalar:
    a captured launch draws with whatever seed each replay finds there.

    Greedy rows are the first-index argmax and the kept top-k set is
    exact; the categorical draw is a Gumbel-max over one of two
    streams:

    - ``"hash"`` (the paged decode tail): hashed uniforms of (seed, row,
      lane), bitwise ``paddle_tpu``'s ``fused_sample`` stream; lanes
      kept by key. One departure: a uniform that rounds to exactly 1.0
      on a filtered lane makes that lane's score NaN, which never wins
      here, where the JAX kernel returns the out-of-range id V.
    - ``"threefry"`` (the paged prefill tail): ``paddle_tpu``'s
      ``sample_tokens(logits, jax.random.PRNGKey(seed), ...)``, bitwise:
      the Gumbel noise of ``ops/prng.py`` over the [B, V] batch, lanes
      kept by float compare with the k-th value.

    On the card one launch of ``csrc/fused_sample.cu`` serves either;
    ``fused_sample.launches`` counts them per stream."""
    threefry = _stream_code(stream)
    if _build.on_cpu(logits, "fused_sample"):
        return fused_sample_plain(logits, seed, temperature, top_k, stream)
    dev = logits.device
    _build.require(logits, "logits", device=dev, dtype=torch.float32,
                   ndim=2)
    B, V = logits.shape
    _build.require(temperature, "temperature", device=dev,
                   dtype=torch.float32, shape=(B,))
    _build.require(top_k, "top_k", device=dev, dtype=torch.int32,
                   shape=(B,))
    if 4 * (-(-V // SAMPLE_CLUSTER) + 7 + 2 * SAMPLE_CAP) > SAMPLE_SMEM_LIMIT:
        raise ValueError(f"fused_sample: a row of {V} logits does not fit "
                         f"the shared memory of {SAMPLE_CLUSTER} CTAs")
    if not isinstance(seed, torch.Tensor):
        raise ValueError("fused_sample: on the card the seed is a 0-d int32 "
                         "tensor on the logits' device, read by the kernel")
    _build.require(seed, "seed", device=dev, dtype=torch.int32, shape=())
    out = torch.empty((B,), dtype=torch.int32, device=dev)
    with _build.on_device(dev):
        err = _build.library().pk_fused_sample(
            _build.ptr(logits), _build.ptr(temperature), _build.ptr(top_k),
            _build.ptr(out), B, V, _build.ptr(seed), threefry,
            _build.stream(dev))
    _build.check(err, "fused_sample")
    fused_sample.launches[stream] += 1
    return out


fused_sample.launches = _build.new_launch_counts(STREAMS)


def fused_spec_verify(logits, draft, seed, temperature, top_k, valid):
    """The speculative-decoding accept/reject tail: :func:`fused_sample`
    on the hashed stream over a verify window's logits [B, W, V]
    flattened to [B * W, V] (window row (b, w) is row ``b * W + w``, per-
    slot temperature [B] and top_k [B] repeated element by element over
    the window), then ``serving/sampling.spec_accept`` over draft
    [B, W-1] and valid [B] -> (sampled [B, W] int32, n [B] int32).

    On the card it is one launch of ``csrc/fused_sample.cu`` at B * W
    rows, counted under ``fused_sample`` as every other; this entry
    point also keeps its own tally, ``fused_spec_verify.launches``."""
    from paddle_tpu_torch.serving import sampling
    B, W, V = logits.shape
    ids = fused_sample(logits.reshape(B * W, V), seed,
                       sampling.window_rows(temperature, W),
                       sampling.window_rows(top_k, W)).reshape(B, W)
    if not _build.on_cpu(logits, "fused_spec_verify"):
        fused_spec_verify.launches += 1
    return ids, sampling.spec_accept(ids, draft, valid)


fused_spec_verify.launches = 0
