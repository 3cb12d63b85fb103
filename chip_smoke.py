#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one card.

    python3 chip_smoke.py

Drives ``paddle_tpu_torch``'s serving and training paths on the first
CUDA card and exits non-zero on any failure (there is no CPU path). In
order it:

1. prints the environment (torch, CUDA, capability, nvcc, Triton,
   CUTLASS headers, the card's name and power limit);
2. builds the Hopper kernels from ``paddle_tpu_torch/ops/kernels/csrc``
   with nvcc (one process per source, in parallel) and prints the build
   time;
3. prints the ``-Xptxas -v`` registers and spills of the paged
   attention kernels, the sampler and the span write (``ptxas:`` line),
   then holds each kernel, the int8
   and int4 branches of kernels 1, 3 and 4, the fp32-query branches of
   kernels 1 and 3, and both branches of kernels 5 and 6 (bf16 on the
   tensor cores, fp32 on the CUDA cores) against its plain PyTorch
   version on the card, at its slice's shapes and at one GQA shape, and
   times kernel, plain version and a PyTorch library call that computes
   the same function (a yardstick only: the port never calls it; SDPA
   over gathered, dequantized K/V for a quantized pool), beside the
   least time the card could take (the bytes stored and moved over
   3.35 TB/s or FLOPs over the peak for the input type, whichever is
   larger); every kernel also times its C entry alone (``entry_ms``,
   outputs allocated beforehand), and kernels 1–4 their execution on
   the device alone (``device_ms``, from the profiler's device activity,
   which a slow host's launch work cannot inflate); the sampler runs on
   both its streams (hashed: the decode tail, B=8; threefry: the
   prefill tail, B=1) and is held bitwise over B in {1, 8, 64} and V in
   {64, 1000, 50257} (``check sample:`` line); the span write is held
   byte for byte; decode is also checked at G=8, Dh=128 over 16384
   positions and, per slot, alone against its batch of 8 (bitwise);
   kernels 1, 3, 5 and 6 are launched twice on the same inputs, which
   must give bitwise the same outputs; kernels 5 and 6 are timed at the
   training slice's shape in both dtypes and at the GQA D=128 shape in
   bf16;
4. holds the serving step functions on the card against the CPU on a
   small fp32 model, with an fp32 pool (the launches of the fp32-query
   paged kernels) and again with an int8 pool and int8 weights;
5. holds a small fp32 LM's training on the card against the CPU (one
   step's loss and gradients, then five Adam steps' losses), and runs
   the same three steps twice on the card: losses and weights must be
   bitwise equal (the attention backward uses no atomics). The card's
   five steps are the fp32 attention branch's path: their launch counts
   are that branch's ``launches`` (no bf16 kernel may launch there);
6. checks the engine's step programs (``check graphs:``): at GPT-2
   small widths over bf16, int8 and int4 pools, each CUDA graph
   replayed (prefill: a cold chunk and a chunk with context; decode: 8
   rows, greedy and sampled, two inactive) gives bitwise the ids and
   every pool byte of the raw step function on the same inputs, across
   new seeds and after a page-table remap;
7. serves 16 seeded requests with a GPT-2-small-width engine (random
   weights from a seed) in a fresh engine, so every CUDA graph capture
   falls in the timed window (``captures``, ``capture_s``), then a
   second trace drawn the same way (``warm``); reads each serving
   kernel's launch count for the first run — every count must be > 0 —
   checks that the graphs captured are the trace's distinct (chunk
   bucket, page-vector length) keys plus one for decode, that a
   prefix-cache hit gives the same greedy tokens as the same prompt
   served cold in a fresh engine, and profiles a third trace
   (``engine_profile:``: the ten device kernels with the most time, the
   device's busy share); then does the same over quantized pools: (b)
   an int4 pool with the bf16 weights, and (a) an int8 pool with
   ``quantize_lm_params`` int8 weights of the same seed-0 fp32 draws
   (the bf16 weights freed first, so its peak memory holds the int8
   tree alone), each run launching every quantized branch of its
   storage (``engine_int4_profile:``, ``engine_int8_profile:``). Between
   the two, decode logits off int8 and int4 pools must lie within
   ``kv_rel_l2_budget`` of the bf16 pool's on one prompt, and a
   latency-tier burst preempts batch-tier work in a pool of 8 blocks
   (``preempt:``): both resume modes occur, every request completes,
   each victim's greedy ids equal its run alone;
8. speculative decoding (``spec:`` line, ``spec_phase``): the repo's
   draft-friendly pair at GPT-2 small widths (a 2-layer draft that is
   the target's first layers, the later layers' residual outputs scaled
   by 0.05), k = 4: a verify window against sequential raw decode steps
   over bf16, int8 and int4 pools (whether it is bitwise) and on an
   fp32 model within 1e-4; kernel 1 at the verify's 40 rows and
   ``fused_spec_verify`` at [8, 5, 50257] against their plain versions;
   the engine trace cold and warm through the target-only engine and the
   spec engine (captures, launches, acceptance), 4 requests through an
   unrelated draft; every greedy id equal to the target-only engine's
   (or, if the window is not bitwise, diverging only below the window's
   logit difference); a remap and a replay preemption of spec victims;
   the port's v5 artifact of the pair saved, loaded and served; the spec
   programs' replays bitwise their raw steps; a profiled third trace
   (``spec_profile:``);
9. the row-arena slot engine and the lockstep paths (``slots:``,
   ``slots_profile:`` and ``lockstep:`` lines): the slot engine
   (batch 8, an arena of 1024 positions, buckets 16..512) serves the
   engine trace with prompts clipped to 512 tokens, cold (every capture
   in its window: one per bucket met, one for decode) and warm, beside
   the paged engine on the same traces; every greedy request equals
   ``generate`` at B = 1 or diverges only where the lockstep step's
   top-2 margin is below the slot path's max |logit difference| from
   it; kernel 5 at the slot prefill's shapes (T = 16, 32, 200, 512,
   B*H = 12, bf16, causal) within 2 bf16 ulps of its plain version,
   timed at T = 16 and 512 against SDPA; the slot step programs'
   replays bitwise their raw steps (a prefill bucket replayed with two
   seeds), ``decode_step_slots`` bitwise ``decode_step`` at equal
   positions; the arena attention's share of a warm decode step; a
   profiled third trace; then ``generate`` (B = 4, 128-token prompts,
   64 new, greedy and sampled), ``beam_search`` (B = 2, K = 4, 16 new)
   and the port's v1 and v3 artifacts saved, loaded and served with
   the in-process ids;
10. trains the GPT-2-small-width LM (bf16, flash attention, batch 8 x
   1024 tokens, Adam at 1e-4, one seeded batch: the repo's
   ``benchmarks/transformer_bench.py`` recipe) for 2 warm-up and 10
   timed steps, and reads each attention kernel's launch count for the
   timed steps — 12 layers x 10 steps of each bf16 kernel, none of the
   fp32 ones; then profiles one more step (``train_profile:`` line: the
   ten device kernels with the most time, the device's busy share);
11. prints the card line, a ``{"kernels": [...]}`` line (18 entries: the
   17 kernels and branches, and ``fused_spec_verify``, kernel 2 at the
   spec trace's verify rows; kernel 2's two streams and kernel 5's bf16
   forward count the slot trace's and the lockstep calls' launches too)
   and, last, the ``{"ok": true, ...}`` line.

TF32 is switched off for matmuls and cuDNN, so fp32 products are full
fp32 on the card as on the CPU.
"""

import importlib.util
import json
import re
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core rates
              "float32": 67e12}    # fp32 outside the tensor cores
REPEATS = 30
L2_FLUSH_BYTES = 64 << 20          # > the 50 MB L2: every launch cold


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def sh(cmd) -> str:
    done = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    return (done.stdout or done.stderr).strip()


class Timer:
    """Median device time of a function over ``REPEATS`` launches, each
    after a write that evicts L2 (the serving path reads each layer's
    pool slice cold), with CUDA events around the launch alone."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8,
                                 device="cuda")

    def ms(self, fn) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        times = []
        for _ in range(REPEATS):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))

    def device_ms(self, fn, kernel: str):
        """(median execution time on the device, records) of the CUDA
        kernels whose name holds ``kernel`` over ``REPEATS`` launches of
        ``fn`` (each after the L2-evicting write), from
        ``torch.profiler``'s device activity: the kernel alone, without
        the host's launch work. The profiler drops records now and then
        on the card's machine: the median is over those it kept, a
        window with none is tried once more, and then the time is None
        (not measured)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        torch = self.torch
        fn()
        for _ in range(2):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(REPEATS):
                    self.flush.zero_()
                    fn()
                torch.cuda.synchronize()
            us = [ev.time_range.end - ev.time_range.start
                  for ev in prof.events()
                  if ev.device_type == DeviceType.CUDA and kernel in ev.name]
            if us:
                return float(np.median(us)) / 1e3, len(us)
        return None, 0


def ptxas_summary(build_dir, stems) -> dict:
    """{source: [[kernel, registers, spill store bytes, spill load
    bytes], ...]} from the ``-Xptxas -v`` logs the build keeps beside
    its objects (kernel names demangled by ``c++filt`` when there is
    one, template arguments kept, parameters dropped)."""
    out = {}
    for stem in stems:
        log = Path(build_dir, stem + ".log")
        fns, name, spill = [], None, (0, 0)
        for line in log.read_text().splitlines() if log.exists() else ():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                name, spill = m.group(1), (0, 0)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and name:
                spill = (int(m.group(1)), int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                fns.append([name, int(m.group(1)), *spill])
                name = None
        try:
            names = subprocess.run(
                ["c++filt"], input="\n".join(f[0] for f in fns),
                capture_output=True, text=True, timeout=60).stdout.split("\n")
        except OSError:
            names = []
        for f, d in zip(fns, names):
            f[0] = re.sub(r"\(.*$", "",
                          d.replace("(anonymous namespace)::", "")) or f[0]
        out[stem] = fns
    return out


def bound(nbytes: float, flops: float, dtype_name: str):
    """(bound_ms, bound_by): the larger of bytes over the memory rate
    and operations over the peak rate for the input type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------


def quant_pool(torch, q8, shape, kvd, dev, dtype=None):
    """Rows [..., M, Dh] drawn on the card in ``dtype`` (bf16 by
    default), stored as ``kvd`` ("none": those rows; "int8"/"int4":
    codes and fp32 row scales from ``ops/q8.quantize_kv``). Returns
    (values, scales or None)."""
    x = torch.randn(*shape, device=dev).to(dtype or torch.bfloat16)
    if kvd == "none":
        return x, None
    return q8.quantize_kv(x, kvd)


def stored_row_bytes(kvd: str, Dh: int, elt: int = 2) -> int:
    """Bytes one pool row occupies: ``elt``-byte values, or int8 /
    packed int4 codes plus the row's fp32 scale."""
    return {"none": elt * Dh, "int8": Dh + 4, "int4": Dh // 2 + 4}[kvd]


def decode_entry(torch, kd, build, q, k, v, pages, pos, kw):
    """The decode C entry alone on the wrapper's operands, its output,
    partials and counters allocated once beforehand: a callable that
    launches it and returns the output tensor it writes."""
    B, Hkv, G, Dh = q.shape
    bs, kv = kw["block_size"], kw["kv_dtype"]
    P, M = pages.shape[1], k.shape[1]
    _, smem, part = kd.decode_split_layout(G, Dh, P, bs, q.dtype, kv)
    buf = torch.empty(B * Hkv * (G * Dh + part), dtype=torch.float32,
                      device=q.device)
    counters = kd.arrival_counters(q.device, build.stream(q.device),
                                   B * Hkv)
    ptr = build.ptr
    args = [ptr(q), ptr(k), ptr(v), ptr(kw.get("k_scale")),
            ptr(kw.get("v_scale")), ptr(pages), ptr(pos), ptr(buf),
            build.ptr(buf[B * Hkv * G * Dh:]), ptr(counters), B, Hkv, G, Dh,
            M, P, bs, Dh ** 0.5, build.DTYPE_CODES[q.dtype],
            build.KV_CODES[kv], smem, build.stream(q.device)]
    lib = build.library()
    out = buf[:B * Hkv * G * Dh].view(B, Hkv, G, Dh)

    def run():
        build.check(lib.pk_decode_attention(*args), "flash_decode_attention")
        return out
    return run


def prefill_entry(torch, kp, build, q, kck, vck, k, v, pages, kw):
    """The chunk-prefill C entry alone, as ``decode_entry``."""
    C, Hkv, G, Dh = q.shape
    bs, kv = kw["block_size"], kw["kv_dtype"]
    P_ctx, M = pages.shape[0], k.shape[1]
    rows, smem = kp.prefill_layout(C, G, Dh, P_ctx * bs, q.dtype,
                                   kv if P_ctx else "none")
    n_out, part, counters = C * Hkv * G * Dh, 0, None
    if q.dtype == torch.bfloat16:
        row_tiles, _, part = kp.prefill_tc_splits(C, G, Dh, P_ctx * bs)
        part *= Hkv
        counters = kp.arrival_counters(q.device, build.stream(q.device),
                                       Hkv * row_tiles)
    buf = torch.empty(n_out + part, dtype=torch.float32, device=q.device)
    out = buf[:n_out].view(C, Hkv, G, Dh)
    ptr = build.ptr
    args = [ptr(q), ptr(kck), ptr(vck), ptr(k), ptr(v),
            ptr(kw.get("k_scale")), ptr(kw.get("v_scale")), ptr(pages),
            ptr(out), build.ptr(buf[n_out:]), ptr(counters), C, Hkv, G, Dh,
            M, P_ctx, bs, rows, Dh ** 0.5,
            build.DTYPE_CODES[q.dtype], build.KV_CODES[kv], smem,
            build.stream(q.device)]
    lib = build.library()

    def run():
        build.check(lib.pk_chunk_prefill(*args), "flash_chunk_prefill")
        return out
    return run


def widened(q8, x, scale, kvd, dtype):
    """Gathered pool rows as the library call's operand: dequantized
    through ``ops/q8.dequantize_kv`` and cast to the query dtype."""
    return x if kvd == "none" else q8.dequantize_kv(x, scale, kvd).to(dtype)


def check_decode(torch, timer, kd, q8, build, dev, rng, Hkv, G, Dh, timed,
                 kvd="none", dt=None, window=1):
    """Decode at one shape against its plain version: (max abs error,
    times or None). Timed: kernel through the wrapper, the C entry alone
    (``entry_ms``), the plain version and SDPA over gathered K/V; the C
    entry's output must equal the wrapper's bitwise (two launches).
    ``window`` > 1 is the verify step's shape: 8 slots of ``window``
    rows each, a slot's rows sharing its page-table row at consecutive
    positions (the library call: SDPA with ``window`` queries a slot)."""
    S, bs, P, nblocks = 8, 16, 64, 512
    B = S * window
    dt = dt or torch.bfloat16
    q = torch.randn(B, Hkv, G, Dh, device=dev).to(dt)
    k, ks = quant_pool(torch, q8, (Hkv, nblocks * bs, Dh), kvd, dev, dt)
    v, vs = quant_pool(torch, q8, (Hkv, nblocks * bs, Dh), kvd, dev, dt)
    kw = dict(block_size=bs, kv_dtype=kvd)
    if kvd != "none":
        kw.update(k_scale=ks, v_scale=vs)
    slot_pages = np.stack([rng.permutation(nblocks)[:P]
                           for _ in range(S)]).astype(np.int32)
    pages = torch.from_numpy(np.repeat(slot_pages, window, axis=0)).to(dev)
    pos_np = (rng.randint(32, 765 - (window - 1), S)[:, None]
              + np.arange(window)).reshape(B).astype(np.int32)
    pos = torch.from_numpy(pos_np).to(dev)
    args = (q, k, v, pages, pos)
    got = kd.flash_decode_attention(*args, **kw)
    want = kd.flash_decode_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if not timed:
        return err, None
    entry = decode_entry(torch, kd, build, *args, kw)
    if not torch.equal(entry(), got):
        fail(f"flash_decode_attention ({kvd}, {dt}): the C entry and the "
             f"wrapper differ on the same inputs")
    e = q.element_size()
    # each slot's rows read once (a window's rows share them); every
    # query row does its own products
    rows = int((pos_np.reshape(S, window).max(1) + 1).sum())
    nbytes = (q.numel() * e + rows * Hkv * stored_row_bytes(kvd, Dh, e) * 2
              + pages.numel() * 4 + B * 4 + got.numel() * 4)
    flops = int((pos_np + 1).sum()) * Hkv * G * Dh * 2 * 2
    # library yardstick: SDPA over K/V already gathered per slot (and
    # dequantized, for a quantized pool)
    T = P * bs
    gidx = (torch.from_numpy(slot_pages).to(dev).long()[:, :, None] * bs
            + torch.arange(bs, device=dev)).reshape(S, T)
    kt = widened(q8, k[:, gidx], None if ks is None else ks[:, gidx], kvd, dt)
    vt = widened(q8, v[:, gidx], None if vs is None else vs[:, gidx], kvd, dt)
    kt = kt.permute(1, 0, 2, 3).repeat_interleave(G, dim=1)
    vt = vt.permute(1, 0, 2, 3).repeat_interleave(G, dim=1)
    qh = q.reshape(S, window, Hkv * G, Dh).transpose(1, 2)
    mask = (torch.arange(T, device=dev)[None, None, :]
            <= pos.reshape(S, window)[:, :, None])[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    times = {
        "ms": timer.ms(lambda: kd.flash_decode_attention(*args, **kw)),
        "plain_ms": timer.ms(lambda: kd.flash_decode_attention_plain(
            *args, **kw)),
        "library_ms": timer.ms(lambda: sdpa(qh, kt, vt, attn_mask=mask)),
        "entry_ms": timer.ms(entry),
    }
    times["device_ms"], times["device_records"] = timer.device_ms(
        entry, "decode_split_kernel")
    times["bound_ms"], times["bound_by"] = bound(
        nbytes, flops, str(dt).replace("torch.", ""))
    return err, times


def decode_invariance(torch, kd, q8, dev, kvd):
    """The serving slice's decode (B=8, Hkv=12, G=1, Dh=64, 64 pages of
    16) at positions on both sides of the split edges: (each slot decoded
    alone bitwise equal to its row of the batch, a second launch of the
    batch bitwise equal to the first)."""
    rng = np.random.RandomState(3)
    B, Hkv, G, Dh, P, bs, nblocks = 8, 12, 1, 64, 64, 16, 512
    q = torch.randn(B, Hkv, G, Dh, device=dev).to(torch.bfloat16)
    k, ks = quant_pool(torch, q8, (Hkv, nblocks * bs, Dh), kvd, dev)
    v, vs = quant_pool(torch, q8, (Hkv, nblocks * bs, Dh), kvd, dev)
    kw = dict(block_size=bs, kv_dtype=kvd, k_scale=ks, v_scale=vs)
    pages = torch.from_numpy(np.stack(
        [rng.permutation(nblocks)[:P] for _ in range(B)]).astype(np.int32)
    ).to(dev)
    pos = torch.tensor([700, 3, 63, 64, 1023, 129, 0, 511],
                       dtype=torch.int32, device=dev)
    batch = kd.flash_decode_attention(q, k, v, pages, pos, **kw)
    again = kd.flash_decode_attention(q, k, v, pages, pos, **kw)
    alone = all(torch.equal(kd.flash_decode_attention(
        q[b:b + 1].contiguous(), k, v, pages[b:b + 1].contiguous(),
        pos[b:b + 1].contiguous(), **kw)[0], batch[b]) for b in range(B))
    return alone, torch.equal(batch, again)


def decode_long(torch, kd, q8, dev, kvd):
    """Max abs error of decode at G=8, Dh=128 over T=16384 positions
    (256 splits; B=2, Hkv=2, one slot at the last position, one at 9000)
    against the plain version."""
    rng = np.random.RandomState(4)
    B, Hkv, G, Dh, P, bs = 2, 2, 8, 128, 1024, 16
    q = torch.randn(B, Hkv, G, Dh, device=dev).to(torch.bfloat16)
    k, ks = quant_pool(torch, q8, (Hkv, P * bs, Dh), kvd, dev)
    v, vs = quant_pool(torch, q8, (Hkv, P * bs, Dh), kvd, dev)
    kw = dict(block_size=bs, kv_dtype=kvd, k_scale=ks, v_scale=vs)
    pages = torch.from_numpy(np.stack(
        [rng.permutation(P) for _ in range(B)]).astype(np.int32)).to(dev)
    pos = torch.tensor([P * bs - 1, 9000], dtype=torch.int32, device=dev)
    got = kd.flash_decode_attention(q, k, v, pages, pos, **kw)
    want = kd.flash_decode_attention_plain(q, k, v, pages, pos, **kw)
    torch.cuda.synchronize()
    return (got - want).abs().max().item()


def check_sample(torch, timer, kd, build, dev, rng, stream):
    """The sampler on one stream at its main-path shape (the hashed
    stream: the decode tail, B=8; threefry: the prefill tail, B=1;
    V=50257, temperature 0.8 and top_k 50 on sampled rows): bitwise
    against its plain version, then timed through the wrapper, as the C
    entry alone (``entry_ms``) and on the device (``device_ms``), beside
    the plain version and topk + softmax + multinomial."""
    B, V = (8, 50257) if stream == "hash" else (1, 50257)
    x = torch.from_numpy((3.0 * rng.randn(B, V)).astype(np.float32)).to(dev)
    temp = torch.tensor([0.0, 0.8] * 4, device=dev)[-B:]
    topk = torch.tensor([0, 50] * 4, dtype=torch.int32, device=dev)[-B:]
    seed = torch.tensor(1234, dtype=torch.int32, device=dev)
    got = kd.fused_sample(x, seed, temp, topk, stream)
    want = kd.fused_sample_plain(x, seed, temp, topk, stream)
    torch.cuda.synchronize()
    err = float((got.long() - want.long()).abs().max().item())

    def library():
        vals, idx = torch.topk(x, 50, dim=-1)
        probs = torch.softmax(vals / 0.8, dim=-1)
        return idx.gather(-1, torch.multinomial(probs, 1))

    out = torch.empty(B, dtype=torch.int32, device=dev)
    lib, ptr = build.library(), build.ptr
    args = [ptr(x), ptr(temp), ptr(topk), ptr(out), B, V, ptr(seed),
            kd.STREAMS.index(stream), build.stream(dev)]

    def entry():
        build.check(lib.pk_fused_sample(*args), "fused_sample")
        return out

    if not torch.equal(entry(), got):
        fail(f"fused_sample ({stream}): the C entry and the wrapper differ "
             f"on the same inputs")
    times = {
        "ms": timer.ms(lambda: kd.fused_sample(x, seed, temp, topk, stream)),
        "plain_ms": timer.ms(lambda: kd.fused_sample_plain(x, seed, temp,
                                                           topk, stream)),
        "library_ms": timer.ms(library),
        "entry_ms": timer.ms(entry),
    }
    times["device_ms"], times["device_records"] = timer.device_ms(
        entry, "fused_sample")
    # one read of every logit; the work per logit is a few compares
    times["bound_ms"], times["bound_by"] = bound(
        x.numel() * 4 + B * 12, x.numel() * 4, "float32")
    return err, times


def sample_sweep(torch, kd, dev):
    """Both streams at B in {1, 8, 64} and V in {64, 1000, 50257}, rows
    cycling through greedy and top_k 0, 1, 50, V//4, V-1, V, every third
    row with ties at its 50th value: bitwise the plain version, two launches
    equal, row 0 and every greedy row alone equal to their rows of the
    batch; and seed 33137's uniform of 1.0 (row 0, lane 219) on a lane
    the top-k filter drops, which must not win. Returns the number of
    cases checked."""
    cases = 0
    seed = torch.tensor(4321, dtype=torch.int32, device=dev)
    for stream in kd.STREAMS:
        for B in (1, 8, 64):
            for V in (64, 1000, 50257):
                rng = np.random.RandomState(B * 7 + V)
                x = (3.0 * rng.randn(B, V)).astype(np.float32)
                for b in range(0, B, 3):
                    order = np.argsort(-x[b])
                    x[b, order[48:53]] = x[b, order[min(49, V - 1)]]
                ks = [0, 1, 50, V // 4, V - 1, V]
                topk = torch.tensor([ks[b % 6] for b in range(B)],
                                    dtype=torch.int32, device=dev)
                temp = torch.tensor([0.0 if b % 4 == 3 else 0.6 + 0.1 * (b % 7)
                                     for b in range(B)], device=dev)
                xs = torch.from_numpy(x).to(dev)
                got = kd.fused_sample(xs, seed, temp, topk, stream)
                again = kd.fused_sample(xs, seed, temp, topk, stream)
                want = kd.fused_sample_plain(xs, seed, temp, topk, stream)
                alone = all(
                    int(kd.fused_sample(xs[b:b + 1].contiguous(), seed,
                                        temp[b:b + 1].contiguous(),
                                        topk[b:b + 1].contiguous(),
                                        stream)[0]) == int(got[b])
                    for b in [0] + [b for b in range(B) if temp[b] <= 0])
                if not (torch.equal(got, want) and torch.equal(got, again)
                        and alone):
                    fail(f"fused_sample ({stream}, B={B}, V={V}): plain "
                         f"{torch.equal(got, want)}, repeat "
                         f"{torch.equal(got, again)}, alone {alone}")
                cases += 1
    V = 50257
    x = np.random.RandomState(6).randn(1, V).astype(np.float32)
    x[0, 219] = x.min() - 1.0
    one = torch.ones(1, device=dev)
    top5 = torch.full((1,), 5, dtype=torch.int32, device=dev)
    seed = torch.tensor(33137, dtype=torch.int32, device=dev)
    got = kd.fused_sample(torch.from_numpy(x).to(dev), seed, one, top5)
    want = kd.fused_sample_plain(torch.from_numpy(x).to(dev), seed, one,
                                 top5)
    if not (torch.equal(got, want) and int(got[0]) in np.argsort(-x[0])[:5]):
        fail(f"fused_sample: the uniform of 1.0 on a filtered lane won "
             f"({int(got[0])})")
    return cases + 1


def check_prefill(torch, timer, kp, q8, build, dev, rng, Hkv, G, Dh, P_ctx,
                  timed, kvd="none", dt=None):
    """Chunk prefill at one shape against its plain version, as
    ``check_decode``; every call also checks that a second launch is
    bitwise equal to the first."""
    C, bs, nblocks = 256, 16, 512
    dt = dt or torch.bfloat16
    q = torch.randn(C, Hkv, G, Dh, device=dev).to(dt)
    kck = torch.randn(C, Hkv, Dh, device=dev).to(dt)
    vck = torch.randn(C, Hkv, Dh, device=dev).to(dt)
    k, ks = quant_pool(torch, q8, (Hkv, nblocks * bs, Dh), kvd, dev, dt)
    v, vs = quant_pool(torch, q8, (Hkv, nblocks * bs, Dh), kvd, dev, dt)
    kw = dict(block_size=bs, kv_dtype=kvd)
    if kvd != "none":
        kw.update(k_scale=ks, v_scale=vs)
    pages = torch.from_numpy(
        rng.permutation(nblocks)[:P_ctx].astype(np.int32)).to(dev)
    args = (q, kck, vck, k, v, pages)
    got = kp.flash_chunk_prefill(*args, **kw)
    want = kp.flash_chunk_prefill_plain(*args, **kw)
    if not torch.equal(got, kp.flash_chunk_prefill(*args, **kw)):
        fail(f"flash_chunk_prefill ({kvd}, {dt}, P_ctx={P_ctx}): two "
             f"launches on the same inputs differ")
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if not timed:
        return err, None
    entry = prefill_entry(torch, kp, build, *args, kw)
    if not torch.equal(entry(), got):
        fail(f"flash_chunk_prefill ({kvd}, {dt}): the C entry and the "
             f"wrapper differ on the same inputs")
    S = P_ctx * bs
    e = q.element_size()
    nbytes = (q.numel() * e + 2 * kck.numel() * e
              + 2 * S * Hkv * stored_row_bytes(kvd, Dh, e) + P_ctx * 4
              + got.numel() * 4)
    visible = C * S + C * (C + 1) // 2          # (row, column) pairs seen
    flops = visible * Hkv * G * Dh * 2 * 2
    gidx = (pages.long()[:, None] * bs
            + torch.arange(bs, device=dev)).reshape(S)
    kctx = widened(q8, k[:, gidx], None if ks is None else ks[:, gidx], kvd,
                   dt)
    vctx = widened(q8, v[:, gidx], None if vs is None else vs[:, gidx], kvd,
                   dt)
    kall = torch.cat([kctx, kck.transpose(0, 1)], 1)
    vall = torch.cat([vctx, vck.transpose(0, 1)], 1)
    kall = kall.repeat_interleave(G, dim=0)[None]
    vall = vall.repeat_interleave(G, dim=0)[None]
    qh = q.reshape(C, Hkv * G, Dh).transpose(0, 1)[None]
    mask = torch.cat([torch.ones(C, S, dtype=torch.bool, device=dev),
                      torch.ones(C, C, dtype=torch.bool,
                                 device=dev).tril()], 1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    times = {
        "ms": timer.ms(lambda: kp.flash_chunk_prefill(*args, **kw)),
        "plain_ms": timer.ms(lambda: kp.flash_chunk_prefill_plain(
            *args, **kw)),
        "library_ms": timer.ms(lambda: sdpa(qh, kall, vall,
                                            attn_mask=mask)),
        "entry_ms": timer.ms(entry),
    }
    times["device_ms"], times["device_records"] = timer.device_ms(
        entry, "chunk_prefill")
    times["bound_ms"], times["bound_by"] = bound(
        nbytes, flops, str(dt).replace("torch.", ""))
    return err, times


def check_span_write(torch, timer, kp, q8, build, dev, rng, Hkv, Dh, timed,
                     kvd="none"):
    """Max abs difference of every array (exact: 0 expected); bf16 rows,
    or int8 / int4 codes with their fp32 scale tables."""
    L, bs, pc, nblocks, n_valid = 12, 16, 16, 512, 200
    names = kp.span_names(kvd)
    pool, spans = {}, {}
    for n in ("k", "v"):
        pool[n], ps = quant_pool(torch, q8, (L, Hkv, nblocks * bs, Dh), kvd,
                                 dev)
        spans[n], ss = quant_pool(torch, q8, (L, Hkv, pc * bs, Dh), kvd, dev)
        if kvd != "none":
            pool[n + "_scale"], spans[n + "_scale"] = ps, ss
    pages = torch.from_numpy(
        rng.permutation(nblocks)[:pc].astype(np.int32)).to(dev)
    valid = torch.arange(pc * bs, device=dev) < n_valid
    kw = dict(block_size=bs, kv_dtype=kvd)
    ref = {n: t.clone() for n, t in pool.items()}
    kp.paged_span_write(pool, spans, pages, valid, **kw)
    kp.paged_span_write_plain(ref, spans, pages, valid, **kw)
    torch.cuda.synchronize()
    err = max((pool[n].float() - ref[n].float()).abs().max().item()
              for n in names)
    if not all(torch.equal(pool[n].view(torch.uint8), ref[n].view(torch.uint8))
               for n in names):
        fail(f"paged_span_write ({kvd}, Hkv={Hkv}, Dh={Dh}): not byte for "
             f"byte the plain version")
    if not timed:
        return err, None
    row_bytes = {n: pool[n][0, 0, 0].numel() * pool[n].element_size()
                 for n in names}
    nbytes = (2 * n_valid * L * Hkv * sum(row_bytes.values()) + pc * 4
              + pc * bs)
    rows = (pages.long()[:, None] * bs
            + torch.arange(bs, device=dev)).reshape(-1)[:n_valid]
    flat = {n: pool[n].view(L * Hkv, nblocks * bs, -1) for n in names}
    src = {n: spans[n].reshape(L * Hkv, pc * bs, -1)[:, :n_valid]
           .contiguous() for n in names}

    def library():
        for n in names:
            flat[n].index_copy_(1, rows, src[n])

    times = {
        "ms": timer.ms(lambda: kp.paged_span_write(pool, spans, pages,
                                                   valid, **kw)),
        "plain_ms": timer.ms(lambda: kp.paged_span_write_plain(
            pool, spans, pages, valid, **kw)),
        "library_ms": timer.ms(library),
    }
    # the C entry alone on the wrapper's operands
    lib, ptr = build.library(), build.ptr
    pad = 4 - len(names)
    args = ([ptr(pool[n]) for n in names] + [None] * pad
            + [ptr(spans[n]) for n in names] + [None] * pad
            + [row_bytes[n] for n in names] + [0] * pad
            + [len(names), ptr(pages), ptr(valid), L * Hkv, pc,
               nblocks * bs, bs, build.stream(dev)])

    def entry():
        build.check(lib.pk_span_write(*args), "paged_span_write")

    times["entry_ms"] = timer.ms(entry)
    times["device_ms"], times["device_records"] = timer.device_ms(
        entry, "span_write")
    # the same launch with no valid row: the kernel's fixed cost
    no_rows = torch.zeros_like(valid)
    args[-6] = ptr(no_rows)
    times["empty_device_ms"], _ = timer.device_ms(entry, "span_write")
    times["bound_ms"], times["bound_by"] = bound(nbytes, 0.0, "bfloat16")
    return err, times


def check_flash(torch, timer, ka, build, dev, B, T, H, Hkv, D, dtype,
                causal, timed):
    """Kernels 5 and 6 (flash attention forward and backward) against
    their plain versions at one shape, through the same GQA expansion
    and [B*H, T, D] layout as ``flash_attention``. Returns the errors
    {fwd: (out, lse), bwd: (dq, dk, dv)} as max abs and, for bf16, in
    bf16 ulps; whether a second launch of each kernel on the same inputs
    gave bitwise the same outputs; and, when ``timed``, the times. Beside
    the wrapper's time (``ms``) stands ``entry_ms``: the C entry alone,
    its outputs allocated beforehand, so the difference is the wrapper's
    host work (checks, allocation, the ctypes call) before the launch."""
    g = torch.Generator(device=dev).manual_seed(T + H)

    def rand(heads):
        return torch.randn(B, T, heads, D, generator=g, device=dev).to(dtype)

    def rows(x):
        return (ka.expand_kv_heads(x, H).transpose(1, 2)
                .reshape(B * H, T, D).contiguous())

    q, k, v, do = rows(rand(H)), rows(rand(Hkv)), rows(rand(Hkv)), rows(
        rand(H))
    kw = dict(sm_scale=D ** -0.5, causal=causal)
    out, lse = ka.flash_attention_fwd(q, k, v, **kw)
    grads = ka.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    out2, lse2 = ka.flash_attention_fwd(q, k, v, **kw)
    grads2 = ka.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    want_out, want_lse = ka.flash_attention_fwd_plain(q, k, v, **kw)
    want = ka.flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    repeat = (torch.equal(out, out2) and torch.equal(lse, lse2)
              and all(torch.equal(a, b) for a, b in zip(grads, grads2)))

    def abs_err(a, b):
        return (a.float() - b.float()).abs().max().item()

    errs = {"fwd": (abs_err(out, want_out), abs_err(lse, want_lse)),
            "bwd": tuple(abs_err(a, b) for a, b in zip(grads, want))}
    ulps = None
    if dtype == torch.bfloat16:
        ulps = {"fwd": ka.bf16_ulps(out, want_out),
                "bwd": max(ka.bf16_ulps(a, b)
                           for a, b in zip(grads, want))}
    if not timed:
        return errs, ulps, repeat, None
    e = q.element_size()
    n = q.numel()
    pairs = (T * (T + 1) // 2 if causal else T * T) * B * H
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4, k4, v4, do4 = (t.view(B, H, T, D) for t in (q, k, v, do))
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q4, k4, v4))
    o_lib = sdpa(qs, ks, vs, is_causal=causal)
    times = {
        "fwd": {
            "ms": timer.ms(lambda: ka.flash_attention_fwd(q, k, v, **kw)),
            "plain_ms": timer.ms(lambda: ka.flash_attention_fwd_plain(
                q, k, v, **kw)),
            "library_ms": timer.ms(lambda: sdpa(q4, k4, v4,
                                                is_causal=causal))},
        "bwd": {
            "ms": timer.ms(lambda: ka.flash_attention_bwd(
                q, k, v, out, lse, do, **kw)),
            "plain_ms": timer.ms(lambda: ka.flash_attention_bwd_plain(
                q, k, v, out, lse, do, **kw)),
            "library_ms": timer.ms(lambda: torch.autograd.grad(
                o_lib, (qs, ks, vs), do4, retain_graph=True))},
    }
    lib, ptr = build.library(), build.ptr
    delta = (do.float() * out.float()).sum(dim=-1)
    spare = [torch.empty_like(t) for t in (out, lse, q, k, v)]
    flags = (kw["sm_scale"], int(causal), build.DTYPE_CODES[dtype],
             build.stream(dev))
    fwd_args = [ptr(t) for t in (q, k, v, *spare[:2])] + [B * H, T, D]
    bwd_args = [ptr(t) for t in (q, k, v, do, lse, delta, *spare[2:])] + [
        B * H, T, D]
    for name, entry, args in (("fwd", lib.pk_flash_attn_fwd, fwd_args),
                              ("bwd", lib.pk_flash_attn_bwd, bwd_args)):
        build.check(entry(*args, *flags), f"flash_attention_{name}")
        times[name]["entry_ms"] = timer.ms(lambda: entry(*args, *flags))
    dname = str(dtype).replace("torch.", "")
    # forward: q, k, v read, out written, lse written; q.k and p.v
    times["fwd"]["bound_ms"], times["fwd"]["bound_by"] = bound(
        4 * n * e + lse.numel() * 4, 4 * D * pairs, dname)
    # backward: q, k, v, out, do, lse read, dq, dk, dv written; five
    # products (q.k, do.v, p^T do, ds k, ds^T q)
    times["bwd"]["bound_ms"], times["bwd"]["bound_by"] = bound(
        8 * n * e + lse.numel() * 4, 10 * D * pairs, dname)
    return errs, ulps, repeat, times


FLASH_FP32_TOL = 1e-4        # fp32 out, lse and grads: sums in another order
FLASH_BF16_ULPS = 2          # bf16 out and grads: one rounding each side
FLASH_LSE_TOL = 1e-4         # lse is fp32 for either input type


def flash_phase(torch, ka, build):
    """Kernels 5 and 6, both branches. bf16 (tensor cores): the training
    slice's shape (B=8, T=1024, H=12, D=64, causal) and a GQA wide-head
    shape (H=32, Hkv=8, D=128, T=2048, causal), both timed. fp32 (CUDA
    cores): the slice's shape, timed, and an uneven non-causal shape
    (B=2, T=1000, H=12, D=64). Every shape also checks that a second
    launch on the same inputs is bitwise equal. Tolerances: fp32 out,
    lse and gradients within 1e-4 absolute (fp32 sums in another order);
    bf16 out and gradients within 2 bf16 ulps (both versions accumulate
    in fp32 and round once, so a sum near a rounding boundary may round
    the other way), lse within 1e-4."""
    dev = torch.device("cuda:0")
    timer = Timer(torch)
    bf16, f32 = torch.bfloat16, torch.float32
    sl_err, sl_ulps, sl_rep, sl_times = check_flash(
        torch, timer, ka, build, dev, 8, 1024, 12, 12, 64, bf16, True, True)
    gqa_err, gqa_ulps, gqa_rep, gqa_times = check_flash(
        torch, timer, ka, build, dev, 1, 2048, 32, 8, 128, bf16, True, True)
    f32_err, _, f32_rep, f32_times = check_flash(
        torch, timer, ka, build, dev, 8, 1024, 12, 12, 64, f32, True, True)
    odd_err, _, odd_rep, _ = check_flash(torch, timer, ka, build, dev, 2,
                                         1000, 12, 12, 64, f32, False, False)
    rows = {}
    for part in ("fwd", "bwd"):
        name = f"flash_attention_{part}"
        gqa = {f"gqa_{'kernel_ms' if k == 'ms' else k}": v
               for k, v in gqa_times[part].items()}
        bf16_row = (max(sl_err[part]), {
            "bf16_ulps": sl_ulps[part],
            "gqa_max_abs_err": max(gqa_err[part]),
            "gqa_bf16_ulps": gqa_ulps[part], **gqa,
            "bitwise_repeat": sl_rep and gqa_rep}, sl_times[part])
        f32_row = (max(f32_err[part]), {
            "uneven_max_abs_err": max(odd_err[part]),
            "bitwise_repeat": f32_rep and odd_rep}, f32_times[part])
        lse_ok = part == "bwd" or max(sl_err[part][1], gqa_err[part][1],
                                      f32_err[part][1],
                                      odd_err[part][1]) <= FLASH_LSE_TOL
        for row_name, (err, extra, times) in ((name, bf16_row),
                                              (name + ".fp32", f32_row)):
            print(f"kernel {row_name}: max_abs_err={err!r} "
                  + " ".join(f"{k}={v!r}" for k, v in extra.items())
                  + f" tol=({FLASH_FP32_TOL!r} fp32, {FLASH_BF16_ULPS} "
                  f"bf16 ulps) "
                  + " ".join(f"{'kernel_ms' if k == 'ms' else k}={v!r}"
                             for k, v in times.items()))
            rows[row_name] = (err, extra, times)
        f32_max = max(f32_err[part] + odd_err[part])
        if not (lse_ok and f32_max <= FLASH_FP32_TOL
                and max(sl_ulps[part], gqa_ulps[part]) <= FLASH_BF16_ULPS):
            fail(f"{name} disagrees with its plain version")
        if not (sl_rep and gqa_rep and f32_rep and odd_rep):
            fail(f"{name}: two launches on the same inputs differ")
    return rows


def kernel_phase(torch, kd, kp, q8, build):
    """Each kernel and each quantized branch against its plain version
    at the slice's shapes (GPT-2 small: Hkv=12, G=1, Dh=64, bf16
    queries; the prefill both cold and with 512 context positions; int8
    and int4 pools for kernels 1, 3 and 4) and at a GQA shape (G=4,
    Dh=128), with its tolerance; timed at the slice's shapes. Decode
    and prefill also run with fp32 queries over an fp32 pool (rows 1f
    and 3f: the fp32 instantiation of the decode kernel, the CUDA-core
    prefill kernel), and each decode branch at G=8, Dh=128 over 16384
    positions and, at the slice, alone against its batch (bitwise). The
    sampler has no head layout, so it has no GQA shape."""
    dev = torch.device("cuda:0")
    timer = Timer(torch)
    rows = {}
    for kvd in ("none", "int8", "int4"):
        # the same pages and positions for every storage
        rng = np.random.RandomState(0)
        sfx = "" if kvd == "none" else f".{kvd}"
        e1, t1 = check_decode(torch, timer, kd, q8, build, dev, rng, 12, 1,
                              64, True, kvd)
        e1g, _ = check_decode(torch, timer, kd, q8, build, dev, rng, 4, 4,
                              128, False, kvd)
        long_err = decode_long(torch, kd, q8, dev, kvd)
        alone, repeat = decode_invariance(torch, kd, q8, dev, kvd)
        print(f"check decode{sfx}: G=8 Dh=128 T=16384 max_abs_err="
              f"{long_err!r} tol=1e-4; B=1 vs B=8 bitwise={alone}; two "
              f"launches bitwise={repeat}")
        if not (long_err <= 1e-4 and alone and repeat):
            fail(f"flash_decode_attention{sfx}: long context, batch "
                 f"invariance or repeatability failed")
        rows["flash_decode_attention" + sfx] = (e1, e1g, 1e-4, t1, {
            "long_context_max_abs_err": long_err,
            "batch_invariant": alone, "bitwise_repeat": repeat})
        if kvd == "none":
            for stream in kd.STREAMS:
                e2, t2 = check_sample(torch, timer, kd, build, dev, rng,
                                      stream)
                rows["fused_sample" + ("" if stream == "hash"
                                       else ".threefry")] = (e2, None, 0.0,
                                                             t2, {})
            print(f"check sample: {sample_sweep(torch, kd, dev)} cases, both "
                  f"streams bitwise the plain version, repeatable, rows "
                  f"alone equal to their batch rows")
        e3, t3 = check_prefill(torch, timer, kp, q8, build, dev, rng, 12, 1,
                               64, 32, True, kvd)
        if kvd == "none":
            e3c, _ = check_prefill(torch, timer, kp, q8, build, dev, rng, 12,
                                   1, 64, 0, False)
            e3 = max(e3, e3c)
        e3g, _ = check_prefill(torch, timer, kp, q8, build, dev, rng, 4, 4,
                               128, 32, False, kvd)
        rows["flash_chunk_prefill" + sfx] = (e3, e3g, 1e-4, t3,
                                             {"bitwise_repeat": True})
        e4, t4 = check_span_write(torch, timer, kp, q8, build, dev, rng, 12,
                                  64, True, kvd)
        e4g, _ = check_span_write(torch, timer, kp, q8, build, dev, rng, 4,
                                  128, False, kvd)
        rows["paged_span_write" + sfx] = (e4, e4g, 0.0, t4, {})
    # fp32 queries over an fp32 pool
    rng = np.random.RandomState(0)
    f32 = torch.float32
    e1, t1 = check_decode(torch, timer, kd, q8, build, dev, rng, 12, 1, 64,
                          True, dt=f32)
    e1g, _ = check_decode(torch, timer, kd, q8, build, dev, rng, 4, 4, 128,
                          False, dt=f32)
    rows["flash_decode_attention.fp32"] = (e1, e1g, 1e-4, t1, {})
    e3, t3 = check_prefill(torch, timer, kp, q8, build, dev, rng, 12, 1, 64,
                           32, True, dt=f32)
    e3c, _ = check_prefill(torch, timer, kp, q8, build, dev, rng, 12, 1, 64,
                           0, False, dt=f32)
    e3g, _ = check_prefill(torch, timer, kp, q8, build, dev, rng, 4, 4, 128,
                           32, False, dt=f32)
    rows["flash_chunk_prefill.fp32"] = (max(e3, e3c), e3g, 1e-4, t3,
                                        {"bitwise_repeat": True})
    for name, (err, gqa_err, tol, times, extra) in rows.items():
        shown = {("kernel_ms" if k == "ms" else k): v
                 for k, v in times.items()}
        print(f"kernel {name}: max_abs_err={err!r} gqa_max_abs_err="
              f"{gqa_err!r} tol={tol!r} "
              + " ".join(f"{k}={v!r}" for k, v in shown.items()))
        if not (err <= tol and (gqa_err is None or gqa_err <= tol)):
            fail(f"{name} disagrees with its plain version: "
                 f"{err}, {gqa_err} > {tol}")
    return {name: (err, {"gqa_max_abs_err": gqa_err, **extra}, times)
            for name, (err, gqa_err, _, times, extra) in rows.items()}


# ---------------------------------------------------------------------------
# step functions on the card against the CPU, small fp32 model
# ---------------------------------------------------------------------------


def step_parity(torch, tt):
    """Two prefill chunks and a decode step of a small fp32 model on the
    card against the CPU, logits and pool within 1e-4. When they part, the
    walk runs again on both sides (does either side repeat itself?) and
    the pool's per-(layer, page) differences are printed before the
    failure (``steps diag:`` line)."""
    cfg = tt.TransformerConfig(vocab=256, d_model=128, n_heads=4,
                               n_kv_heads=2, n_layers=2, d_ff=256,
                               max_len=128, dtype="float32")
    bs, nb = 16, 16
    rng = np.random.RandomState(7)
    prompt = rng.randint(0, 256, 40).astype(np.int32)
    pages = np.asarray([3, 9, 4, 0], np.int32)       # 0: unmapped tail

    def walk(d):
        """(logits of the three steps on the CPU, the pool) on ``d``."""
        params = tt.init_params(cfg, torch.Generator().manual_seed(5), d)
        pool = tt.init_block_pool(cfg, nb, bs, device=d)
        out = []
        for off, c in ((0, 32), (32, 8)):
            bucket = 32 if c > 16 else 16
            padded = np.zeros((1, bucket), np.int32)
            padded[0, :c] = prompt[off:off + c]
            pv = pages[:off // bs + bucket // bs]
            lg, _ = tt.prefill_into_blocks(
                params, pool, torch.from_numpy(padded).to(d), c,
                torch.from_numpy(pv.copy()).to(d), cfg, block_size=bs)
            out.append(lg.cpu())
        tok = torch.tensor([int(out[-1].argmax()), 5], dtype=torch.int32)
        lg, _ = tt.decode_step_paged(
            params, pool, tok.to(d),
            torch.tensor([40, 3], dtype=torch.int32).to(d),
            torch.tensor([True, False]).to(d),
            torch.from_numpy(np.stack([pages, pages])).to(d), cfg,
            block_size=bs)
        out.append(lg.cpu())
        return out, {n: t.cpu() for n, t in pool.items()}

    def diffs(a, b):
        """(per-step logits errors, pool error) between two walks."""
        return ([(x - y).abs().max().item() for x, y in zip(a[0], b[0])],
                max((a[1][n] - b[1][n]).abs().max().item()
                    for n in ("k", "v")))

    cpu, card = walk("cpu"), walk("cuda")
    if not all(torch.isfinite(x).all() for x in card[0]):
        fail("non-finite logits on the card")
    errs, pool_err = diffs(cpu, card)
    err = max(errs)
    print(f"steps: prefill(2 chunks)+decode on the card vs the CPU, fp32, "
          f"logits max_abs_err={err!r} (per step {errs}) pool "
          f"max_abs_err={pool_err!r} tol=1e-4")
    if not (err <= 1e-4 and pool_err <= 1e-4):
        cpu2, card2 = walk("cpu"), walk("cuda")
        per_page = {n: [[(cpu[1][n][li, :, p * bs:(p + 1) * bs]
                          - card[1][n][li, :, p * bs:(p + 1) * bs])
                         .abs().max().item() for p in (3, 9, 4)]
                        for li in range(cfg.n_layers)] for n in ("k", "v")}
        print("steps diag: " + json.dumps({
            "cpu_again": diffs(cpu, cpu2), "card_again": diffs(card, card2),
            "cpu_again_vs_card_again": diffs(cpu2, card2),
            "pool_by_layer_and_page_3_9_4": per_page,
            "threads": torch.get_num_threads()}))
        fail("step functions on the card disagree with the CPU")


def pools_close(torch, q8, a, b, kvd):
    """(max code difference, share of equal codes, max relative scale
    difference) of two quantized pools; int4 compared nibble by
    nibble."""
    dmax, equal, srel = 0, 1.0, 0.0
    for n in ("k", "v"):
        x, y = a[n].cpu(), b[n].cpu()
        if kvd == "int4":
            x, y = q8.unpack_int4(x), q8.unpack_int4(y)
        d = (x.int() - y.int()).abs()
        dmax = max(dmax, int(d.max()))
        equal = min(equal, float((d == 0).float().mean()))
        sa, sb = a[n + "_scale"].cpu(), b[n + "_scale"].cpu()
        rel = ((sa - sb).abs() / sb.abs().clamp_min(1e-30)).max().item()
        srel = max(srel, rel)
    return dmax, equal, srel


def step_parity_quant(torch, tt, tlm, q8):
    """The step_parity walk with an int8 pool and int8 weights
    (``quantize_lm_params`` of the seed-5 fp32 draws), card vs CPU:
    logits within 1e-4 (fp32, sums in another order); pool codes within
    1 and equal on >= 99.9 % of elements (a projection an ulp off can
    cross a rounding boundary); scales within 1e-5 relative (a scale is
    a row's absmax over 127, and the k/v rows themselves differ by fp32
    sums of 128 products taken in another order: ~1e-6 relative, 8e-7
    observed on an H100)."""
    cfg = tt.TransformerConfig(vocab=256, d_model=128, n_heads=4,
                               n_kv_heads=2, n_layers=2, d_ff=256,
                               max_len=128, dtype="float32")
    bs, nb = 16, 16
    fp32 = tt.init_train_params(cfg, torch.Generator().manual_seed(5), "cpu")
    params = {d: tlm.quantize_lm_params(fp32, device=d)
              for d in ("cpu", "cuda")}
    pools = {d: tt.init_block_pool(cfg, nb, bs, kv_dtype="int8", device=d)
             for d in ("cpu", "cuda")}
    rng = np.random.RandomState(7)
    prompt = rng.randint(0, 256, 40).astype(np.int32)
    pages = np.asarray([3, 9, 4, 0], np.int32)       # 0: unmapped tail
    logits = {}
    for d in ("cpu", "cuda"):
        out = []
        for off, c in ((0, 32), (32, 8)):
            bucket = 32 if c > 16 else 16
            padded = np.zeros((1, bucket), np.int32)
            padded[0, :c] = prompt[off:off + c]
            pv = pages[:off // bs + bucket // bs]
            lg, _ = tt.prefill_into_blocks(
                params[d], pools[d], torch.from_numpy(padded).to(d), c,
                torch.from_numpy(pv.copy()).to(d), cfg, block_size=bs)
            out.append(lg.cpu())
        tok = torch.tensor([int(out[-1].argmax()), 5], dtype=torch.int32)
        lg, _ = tt.decode_step_paged(
            params[d], pools[d], tok.to(d),
            torch.tensor([40, 3], dtype=torch.int32).to(d),
            torch.tensor([True, False]).to(d),
            torch.from_numpy(np.stack([pages, pages])).to(d), cfg,
            block_size=bs)
        out.append(lg.cpu())
        logits[d] = out
    err = 0.0
    for a, b in zip(logits["cpu"], logits["cuda"]):
        if not torch.isfinite(b).all():
            fail("non-finite logits on the card (int8 pool, int8 weights)")
        err = max(err, (a - b).abs().max().item())
    dmax, equal, srel = pools_close(torch, q8, pools["cuda"], pools["cpu"],
                                    "int8")
    print(f"steps int8: prefill(2 chunks)+decode on the card vs the CPU, "
          f"fp32, int8 pool and int8 weights, logits max_abs_err={err!r} "
          f"tol=1e-4; pool codes max_diff={dmax} equal_share={equal!r} "
          f"(tol 1, 0.999); scales max_rel_err={srel!r} tol=1e-5")
    if not (err <= 1e-4 and dmax <= 1 and equal >= 0.999 and srel <= 1e-5):
        fail("quantized step functions on the card disagree with the CPU")


# ---------------------------------------------------------------------------
# training on the card against the CPU, small fp32 model
# ---------------------------------------------------------------------------


def _train_run(torch, tt, topt, cfg, batches, device):
    """Adam (lr 1e-3) steps from seeded weights, one batch per step:
    (losses, first step's gradients on the CPU, final params)."""
    params = tt.init_train_params(cfg, torch.Generator().manual_seed(5),
                                  device)
    adam = topt.Adam(learning_rate=1e-3)
    state = adam.tree_init_state(params)
    losses, first = [], None
    for i, toks in enumerate(batches):
        toks = torch.from_numpy(toks).to(device)
        loss = tt.lm_loss(params, toks, toks.roll(-1, 1), cfg)
        loss.backward()
        grads = topt.take_grads(params)
        if first is None:
            first = {n: g.cpu() for n, g in topt.tree_leaves(grads)}
        params, state = adam.tree_update(i, grads, params, state)
        losses.append(loss.item())
    return losses, first, params


def train_parity(torch, tt, topt, kernels):
    """The step_parity model with flash attention, T=96 (one full and
    one ragged 64-row tile): card vs CPU within 1e-4 (fp32 throughout,
    sums in other orders through two layers, the vocab head and up to
    five Adam steps), then the same three steps twice on the card,
    bitwise. The card's five steps are the fp32 attention branch's path:
    its launch counts are read around them (every fp32 kernel launched,
    no bf16 one). Returns those counts."""
    cfg = tt.TransformerConfig(vocab=256, d_model=128, n_heads=4,
                               n_kv_heads=2, n_layers=2, d_ff=256,
                               max_len=128, dtype="float32")
    rng = np.random.RandomState(8)
    batches = [rng.randint(0, 256, (2, 96)).astype(np.int32)
               for _ in range(5)]
    cpu = _train_run(torch, tt, topt, cfg, batches, "cpu")
    kernels.reset_launches()                 # counts of the fp32 path
    gpu = _train_run(torch, tt, topt, cfg, batches, "cuda")
    launches = kernels.launch_counts()
    loss_err = max(abs(a - b) for a, b in zip(cpu[0], gpu[0]))
    grad_err = max((cpu[1][n] - gpu[1][n]).abs().max().item()
                   for n in cpu[1])
    runs = [_train_run(torch, tt, topt, cfg, batches[:3], "cuda")
            for _ in range(2)]
    same_loss = runs[0][0] == runs[1][0]
    same_params = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        topt.tree_leaves(runs[0][2]), topt.tree_leaves(runs[1][2])))
    print(f"train parity: 5 Adam steps card vs CPU, fp32, losses "
          f"{gpu[0]!r}, loss max_abs_err={loss_err!r} step-1 grads "
          f"max_abs_err={grad_err!r} tol=1e-4; 3 steps twice on the card: "
          f"losses bitwise={same_loss} params bitwise={same_params}")
    if not all(np.isfinite(gpu[0])):
        fail("non-finite training loss on the card")
    if not (loss_err <= 1e-4 and grad_err <= 1e-4):
        fail("training on the card disagrees with the CPU")
    if not (same_loss and same_params):
        fail("two identical training runs on the card differ")
    n = cfg.n_layers * len(batches)
    print(f"train parity launches: "
          + " ".join(f"{k}={launches[k]}" for k in TRAINING_KERNELS
                     + FP32_BRANCHES))
    if not (all(launches[k] == n for k in FP32_BRANCHES)
            and all(launches[k] == 0 for k in TRAINING_KERNELS)):
        fail(f"fp32 training launched other attention kernels than the "
             f"fp32 branch {n} times each: {launches}")
    return launches


# ---------------------------------------------------------------------------
# engine phase
# ---------------------------------------------------------------------------


def gpt2_small(tt):
    """GPT-2 small widths (Radford et al. 2019; Hugging Face ``gpt2``)."""
    return tt.TransformerConfig(vocab=50257, d_model=768, n_heads=12,
                                n_layers=12, d_ff=3072, max_len=1024,
                                use_rope=False, dtype="bf16")


ENGINE_KW = dict(batch=8, cache_len=1024, block_size=16, chunk_tokens=256,
                 seed=0)


def trace(rng, vocab):
    """16 requests: prompts of 32..700 tokens, the first two sharing a
    256-token prefix (the second is the greedy prefix hit), max_new
    32..64, half greedy and half at temperature 0.8 with top_k 50."""
    prefix = rng.randint(0, vocab, 256)
    reqs = [(np.concatenate([prefix, rng.randint(0, vocab, 100)]), 48, 0.8),
            (np.concatenate([prefix, rng.randint(0, vocab, 180)]), 40, 0.0)]
    lens = list(rng.randint(32, 701, 13)) + [700]
    for i, n in enumerate(lens):
        reqs.append((rng.randint(0, vocab, n), int(rng.randint(32, 65)),
                     0.0 if i % 2 == 0 else 0.8))
    return reqs


def submit(eng, prompt, max_new, temp):
    return eng.submit(prompt, max_new, temperature=temp,
                      top_k=50 if temp > 0 else 0)


def chunk_keys(reqs, chunk_tokens, block_size, buckets) -> set:
    """The (chunk bucket, page-vector length) keys the scheduler's chunk
    walk reaches for ``reqs``: each prompt from its prefix hit (whole
    chunks at the front) in chunks of ``chunk_tokens``, the tail padded
    to the smallest covering bucket."""
    keys = set()
    for r in reqs:
        off, n = r.prefix_hit_tokens, r.prompt.size
        while off < n:
            c = min(n - off, chunk_tokens)
            b = min(x for x in buckets if x >= c)
            keys.add((b, off // block_size + -(-b // block_size)))
            off += c
    return keys


def serve_trace(torch, eng, reqs_in):
    """Submit ``reqs_in`` at once and drain: (requests, wall seconds,
    graphs captured in the window, capture seconds in the window)."""
    before = eng.compile_counts()
    secs = eng.health()["compile_seconds"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [submit(eng, *r) for r in reqs_in]
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = eng.compile_counts()
    secs2 = eng.health()["compile_seconds"]
    captures = {k: after[k] - before[k] for k in after}
    return reqs, wall, captures, sum(secs2.values()) - sum(secs.values())


def trace_doc(reqs, wall, captures, capture_s) -> dict:
    tokens = sum(len(r.tokens) for r in reqs)
    ttft = np.asarray([r.ttft_s for r in reqs])
    return {"requests": len(reqs), "generated_tokens": tokens,
            "wall_s": wall, "tokens_per_s": tokens / wall,
            "ttft_p50_s": float(np.percentile(ttft, 50)),
            "ttft_p99_s": float(np.percentile(ttft, 99)),
            "prefix_hit_tokens": reqs[1].prefix_hit_tokens,
            "captures": captures, "capture_s": capture_s}


def check_served(label, reqs, reqs_in, vocab):
    for r, (p, max_new, _) in zip(reqs, reqs_in):
        ids = np.asarray(r.tokens)
        if (r.status != "done" or len(ids) != max_new
                or ids.min() < 0 or ids.max() >= vocab):
            fail(f"{label} request {r.rid}: status {r.status}, {len(ids)} "
                 f"of {max_new} tokens, ids in [{ids.min()}, {ids.max()}]")


def engine_phase(torch, tt, kernels, PagedDecodeEngine, cfg, dev, params,
                 kv_dtype, label, branch):
    """Serve the 16-request trace with ``params`` over a ``kv_dtype``
    pool in a fresh engine; print the ``<label>:`` line, whose timed
    window holds every CUDA graph capture of the trace (``captures``,
    ``capture_s``), and its ``warm`` block: a second trace drawn the same
    way from seed 1, served next by the same engine. Check every
    request, the launch of each serving kernel of the ``branch`` ("" for
    the model-dtype pool, ".int8"/".int4"), that the graphs captured are
    the trace's distinct (bucket, page-vector length) keys plus one for
    decode, and that the prefix hit equals the cold run in a fresh
    engine; then serve a third trace (seed 2) under the profiler
    (``<label>_profile:`` line). Returns the timed run's launch counts."""
    kw = dict(ENGINE_KW, kv_dtype=kv_dtype)
    # first-use costs of the process (cuBLAS handles, the allocator)
    # stay out of the timing: a throwaway engine serves one request, so
    # every capture of the timed engine falls inside its window
    warm_eng = PagedDecodeEngine.from_params(params, cfg, device=dev, **kw)
    warm = submit(warm_eng, np.arange(40) % cfg.vocab, 4, 0.0)
    warm_eng.run_until_idle()
    if len(warm.tokens) != 4:
        fail("warm-up request did not finish")
    del warm_eng
    eng = PagedDecodeEngine.from_params(params, cfg, device=dev, **kw)
    reqs_in = trace(np.random.RandomState(0), cfg.vocab)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()                 # counts of the main path only
    reqs, wall, captures, capture_s = serve_trace(torch, eng, reqs_in)
    launches = kernels.launch_counts()
    observed = observe_check(eng, reqs) if label == "engine" else None
    health = eng.health()
    doc = trace_doc(reqs, wall, captures, capture_s)
    doc.update({"decode_mfu": eng.decode_mfu(),
                "decode_steps": health["decode_steps"],
                "max_memory_allocated_bytes":
                    torch.cuda.max_memory_allocated(),
                "kv_dtype": health["kv_dtype"],
                "kv_bytes_per_token": health["kv_bytes_per_token"],
                "pool_bytes": eng.pool_bytes, "launches": launches})
    keys = chunk_keys(reqs, eng.chunk_tokens, eng.block_size, eng.buckets)
    warm_in = trace(np.random.RandomState(1), cfg.vocab)
    wreqs, wwall, wcaptures, wcapture_s = serve_trace(torch, eng, warm_in)
    doc["warm"] = trace_doc(wreqs, wwall, wcaptures, wcapture_s)
    print(f"{label}: " + json.dumps(doc))
    check_served(label, reqs, reqs_in, cfg.vocab)
    check_served(f"{label} warm", wreqs, warm_in, cfg.vocab)
    if not eng.pool.idle:
        fail(f"{label}: blocks still held after the engine drained")
    path = [k + (branch if k != "fused_sample" else "")
            for k in SERVING_KERNELS] + ["fused_sample.threefry"]
    missing = [k for k in path if launches[k] <= 0]
    if missing:
        fail(f"{label}: kernels never launched on the main path: {missing}")
    wkeys = chunk_keys(wreqs, eng.chunk_tokens, eng.block_size, eng.buckets)
    want = {"prefill": len(keys), "decode": 1}
    wwant = {"prefill": len(wkeys - keys), "decode": 0}
    print(f"check {label} graphs: captured {captures} in the trace, "
          f"{wcaptures} in the warm trace; distinct (bucket, pages) keys "
          f"{len(keys)} and {len(wkeys - keys)} new + one decode graph")
    if captures != want or wcaptures != wwant:
        fail(f"{label}: captured {captures} / {wcaptures}, expected "
             f"{want} / {wwant}")
    if reqs[1].prefix_hit_tokens != 256:
        fail(f"{label}: the shared-prefix request hit "
             f"{reqs[1].prefix_hit_tokens} tokens, expected 256")
    # the hit replays a cold prefill: same greedy tokens in a fresh engine
    cold_eng = PagedDecodeEngine.from_params(params, cfg, device=dev, **kw)
    cold = submit(cold_eng, *reqs_in[1])
    cold_eng.run_until_idle()
    same = cold.tokens == reqs[1].tokens
    print(f"check {label}: prefix-hit request (hit "
          f"{reqs[1].prefix_hit_tokens} tokens) vs the same prompt cold in "
          f"a fresh engine (hit {cold.prefix_hit_tokens}): "
          f"{len(cold.tokens)} greedy tokens, identical={same}")
    if not same:
        fail(f"{label}: prefix hit and cold prefill gave different greedy "
             f"tokens")
    if observed is not None:
        observed["abort"] = abort_check(cold_eng, cfg.vocab)
        print("observe: " + json.dumps(observed))
    del cold_eng
    # where the serving time goes once the engine is warm: a third trace
    # under the profiler (its few new keys capture inside the window)
    prof_in = trace(np.random.RandomState(2), cfg.vocab)

    def serve():
        for r in prof_in:
            submit(eng, *r)
        eng.run_until_idle()
        torch.cuda.synchronize()
    before = eng.compile_counts()
    profile = profile_window(torch, serve)
    after = eng.compile_counts()
    profile["captures"] = {k: after[k] - before[k] for k in after}
    print(f"{label}_profile: " + json.dumps(profile))
    return launches


def track_balance(trace_id) -> list:
    """The (name, phase) lifecycle events of one request track in the
    span ring, and whether its b/e slices balance (never more e than b,
    none open at the end)."""
    from paddle_tpu_torch.observe import chrome_trace
    evs = [(s[0], s[5]) for s in chrome_trace.default_buffer().spans()
           if s[6] == trace_id and s[7] == "request"]
    depth, ok = 0, True
    for _, ph in evs:
        depth += {"b": 1, "e": -1}.get(ph, 0)
        ok = ok and depth >= 0
    return evs, ok and depth == 0


def http_get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def observe_check(eng, reqs) -> dict:
    """The ``observe:`` line's checks, right after the bf16 engine's
    first trace: every request's track in the chrome-trace export holds
    balanced ``b``/``e`` slices and the lifecycle's events, the request
    log holds the 16 records, ``health()``'s window counts 16 requests,
    and the engine's HealthServer on 127.0.0.1 answers ``/healthz``,
    ``/metrics`` and ``/requests`` with 200 (each GET timed)."""
    from paddle_tpu_torch.observe import chrome_trace
    t0 = time.perf_counter()
    export = chrome_trace.trace_export()
    export_s = time.perf_counter() - t0
    ids = {r.trace_id for r in reqs}
    events = sum(1 for e in export["traceEvents"] if e.get("id") in ids)
    unbalanced = [r.rid for r in reqs if not track_balance(r.trace_id)[1]]
    need = {"request", "queued", "admitted", "prefill", "prefill_chunk",
            "first_token", "finished"}
    incomplete = [r.rid for r in reqs
                  if not need <= {n for n, _ in track_balance(r.trace_id)[0]}]
    doc_req = eng.requests_doc()
    window = eng.health()["window"]
    srv = eng.serve()
    codes, get_ms = {}, {}
    try:
        for route in ("/healthz", "/metrics", "/requests"):
            t0 = time.perf_counter()
            codes[route], body = http_get(srv.url + route)
            get_ms[route] = 1e3 * (time.perf_counter() - t0)
            if route == "/requests":
                served_count = json.loads(body)["count"]
    finally:
        srv.close()
    doc = {"events": events, "tracks": len(ids),
           "unbalanced_tracks": unbalanced,
           "incomplete_tracks": incomplete,
           "trace_export_ms": 1e3 * export_s,
           "request_records": doc_req["count"],
           "by_reason": doc_req["by_reason"],
           "window_requests": window["requests"],
           "window_ttft_p50_s": window["ttft_p50_s"],
           "window_ttft_p99_s": window["ttft_p99_s"],
           "http": codes, "http_ms": get_ms,
           "http_requests_count": served_count}
    if (unbalanced or incomplete or doc_req["count"] != len(reqs)
            or window["requests"] != len(reqs) or served_count != len(reqs)
            or any(c != 200 for c in codes.values())):
        print("observe: " + json.dumps(doc))
        fail(f"observe: tracks unbalanced {unbalanced}, incomplete "
             f"{incomplete}, {doc_req['count']} records, window "
             f"{window['requests']} requests, HTTP {codes}")
    return doc


def abort_check(eng, vocab) -> dict:
    """``abort_requests`` on a loaded engine (12 requests: 8 in slots
    after 3 steps, the rest queued): it returns the live count and
    leaves every track balanced. The engine is not used again."""
    rng = np.random.RandomState(41)
    reqs = [submit(eng, rng.randint(0, vocab, int(rng.randint(32, 400))),
                   32, 0.0) for _ in range(12)]
    for _ in range(3):
        eng.step()
    live = sum(1 for r in reqs if r.status != "done")
    n = eng.abort_requests()
    unbalanced = [r.rid for r in reqs if not track_balance(r.trace_id)[1]]
    doc = {"live": live, "aborted": n, "unbalanced_tracks": unbalanced,
           "statuses": sorted({r.status for r in reqs})}
    if n != live or unbalanced or doc["statuses"] != ["aborted"]:
        fail(f"abort_requests: {doc}")
    return doc


def rows_equal(torch, a, b, ba: int, bb: int, bs: int) -> bool:
    """Block ``ba`` of pool ``a`` and block ``bb`` of pool ``b``, byte for
    byte over every leaf."""
    return all(torch.equal(
        a[n][:, :, ba * bs:(ba + 1) * bs].contiguous().view(torch.uint8),
        b[n][:, :, bb * bs:(bb + 1) * bs].contiguous().view(torch.uint8))
        for n in a)


def prefix_phase(torch, kernels, PagedDecodeEngine, cfg, dev, params):
    """The ``prefix:`` line, at the engine phase's configuration (bf16
    weights).

    Transfer, for bf16, int8 and int4 pools: engine A serves a 300-token
    prompt with ``max_new=1`` and exports its 16 chunk-aligned prefix
    blocks (``export_prefix``, timed over 5 exports); a fresh engine B,
    warmed by another 300-token prompt (its graphs captured), imports
    them (``import_prefix``, timed; then the chain's deserialize and
    in-place write repeated 5 times). Every pool leaf of B keeps its
    ``data_ptr`` and B's captures do not change; B's adopted rows equal
    A's byte for byte; B then serves the prompt greedily with a
    256-token hit (16 blocks x 16) and its ids equal the same prompt
    served cold in a third fresh engine, launching each serving kernel
    of its storage.

    Tiers (bf16 pool of 24 blocks of 16, so other prompts evict the
    prompt's cached blocks): a DRAM pass and a disk pass
    (``dram_bytes=0``, a temporary directory) each serve the prompt,
    evict it with three other prompts and serve it again: the second
    run's tier hits are > 0 in the expected tier and its greedy ids are
    the cold run's. The disk pass then evicts it once more, corrupts the
    first block's file and serves it a third time: a quarantined miss,
    the ids still the cold run's. Each demotion (``pool.on_evict``) is
    timed."""
    from paddle_tpu_torch.serving import transfer
    bs = ENGINE_KW["block_size"]
    rng = np.random.RandomState(51)
    prompt = rng.randint(0, cfg.vocab, 300)
    other = rng.randint(0, cfg.vocab, 300)
    max_new = 32
    doc = {"max_new": max_new}

    def serve(eng, p, n=max_new):
        r = eng.submit(p, n)
        eng.run_until_idle()
        if r.status != "done" or len(r.tokens) != n:
            fail(f"prefix: request {r.rid} {r.status}, {len(r.tokens)} of "
                 f"{n} tokens")
        return r

    def fresh(kvd, **kw):
        return PagedDecodeEngine.from_params(
            params, cfg, device=dev, **dict(ENGINE_KW, kv_dtype=kvd, **kw))

    want = None
    for kvd in (None, "int8", "int4"):
        name = kvd or "bf16"
        cold = serve(fresh(kvd), prompt).tokens
        if kvd is None:
            want = cold
        a = fresh(kvd)
        serve(a, prompt, 1)
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            payload = a.export_prefix(prompt)
            times.append(time.perf_counter() - t0)
        digests = a.prefix_digests(prompt)
        b = fresh(kvd)
        serve(b, other)
        ptrs = {n: t.data_ptr() for n, t in b.cache.items()}
        captures = b.compile_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        adopted = b.import_prefix(payload)
        torch.cuda.synchronize()
        import_s = time.perf_counter() - t0
        same_ptrs = {n: t.data_ptr() for n, t in b.cache.items()} == ptrs
        same_captures = b.compile_counts() == captures
        rows = all(rows_equal(torch, a.cache, b.cache, a.pool.lookup(h),
                              b.pool.lookup(h), bs) for h in digests)
        rewrite = []
        meta, items = transfer.deserialize_blocks(payload)
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            meta, items = transfer.deserialize_blocks(payload)
            transfer.write_blocks(b.cache, [(b.pool.lookup(h), arr)
                                            for h, arr in items], bs)
            torch.cuda.synchronize()
            rewrite.append(time.perf_counter() - t0)
        kernels.reset_launches()
        r = serve(b, prompt)
        launched = kernels.launch_counts()
        branch = "" if kvd is None else f".{kvd}"
        path = [k + (branch if k != "fused_sample" else "")
                for k in SERVING_KERNELS]
        entry = {"blocks": len(digests), "adopted": adopted,
                 "payload_bytes_per_block": len(payload) / len(digests),
                 "export_ms_per_block": 1e3 * float(np.median(times))
                 / len(digests),
                 "import_ms_per_block": 1e3 * import_s / len(digests),
                 "rewrite_ms_per_block": 1e3 * float(np.median(rewrite))
                 / len(digests),
                 "prefix_hit_tokens": r.prefix_hit_tokens,
                 "ids_equal_cold": r.tokens == cold,
                 "rows_equal": rows, "data_ptrs_kept": same_ptrs,
                 "captures_kept": same_captures,
                 "captures_after_serve": b.compile_counts(),
                 "launches": {k: launched[k] for k in path}}
        doc[name] = entry
        if not (adopted == len(digests) == 16 and rows and same_ptrs
                and same_captures and r.tokens == cold
                and r.prefix_hit_tokens == 16 * bs
                and all(launched[k] > 0 for k in path)):
            print("prefix: " + json.dumps(doc))
            fail(f"prefix transfer ({name}): {entry}")
        del a, b

    kw = dict(num_blocks=24)
    for tier, tiers in (("dram", {"dram_bytes": 1 << 30}),
                        ("disk", {"dram_bytes": 0, "disk_bytes": 1 << 30})):
        with tempfile.TemporaryDirectory() as tmp:
            if tier == "disk":
                tiers = dict(tiers, disk_dir=tmp)
            eng = fresh(None, tiers=tiers, **kw)
            demote = []
            hook = eng.pool.on_evict

            def timed(block, digest, hook=hook, demote=demote):
                t0 = time.perf_counter()
                hook(block, digest)
                demote.append(time.perf_counter() - t0)
            eng.pool.on_evict = timed

            def evict(seed):
                g = np.random.RandomState(seed)
                for _ in range(3):
                    serve(eng, g.randint(0, cfg.vocab, 300), 16)
            runs = [serve(eng, prompt).tokens]
            evict(61)
            r = serve(eng, prompt)
            runs.append(r.tokens)
            hits = eng.metrics.get("engine_prefix_tier_hit_blocks_total")
            miss = eng.metrics.get("engine_prefix_tier_miss_blocks_total")
            entry = {"promoted_hit_tokens": r.prefix_hit_tokens}
            corrupt_ok = True
            if tier == "disk":
                evict(62)
                path = Path(tmp) / (eng.prefix_digests(prompt)[0].hex()
                                    + ".kv")
                raw = bytearray(path.read_bytes())
                raw[len(raw) // 2] ^= 0x40
                path.write_bytes(bytes(raw))
                r = serve(eng, prompt)
                runs.append(r.tokens)
                corrupt = int(eng.metrics.get(
                    "engine_tier_corrupt_total").value())
                corrupt_ok = (corrupt == 1 and r.prefix_hit_tokens == 0
                              and Path(str(path) + ".corrupt").exists())
                entry["corrupt"] = corrupt
            entry.update({
                "demotions": len(demote),
                "demote_ms_per_block": 1e3 * float(np.median(demote))
                if demote else None,
                "demote_ms_max": 1e3 * max(demote) if demote else None,
                "hits": {t: int(hits.value(tier=t))
                         for t in ("hbm", "dram", "disk")},
                "misses": {t: int(miss.value(tier=t))
                           for t in ("hbm", "dram", "disk")},
                "ids_equal_cold": [x == want for x in runs],
                "tiers": {k: v for k, v in eng.health()["tiers"].items()
                          if k != "digests"}})
            doc[f"tier_{tier}"] = entry
            if not (all(entry["ids_equal_cold"]) and entry["hits"][tier] > 0
                    and corrupt_ok and eng.pool.idle):
                print("prefix: " + json.dumps(doc))
                fail(f"prefix tiers ({tier}): {entry}")
            del eng
    print("prefix: " + json.dumps(doc))


def random_pool(torch, tt, cfg, nb, bs, kvd, dev, seed):
    """A pool of ``nb`` blocks in the storage ``kvd`` holding random
    values (bf16 values ~N(0, 0.25), int8/int4 codes over their range,
    fp32 scales in [0.001, 0.021)), drawn on the CPU from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    pool = tt.init_block_pool(cfg, nb, bs, kv_dtype=kvd, device="cpu")
    for name, t in pool.items():
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=gen))
        elif name.endswith("_scale"):
            t.copy_(torch.rand(t.shape, generator=gen) * 0.02 + 0.001)
        else:
            t.copy_(torch.randn(t.shape, generator=gen) * 0.5)
    return {n: t.to(dev) for n, t in pool.items()}


def same_pool(torch, a, b) -> bool:
    return all(torch.equal(a[n].view(torch.uint8), b[n].view(torch.uint8))
               for n in a)


def graph_phase(torch, tt, sampling, cfg, params, dev):
    """``check graphs:``: the engine's step programs against their raw
    functions on the same inputs, over bf16, int8 and int4 pools at the
    serving shapes (GPT-2 small widths, bf16 weights). Each program
    captures at its first call and replays after; its raw function runs
    eagerly on a copy of the pool. After every call the ids and every
    byte of the two pools must be equal. Prefill: a cold chunk (200
    tokens, bucket 256), a chunk with 256 tokens of context (150 tokens),
    then the cold chunk's graph replayed greedy and sampled with new
    seeds; decode: 8 rows (6 active, half of them sampled; 2 inactive
    with all-zero page tables), replayed with a second seed (whose
    sampled ids must differ somewhere, so a frozen seed shows) and after
    a remap of one row's page table."""
    bs, B = ENGINE_KW["block_size"], ENGINE_KW["batch"]
    P = ENGINE_KW["cache_len"] // bs
    nb = 460
    rng = np.random.RandomState(21)
    blocks = rng.permutation(np.arange(1, nb)).astype(np.int32)
    doc = {}

    def T(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def scalar(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    for kvd in (None, "int8", "int4"):
        prefill, decode = sampling.paged_step_fns(cfg, bs)
        pool_g = random_pool(torch, tt, cfg, nb, bs, kvd, dev, 9)
        pool_r = {n: t.clone() for n, t in pool_g.items()}
        calls = 0

        def check(what, got, want):
            nonlocal calls
            calls += 1
            if not (torch.equal(got, want) and same_pool(torch, pool_g,
                                                         pool_r)):
                fail(f"graphs ({kvd or 'bf16'}): {what}: replay ids "
                     f"{got.tolist()} vs raw {want.tolist()}, pools equal "
                     f"{same_pool(torch, pool_g, pool_r)}")

        slot = blocks[:32]
        for what, off, c, temp, seed in (
                ("prefill cold", 0, 200, 0.8, 11),
                ("prefill with context", 256, 150, 0.8, 12),
                ("prefill cold greedy", 0, 200, 0.0, 13),
                ("prefill cold, new seed", 0, 200, 0.8, 14)):
            toks = rng.randint(0, cfg.vocab, (1, 256)).astype(np.int32)
            toks[0, c:] = 0
            pages = slot[:off // bs + 256 // bs]
            args = (np.asarray([temp], np.float32),
                    np.asarray([50], np.int32))
            got, _ = prefill(params, pool_g, toks, np.int32(c), pages,
                             *args, np.int32(seed))
            got = got.clone()
            want, _ = prefill.raw(params, pool_r, T(toks), scalar(c),
                                  T(pages), *map(T, args), scalar(seed))
            check(what, got, want)
        table = np.zeros((B, P), np.int32)
        for b in range(6):
            table[b, :60] = blocks[32 + 60 * b:32 + 60 * (b + 1)]
        pages_dev = T(table)
        pos = np.concatenate([rng.randint(300, 950, 6),
                              [5, 700]]).astype(np.int32)
        active = np.asarray([True] * 6 + [False] * 2)
        temp = np.asarray([0.0, 0.8] * 4, np.float32)
        topk = np.asarray([0, 50] * 4, np.int32)
        sampled = {}
        for what, seed in (("decode", 21), ("decode, new seed", 22),
                           ("decode after a remap", 23)):
            if what.endswith("remap"):
                table[1, :60] = blocks[32 + 360:32 + 420]
                pages_dev.copy_(T(table))
            toks = rng.randint(0, cfg.vocab, B).astype(np.int32)
            got, _ = decode(params, pool_g, toks, pos, active, pages_dev,
                            temp, topk, np.int32(seed))
            got = got.clone()
            want, _ = decode.raw(params, pool_r, T(toks), T(pos), T(active),
                                 pages_dev, T(temp), T(topk), scalar(seed))
            check(what, got, want)
            if what != "decode after a remap":
                sampled[seed] = (toks, got[1::2].tolist())
        if sampled[21][0][1::2].tolist() == sampled[22][0][1::2].tolist() \
                and sampled[21][1] == sampled[22][1]:
            fail(f"graphs ({kvd or 'bf16'}): two seeds drew the same ids")
        graphs = {"prefill": prefill.graphs, "decode": decode.graphs}
        if graphs != {"prefill": 2, "decode": 1}:
            fail(f"graphs ({kvd or 'bf16'}): captured {graphs}")
        doc[kvd or "bf16"] = {"graphs": graphs, "calls": calls,
                              "capture_s": prefill.tracker.compile_seconds()}
        del pool_g, pool_r
    print("check graphs: replayed step programs vs their raw functions, "
          "ids and every pool byte equal: " + json.dumps(doc))


def preempt_run(make, vocab, label) -> dict:
    """Two preemptions of a batch-tier victim in engines from ``make()``
    (2 slots, a pool of 8 blocks of 16): a latency-tier arrival whose
    reservation does not fit preempts it to blocks, and since the
    arrival's allocations come from free blocks the victim's own stay
    cached and it resumes by ``remap``; then a second victim and a
    latency burst whose first request's worst case is the whole pool:
    its allocations evict the victim's parked blocks and it resumes by
    ``replay``. Each victim is running when its arrival comes. Every
    request completes, each victim's greedy ids equal the same request
    served alone in a fresh engine, and the pool is idle at the end.
    Returns the ``<label>`` document."""
    rng = np.random.RandomState(31)
    eng = make()
    t0 = time.perf_counter()
    victims, others = [], []
    for lat_lens in ([(48, 16)], [(64, 64), (32, 16)]):
        v = eng.submit(rng.randint(0, vocab, 48), 64, tier="batch")
        victims.append(v)
        while len(v.tokens) < 3:
            eng.step()
        if v.status != "running":
            fail(f"{label}: the victim is {v.status} when the latency "
                 f"requests arrive")
        others += [eng.submit(rng.randint(0, vocab, n), m,
                              tier="latency") for n, m in lat_lens]
        eng.run_until_idle()
    wall = time.perf_counter() - t0
    resumes = eng.metrics.get("engine_resumes_total")
    doc = {"requests": len(victims) + len(others),
           "preemptions": int(eng.metrics.get(
               "engine_preemptions_total").value()),
           "resumes": {m: int(resumes.value(mode=m))
                       for m in ("remap", "replay")},
           "victim_preemptions": [v.preemptions for v in victims],
           "wall_s": wall, "captures": eng.compile_counts()}
    alone = []
    for v in victims:
        # the same engine shapes: cuBLAS may round otherwise at another
        # batch size
        solo = make()
        r = solo.submit(v.prompt, v.max_new)
        solo.run_until_idle()
        alone.append(r.tokens == v.tokens)
    doc["equal_to_alone"] = alone
    print(f"{label}: " + json.dumps(doc))
    done = all(r.status == "done" and len(r.tokens) == r.max_new
               for r in victims + others)
    if not (done and eng.pool.idle and all(alone)
            and doc["resumes"] == {"remap": 1, "replay": 1}
            and doc["victim_preemptions"] == [1, 1]):
        fail(f"{label}: every request done {done}, pool idle "
             f"{eng.pool.idle}, resumes {doc['resumes']}, victims equal to "
             f"their runs alone {alone}")
    return doc


def preempt_phase(torch, PagedDecodeEngine, cfg, dev, params):
    """``preempt:``: ``preempt_run`` at GPT-2 small widths, bf16."""
    kw = dict(ENGINE_KW, batch=2, num_blocks=8)
    preempt_run(lambda: PagedDecodeEngine.from_params(params, cfg,
                                                      device=dev, **kw),
                cfg.vocab, "preempt")


def quant_logits_phase(torch, tt, cfg, params, dev):
    """Decode logits off int8 and int4 pools against the bf16 pool at
    the slice's widths, on one 300-token prompt (chunks of 256 and 44,
    then one decode step, the same bf16 weights): the global relative L2
    distance must stay under ``kv_rel_l2_budget``."""
    bs = ENGINE_KW["block_size"]
    rng = np.random.RandomState(11)
    prompt = rng.randint(0, cfg.vocab, 300).astype(np.int32)
    pages = np.arange(1, 21, dtype=np.int32)         # 20 pages of 16
    logits = {}
    for kvd in (None, "int8", "int4"):
        pool = tt.init_block_pool(cfg, 24, bs, kv_dtype=kvd, device=dev)
        for off, c in ((0, 256), (256, 44)):
            padded = np.zeros((1, 256 if c > 64 else 64), np.int32)
            padded[0, :c] = prompt[off:off + c]
            pv = pages[:off // bs + padded.shape[1] // bs]
            lg, _ = tt.prefill_into_blocks(
                params, pool, torch.from_numpy(padded).to(dev), c,
                torch.from_numpy(pv.copy()).to(dev), cfg, block_size=bs)
        tok = lg.argmax(-1).to(torch.int32)
        lg, _ = tt.decode_step_paged(
            params, pool, tok, torch.tensor([300], dtype=torch.int32,
                                            device=dev),
            torch.ones(1, dtype=torch.bool, device=dev),
            torch.from_numpy(pages[None].copy()).to(dev), cfg,
            block_size=bs)
        logits[kvd] = lg.float()
    out = {}
    for kvd in ("int8", "int4"):
        rel = ((logits[kvd] - logits[None]).norm()
               / logits[None].norm()).item()
        budget = tt.kv_rel_l2_budget(cfg, kvd)
        out[kvd] = (rel, budget)
        print(f"check quant logits {kvd}: decode logits off the {kvd} pool "
              f"vs the bf16 pool, rel_l2={rel!r} budget={budget!r}")
        if not (np.isfinite(rel) and 0 < rel < budget):
            fail(f"{kvd} pool logits outside kv_rel_l2_budget: {rel} vs "
                 f"{budget}")
    return out


# ---------------------------------------------------------------------------
# speculative decoding phase
# ---------------------------------------------------------------------------

# benchmarks/serving_bench.py::build_draft_pair's recipe, at k = 4
SPEC_K, SPEC_DRAFT_LAYERS, SPEC_ALPHA = 4, 2, 0.05


def draft_pair(torch, tt, cfg, params):
    """The repo's draft-friendly pair on the port's weights: the target
    is ``params`` with ``attn_out`` and ``mlp_out`` of every layer past
    the first ``SPEC_DRAFT_LAYERS`` scaled by ``SPEC_ALPHA`` (its cost is
    unchanged, its logits land near the draft's); the draft IS the
    target's first ``SPEC_DRAFT_LAYERS`` layers with the shared
    embedding, position table, head and final norm. Returns (target
    params, draft config, draft params)."""
    blocks = dict(params["blocks"])
    for leaf in ("attn_out", "mlp_out"):
        w = blocks[leaf].clone()
        w[SPEC_DRAFT_LAYERS:] *= SPEC_ALPHA
        blocks[leaf] = w
    target = dict(params, blocks=blocks)
    dcfg = tt.TransformerConfig(
        vocab=cfg.vocab, d_model=cfg.d_model, n_heads=cfg.n_heads,
        n_layers=SPEC_DRAFT_LAYERS, d_ff=cfg.d_ff, max_len=cfg.max_len,
        use_rope=cfg.use_rope, dtype=cfg.dtype)
    draft = dict(target, blocks={k: v[:SPEC_DRAFT_LAYERS].contiguous()
                                 for k, v in blocks.items()})
    return target, dcfg, draft


def window_check(torch, tt, cfg, params, dev, kvd, P, lo, hi):
    """One verify window (W = SPEC_K + 1) against W sequential raw decode
    steps from the same pool state: 8 slots on disjoint pages (P a
    slot), 6 active at positions in [lo, hi) and 2 inactive, a random
    pool in the storage ``kvd``; the window's tokens are the sequential
    steps' greedy ids. Returns (the window's logits and pool, the
    sequential ones, the active rows' mask)."""
    bs, B, W = ENGINE_KW["block_size"], 8, SPEC_K + 1
    nb = B * P + 1
    rng = np.random.RandomState(41)
    pool_s = random_pool(torch, tt, cfg, nb, bs, kvd, dev, 19)
    pool_v = {n: t.clone() for n, t in pool_s.items()}
    blocks = rng.permutation(np.arange(1, nb)).astype(np.int32)
    table = blocks.reshape(B, P).copy()
    table[6:] = 0
    act = np.asarray([True] * 6 + [False] * 2)

    def T(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    pages, active = T(table), T(act)
    pos = T(np.concatenate([rng.randint(lo, hi, 6), [5, hi // 2]])
            .astype(np.int32))
    tok = T(rng.randint(0, cfg.vocab, B).astype(np.int32))
    seq, window = [], [tok]
    for j in range(W):
        lg, _ = tt.decode_step_paged(params, pool_s, tok, pos + j, active,
                                     pages, cfg, block_size=bs)
        seq.append(lg)
        tok = lg.argmax(-1).to(torch.int32)
        if j < W - 1:
            window.append(tok)
    valid = torch.full((B,), W, dtype=torch.int32, device=dev)
    vlg, _ = tt.verify_step_paged(params, pool_v, torch.stack(window, 1),
                                  pos, valid, active, pages, cfg,
                                  block_size=bs)
    return vlg, pool_v, torch.stack(seq, 1), pool_s, active


def window_numbers(torch, vlg, pool_v, seq, pool_s, active) -> dict:
    """The window check's reading over the active slots: max |logit
    difference|, whether logits, written pool and greedy ids are equal."""
    a, b = vlg[active].float(), seq[active].float()
    return {"max_abs_dlogit": (a - b).abs().max().item(),
            "logits_bitwise": torch.equal(a, b),
            "pool_bitwise": same_pool(torch, pool_v, pool_s),
            "greedy_equal": torch.equal(a.argmax(-1), b.argmax(-1))}


def check_spec_verify(torch, timer, kd, sampling, build, dev):
    """``fused_spec_verify`` at the spec engine's shape, [8, 5, 50257]
    fp32 logits: every slot its own temperature and top_k (a tiled
    repeat of the controls would give rows other ones), drafts that
    match the greedy rows for a slot-dependent run, valid rows 1..5:
    sampled ids and accepted counts exactly the plain version's (the
    plain sampler over the flattened rows and ``spec_accept``). Timed
    through the wrapper, its kernel launch as the C entry alone
    (``entry_ms``) and on the device (``device_ms``), the plain version,
    and topk + softmax + multinomial over the [40, V] rows."""
    B, W, V = 8, SPEC_K + 1, 50257
    rng = np.random.RandomState(45)
    x = torch.from_numpy((3.0 * rng.randn(B, W, V)).astype(np.float32)
                         ).to(dev)
    draft = x.argmax(-1)[:, :W - 1].to(torch.int32).clone()
    for b in range(B):
        if b % W < W - 1:
            draft[b, b % W] = (draft[b, b % W] + 1) % V
    temp = torch.tensor([0.0, 0.8, 0.0, 1.1, 0.0, 0.6, 0.7, 0.9],
                        device=dev)
    topk = torch.tensor([0, 50, 0, 20, 7, 5, 0, 100], dtype=torch.int32,
                        device=dev)
    valid = torch.tensor([5, 5, 3, 5, 1, 4, 2, 5], dtype=torch.int32,
                         device=dev)
    seed = torch.tensor(4321, dtype=torch.int32, device=dev)
    flat = x.reshape(B * W, V)
    temp_r = sampling.window_rows(temp, W)
    topk_r = sampling.window_rows(topk, W)

    def plain():
        ids = kd.fused_sample_plain(flat, seed, temp_r, topk_r).reshape(B, W)
        return ids, sampling.spec_accept(ids, draft, valid)

    ids, n = kd.fused_spec_verify(x, draft, seed, temp, topk, valid)
    want_ids, want_n = plain()
    torch.cuda.synchronize()
    err = float(max((ids.long() - want_ids.long()).abs().max().item(),
                    (n.long() - want_n.long()).abs().max().item()))

    def library():
        vals, idx = torch.topk(flat, 50, dim=-1)
        probs = torch.softmax(vals / 0.8, dim=-1)
        return idx.gather(-1, torch.multinomial(probs, 1))

    out = torch.empty(B * W, dtype=torch.int32, device=dev)
    lib, ptr = build.library(), build.ptr
    args = [ptr(flat), ptr(temp_r), ptr(topk_r), ptr(out), B * W, V,
            ptr(seed), kd.STREAMS.index("hash"), build.stream(dev)]

    def entry():
        build.check(lib.pk_fused_sample(*args), "fused_sample")
        return out

    if not torch.equal(entry().reshape(B, W), ids):
        fail("fused_spec_verify: the C entry and the wrapper differ on the "
             "same inputs")
    times = {
        "ms": timer.ms(lambda: kd.fused_spec_verify(x, draft, seed, temp,
                                                    topk, valid)),
        "plain_ms": timer.ms(plain),
        "library_ms": timer.ms(library),
        "entry_ms": timer.ms(entry),
    }
    times["device_ms"], times["device_records"] = timer.device_ms(
        entry, "fused_sample")
    # one read of every logit (and the small per-slot vectors), the ids
    # and counts written; a few compares per logit
    times["bound_ms"], times["bound_by"] = bound(
        x.numel() * 4 + B * (W - 1) * 4 + B * 12 + B * W * 4 + B * 4,
        x.numel() * 4, "float32")
    return err, times


def target_margin(torch, tt, cfg, params, dev, buckets, prompt, ids, i):
    """The top-2 logit margin of the target-only engine's step that chose
    ``ids[i]`` for ``prompt``, recomputed with the raw steps at the
    engine's shapes: the prompt in chunks of ``chunk_tokens`` padded to
    the engine's buckets, then decode at B = 8 rows (row 0 active) fed
    ``ids[:i]``."""
    bs, C, B = (ENGINE_KW["block_size"], ENGINE_KW["chunk_tokens"],
                ENGINE_KW["batch"])
    P = ENGINE_KW["cache_len"] // bs
    pool = tt.init_block_pool(cfg, P + 1, bs, device=dev)
    pages = np.arange(1, P + 1, dtype=np.int32)

    def T(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    off, n = 0, len(prompt)
    while off < n:
        c = min(n - off, C)
        b = min(x for x in buckets if x >= c)
        padded = np.zeros((1, b), np.int32)
        padded[0, :c] = prompt[off:off + c]
        lg, _ = tt.prefill_into_blocks(
            params, pool, T(padded), c, T(pages[:off // bs + -(-b // bs)]),
            cfg, block_size=bs)
        off += c
    table = np.zeros((B, P), np.int32)
    table[0] = pages
    active = np.zeros(B, bool)
    active[0] = True
    for j in range(i):
        toks, pos = np.zeros(B, np.int32), np.zeros(B, np.int32)
        toks[0], pos[0] = ids[j], n + j
        lg, _ = tt.decode_step_paged(params, pool, T(toks), T(pos),
                                     T(active), T(table), cfg,
                                     block_size=bs)
    top = lg[0].float().topk(2).values
    return (top[0] - top[1]).item()


def greedy_gate(pairs, dmax, margin, label, against,
                bitwise=False) -> list:
    """Every greedy request's ids against ``against``'s ids for the same
    prompt (``pairs``: (request, reference ids)). A divergence passes
    only where the two paths are not bitwise and ``margin(request, ids,
    i)``, the reference step's top-2 logit margin at the first differing
    token ``i``, is below ``dmax``, the paths' max |logit difference|;
    each one is printed with its margin. Returns the divergences."""
    out = []
    for req, want in pairs:
        got, want = list(req.tokens), list(want)
        if got == want:
            continue
        i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b),
                 min(len(got), len(want)))
        m = margin(req, want, i)
        div = {"rid": req.rid, "token": i, "margin": m,
               "max_abs_dlogit": dmax}
        print(f"{label} greedy divergence: " + json.dumps(div))
        out.append(div)
        if bitwise or not m < dmax:
            fail(f"{label}: greedy request {req.rid} diverges from "
                 f"{against} at token {i} (margin {m} vs {dmax}, bitwise "
                 f"{bitwise})")
    return out


def spec_graph_check(torch, tt, sampling, cfg, target, dcfg, draft, dev):
    """The spec programs (``sampling.paged_spec_fns``) against their raw
    functions on the same inputs at the spec phase's shapes: propose,
    verify (greedy and sampled slots, per-slot valid rows, two inactive
    slots) and draft_verify (the replay rows), each captured at its first
    call and replayed with new inputs and after a page-table remap: ids,
    counts and every byte of both pools equal. Returns the graphs."""
    bs, B, W = ENGINE_KW["block_size"], 8, SPEC_K + 1
    P = 64
    nb = (B + 1) * P + 1
    spec = sampling.paged_spec_fns(cfg, dcfg, bs, SPEC_K)
    pools = {"g": random_pool(torch, tt, cfg, nb, bs, None, dev, 29),
             "dg": random_pool(torch, tt, dcfg, nb, bs, None, dev, 31)}
    pools["r"] = {n: t.clone() for n, t in pools["g"].items()}
    pools["dr"] = {n: t.clone() for n, t in pools["dg"].items()}
    rng = np.random.RandomState(47)
    blocks = rng.permutation(np.arange(1, nb)).astype(np.int32)
    table = blocks[:B * P].reshape(B, P).copy()
    table[6:] = 0

    def T(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    pages_dev = T(table)
    active = np.asarray([True] * 6 + [False] * 2)
    forced = np.asarray([False, True] * 4) & active
    temp = np.asarray([0.0, 0.8] * 4, np.float32)
    topk = np.asarray([0, 50] * 4, np.int32)
    for what, seed in (("first", 51), ("new inputs", 52),
                       ("after a remap", 53)):
        if what == "after a remap":
            table[1] = blocks[B * P:(B + 1) * P]
            pages_dev.copy_(T(table))
        last = rng.randint(0, cfg.vocab, B).astype(np.int32)
        pos = np.concatenate([rng.randint(300, 950, 6), [5, 700]]
                             ).astype(np.int32)
        valid = np.asarray([5, 4, 5, 2, 5, 1, 5, 5], np.int32)
        props, _ = spec["propose"](draft, pools["dg"], last, pos, active,
                                   valid, pages_dev)
        props = props.clone()
        want, _ = spec["propose"].raw(draft, pools["dr"], T(last), T(pos),
                                      T(active), T(valid), pages_dev)
        window = np.concatenate([last[:, None], props.cpu().numpy()], 1)
        X, n, _ = spec["verify"](target, pools["g"], window, pos, valid,
                                 active, pages_dev, temp, topk,
                                 np.int32(seed))
        X, n = X.clone(), n.clone()
        wX, wn, _ = spec["verify"].raw(
            target, pools["r"], T(window), T(pos), T(valid), T(active),
            pages_dev, T(temp), T(topk),
            torch.tensor(seed, dtype=torch.int32, device=dev))
        spec["draft_verify"](draft, pools["dg"], window, pos, valid, forced,
                             pages_dev)
        spec["draft_verify"].raw(draft, pools["dr"], T(window), T(pos),
                                 T(valid), T(forced), pages_dev)
        ok = (torch.equal(props, want) and torch.equal(X, wX)
              and torch.equal(n, wn)
              and same_pool(torch, pools["g"], pools["r"])
              and same_pool(torch, pools["dg"], pools["dr"]))
        if not ok:
            fail(f"spec graphs ({what}): a replay differs from its raw "
                 f"step")
    graphs = {k: spec[k].graphs for k in ("propose", "verify",
                                          "draft_verify")}
    if graphs != {"propose": 1, "verify": 1, "draft_verify": 1}:
        fail(f"spec graphs: captured {graphs}")
    return graphs


def spec_preempt(SpecDecodeEngine, cfg, target, dcfg, draft, dev):
    """``preempt_run`` with spec-engine victims (``spec_preempt:`` line):
    on the replay resume ``draft_verify`` writes the forced windows into
    the draft pool, so its graph must have been captured."""
    kw = dict(ENGINE_KW, batch=2, num_blocks=8, spec_k=SPEC_K)
    doc = preempt_run(lambda: SpecDecodeEngine.from_params(
        target, cfg, draft, dcfg, device=dev, **kw), cfg.vocab,
        "spec_preempt")
    if doc["captures"]["draft_verify"] < 1:
        fail(f"spec_preempt: draft_verify never ran: {doc['captures']}")
    return doc


def spec_phase(torch, tt, tlm, kd, q8, build, kernels, sampling,
               PagedDecodeEngine, SpecDecodeEngine, cfg, dev, params):
    """The ``spec:`` line: speculative decoding at GPT-2 small widths, on
    the repo's draft-friendly pair (``draft_pair``), k = 4.

    1. window check: one verify window of 5 rows against 5 sequential raw
       decode steps from the same pool state, on bf16, int8 and int4
       target pools (max |logit difference|, whether logits and written
       pool rows are bitwise equal); and on the fp32 step-parity model
       within 1e-4, window against steps and card against the CPU;
    2. kernel 1 at the verify's 40 rows (5 a slot sharing its page-table
       row) within 1e-4 of its plain version, and ``fused_spec_verify``
       at [8, 5, 50257] exactly (ids and accepted counts), both timed;
    3. the engine trace's 16 requests cold and then the seed-1 trace
       warm through a target-only ``PagedDecodeEngine`` and through a
       ``SpecDecodeEngine``, both on the scaled target; the spec cold
       run's launch counts are the phase's main-path counts (every
       kernel of the path and ``fused_spec_verify`` > 0); captures:
       propose 1, verify 1, draft_prefill = the target-only prefill's,
       decode 0; then 4 requests through an unrelated 2-layer draft
       (seed 1): low acceptance, rejections and rewinds at full width;
    4. greedy gate (``greedy_gate``) for both spec runs;
    5. a remap and a replay preemption of spec victims (``spec_preempt``,
       its own line);
    6. the port's v5 artifact of the pair saved, loaded and served (4
       greedy requests equal to the in-process spec engine's);
    7. the spec programs' replays bitwise their raw steps
       (``spec_graph_check``);
    8. a third trace (seed 2) through the warm spec engine under the
       profiler (``spec_profile:`` line).
    Returns (the spec trace's launch counts, the ``fused_spec_verify``
    kernel row)."""
    t_phase = time.perf_counter()
    W = SPEC_K + 1
    target, dcfg, draft = draft_pair(torch, tt, cfg, params)
    doc = {"k": SPEC_K, "draft_layers": SPEC_DRAFT_LAYERS,
           "alpha": SPEC_ALPHA}
    # 1. window check
    windows = {}
    for kvd in (None, "int8", "int4"):
        windows[kvd or "bf16"] = window_numbers(torch, *window_check(
            torch, tt, cfg, target, dev, kvd, 64, 300, 950))
    c32 = tt.TransformerConfig(vocab=256, d_model=128, n_heads=4,
                               n_kv_heads=2, n_layers=2, d_ff=256,
                               max_len=128, dtype="float32")
    runs = {d: window_check(torch, tt, c32, tt.init_params(
        c32, torch.Generator().manual_seed(5), d), d, None, 8, 40, 100)
        for d in ("cpu", dev)}
    w32 = window_numbers(torch, *runs[dev])
    vlg_c, pool_c = runs["cpu"][0], runs["cpu"][1]
    vlg_g, pool_g = runs[dev][0].cpu(), {n: t.cpu()
                                         for n, t in runs[dev][1].items()}
    w32["card_vs_cpu_logits"] = (vlg_g - vlg_c).abs().max().item()
    w32["card_vs_cpu_pool"] = max((pool_g[n] - pool_c[n]).abs().max().item()
                                  for n in pool_c)
    windows["fp32_step_parity"] = w32
    print("check spec window: verify window of 5 vs 5 sequential decode "
          "steps: " + json.dumps(windows))
    if not (w32["max_abs_dlogit"] <= 1e-4 and w32["card_vs_cpu_logits"]
            <= 1e-4 and w32["card_vs_cpu_pool"] <= 1e-4):
        fail(f"spec window (fp32): {w32} outside 1e-4")
    if not all(np.isfinite(w["max_abs_dlogit"]) for w in windows.values()):
        fail(f"spec window: non-finite logits {windows}")
    doc["window_check"] = windows
    dmax = windows["bf16"]["max_abs_dlogit"]
    bitwise = windows["bf16"]["logits_bitwise"]
    # 2. the kernels at the verify's shapes
    timer = Timer(torch)
    err1, t1 = check_decode(torch, timer, kd, q8, build, dev,
                            np.random.RandomState(43), 12, 1, 64, True,
                            window=W)
    err2, t2 = check_spec_verify(torch, timer, kd, sampling, build, dev)
    for name, err, tol, t in (
            ("flash_decode_attention (40 window rows)", err1, 1e-4, t1),
            ("fused_spec_verify", err2, 0.0, t2)):
        print(f"kernel {name}: max_abs_err={err!r} tol={tol!r} "
              + " ".join(f"{'kernel_ms' if k == 'ms' else k}={v!r}"
                         for k, v in t.items()))
        if not err <= tol:
            fail(f"{name} disagrees with its plain version: {err} > {tol}")
    doc["window_kernel"] = {"rows": 8 * W, "max_abs_err": err1, **t1}
    # 3. the engines, each timed from a fresh engine after a throwaway
    # one served a request (first-use costs stay out of the window)
    def make(draft_params=None):
        if draft_params is None:
            return PagedDecodeEngine.from_params(target, cfg, device=dev,
                                                 **ENGINE_KW)
        return SpecDecodeEngine.from_params(target, cfg, draft_params, dcfg,
                                            spec_k=SPEC_K, device=dev,
                                            **ENGINE_KW)

    reqs_in = trace(np.random.RandomState(0), cfg.vocab)
    warm_in = trace(np.random.RandomState(1), cfg.vocab)
    served = {}
    for kind, dp in (("target_only", None), ("spec", draft)):
        throwaway = make(dp)
        submit(throwaway, np.arange(40) % cfg.vocab, 4, 0.0)
        throwaway.run_until_idle()
        del throwaway
        eng = make(dp)
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()             # counts of the main path only
        reqs, wall, captures, capture_s = serve_trace(torch, eng, reqs_in)
        launches = {**kernels.launch_counts(), **kernels.entry_counts()}
        health = eng.health()
        d = trace_doc(reqs, wall, captures, capture_s)
        d.update({"decode_steps": health["decode_steps"],
                  "decode_mfu": eng.decode_mfu(),
                  "max_memory_allocated_bytes":
                      torch.cuda.max_memory_allocated(),
                  "launches": {k: v for k, v in launches.items() if v}})
        if dp is not None:
            d["spec"] = health["spec"]
        wreqs, wwall, wcaptures, wcapture_s = serve_trace(torch, eng,
                                                          warm_in)
        d["warm"] = trace_doc(wreqs, wwall, wcaptures, wcapture_s)
        if dp is not None:
            d["warm"]["spec_lifetime"] = eng.health()["spec"]
        check_served(f"spec {kind}", reqs, reqs_in, cfg.vocab)
        check_served(f"spec {kind} warm", wreqs, warm_in, cfg.vocab)
        if not eng.pool.idle:
            fail(f"spec {kind}: blocks still held after the engine drained")
        served[kind] = (eng, reqs, wreqs, d, launches)
    doc["target_only"] = served["target_only"][3]
    doc["spec"] = served["spec"][3]
    t_eng, t_reqs, t_wreqs = served["target_only"][:3]
    s_eng, s_reqs, s_wreqs, _, launches = served["spec"]
    del t_eng
    captures = doc["spec"]["captures"]
    want = {"prefill": doc["target_only"]["captures"]["prefill"],
            "decode": 0, "draft_prefill":
                doc["target_only"]["captures"]["prefill"],
            "propose": 1, "verify": 1, "draft_verify": 0}
    if captures != want:
        fail(f"spec: captured {captures}, expected {want}")
    path = list(SERVING_KERNELS) + ["fused_sample.threefry",
                                    "fused_spec_verify"]
    missing = [k for k in path if launches[k] <= 0]
    if missing:
        fail(f"spec: kernels never launched on the main path: {missing}")
    # 4. greedy gate, and an unrelated draft: rejections and rewinds
    pairs = ([(r, t.tokens) for r, t, (_, _, temp) in
              zip(s_reqs, t_reqs, reqs_in) if temp == 0]
             + [(r, t.tokens) for r, t, (_, _, temp) in
                zip(s_wreqs, t_wreqs, warm_in) if temp == 0])
    unrelated = tt.init_params(dcfg, torch.Generator().manual_seed(1), dev)
    u_eng = make(unrelated)
    u_in = reqs_in[:4]
    u_reqs, u_wall, _, _ = serve_trace(torch, u_eng, u_in)
    check_served("spec unrelated", u_reqs, u_in, cfg.vocab)
    doc["unrelated_draft"] = {"requests": len(u_reqs), "wall_s": u_wall,
                              "spec": u_eng.health()["spec"]}
    del u_eng, unrelated
    pairs += [(r, t.tokens) for r, t, (_, _, temp) in
              zip(u_reqs, t_reqs, u_in) if temp == 0]
    divergences = greedy_gate(
        pairs, dmax, lambda req, ids, i: target_margin(
            torch, tt, cfg, target, dev, s_eng.buckets, req.prompt, ids, i),
        "spec", "the target-only engine", bitwise)
    doc["greedy_gate"] = {"greedy_requests": len(pairs),
                          "divergences": divergences}
    print(f"check spec greedy: {len(pairs)} greedy requests (cold, warm, "
          f"unrelated draft) vs the target-only engine, "
          f"{len(divergences)} divergences, window bitwise {bitwise}")
    # 5. preemption
    doc["preempt"] = spec_preempt(SpecDecodeEngine, cfg, target, dcfg,
                                  draft, dev)
    # 6. the artifact
    greedy = [i for i, (_, _, temp) in enumerate(reqs_in) if temp == 0][:4]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        tlm.save_lm_artifact(
            f"{tmp}/pair.tar", target, cfg, batch=ENGINE_KW["batch"],
            prompt_len=ENGINE_KW["chunk_tokens"],
            cache_len=ENGINE_KW["cache_len"], engine_buckets=s_eng.buckets,
            engine_paged=True, engine_block_size=ENGINE_KW["block_size"],
            engine_draft_params=draft, engine_draft_config=dcfg,
            engine_spec_k=SPEC_K)
        save_s = time.perf_counter() - t0
        srv = tlm.load_lm_artifact(f"{tmp}/pair.tar")
        a_eng = srv.engine(seed=0, device=dev)
        load_s = time.perf_counter() - t0 - save_s
    a_in = [reqs_in[i] for i in greedy]
    a_reqs, _, _, _ = serve_trace(torch, a_eng, a_in)
    a_equal = [a.tokens == s_reqs[i].tokens for a, i in zip(a_reqs, greedy)]
    doc["artifact"] = {"format_version": srv.meta["format_version"],
                       "engine": type(a_eng).__name__, "save_s": save_s,
                       "load_s": load_s, "ids_equal_in_process": a_equal}
    del a_eng, srv
    if not (all(a_equal) and doc["artifact"]["engine"] == "SpecDecodeEngine"
            and doc["artifact"]["format_version"] == 5):
        fail(f"spec artifact: {doc['artifact']}")
    # 7. replays against raw steps
    doc["graphs"] = spec_graph_check(torch, tt, sampling, cfg, target, dcfg,
                                     draft, dev)
    # 8. where a warm spec trace's time goes
    prof_in = trace(np.random.RandomState(2), cfg.vocab)

    def serve():
        for r in prof_in:
            submit(s_eng, *r)
        s_eng.run_until_idle()
        torch.cuda.synchronize()
    profile = profile_window(torch, serve)
    doc["phase_s"] = time.perf_counter() - t_phase
    print("spec: " + json.dumps(doc))
    print("spec_profile: " + json.dumps(profile))
    del s_eng
    row = (err2, {"rows": 8 * W}, t2)
    return launches, row


# ---------------------------------------------------------------------------
# slot engine and lockstep phase
# ---------------------------------------------------------------------------

SLOT_KW = dict(batch=8, cache_len=1024, buckets=(16, 32, 64, 128, 256, 512),
               seed=0)
LOCKSTEP_B, LOCKSTEP_TP, LOCKSTEP_NEW = 4, 128, 64
SLOT_FLASH_TIMED = (16, 512)            # row 5s: B = 1, the end buckets


def slot_trace(rng, vocab):
    """The engine trace with every prompt clipped to its first 512
    tokens (the slot engine's largest bucket): 32..512 tokens."""
    top = SLOT_KW["buckets"][-1]
    return [(p[:top], m, t) for p, m, t in trace(rng, vocab)]


def slot_flash(torch, ka, build, ragged) -> dict:
    """Kernel 5 at every shape the slot and lockstep paths give it (12
    heads, D = 64, bf16, causal): B = 1 at each slot bucket (16..512) and
    at the ``ragged`` prompt lengths that ``generate`` prefills at B = 1
    in the greedy gate; B = 4, T = 128 (``generate`` and
    ``LMServer.generate`` in ``lockstep:``) and B = 2, T = 128
    (``beam_search``). Each against its plain version within 2 bf16 ulps
    (lse 1e-4), two launches bitwise equal; timed at B = 1, T = 16 and
    512 against SDPA ``is_causal``, with its bound (row 5s)."""
    dev = torch.device("cuda:0")
    timer = Timer(torch)
    shapes = ([(1, T) for T in SLOT_KW["buckets"]]
              + [(1, T) for T in ragged]
              + [(LOCKSTEP_B, LOCKSTEP_TP), (2, LOCKSTEP_TP)])
    doc = {}
    for B, T in shapes:
        errs, ulps, rep, times = check_flash(
            torch, timer, ka, build, dev, B, T, 12, 12, 64, torch.bfloat16,
            True, B == 1 and T in SLOT_FLASH_TIMED)
        row = {"max_abs_err": errs["fwd"][0], "bf16_ulps": ulps["fwd"],
               "lse_err": errs["fwd"][1], "bitwise_repeat": rep}
        if times is not None:
            row.update(times["fwd"])
        doc[f"B={B},T={T}"] = row
        if not (ulps["fwd"] <= FLASH_BF16_ULPS
                and errs["fwd"][1] <= FLASH_LSE_TOL and rep):
            fail(f"flash_attention_fwd at the slot/lockstep B={B}, T={T}: "
                 f"{row}")
    print("kernel flash_attention_fwd (slot and lockstep paths, H=12, D=64, "
          "bf16, causal): " + json.dumps(doc))
    return doc


def slot_graph_check(torch, tt, sampling, cfg, params, dev) -> dict:
    """The slot engine's step programs (``sampling.engine_step_fns``)
    against their raw functions on a random arena at the engine's
    shapes: prefill at bucket 64 into slot 3 (sampled), the same bucket's
    graph replayed into slot 5 greedy and twice more sampled with two
    seeds (each replay must give the raw step's id for its own seed, and
    the two seeds must draw different ids), a prefill at bucket 512;
    decode at 8 rows (6 active, half sampled), replayed with a new seed.
    After each call the ids and every arena byte equal. Then
    ``decode_step_slots`` at 8 equal positions against ``decode_step``:
    logits and arena bitwise."""
    B, L = SLOT_KW["batch"], SLOT_KW["cache_len"]
    prefill, decode = sampling.engine_step_fns(cfg)
    gen = torch.Generator(device=dev).manual_seed(31)
    arena_g = tt.init_cache(cfg, B, L, device=dev)
    for t in arena_g.values():
        t.copy_(torch.randn(t.shape, generator=gen, device=dev))
    arena_r = {n: t.clone() for n, t in arena_g.items()}
    rng = np.random.RandomState(32)

    def T(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def scalar(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    def same():
        return all(torch.equal(arena_g[n].view(torch.int16),
                               arena_r[n].view(torch.int16)) for n in arena_g)

    calls, drawn = 0, {}
    for what, bucket, n, slot, temp, seed in (
            ("prefill", 64, 50, 3, 0.8, 41), ("prefill greedy", 64, 40, 5,
                                               0.0, 42),
            ("prefill seed a", 64, 50, 3, 5.0, 43),
            ("prefill seed b", 64, 50, 3, 5.0, 44),
            ("prefill 512", 512, 300, 6, 0.8, 45)):
        toks = np.zeros((1, bucket), np.int32)
        if what != "prefill seed b":
            prompt = rng.randint(0, cfg.vocab, n)
        toks[0, :n] = prompt
        ctl = (np.asarray([temp], np.float32), np.asarray([50], np.int32))
        got, _ = prefill(params, arena_g, toks, np.int32(n), np.int32(slot),
                         *ctl, np.int32(seed))
        got = got.clone()
        want, _ = prefill.raw(params, arena_r, T(toks), scalar(n),
                              scalar(slot), *map(T, ctl), scalar(seed))
        calls += 1
        if not (torch.equal(got, want) and same()):
            fail(f"slot graphs: {what}: replay {got.tolist()} vs raw "
                 f"{want.tolist()}, arenas equal {same()}")
        drawn[seed] = int(got[0])
    pos = np.concatenate([rng.randint(100, 1000, 6), [5, 1023]]).astype(
        np.int32)
    active = np.asarray([True] * 6 + [False] * 2)
    temp = np.asarray([0.0, 0.8] * 4, np.float32)
    topk = np.asarray([0, 50] * 4, np.int32)
    for what, seed in (("decode", 51), ("decode, new seed", 52)):
        toks = rng.randint(0, cfg.vocab, B).astype(np.int32)
        got, _ = decode(params, arena_g, toks, pos, active, temp, topk,
                        np.int32(seed))
        got = got.clone()
        want, _ = decode.raw(params, arena_r, T(toks), T(pos), T(active),
                             T(temp), T(topk), scalar(seed))
        calls += 1
        if not (torch.equal(got, want) and same()):
            fail(f"slot graphs: {what}: replay {got.tolist()} vs raw "
                 f"{want.tolist()}, arenas equal {same()}")
    if drawn[43] == drawn[44]:
        fail(f"slot graphs: seeds 43 and 44 drew the same id {drawn[43]}: "
             f"the replay may have frozen its seed")
    graphs = {"prefill": prefill.graphs, "decode": decode.graphs}
    if graphs != {"prefill": 2, "decode": 1}:
        fail(f"slot graphs: captured {graphs}")
    # the slot step at equal positions is the lockstep step, bitwise
    toks = T(rng.randint(0, cfg.vocab, B).astype(np.int32))
    c1 = {n: t.clone() for n, t in arena_r.items()}
    c2 = {n: t.clone() for n, t in arena_r.items()}
    l1, c1 = tt.decode_step(params, c1, toks, 700, cfg)
    l2, c2 = tt.decode_step_slots(params, c2, toks,
                                  torch.full((B,), 700, dtype=torch.int32,
                                             device=dev),
                                  torch.ones(B, dtype=torch.bool, device=dev),
                                  cfg)
    lock_bitwise = torch.equal(l1, l2) and all(
        torch.equal(c1[n].view(torch.int16), c2[n].view(torch.int16))
        for n in c1)
    if not lock_bitwise:
        fail("decode_step_slots at equal positions is not bitwise "
             "decode_step on the card")
    return {"graphs": graphs, "calls": calls,
            "two_seed_ids": [drawn[43], drawn[44]],
            "slots_vs_lockstep_bitwise": lock_bitwise}


def lockstep_margin(torch, tt, cfg, params, dev, prompt, ids, i):
    """The top-2 logit margin of the lockstep step that chose ``ids[i]``
    for ``prompt`` (``generate``'s arithmetic at B = 1 and its cache
    length), fed ``ids[:i]``."""
    lg, cache = tt.prefill(params, torch.from_numpy(prompt[None]).to(dev),
                           cfg, len(prompt) + len(ids))
    for j in range(i):
        lg, cache = tt.decode_step(
            params, cache, torch.tensor([ids[j]], dtype=torch.int32,
                                        device=dev), len(prompt) + j, cfg)
    top = lg[0].float().topk(2).values
    return (top[0] - top[1]).item()


def slot_dlogit(torch, tt, cfg, params, dev) -> float:
    """Max |logit difference| between the slot path (the prompt padded to
    its bucket in row 3 of an 8-row arena of 1024, then decode steps at 8
    rows, only row 3 active) and the lockstep path at B = 1
    (``generate``'s), over the 16 greedy steps of one 300-token prompt:
    what cuBLAS at other row counts, kernel 5 at the padded length and
    the arena's length move. The greedy gate's near-tie bound."""
    prompt = np.random.RandomState(33).randint(0, cfg.vocab, 300)
    steps = 16
    arena = tt.init_cache(cfg, 8, SLOT_KW["cache_len"], device=dev)
    padded = np.zeros((1, 512), np.int32)
    padded[0, :300] = prompt
    slot_lg, arena = tt.prefill_into_slot(
        params, arena, torch.from_numpy(padded).to(dev),
        torch.tensor(300, dtype=torch.int32, device=dev),
        torch.tensor(3, dtype=torch.int32, device=dev), cfg)
    lock_lg, cache = tt.prefill(params, torch.from_numpy(prompt[None]).to(
        dev), cfg, 300 + steps)
    dmax = (slot_lg[0] - lock_lg[0]).abs().max().item()
    active = torch.zeros(8, dtype=torch.bool, device=dev)
    active[3] = True
    for j in range(steps - 1):
        tok = int(lock_lg[0].argmax())
        toks = torch.zeros(8, dtype=torch.int32, device=dev)
        toks[3] = tok
        pos = torch.zeros(8, dtype=torch.int32, device=dev)
        pos[3] = 300 + j
        slot_lg, arena = tt.decode_step_slots(params, arena, toks, pos,
                                              active, cfg)
        lock_lg, cache = tt.decode_step(params, cache, toks[3:4], 300 + j,
                                        cfg)
        dmax = max(dmax, (slot_lg[3] - lock_lg[0]).abs().max().item())
    return dmax


def arena_attention_ms(torch, tt, cfg, dev) -> float:
    """Device time of one layer's arena attention at the slot engine's
    decode shape (8 rows over 1024 positions, 12 heads, Dh 64, bf16
    arena), as the decode graph runs it: captured into a CUDA graph of
    its own (so no host launch gap is timed) and replayed, CUDA events
    around the replay, median of ``REPEATS``, each after the L2-evicting
    write (a step's 12 layers read 25 MB of arena each)."""
    B, L = SLOT_KW["batch"], SLOT_KW["cache_len"]
    g = torch.Generator(device=dev).manual_seed(34)
    q = torch.randn(B, 12, 1, 64, generator=g, device=dev).to(cfg.dtype)
    kc, vc = (torch.randn(B, L, 12, 64, generator=g, device=dev)
              .to(cfg.dtype) for _ in range(2))
    attend = torch.arange(L, device=dev)[None, :] <= torch.randint(
        0, L, (B, 1), generator=g, device=dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        tt.arena_attention(q, kc, vc, attend)       # warm-up
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        tt.arena_attention(q, kc, vc, attend)
    return Timer(torch).ms(graph.replay)


def slots_phase(torch, tt, kernels, sampling, ka, build, DecodeEngine,
                PagedDecodeEngine, cfg, dev, params) -> dict:
    """The ``slots:`` line: the row-arena slot engine at GPT-2 small widths
    (batch 8, an arena of 1024 positions, buckets 16..512) on the engine
    trace clipped to 512-token prompts, cold in a fresh engine (every
    capture in its window) and then warm (seed 1); the paged engine's
    figures on the same two clipped traces beside it. Checks every
    request, each kernel of the path launched (kernel 5 in the slot
    prefills, kernel 2 on both streams), captures = buckets met + 1, and
    every greedy request against ``generate`` at B = 1 (divergences only
    at near-ties: ``greedy_gate``); prints kernel 5 at the shapes the
    slot and lockstep paths give it, the step programs' replays against their raw
    steps, the arena attention's share of a decode step and a profiled
    third trace (``slots_profile:``). Returns the cold run's launch
    counts."""
    from paddle_tpu_torch.core import ragged
    t_phase = time.perf_counter()
    warm_eng = DecodeEngine.from_params(params, cfg, device=dev, **SLOT_KW)
    warm = submit(warm_eng, np.arange(40) % cfg.vocab, 4, 0.0)
    warm_eng.run_until_idle()
    if len(warm.tokens) != 4:
        fail("slots: warm-up request did not finish")
    del warm_eng
    eng = DecodeEngine.from_params(params, cfg, device=dev, **SLOT_KW)
    reqs_in = slot_trace(np.random.RandomState(0), cfg.vocab)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()                 # counts of the main path only
    reqs, wall, captures, capture_s = serve_trace(torch, eng, reqs_in)
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    health = eng.health()
    doc = trace_doc(reqs, wall, captures, capture_s)
    doc.pop("prefix_hit_tokens")
    step = eng.metrics.get("engine_decode_step_seconds").snapshot()
    doc.update({"decode_mfu": eng.decode_mfu(),
                "decode_steps": health["decode_steps"],
                "decode_step_ms_mean": 1e3 * step["avg"],
                "prefill_ms_mean": 1e3 * eng.metrics.get(
                    "engine_prefill_seconds").snapshot()["avg"],
                "max_memory_allocated_bytes": peak,
                "arena_bytes": sum(t.numel() * t.element_size()
                                   for t in eng.cache.values()),
                "launches": {k: v for k, v in launches.items() if v}})
    check_served("slots", reqs, reqs_in, cfg.vocab)
    path = ("fused_sample", "fused_sample.threefry", "flash_attention_fwd")
    missing = [k for k in path if launches[k] <= 0]
    if missing:
        fail(f"slots: kernels never launched on the main path: {missing}")
    met = {ragged.bucket_length(len(p), eng.buckets) for p, _, _ in reqs_in}
    if captures != {"prefill": len(met), "decode": 1}:
        fail(f"slots: captured {captures}, expected {len(met)} prefill "
             f"graphs (buckets met {sorted(met)}) + 1 decode")
    doc["buckets_met"] = sorted(met)
    warm_in = slot_trace(np.random.RandomState(1), cfg.vocab)
    wreqs, wwall, wcaptures, wcapture_s = serve_trace(torch, eng, warm_in)
    step_w = eng.metrics.get("engine_decode_step_seconds").snapshot()
    check_served("slots warm", wreqs, warm_in, cfg.vocab)
    wmet = {ragged.bucket_length(len(p), eng.buckets) for p, _, _ in warm_in}
    if wcaptures != {"prefill": len(wmet - met), "decode": 0}:
        fail(f"slots warm: captured {wcaptures}")
    doc["warm"] = trace_doc(wreqs, wwall, wcaptures, wcapture_s)
    doc["warm"].pop("prefix_hit_tokens")
    doc["warm"]["decode_step_ms_mean"] = 1e3 * (
        (step_w["sum"] - step["sum"]) / (step_w["count"] - step["count"]))
    # the paged engine on the same clipped traces
    p_eng = PagedDecodeEngine.from_params(params, cfg, device=dev,
                                          **ENGINE_KW)
    preqs, pwall, pcapt, pcap_s = serve_trace(torch, p_eng, reqs_in)
    pwreqs, pwwall, pwcapt, pwcap_s = serve_trace(torch, p_eng, warm_in)
    doc["paged"] = {**trace_doc(preqs, pwall, pcapt, pcap_s),
                    "decode_mfu": p_eng.decode_mfu(),
                    "warm": trace_doc(pwreqs, pwwall, pwcapt, pwcap_s)}
    del p_eng
    # the greedy gate against generate at B = 1
    dmax = slot_dlogit(torch, tt, cfg, params, dev)
    pairs = [(req, tt.generate(params, torch.from_numpy(p[None]).to(dev),
                               cfg, max_new=m)[0, len(p):].tolist())
             for req, (p, m, t) in zip(reqs + wreqs, reqs_in + warm_in)
             if t == 0]
    divs = greedy_gate(
        pairs, dmax, lambda req, ids, i: lockstep_margin(
            torch, tt, cfg, params, dev, req.prompt, ids, i),
        "slots", "generate")
    n_greedy = len(pairs)
    doc["greedy_gate"] = {"requests": int(n_greedy),
                          "divergences": len(divs),
                          "max_abs_dlogit_slot_vs_lockstep": dmax}
    print(f"check slots greedy: {n_greedy} greedy requests against "
          f"generate at B=1, {len(divs)} divergences (each at a near-tie), "
          f"max |dlogit| slot vs lockstep {dmax!r}")
    # kernel 5 at every shape this phase and ``lockstep:`` launch it at;
    # 300 is ``slot_dlogit``'s prompt
    ragged = sorted({len(p) for p, _, t in reqs_in + warm_in if t == 0}
                    | {300})
    doc["flash_slot_prefill"] = slot_flash(torch, ka, build, ragged)
    doc["graphs"] = slot_graph_check(torch, tt, sampling, cfg, params, dev)
    # where a warm decode step's time goes: the arena attention alone,
    # 12 layers of it, against the warm trace's mean step (replay, ids
    # copy and host work included)
    attn_ms = arena_attention_ms(torch, tt, cfg, dev)
    doc["arena_attention_ms_per_layer"] = attn_ms
    doc["arena_attention_share_of_warm_step"] = (
        cfg.n_layers * attn_ms / doc["warm"]["decode_step_ms_mean"])
    prof_in = slot_trace(np.random.RandomState(2), cfg.vocab)

    def serve():
        for r in prof_in:
            submit(eng, *r)
        eng.run_until_idle()
        torch.cuda.synchronize()
    profile = profile_window(torch, serve)
    # whether the arena attention leads a warm step (ROADMAP B's test)
    profile["arena_attention_share_of_warm_step"] = \
        doc["arena_attention_share_of_warm_step"]
    doc["phase_s"] = time.perf_counter() - t_phase
    print("slots: " + json.dumps(doc))
    print("slots_profile: " + json.dumps(profile))
    del eng
    return launches


def lockstep_phase(torch, tt, tlm, prng, DecodeEngine, cfg, dev, params):
    """The ``lockstep:`` line: ``generate`` at B = 4, 128-token prompts,
    64 new tokens, greedy and sampled (temperature 0.8, key 0), each
    timed after a warm-up call, twice greedy (bitwise the same ids);
    ``beam_search`` at B = 2, K = 4, 16 new tokens (scores finite, best
    first); then the port's v1 and v3 artifacts of the same weights
    (batch 4, prompt length 128, 192 positions, v3's buckets 64 and
    128), saved and loaded: ``LMServer.generate`` gives ``generate``'s
    greedy ids, and the v3 engine serves the four prompts with the ids
    of an in-process slot engine of the same geometry."""
    t_phase = time.perf_counter()
    B, Tp, new = LOCKSTEP_B, LOCKSTEP_TP, LOCKSTEP_NEW
    prompt = np.random.RandomState(35).randint(0, cfg.vocab, (B, Tp)).astype(
        np.int32)
    pt = torch.from_numpy(prompt).to(dev)
    doc = {}

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    greedy, g_s = timed(lambda: tt.generate(params, pt, cfg, max_new=new))
    sampled, s_s = timed(lambda: tt.generate(
        params, pt, cfg, max_new=new, temperature=0.8,
        key=prng.prng_key(0)))
    again = tt.generate(params, pt, cfg, max_new=new)
    for name, ids in (("greedy", greedy), ("sampled", sampled)):
        if (ids.shape != (B, Tp + new) or not torch.equal(ids[:, :Tp], pt)
                or ids.min() < 0 or ids.max() >= cfg.vocab):
            fail(f"lockstep generate ({name}): shape {tuple(ids.shape)}, "
                 f"ids in [{ids.min()}, {ids.max()}]")
    if not torch.equal(greedy, again) or torch.equal(greedy, sampled):
        fail("lockstep generate: greedy not repeatable, or sampling gave "
             "the greedy ids")
    doc["generate"] = {"batch": B, "prompt_len": Tp, "max_new": new,
                       "greedy_s": g_s, "greedy_tokens_per_s": B * new / g_s,
                       "sampled_s": s_s,
                       "sampled_tokens_per_s": B * new / s_s}
    (toks, scores), b_s = timed(lambda: tt.beam_search(
        params, pt[:2], cfg, max_new=16, beam_size=4))
    sc = scores.float()
    if (toks.shape != (2, 4, Tp + 16) or not torch.isfinite(sc).all()
            or (sc[:, 1:] > sc[:, :-1]).any()):
        fail(f"beam_search: shape {tuple(toks.shape)}, scores "
             f"{sc.tolist()}")
    doc["beam_search"] = {"batch": 2, "beam": 4, "max_new": 16, "s": b_s,
                          "scores": sc.tolist()}
    art = {}
    kw = dict(batch=B, prompt_len=Tp, cache_len=Tp + new)
    with tempfile.TemporaryDirectory() as tmp:
        for version, extra in (("v1", {}),
                               ("v3", {"engine_buckets": (64, 128)})):
            t0 = time.perf_counter()
            tlm.save_lm_artifact(f"{tmp}/{version}.tar", params, cfg, **kw,
                                 **extra)
            save_s = time.perf_counter() - t0
            srv = tlm.load_lm_artifact(f"{tmp}/{version}.tar")
            load_s = time.perf_counter() - t0 - save_s
            ids = srv.generate(prompt, new, device=dev)
            row = {"format_version": srv.meta["format_version"],
                   "save_s": save_s, "load_s": load_s,
                   "generate_ids_equal": bool(np.array_equal(
                       ids, greedy.cpu().numpy()))}
            if version == "v3":
                a_eng = srv.engine(seed=0, device=dev)
                ref = DecodeEngine.from_params(
                    params, cfg, batch=B, cache_len=Tp + new,
                    buckets=(64, 128), seed=0, device=dev)
                got = [submit(a_eng, p, new, 0.0) for p in prompt]
                want = [submit(ref, p, new, 0.0) for p in prompt]
                a_eng.run_until_idle()
                ref.run_until_idle()
                row["engine"] = type(a_eng).__name__
                row["engine_ids_equal"] = [a.tokens == b.tokens
                                           for a, b in zip(got, want)]
                del a_eng, ref
            art[version] = row
            del srv
    doc["artifacts"] = art
    doc["phase_s"] = time.perf_counter() - t_phase
    print("lockstep: " + json.dumps(doc))
    if not (art["v1"]["generate_ids_equal"] and art["v3"]["generate_ids_equal"]
            and art["v1"]["format_version"] == 1
            and art["v3"]["format_version"] == 3
            and art["v3"]["engine"] == "DecodeEngine"
            and all(art["v3"]["engine_ids_equal"])):
        fail(f"lockstep artifacts: {art}")


# ---------------------------------------------------------------------------
# training phase
# ---------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_SEQ, WARMUP, TIMED = 8, 1024, 2, 10


def train_phase(torch, tt, topt, kernels, costs, place, cfg, dev):
    """``benchmarks/transformer_bench.py``'s ``_run_variant`` on the
    port: bf16, flash attention, dropout 0, Adam(1e-4), one batch from
    RandomState(0) with targets rolled by one; 2 warm-up and 10 timed
    steps, each ended by ``torch.cuda.synchronize()``."""
    params = tt.init_train_params(cfg, torch.Generator().manual_seed(0), dev)
    adam = topt.Adam(learning_rate=1e-4)
    state = adam.tree_init_state(params)
    rng = np.random.RandomState(0)
    tokens = torch.from_numpy(rng.randint(
        0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)).to(dev)
    targets = tokens.roll(-1, 1)

    def step(i):
        nonlocal params, state
        loss = tt.lm_loss(params, tokens, targets, cfg)
        loss.backward()
        params, state = adam.tree_update(i, topt.take_grads(params), params,
                                         state)
        torch.cuda.synchronize()
        return loss.item()

    torch.cuda.reset_peak_memory_stats()
    losses = [step(i) for i in range(WARMUP)]
    kernels.reset_launches()                 # counts of the timed steps
    times = []
    for i in range(WARMUP, WARMUP + TIMED):
        t0 = time.perf_counter()
        losses.append(step(i))
        times.append(time.perf_counter() - t0)
    launches = kernels.launch_counts()
    p50 = float(np.median(times))
    flops = costs.train_step_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    doc = {"batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps_timed": TIMED,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ * TIMED / sum(times),
           "step_ms_p50": p50 * 1e3, "step_ms_min": min(times) * 1e3,
           "step_ms_max": max(times) * 1e3, "step_flops": flops,
           "train_mfu": costs.mfu(flops, p50, place.peak_flops(dev)),
           "first_loss": losses[0], "last_loss": losses[-1],
           "losses": losses,
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "launches": launches}
    print("train: " + json.dumps(doc))
    if not all(np.isfinite(losses)):
        fail(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"the loss did not fall: {losses[0]} -> {losses[-1]}")
    for name in TRAINING_KERNELS + FP32_BRANCHES:
        want = cfg.n_layers * TIMED if name in TRAINING_KERNELS else 0
        if launches[name] != want:
            fail(f"{name} launched {launches[name]} times in {TIMED} "
                 f"steps, expected {want}")
    train_profile(torch, step, WARMUP + TIMED)
    return launches


def profile_window(torch, fn) -> dict:
    """Run ``fn`` once under ``torch.profiler`` (CPU and CUDA activity):
    the host-clocked time, the ten device kernels with the most total
    time (name, calls, ms), the device's busy time (the union of its
    kernel and copy intervals) and its share of the host-clocked time,
    or that the trace holds no device time; ``port_kernels``: calls, ms
    and share of the busy time of each of the port's kernels (by name
    fragment), wherever they rank; ``host_top``: the ten host-side
    events (PyTorch operators and CUDA runtime calls) with the most self
    time, which is where the host's share of the window goes (a
    synchronising call's self time is its wait for the device)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_name, host = [], {}, {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            calls, us = host.get(ev.name, (0, 0.0))
            host[ev.name] = (calls + 1, us + ev.self_cpu_time_total)
            continue
        start, end = ev.time_range.start, ev.time_range.end
        spans.append((start, end))
        calls, us = by_name.get(ev.name, (0, 0.0))
        by_name[ev.name] = (calls + 1, us + (end - start))
    if not spans:
        return {"step_ms": wall_ms, "device_time": "none in the trace"}
    busy, reach = 0.0, None
    for start, end in sorted(spans):
        if reach is None or start > reach:
            busy += end - start
            reach = end
        elif end > reach:
            busy += end - reach
            reach = end
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    port = {}
    for frag in PORT_KERNEL_NAMES:
        hits = [v for name, v in by_name.items() if frag in name]
        us = sum(u for _, u in hits)
        port[frag] = {"calls": sum(c for c, _ in hits), "ms": us / 1e3,
                      "busy_share": us / busy}
    return {"step_ms": wall_ms, "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / 1e3 / wall_ms,
            "device_span_ms": (max(e for _, e in spans)
                               - min(s for s, _ in spans)) / 1e3,
            "device_kernels": len(spans),
            "top": [{"name": name[:120], "calls": calls, "ms": us / 1e3}
                    for name, (calls, us) in top],
            "port_kernels": port,
            "host_top": [{"name": name[:80], "calls": calls,
                          "self_ms": us / 1e3} for name, (calls, us) in
                         sorted(host.items(), key=lambda kv: -kv[1][1])[:10]]}


# a fragment of each port kernel's device name, for profile_window
PORT_KERNEL_NAMES = ("decode_split_kernel", "fused_sample_kernel",
                     "chunk_prefill", "span_write_kernel", "flash_fwd",
                     "flash_bwd")


def train_profile(torch, step, i):
    """One more training step under ``torch.profiler``: the
    ``train_profile:`` line (``profile_window``)."""
    print("train_profile: " + json.dumps(profile_window(torch,
                                                        lambda: step(i))))


# ---------------------------------------------------------------------------


SOURCES = {
    "flash_decode_attention": ("decode_attention.cu",
                               "paddle_tpu/ops/pallas/decode.py:382"),
    "fused_sample": ("fused_sample.cu",
                     "paddle_tpu/ops/pallas/decode.py:558"),
    # the same kernel on the threefry stream: the paged prefill tail,
    # where the JAX package samples with sample_tokens and jax.random
    "fused_sample.threefry": ("fused_sample.cu",
                              "paddle_tpu/ops/pallas/decode.py:558"),
    "flash_chunk_prefill": ("chunk_prefill.cu",
                            "paddle_tpu/ops/pallas/prefill.py:314"),
    "paged_span_write": ("span_write.cu",
                         "paddle_tpu/ops/pallas/prefill.py:442"),
    "flash_attention_fwd": ("flash_attn_fwd.cu",
                            "paddle_tpu/ops/pallas/attention.py:351"),
    "flash_attention_bwd": ("flash_attn_bwd.cu",
                            "paddle_tpu/ops/pallas/attention.py:268"),
    # the same TPU kernels for fp32 inputs: the CUDA-core branch
    "flash_attention_fwd.fp32": ("flash_attn_fwd_f32.cu",
                                 "paddle_tpu/ops/pallas/attention.py:351"),
    "flash_attention_bwd.fp32": ("flash_attn_bwd_f32.cu",
                                 "paddle_tpu/ops/pallas/attention.py:268"),
}
SERVING_KERNELS = ("flash_decode_attention", "fused_sample",
                   "flash_chunk_prefill", "paged_span_write")
# the quantized branches of kernels 1, 3 and 4, each its own entry: the
# same source, the TPU kernel's kv_dtype="int8"/"int4" path
QUANT_BRANCHES = tuple(f"{k}.{kvd}" for kvd in ("int8", "int4")
                       for k in SERVING_KERNELS if k != "fused_sample")
SOURCES.update({b: SOURCES[b.split(".")[0]] for b in QUANT_BRANCHES})
TRAINING_KERNELS = ("flash_attention_fwd", "flash_attention_bwd")
FP32_BRANCHES = tuple(f"{k}.fp32" for k in TRAINING_KERNELS)
# fp32 queries of kernels 1 and 3: the fp32 instantiation of the decode
# kernel and the CUDA-core prefill kernel, launched by the fp32 step
# functions (``step_parity``) under the pool storage "none"
PAGED_FP32 = ("flash_decode_attention", "flash_chunk_prefill")
SOURCES["flash_decode_attention.fp32"] = SOURCES["flash_decode_attention"]
SOURCES["flash_chunk_prefill.fp32"] = (
    "chunk_prefill_f32.cu", SOURCES["flash_chunk_prefill"][1])
# kernel 2 at a speculative verify window's rows, through the entry point
# that reaches it there (its launches: the spec trace's)
SOURCES["fused_spec_verify"] = ("fused_sample.cu",
                                "paddle_tpu/ops/pallas/decode.py:589")


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA card")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    if importlib.util.find_spec("paddle_tpu_torch") is None:
        fail("paddle_tpu_torch is not beside chip_smoke.py")
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.core import place
    from paddle_tpu_torch.io import lm_serving as tlm
    from paddle_tpu_torch.models import transformer as tt
    from paddle_tpu_torch.observe import costs
    from paddle_tpu_torch.ops import kernels, q8
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import attention as ka
    from paddle_tpu_torch.ops.kernels import decode as kd
    from paddle_tpu_torch.ops.kernels import prefill as kp
    from paddle_tpu_torch.ops import prng
    from paddle_tpu_torch.serving import (DecodeEngine, PagedDecodeEngine,
                                          SpecDecodeEngine, sampling)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = sh(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    nvcc = sh([_build.nvcc_path(), "--version"]).splitlines()[-1]
    env = {"torch": torch.__version__, "cuda": torch.version.cuda,
           "capability": list(torch.cuda.get_device_capability(0)),
           "nvcc": nvcc,
           "triton": importlib.util.find_spec("triton") is not None,
           "cutlass_include": Path("/usr/local/cutlass/include").exists(),
           "card": card, "tf32": False}
    print("env: " + json.dumps(env))

    t0 = time.perf_counter()
    _build.library()
    info = _build.build_info()
    print(f"build: nvcc_s={info['seconds']!r} load_s="
          f"{time.perf_counter() - t0!r} dir={info['dir']}")

    print("ptxas: " + json.dumps(ptxas_summary(
        info["dir"], ("decode_attention", "chunk_prefill",
                      "chunk_prefill_f32", "fused_sample", "span_write"))))

    dev = torch.device("cuda:0")
    rows = {**kernel_phase(torch, kd, kp, q8, _build),
            **flash_phase(torch, ka, _build)}
    kernels.reset_launches()            # counts of the fp32 step functions
    step_parity(torch, tt)
    fp32_steps = kernels.launch_counts()
    if not all(fp32_steps[k] > 0 for k in PAGED_FP32):
        fail(f"the fp32 step functions launched no fp32 paged kernel: "
             f"{fp32_steps}")
    step_parity_quant(torch, tt, tlm, q8)
    parity = train_parity(torch, tt, topt, kernels)
    cfg = gpt2_small(tt)
    params = tt.init_params(cfg, torch.Generator().manual_seed(0), dev)
    graph_phase(torch, tt, sampling, cfg, params, dev)
    served = engine_phase(torch, tt, kernels, PagedDecodeEngine, cfg, dev,
                          params, None, "engine", "")
    # (b) int4 pool, bf16 weights
    served4 = engine_phase(torch, tt, kernels, PagedDecodeEngine, cfg, dev,
                           params, "int4", "engine_int4", ".int4")
    preempt_phase(torch, PagedDecodeEngine, cfg, dev, params)
    prefix_phase(torch, kernels, PagedDecodeEngine, cfg, dev, params)
    spec_launches, rows["fused_spec_verify"] = spec_phase(
        torch, tt, tlm, kd, q8, _build, kernels, sampling, PagedDecodeEngine,
        SpecDecodeEngine, cfg, dev, params)
    slot_launches = slots_phase(torch, tt, kernels, sampling, ka, _build,
                                DecodeEngine, PagedDecodeEngine, cfg, dev,
                                params)
    kernels.reset_launches()            # counts of the lockstep calls
    lockstep_phase(torch, tt, tlm, prng, DecodeEngine, cfg, dev, params)
    lock_launches = kernels.launch_counts()
    if lock_launches["flash_attention_fwd"] <= 0:
        fail(f"lockstep: kernel 5 never launched: {lock_launches}")
    quant_logits_phase(torch, tt, cfg, params, dev)
    del params                  # (a)'s peak memory holds its weights only
    # (a) int8 pool, int8 weights from the same seed-0 fp32 draws
    fp32 = tt.init_train_params(cfg, torch.Generator().manual_seed(0), "cpu")
    w8 = tlm.quantize_lm_params(fp32, device=dev)
    del fp32
    served8 = engine_phase(torch, tt, kernels, PagedDecodeEngine, cfg, dev,
                           w8, "int8", "engine_int8", ".int8")
    del w8
    trained = train_phase(torch, tt, topt, kernels, costs, place, cfg, dev)
    launches = {**{k: served[k] for k in SERVING_KERNELS},
                "fused_sample.threefry": served["fused_sample.threefry"],
                **{k: served8[k] for k in QUANT_BRANCHES if "int8" in k},
                **{k: served4[k] for k in QUANT_BRANCHES if "int4" in k},
                **{k: trained[k] for k in TRAINING_KERNELS},
                **{k: parity[k] for k in FP32_BRANCHES},
                **{k + ".fp32": fp32_steps[k] for k in PAGED_FP32},
                "fused_spec_verify": spec_launches["fused_spec_verify"]}
    # the slot engine's trace and the lockstep calls run kernels 2 and 5
    for k in ("fused_sample", "fused_sample.threefry", "flash_attention_fwd"):
        launches[k] += slot_launches[k] + lock_launches[k]

    out = []
    for name, (src, replaces) in SOURCES.items():
        err, extra, times = rows[name]
        out.append({"name": name, "route": "cuda",
                    "source": f"paddle_tpu_torch/ops/kernels/csrc/{src}",
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": err, **extra, **times})
    print(card)
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
