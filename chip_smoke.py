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
3. holds each kernel, the int8 and int4 branches of kernels 1, 3 and 4,
   and both branches of kernels 5 and 6 (bf16 on the tensor cores, fp32
   on the CUDA cores) against its plain PyTorch version on the card, at
   its slice's shapes and at one GQA shape, and times kernel, plain
   version and a PyTorch library call that computes the same function
   (a yardstick only: the port never calls it; SDPA over gathered,
   dequantized K/V for a quantized pool), beside the least time the
   card could take (the bytes stored and moved over 3.35 TB/s or FLOPs
   over the peak for the input type, whichever is larger); kernels 5
   and 6 are timed at the training slice's shape in both dtypes and at
   the GQA D=128 shape in bf16, and launched twice on the same inputs,
   which must give bitwise the same outputs;
4. holds the serving step functions on the card against the CPU on a
   small fp32 model, with an fp32 pool and again with an int8 pool and
   int8 weights;
5. holds a small fp32 LM's training on the card against the CPU (one
   step's loss and gradients, then five Adam steps' losses), and runs
   the same three steps twice on the card: losses and weights must be
   bitwise equal (the attention backward uses no atomics). The card's
   five steps are the fp32 attention branch's path: their launch counts
   are that branch's ``launches`` (no bf16 kernel may launch there);
6. serves 16 seeded requests with a GPT-2-small-width engine (random
   weights from a seed) and reads each serving kernel's launch count
   for that run — every count must be > 0 — and checks that a
   prefix-cache hit gives the same greedy tokens as the same prompt
   served cold in a fresh engine;
7. does the same twice more over quantized pools: (b) an int4 pool
   with the bf16 weights, and (a) an int8 pool with
   ``quantize_lm_params`` int8 weights of the same seed-0 fp32 draws
   (the bf16 weights freed first, so its peak memory holds the int8
   tree alone); each run must launch every quantized branch of its
   storage. Between the two, decode logits off int8 and int4 pools must
   lie within ``kv_rel_l2_budget`` of the bf16 pool's on one prompt;
8. trains the GPT-2-small-width LM (bf16, flash attention, batch 8 x
   1024 tokens, Adam at 1e-4, one seeded batch: the repo's
   ``benchmarks/transformer_bench.py`` recipe) for 2 warm-up and 10
   timed steps, and reads each attention kernel's launch count for the
   timed steps — 12 layers x 10 steps of each bf16 kernel, none of the
   fp32 ones; then profiles one more step (``train_profile:`` line: the
   ten device kernels with the most time, the device's busy share);
9. prints the card line, a ``{"kernels": [...]}`` line (14 entries) and,
   last, the ``{"ok": true, ...}`` line.

TF32 is switched off for matmuls and cuDNN, so fp32 products are full
fp32 on the card as on the CPU.
"""

import importlib.util
import json
import subprocess
import sys
import time
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


def bound(nbytes: float, flops: float, dtype_name: str):
    """(bound_ms, bound_by): the larger of bytes over the memory rate
    and operations over the peak rate for the input type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------


def quant_pool(torch, q8, shape, kvd, dev):
    """bf16 rows [..., M, Dh] drawn on the card, stored as ``kvd``
    ("none": the bf16 rows; "int8"/"int4": codes and fp32 row scales
    from ``ops/q8.quantize_kv``). Returns (values, scales or None)."""
    x = torch.randn(*shape, device=dev).to(torch.bfloat16)
    if kvd == "none":
        return x, None
    return q8.quantize_kv(x, kvd)


def stored_row_bytes(kvd: str, Dh: int) -> int:
    """Bytes one pool row occupies: bf16 values, or int8 / packed int4
    codes plus the row's fp32 scale."""
    return {"none": 2 * Dh, "int8": Dh + 4, "int4": Dh // 2 + 4}[kvd]


def widened(q8, x, scale, kvd, dtype):
    """Gathered pool rows as the library call's operand: dequantized
    through ``ops/q8.dequantize_kv`` and cast to the query dtype."""
    return x if kvd == "none" else q8.dequantize_kv(x, scale, kvd).to(dtype)


def check_decode(torch, timer, kd, q8, dev, rng, Hkv, G, Dh, timed,
                 kvd="none"):
    B, bs, P, nblocks = 8, 16, 64, 512
    dt = torch.bfloat16
    q = torch.randn(B, Hkv, G, Dh, device=dev).to(dt)
    k, ks = quant_pool(torch, q8, (Hkv, nblocks * bs, Dh), kvd, dev)
    v, vs = quant_pool(torch, q8, (Hkv, nblocks * bs, Dh), kvd, dev)
    kw = dict(block_size=bs, kv_dtype=kvd)
    if kvd != "none":
        kw.update(k_scale=ks, v_scale=vs)
    pages = torch.from_numpy(np.stack(
        [rng.permutation(nblocks)[:P] for _ in range(B)]).astype(np.int32)
    ).to(dev)
    pos_np = rng.randint(32, 765, B).astype(np.int32)
    pos = torch.from_numpy(pos_np).to(dev)
    args = (q, k, v, pages, pos)
    got = kd.flash_decode_attention(*args, **kw)
    want = kd.flash_decode_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if not timed:
        return err, None
    rows = int((pos_np + 1).sum())
    nbytes = (q.numel() * 2 + rows * Hkv * stored_row_bytes(kvd, Dh) * 2
              + pages.numel() * 4 + B * 4 + got.numel() * 4)
    flops = rows * Hkv * G * Dh * 2 * 2
    # library yardstick: SDPA over K/V already gathered per slot (and
    # dequantized, for a quantized pool)
    T = P * bs
    gidx = (pages.long()[:, :, None] * bs
            + torch.arange(bs, device=dev)).reshape(B, T)
    kt = widened(q8, k[:, gidx], None if ks is None else ks[:, gidx], kvd, dt)
    vt = widened(q8, v[:, gidx], None if vs is None else vs[:, gidx], kvd, dt)
    kt = kt.permute(1, 0, 2, 3).repeat_interleave(G, dim=1)
    vt = vt.permute(1, 0, 2, 3).repeat_interleave(G, dim=1)
    qh = q.reshape(B, Hkv * G, 1, Dh)
    mask = (torch.arange(T, device=dev)[None, :]
            <= pos[:, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    times = {
        "ms": timer.ms(lambda: kd.flash_decode_attention(*args, **kw)),
        "plain_ms": timer.ms(lambda: kd.flash_decode_attention_plain(
            *args, **kw)),
        "library_ms": timer.ms(lambda: sdpa(qh, kt, vt, attn_mask=mask)),
    }
    times["bound_ms"], times["bound_by"] = bound(nbytes, flops, "bfloat16")
    return err, times


def check_sample(torch, timer, kd, dev, rng):
    B, V = 8, 50257
    x = torch.from_numpy((3.0 * rng.randn(B, V)).astype(np.float32)).to(dev)
    temp = torch.tensor([0.0, 0.8] * 4, device=dev)
    topk = torch.tensor([0, 50] * 4, dtype=torch.int32, device=dev)
    got = kd.fused_sample(x, 1234, temp, topk)
    want = kd.fused_sample_plain(x, 1234, temp, topk)
    torch.cuda.synchronize()
    err = float((got.long() - want.long()).abs().max().item())

    def library():
        vals, idx = torch.topk(x, 50, dim=-1)
        probs = torch.softmax(vals / 0.8, dim=-1)
        return idx.gather(-1, torch.multinomial(probs, 1))

    times = {
        "ms": timer.ms(lambda: kd.fused_sample(x, 1234, temp, topk)),
        "plain_ms": timer.ms(lambda: kd.fused_sample_plain(x, 1234, temp,
                                                           topk)),
        "library_ms": timer.ms(library),
    }
    # one read of every logit; the work per logit is a few compares
    times["bound_ms"], times["bound_by"] = bound(
        x.numel() * 4 + B * 12, x.numel() * 4, "float32")
    return err, times


def check_prefill(torch, timer, kp, q8, dev, rng, Hkv, G, Dh, P_ctx, timed,
                  kvd="none"):
    C, bs, nblocks = 256, 16, 512
    dt = torch.bfloat16
    q = torch.randn(C, Hkv, G, Dh, device=dev).to(dt)
    kck = torch.randn(C, Hkv, Dh, device=dev).to(dt)
    vck = torch.randn(C, Hkv, Dh, device=dev).to(dt)
    k, ks = quant_pool(torch, q8, (Hkv, nblocks * bs, Dh), kvd, dev)
    v, vs = quant_pool(torch, q8, (Hkv, nblocks * bs, Dh), kvd, dev)
    kw = dict(block_size=bs, kv_dtype=kvd)
    if kvd != "none":
        kw.update(k_scale=ks, v_scale=vs)
    pages = torch.from_numpy(
        rng.permutation(nblocks)[:P_ctx].astype(np.int32)).to(dev)
    args = (q, kck, vck, k, v, pages)
    got = kp.flash_chunk_prefill(*args, **kw)
    want = kp.flash_chunk_prefill_plain(*args, **kw)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if not timed:
        return err, None
    S = P_ctx * bs
    nbytes = (q.numel() * 2 + 2 * kck.numel() * 2
              + 2 * S * Hkv * stored_row_bytes(kvd, Dh) + P_ctx * 4
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
    }
    times["bound_ms"], times["bound_by"] = bound(nbytes, flops, "bfloat16")
    return err, times


def check_span_write(torch, timer, kp, q8, dev, rng, Hkv, Dh, timed,
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


def kernel_phase(torch, kd, kp, q8):
    """Each kernel and each quantized branch against its plain version
    at the slice's shapes (GPT-2 small: Hkv=12, G=1, Dh=64, bf16
    queries; the prefill both cold and with 512 context positions; int8
    and int4 pools for kernels 1, 3 and 4) and at a GQA shape (G=4,
    Dh=128), with its tolerance; timed at the slice's shapes. The
    sampler has no head layout, so it has no GQA shape."""
    dev = torch.device("cuda:0")
    timer = Timer(torch)
    rows = {}
    for kvd in ("none", "int8", "int4"):
        # the same pages and positions for every storage
        rng = np.random.RandomState(0)
        sfx = "" if kvd == "none" else f".{kvd}"
        e1, t1 = check_decode(torch, timer, kd, q8, dev, rng, 12, 1, 64,
                              True, kvd)
        e1g, _ = check_decode(torch, timer, kd, q8, dev, rng, 4, 4, 128,
                              False, kvd)
        rows["flash_decode_attention" + sfx] = (e1, e1g, 1e-4, t1)
        if kvd == "none":
            e2, t2 = check_sample(torch, timer, kd, dev, rng)
            rows["fused_sample"] = (e2, None, 0.0, t2)
        e3, t3 = check_prefill(torch, timer, kp, q8, dev, rng, 12, 1, 64, 32,
                               True, kvd)
        if kvd == "none":
            e3c, _ = check_prefill(torch, timer, kp, q8, dev, rng, 12, 1, 64,
                                   0, False)
            e3 = max(e3, e3c)
        e3g, _ = check_prefill(torch, timer, kp, q8, dev, rng, 4, 4, 128, 32,
                               False, kvd)
        rows["flash_chunk_prefill" + sfx] = (e3, e3g, 1e-4, t3)
        e4, t4 = check_span_write(torch, timer, kp, q8, dev, rng, 12, 64,
                                  True, kvd)
        e4g, _ = check_span_write(torch, timer, kp, q8, dev, rng, 4, 128,
                                  False, kvd)
        rows["paged_span_write" + sfx] = (e4, e4g, 0.0, t4)
    for name, (err, gqa_err, tol, times) in rows.items():
        shown = {("kernel_ms" if k == "ms" else k): v
                 for k, v in times.items()}
        print(f"kernel {name}: max_abs_err={err!r} gqa_max_abs_err="
              f"{gqa_err!r} tol={tol!r} "
              + " ".join(f"{k}={v!r}" for k, v in shown.items()))
        if not (err <= tol and (gqa_err is None or gqa_err <= tol)):
            fail(f"{name} disagrees with its plain version: "
                 f"{err}, {gqa_err} > {tol}")
    return {name: (err, {"gqa_max_abs_err": gqa_err}, times)
            for name, (err, gqa_err, _, times) in rows.items()}


# ---------------------------------------------------------------------------
# step functions on the card against the CPU, small fp32 model
# ---------------------------------------------------------------------------


def step_parity(torch, tt):
    cfg = tt.TransformerConfig(vocab=256, d_model=128, n_heads=4,
                               n_kv_heads=2, n_layers=2, d_ff=256,
                               max_len=128, dtype="float32")
    bs, nb = 16, 16
    params = {d: tt.init_params(cfg, torch.Generator().manual_seed(5), d)
              for d in ("cpu", "cuda")}
    pools = {d: tt.init_block_pool(cfg, nb, bs, device=d)
             for d in ("cpu", "cuda")}
    rng = np.random.RandomState(7)
    prompt = rng.randint(0, 256, 40).astype(np.int32)
    pages = np.asarray([3, 9, 4, 0], np.int32)       # 0: unmapped tail
    err = 0.0
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
    for a, b in zip(logits["cpu"], logits["cuda"]):
        if not torch.isfinite(b).all():
            fail("non-finite logits on the card")
        err = max(err, (a - b).abs().max().item())
    pool_err = max((pools["cpu"][n] - pools["cuda"][n].cpu()).abs().max()
                   .item() for n in ("k", "v"))
    print(f"steps: prefill(2 chunks)+decode on the card vs the CPU, fp32, "
          f"logits max_abs_err={err!r} pool max_abs_err={pool_err!r} "
          f"tol=1e-4")
    if not (err <= 1e-4 and pool_err <= 1e-4):
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


def engine_phase(torch, tt, kernels, PagedDecodeEngine, cfg, dev, params,
                 kv_dtype, label, branch):
    """Serve the 16-request trace with ``params`` over a ``kv_dtype``
    pool; print the ``<label>:`` line; check every request, the launch
    of each serving kernel of the ``branch`` ("" for the model-dtype
    pool, ".int8"/".int4") and that the prefix hit equals the cold run
    in a fresh engine. Returns the run's launch counts."""
    kw = dict(ENGINE_KW, kv_dtype=kv_dtype)
    eng = PagedDecodeEngine.from_params(params, cfg, device=dev, **kw)
    # first calls (cuBLAS handles, allocator) stay out of the timing
    warm = submit(eng, np.arange(40) % cfg.vocab, 4, 0.0)
    eng.run_until_idle()
    if len(warm.tokens) != 4:
        fail("warm-up request did not finish")
    reqs_in = trace(np.random.RandomState(0), cfg.vocab)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()                 # counts of the main path only
    t0 = time.perf_counter()
    reqs = [submit(eng, *r) for r in reqs_in]
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    tokens = sum(len(r.tokens) for r in reqs)
    ttft = np.asarray([r.ttft_s for r in reqs])
    health = eng.health()
    doc = {"requests": len(reqs), "generated_tokens": tokens,
           "wall_s": wall, "tokens_per_s": tokens / wall,
           "ttft_p50_s": float(np.percentile(ttft, 50)),
           "ttft_p99_s": float(np.percentile(ttft, 99)),
           "decode_mfu": eng.decode_mfu(),
           "decode_steps": health["decode_steps"],
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "kv_dtype": health["kv_dtype"],
           "kv_bytes_per_token": health["kv_bytes_per_token"],
           "pool_bytes": eng.pool_bytes,
           "prefix_hit_tokens": reqs[1].prefix_hit_tokens,
           "launches": launches}
    print(f"{label}: " + json.dumps(doc))
    for r, (p, max_new, _) in zip(reqs, reqs_in):
        ids = np.asarray(r.tokens)
        if (r.status != "done" or len(ids) != max_new
                or ids.min() < 0 or ids.max() >= cfg.vocab):
            fail(f"{label} request {r.rid}: status {r.status}, {len(ids)} "
                 f"of {max_new} tokens, ids in [{ids.min()}, {ids.max()}]")
    if not eng.pool.idle:
        fail(f"{label}: blocks still held after the engine drained")
    path = [k + (branch if k != "fused_sample" else "")
            for k in SERVING_KERNELS]
    missing = [k for k in path if launches[k] <= 0]
    if missing:
        fail(f"{label}: kernels never launched on the main path: {missing}")
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
    return launches


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


def train_profile(torch, step, i):
    """One more training step under ``torch.profiler`` (CPU and CUDA
    activity): print the ten device kernels with the most total time
    (name, calls, ms), the device's busy time (the union of its kernel
    and copy intervals) and its share of the step's host-clocked time,
    or that the trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(i)
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_name = [], {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        start, end = ev.time_range.start, ev.time_range.end
        spans.append((start, end))
        calls, us = by_name.get(ev.name, (0, 0.0))
        by_name[ev.name] = (calls + 1, us + (end - start))
    if not spans:
        print("train_profile: " + json.dumps({
            "step_ms": wall_ms, "device_time": "none in the trace"}))
        return
    busy, reach = 0.0, None
    for start, end in sorted(spans):
        if reach is None or start > reach:
            busy += end - start
            reach = end
        elif end > reach:
            busy += end - reach
            reach = end
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    doc = {"step_ms": wall_ms, "device_busy_ms": busy / 1e3,
           "device_busy_share": busy / 1e3 / wall_ms,
           "device_span_ms": (max(e for _, e in spans)
                              - min(s for s, _ in spans)) / 1e3,
           "device_kernels": len(spans),
           "top": [{"name": name[:120], "calls": calls, "ms": us / 1e3}
                   for name, (calls, us) in top]}
    print("train_profile: " + json.dumps(doc))


# ---------------------------------------------------------------------------


SOURCES = {
    "flash_decode_attention": ("decode_attention.cu",
                               "paddle_tpu/ops/pallas/decode.py:382"),
    "fused_sample": ("fused_sample.cu",
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
    from paddle_tpu_torch.serving import PagedDecodeEngine

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

    dev = torch.device("cuda:0")
    rows = {**kernel_phase(torch, kd, kp, q8),
            **flash_phase(torch, ka, _build)}
    step_parity(torch, tt)
    step_parity_quant(torch, tt, tlm, q8)
    parity = train_parity(torch, tt, topt, kernels)
    cfg = gpt2_small(tt)
    params = tt.init_params(cfg, torch.Generator().manual_seed(0), dev)
    served = engine_phase(torch, tt, kernels, PagedDecodeEngine, cfg, dev,
                          params, None, "engine", "")
    # (b) int4 pool, bf16 weights
    served4 = engine_phase(torch, tt, kernels, PagedDecodeEngine, cfg, dev,
                           params, "int4", "engine_int4", ".int4")
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
                **{k: served8[k] for k in QUANT_BRANCHES if "int8" in k},
                **{k: served4[k] for k in QUANT_BRANCHES if "int4" in k},
                **{k: trained[k] for k in TRAINING_KERNELS},
                **{k: parity[k] for k in FP32_BRANCHES}}

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
