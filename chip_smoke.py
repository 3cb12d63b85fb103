#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one card.

    python3 chip_smoke.py

Drives ``paddle_tpu_torch``'s serving path on the first CUDA card and
exits non-zero on any failure (there is no CPU path). In order it:

1. prints the environment (torch, CUDA, capability, nvcc, Triton,
   CUTLASS headers, the card's name and power limit);
2. builds the four Hopper kernels from ``paddle_tpu_torch/ops/kernels/
   csrc`` with nvcc and prints the build time;
3. holds each kernel against its plain PyTorch version on the card, at
   the serving slice's shapes and at one GQA shape (G=4, Dh=128), and
   times kernel, plain version and a PyTorch library call that computes
   the same function (a yardstick only: the port never calls it),
   beside the least time the card could take (bytes over 3.35 TB/s or
   FLOPs over the peak for the input type, whichever is larger);
4. holds the whole step functions on the card against the CPU on a
   small fp32 model;
5. serves 16 seeded requests with a GPT-2-small-width engine (random
   weights from a seed) and reads each kernel's launch count for that
   run — every count must be > 0;
6. checks that a prefix-cache hit gives the same greedy tokens as the
   same prompt served cold in a fresh engine;
7. prints the card line, a ``{"kernels": [...]}`` line and, last, the
   ``{"ok": true, ...}`` line.

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


def check_decode(torch, timer, kd, dev, rng, Hkv, G, Dh, timed):
    B, bs, P, nblocks = 8, 16, 64, 512
    dt = torch.bfloat16
    q = torch.randn(B, Hkv, G, Dh, device=dev).to(dt)
    k = torch.randn(Hkv, nblocks * bs, Dh, device=dev).to(dt)
    v = torch.randn(Hkv, nblocks * bs, Dh, device=dev).to(dt)
    pages = torch.from_numpy(np.stack(
        [rng.permutation(nblocks)[:P] for _ in range(B)]).astype(np.int32)
    ).to(dev)
    pos_np = rng.randint(32, 765, B).astype(np.int32)
    pos = torch.from_numpy(pos_np).to(dev)
    args = (q, k, v, pages, pos)
    got = kd.flash_decode_attention(*args, block_size=bs)
    want = kd.flash_decode_attention_plain(*args, block_size=bs)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if not timed:
        return err, None
    rows = int((pos_np + 1).sum())
    nbytes = (q.numel() * 2 + rows * Hkv * Dh * 2 * 2 + pages.numel() * 4
              + B * 4 + got.numel() * 4)
    flops = rows * Hkv * G * Dh * 2 * 2
    # library yardstick: SDPA over K/V already gathered per slot
    T = P * bs
    gidx = (pages.long()[:, :, None] * bs
            + torch.arange(bs, device=dev)).reshape(B, T)
    kt = k[:, gidx].permute(1, 0, 2, 3).repeat_interleave(G, dim=1)
    vt = v[:, gidx].permute(1, 0, 2, 3).repeat_interleave(G, dim=1)
    qh = q.reshape(B, Hkv * G, 1, Dh)
    mask = (torch.arange(T, device=dev)[None, :]
            <= pos[:, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    times = {
        "ms": timer.ms(lambda: kd.flash_decode_attention(*args,
                                                         block_size=bs)),
        "plain_ms": timer.ms(lambda: kd.flash_decode_attention_plain(
            *args, block_size=bs)),
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


def check_prefill(torch, timer, kp, dev, rng, Hkv, G, Dh, P_ctx, timed):
    C, bs, nblocks = 256, 16, 512
    dt = torch.bfloat16
    q = torch.randn(C, Hkv, G, Dh, device=dev).to(dt)
    kck = torch.randn(C, Hkv, Dh, device=dev).to(dt)
    vck = torch.randn(C, Hkv, Dh, device=dev).to(dt)
    k = torch.randn(Hkv, nblocks * bs, Dh, device=dev).to(dt)
    v = torch.randn(Hkv, nblocks * bs, Dh, device=dev).to(dt)
    pages = torch.from_numpy(
        rng.permutation(nblocks)[:P_ctx].astype(np.int32)).to(dev)
    args = (q, kck, vck, k, v, pages)
    got = kp.flash_chunk_prefill(*args, block_size=bs)
    want = kp.flash_chunk_prefill_plain(*args, block_size=bs)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if not timed:
        return err, None
    S = P_ctx * bs
    nbytes = (q.numel() * 2 + 2 * kck.numel() * 2 + 2 * S * Hkv * Dh * 2
              + P_ctx * 4 + got.numel() * 4)
    visible = C * S + C * (C + 1) // 2          # (row, column) pairs seen
    flops = visible * Hkv * G * Dh * 2 * 2
    gidx = (pages.long()[:, None] * bs
            + torch.arange(bs, device=dev)).reshape(S)
    kall = torch.cat([k[:, gidx], kck.transpose(0, 1)], 1)
    vall = torch.cat([v[:, gidx], vck.transpose(0, 1)], 1)
    kall = kall.repeat_interleave(G, dim=0)[None]
    vall = vall.repeat_interleave(G, dim=0)[None]
    qh = q.reshape(C, Hkv * G, Dh).transpose(0, 1)[None]
    mask = torch.cat([torch.ones(C, S, dtype=torch.bool, device=dev),
                      torch.ones(C, C, dtype=torch.bool,
                                 device=dev).tril()], 1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    times = {
        "ms": timer.ms(lambda: kp.flash_chunk_prefill(*args,
                                                      block_size=bs)),
        "plain_ms": timer.ms(lambda: kp.flash_chunk_prefill_plain(
            *args, block_size=bs)),
        "library_ms": timer.ms(lambda: sdpa(qh, kall, vall,
                                            attn_mask=mask)),
    }
    times["bound_ms"], times["bound_by"] = bound(nbytes, flops, "bfloat16")
    return err, times


def check_span_write(torch, timer, kp, dev, rng, Hkv, Dh, timed):
    L, bs, pc, nblocks, n_valid = 12, 16, 16, 512, 200
    dt = torch.bfloat16
    pool = {n: torch.randn(L, Hkv, nblocks * bs, Dh, device=dev).to(dt)
            for n in ("k", "v")}
    spans = {n: torch.randn(L, Hkv, pc * bs, Dh, device=dev).to(dt)
             for n in ("k", "v")}
    pages = torch.from_numpy(
        rng.permutation(nblocks)[:pc].astype(np.int32)).to(dev)
    valid = torch.arange(pc * bs, device=dev) < n_valid
    ref = {n: t.clone() for n, t in pool.items()}
    kp.paged_span_write(pool, spans, pages, valid, block_size=bs)
    kp.paged_span_write_plain(ref, spans, pages, valid, block_size=bs)
    torch.cuda.synchronize()
    err = max((pool[n].float() - ref[n].float()).abs().max().item()
              for n in ("k", "v"))
    if not timed:
        return err, None
    nbytes = 2 * 2 * n_valid * L * Hkv * Dh * 2 + pc * 4 + pc * bs
    rows = (pages.long()[:, None] * bs
            + torch.arange(bs, device=dev)).reshape(-1)[:n_valid]
    flat = {n: pool[n].view(L * Hkv, nblocks * bs, Dh) for n in pool}
    src = {n: spans[n].reshape(L * Hkv, pc * bs, Dh)[:, :n_valid]
           .contiguous() for n in spans}

    def library():
        for n in ("k", "v"):
            flat[n].index_copy_(1, rows, src[n])

    times = {
        "ms": timer.ms(lambda: kp.paged_span_write(pool, spans, pages,
                                                   valid, block_size=bs)),
        "plain_ms": timer.ms(lambda: kp.paged_span_write_plain(
            pool, spans, pages, valid, block_size=bs)),
        "library_ms": timer.ms(library),
    }
    times["bound_ms"], times["bound_by"] = bound(nbytes, 0.0, "bfloat16")
    return err, times


def kernel_phase(torch, kd, kp):
    """Each kernel against its plain version at the slice's shapes
    (GPT-2 small: Hkv=12, G=1, Dh=64, bf16; the prefill both cold and
    with 512 context positions) and at a GQA shape (G=4, Dh=128), with
    its tolerance; timed at the slice's shapes. The sampler has no head
    layout, so it has no GQA shape."""
    dev = torch.device("cuda:0")
    timer = Timer(torch)
    rng = np.random.RandomState(0)
    rows = {}
    e1, t1 = check_decode(torch, timer, kd, dev, rng, 12, 1, 64, True)
    e1g, _ = check_decode(torch, timer, kd, dev, rng, 4, 4, 128, False)
    rows["flash_decode_attention"] = (e1, e1g, 1e-4, t1)
    e2, t2 = check_sample(torch, timer, kd, dev, rng)
    rows["fused_sample"] = (e2, None, 0.0, t2)
    e3, t3 = check_prefill(torch, timer, kp, dev, rng, 12, 1, 64, 32, True)
    e3c, _ = check_prefill(torch, timer, kp, dev, rng, 12, 1, 64, 0, False)
    e3g, _ = check_prefill(torch, timer, kp, dev, rng, 4, 4, 128, 32, False)
    rows["flash_chunk_prefill"] = (max(e3, e3c), e3g, 1e-4, t3)
    e4, t4 = check_span_write(torch, timer, kp, dev, rng, 12, 64, True)
    e4g, _ = check_span_write(torch, timer, kp, dev, rng, 4, 128, False)
    rows["paged_span_write"] = (e4, e4g, 0.0, t4)
    for name, (err, gqa_err, tol, times) in rows.items():
        shown = {("kernel_ms" if k == "ms" else k): v
                 for k, v in times.items()}
        print(f"kernel {name}: max_abs_err={err!r} gqa_max_abs_err="
              f"{gqa_err!r} tol={tol!r} "
              + " ".join(f"{k}={v!r}" for k, v in shown.items()))
        if not (err <= tol and (gqa_err is None or gqa_err <= tol)):
            fail(f"{name} disagrees with its plain version: "
                 f"{err}, {gqa_err} > {tol}")
    return rows


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


def engine_phase(torch, tt, kernels, PagedDecodeEngine, cfg, dev):
    params = tt.init_params(cfg, torch.Generator().manual_seed(0), dev)
    eng = PagedDecodeEngine.from_params(params, cfg, device=dev,
                                        **ENGINE_KW)
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
    doc = {"requests": len(reqs), "generated_tokens": tokens,
           "wall_s": wall, "tokens_per_s": tokens / wall,
           "ttft_p50_s": float(np.percentile(ttft, 50)),
           "ttft_p99_s": float(np.percentile(ttft, 99)),
           "decode_mfu": eng.decode_mfu(),
           "decode_steps": eng.health()["decode_steps"],
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "pool_bytes": eng.pool_bytes,
           "prefix_hit_tokens": reqs[1].prefix_hit_tokens,
           "launches": launches}
    print("engine: " + json.dumps(doc))
    for r, (p, max_new, _) in zip(reqs, reqs_in):
        ids = np.asarray(r.tokens)
        if (r.status != "done" or len(ids) != max_new
                or ids.min() < 0 or ids.max() >= cfg.vocab):
            fail(f"request {r.rid}: status {r.status}, {len(ids)} of "
                 f"{max_new} tokens, ids in [{ids.min()}, {ids.max()}]")
    if not eng.pool.idle:
        fail("blocks still held after the engine drained")
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
    if reqs[1].prefix_hit_tokens != 256:
        fail(f"the shared-prefix request hit {reqs[1].prefix_hit_tokens} "
             f"tokens, expected 256")
    # the hit replays a cold prefill: same greedy tokens in a fresh engine
    cold_eng = PagedDecodeEngine.from_params(params, cfg, device=dev,
                                             **ENGINE_KW)
    cold = submit(cold_eng, *reqs_in[1])
    cold_eng.run_until_idle()
    same = cold.tokens == reqs[1].tokens
    print(f"check: prefix-hit request (hit {reqs[1].prefix_hit_tokens} "
          f"tokens) vs the same prompt cold in a fresh engine (hit "
          f"{cold.prefix_hit_tokens}): {len(cold.tokens)} greedy tokens, "
          f"identical={same}")
    if not same:
        fail("prefix hit and cold prefill gave different greedy tokens")
    return launches


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
}


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA card")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    if importlib.util.find_spec("paddle_tpu_torch") is None:
        fail("paddle_tpu_torch is not beside chip_smoke.py")
    from paddle_tpu_torch.models import transformer as tt
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels import _build
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

    rows = kernel_phase(torch, kd, kp)
    step_parity(torch, tt)
    launches = engine_phase(torch, tt, kernels, PagedDecodeEngine,
                            gpt2_small(tt), torch.device("cuda:0"))

    out = []
    for name, (src, replaces) in SOURCES.items():
        err, gqa_err, _, times = rows[name]
        out.append({"name": name, "route": "cuda",
                    "source": f"paddle_tpu_torch/ops/kernels/csrc/{src}",
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": err, "gqa_max_abs_err": gqa_err,
                    **times})
    print(card)
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
