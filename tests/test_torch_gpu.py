"""Each Hopper kernel against its plain PyTorch version, on the card.

Marked ``gpu``; whether a card exists is decided inside the ``cuda``
fixture, so the tests collect the same everywhere and skip without one.
This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch (there: ``python -m pytest --noconftest
-m gpu tests/test_torch_gpu.py``, since ``tests/conftest.py`` sets up
JAX).

Tolerances: attention outputs agree to 1e-4 absolute (fp32 accumulation
in both, summed in another order over up to 16384 positions of O(1)
values; the bf16 chunk prefill's products run on the tensor cores with
p split into two bf16 halves, ~2^-16 relative); the span write and the sampler's ids are exact (no arithmetic
to round; the sampler's hash is integer and its float steps are the
same IEEE operations in both). Flash attention, forward and backward:
fp32 outputs, lse and gradients to 1e-4 absolute (fp32 sums in another
order over up to 1000 keys); bf16 outputs and gradients within two bf16
ulps of the plain version's (both accumulate in fp32 and round once,
so a sum that lands near a rounding boundary may round the other way;
the ulp is taken at max(|plain|, 2**-6) so values near 0 are held to
2**-13 absolute), lse (fp32) to 1e-4. The quantized branches (int8 and
int4 pools) are held to the same 1e-4 as the model-dtype ones: both
sides widen each code with one fp32 multiply by its row scale, so only
the order of the sums differs; the four-array span write byte for byte.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import q8
from paddle_tpu_torch.ops.kernels import attention as kattention
from paddle_tpu_torch.ops.kernels import decode as kdecode
from paddle_tpu_torch.ops.kernels import prefill as kprefill


# the suite runs several test processes side by side on a few cores:
# one intra-op thread keeps these tiny-shape tests from crowding the
# cores the other processes' JAX tests use
torch.set_num_threads(1)


def _decode_inputs(rng, B, Hkv, G, Dh, P, bs, nblocks):
    q = rng.randn(B, Hkv, G, Dh).astype(np.float32)
    k = rng.randn(Hkv, nblocks * bs, Dh).astype(np.float32)
    v = rng.randn(Hkv, nblocks * bs, Dh).astype(np.float32)
    pages = np.stack([rng.permutation(nblocks)[:P]
                      for _ in range(B)]).astype(np.int32)
    pos = rng.randint(0, P * bs, B).astype(np.int32)
    return q, k, v, pages, pos


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _gpu(a, dev, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return t.to(dtype) if dtype is not None else t


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,Dh", [(1, 64), (4, 128)])
def test_gpu_decode_attention_matches_plain(cuda, dtype, G, Dh):
    rng = np.random.RandomState(0)
    q, k, v, pages, pos = _decode_inputs(rng, 8, 3, G, Dh, 16, 16, 40)
    args = (_gpu(q, cuda, dtype), _gpu(k, cuda, dtype), _gpu(v, cuda, dtype),
            _gpu(pages, cuda), _gpu(pos, cuda))
    got = kdecode.flash_decode_attention(*args, block_size=16)
    want = kdecode.flash_decode_attention_plain(*args, block_size=16)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P_ctx", [0, 5])
def test_gpu_chunk_prefill_matches_plain(cuda, dtype, P_ctx):
    rng = np.random.RandomState(1)
    C, Hkv, G, Dh, bs = 40, 3, 2, 64, 16
    q = rng.randn(C, Hkv, G, Dh)
    kck, vck = rng.randn(C, Hkv, Dh), rng.randn(C, Hkv, Dh)
    k, v = rng.randn(Hkv, 12 * bs, Dh), rng.randn(Hkv, 12 * bs, Dh)
    pages = rng.permutation(12)[:P_ctx].astype(np.int32)
    args = [_gpu(a, cuda, dtype) for a in (q, kck, vck, k, v)]
    args.append(_gpu(pages, cuda))
    got = kprefill.flash_chunk_prefill(*args, block_size=bs)
    want = kprefill.flash_chunk_prefill_plain(*args, block_size=bs)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_span_write_matches_plain(cuda, dtype):
    rng = np.random.RandomState(2)
    L, Hkv, Dh, bs, pc = 2, 3, 64, 16, 3
    pool = {n: _gpu(rng.randn(L, Hkv, 8 * bs, Dh), cuda, dtype)
            for n in ("k", "v")}
    spans = {n: _gpu(rng.randn(L, Hkv, pc * bs, Dh), cuda, dtype)
             for n in ("k", "v")}
    pages = _gpu(np.asarray([5, 2, 0], np.int32), cuda)
    valid = _gpu(np.arange(pc * bs) < 2 * bs + 3, cuda)
    want = {n: t.clone() for n, t in pool.items()}
    kprefill.paged_span_write(pool, spans, pages, valid, block_size=bs)
    kprefill.paged_span_write_plain(want, spans, pages, valid, block_size=bs)
    torch.cuda.synchronize()
    for n in ("k", "v"):
        assert torch.equal(pool[n], want[n])


def _quant(rng, shape, kvd, dev):
    """Random rows quantized on the card: (codes, scales)."""
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)
    return q8.quantize_kv(x * (1.0 + 2.0 * torch.rand(shape[:-1] + (1,),
                                                      device=dev)), kvd)


@pytest.mark.gpu
@pytest.mark.parametrize("kvd", ["int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,Dh", [(1, 32), (4, 128)])
def test_gpu_quant_decode_attention_matches_plain(cuda, kvd, dtype, G, Dh):
    rng = np.random.RandomState(7)
    B, Hkv, P, bs, nblocks = 5, 3, 9, 16, 40
    q = _gpu(rng.randn(B, Hkv, G, Dh), cuda, dtype)
    k, ks = _quant(rng, (Hkv, nblocks * bs, Dh), kvd, cuda)
    v, vs = _quant(rng, (Hkv, nblocks * bs, Dh), kvd, cuda)
    pages = _gpu(np.stack([rng.permutation(nblocks)[:P] for _ in range(B)])
                 .astype(np.int32), cuda)
    pos = _gpu(np.asarray([0, 17, 77, 130, P * bs - 1], np.int32), cuda)
    kw = dict(block_size=bs, k_scale=ks, v_scale=vs, kv_dtype=kvd)
    before = kdecode.flash_decode_attention.launches[kvd]
    got = kdecode.flash_decode_attention(q, k, v, pages, pos, **kw)
    want = kdecode.flash_decode_attention_plain(q, k, v, pages, pos, **kw)
    torch.cuda.synchronize()
    assert kdecode.flash_decode_attention.launches[kvd] == before + 1
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("kvd", ["int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,Dh", [(1, 32), (2, 128)])
def test_gpu_quant_chunk_prefill_matches_plain(cuda, kvd, dtype, G, Dh):
    rng = np.random.RandomState(8)
    C, Hkv, bs, P_ctx = 37, 3, 16, 5
    q = _gpu(rng.randn(C, Hkv, G, Dh), cuda, dtype)
    kck = _gpu(rng.randn(C, Hkv, Dh), cuda, dtype)
    vck = _gpu(rng.randn(C, Hkv, Dh), cuda, dtype)
    k, ks = _quant(rng, (Hkv, 12 * bs, Dh), kvd, cuda)
    v, vs = _quant(rng, (Hkv, 12 * bs, Dh), kvd, cuda)
    pages = _gpu(rng.permutation(12)[:P_ctx].astype(np.int32), cuda)
    kw = dict(block_size=bs, k_scale=ks, v_scale=vs, kv_dtype=kvd)
    before = kprefill.flash_chunk_prefill.launches[kvd]
    got = kprefill.flash_chunk_prefill(q, kck, vck, k, v, pages, **kw)
    want = kprefill.flash_chunk_prefill_plain(q, kck, vck, k, v, pages, **kw)
    torch.cuda.synchronize()
    assert kprefill.flash_chunk_prefill.launches[kvd] == before + 1
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("kvd", ["int8", "int4"])
@pytest.mark.parametrize("Dh", [32, 128])
def test_gpu_quant_span_write_matches_plain(cuda, kvd, Dh):
    rng = np.random.RandomState(9)
    L, Hkv, bs, pc = 2, 3, 16, 3
    Dst = Dh // 2 if kvd == "int4" else Dh
    pool = {n: _gpu(rng.randint(-128, 128, (L, Hkv, 8 * bs, Dst))
                    .astype(np.int8), cuda) for n in ("k", "v")}
    spans = {n: _gpu(rng.randint(-128, 128, (L, Hkv, pc * bs, Dst))
                     .astype(np.int8), cuda) for n in ("k", "v")}
    for n in ("k_scale", "v_scale"):
        pool[n] = _gpu(rng.rand(L, Hkv, 8 * bs).astype(np.float32), cuda)
        spans[n] = _gpu(rng.rand(L, Hkv, pc * bs).astype(np.float32), cuda)
    pages = _gpu(np.asarray([5, 2, 0], np.int32), cuda)
    valid = _gpu(np.arange(pc * bs) < 2 * bs + 3, cuda)
    want = {n: t.clone() for n, t in pool.items()}
    before = kprefill.paged_span_write.launches[kvd]
    kprefill.paged_span_write(pool, spans, pages, valid, block_size=bs,
                              kv_dtype=kvd)
    kprefill.paged_span_write_plain(want, spans, pages, valid, block_size=bs,
                                    kv_dtype=kvd)
    torch.cuda.synchronize()
    assert kprefill.paged_span_write.launches[kvd] == before + 1
    for n in pool:                  # byte for byte, scales as raw bits
        assert torch.equal(pool[n].view(torch.uint8),
                           want[n].view(torch.uint8))


@pytest.mark.gpu
def test_gpu_quant_engine_runs_every_branch(cuda):
    """A small bf16 engine on the card over an int8 pool with int8
    weights and over an int4 pool: every quantized branch launches, and
    a prefix hit gives the cold run's greedy tokens."""
    from paddle_tpu_torch.io import lm_serving
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.serving import PagedDecodeEngine
    cfg = transformer.TransformerConfig(vocab=512, d_model=128, n_heads=2,
                                        n_layers=2, d_ff=256, max_len=256)
    gen = torch.Generator().manual_seed(0)
    weights = {"int8": lm_serving.quantize_lm_params(
                   transformer.init_train_params(cfg, gen, "cpu"), "cuda"),
               "int4": transformer.init_params(
                   cfg, torch.Generator().manual_seed(0), "cuda")}
    rng = np.random.RandomState(4)
    prompt = np.concatenate([rng.randint(0, 512, 64),
                             rng.randint(0, 512, 30)])
    for kvd, params in weights.items():
        outs = []
        for warm in (False, True):
            eng = PagedDecodeEngine.from_params(
                params, cfg, batch=4, cache_len=256, block_size=16,
                chunk_tokens=64, seed=0, device="cuda", kv_dtype=kvd)
            if warm:
                eng.submit(prompt[:70], max_new=2)
                eng.run_until_idle()
            kernels.reset_launches()
            req = eng.submit(prompt, max_new=12)
            eng.run_until_idle()
            outs.append((req.tokens, req.prefix_hit_tokens))
            counts = kernels.launch_counts()
            for name in ("flash_decode_attention", "flash_chunk_prefill",
                         "paged_span_write"):
                assert counts[f"{name}.{kvd}"] > 0, (name, kvd)
        assert outs[0][1] == 0 and outs[1][1] == 64
        assert outs[0][0] == outs[1][0]


def _pool_on(rng, shape, kvd, dtype, dev):
    """A pool [Hkv, M, Dh] on the card: (``dtype`` values, None), or
    (codes, fp32 row scales) of ``kvd``."""
    if kvd == "none":
        return _gpu(rng.randn(*shape), dev, dtype), None
    return _quant(rng, shape, kvd, dev)


# context lengths at the decode split edges (DECODE_SPLIT = 64 positions
# a CTA), at page edges (16), one slot with many splits and one whose
# position lies past its page vector (P * bs = 1024)
DECODE_POS = [0, 14, 15, 62, 63, 64, 127, 128, 999, 1500]


@pytest.mark.gpu
@pytest.mark.parametrize("kvd", ["none", "int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,Dh", [(1, 64), (4, 128), (8, 32)])
def test_gpu_decode_split_edges_match_plain(cuda, kvd, dtype, G, Dh):
    """Every pool storage and query dtype at context lengths 1, 15, 16,
    63, 64, 65, 128, 129, 1000 and past the pages, within 1e-4; one
    launch of the storage's branch."""
    rng = np.random.RandomState(11)
    B, Hkv, P, bs, nblocks = len(DECODE_POS), 2, 64, 16, 80
    q = _gpu(rng.randn(B, Hkv, G, Dh), cuda, dtype)
    k, ks = _pool_on(rng, (Hkv, nblocks * bs, Dh), kvd, dtype, cuda)
    v, vs = _pool_on(rng, (Hkv, nblocks * bs, Dh), kvd, dtype, cuda)
    pages = _gpu(np.stack([rng.permutation(nblocks)[:P] for _ in range(B)])
                 .astype(np.int32), cuda)
    pos = _gpu(np.asarray(DECODE_POS, np.int32), cuda)
    kw = dict(block_size=bs, k_scale=ks, v_scale=vs, kv_dtype=kvd)
    before = dict(kdecode.flash_decode_attention.launches)
    got = kdecode.flash_decode_attention(q, k, v, pages, pos, **kw)
    want = kdecode.flash_decode_attention_plain(q, k, v, pages, pos, **kw)
    torch.cuda.synchronize()
    assert kdecode.flash_decode_attention.launches == dict(
        before, **{kvd: before[kvd] + 1})
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("kvd", ["none", "int8", "int4"])
def test_gpu_decode_long_context(cuda, kvd):
    """G = 8, Dh = 128 over 16384 positions (256 splits; the old kernel's
    [G, T] score row refused this): within 1e-4 of the plain version."""
    rng = np.random.RandomState(12)
    B, Hkv, G, Dh, P, bs = 2, 2, 8, 128, 1024, 16
    q = _gpu(rng.randn(B, Hkv, G, Dh), cuda, torch.bfloat16)
    k, ks = _pool_on(rng, (Hkv, P * bs, Dh), kvd, torch.bfloat16, cuda)
    v, vs = _pool_on(rng, (Hkv, P * bs, Dh), kvd, torch.bfloat16, cuda)
    pages = _gpu(np.stack([rng.permutation(P) for _ in range(B)])
                 .astype(np.int32), cuda)
    pos = _gpu(np.asarray([P * bs - 1, 9000], np.int32), cuda)
    kw = dict(block_size=bs, k_scale=ks, v_scale=vs, kv_dtype=kvd)
    got = kdecode.flash_decode_attention(q, k, v, pages, pos, **kw)
    want = kdecode.flash_decode_attention_plain(q, k, v, pages, pos, **kw)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("kvd", ["none", "int8", "int4"])
def test_gpu_decode_is_batch_invariant_and_repeatable(cuda, kvd):
    """A slot decoded alone (B = 1) gives bitwise its row of a batch of 8
    with other positions and pages, and two launches on the same inputs
    are bitwise equal: the splits are a constant of the kernel and
    combine in a fixed order."""
    rng = np.random.RandomState(13)
    B, Hkv, G, Dh, P, bs, nblocks = 8, 12, 1, 64, 64, 16, 600
    q = _gpu(rng.randn(B, Hkv, G, Dh), cuda, torch.bfloat16)
    k, ks = _pool_on(rng, (Hkv, nblocks * bs, Dh), kvd, torch.bfloat16, cuda)
    v, vs = _pool_on(rng, (Hkv, nblocks * bs, Dh), kvd, torch.bfloat16, cuda)
    pages = _gpu(np.stack([rng.permutation(nblocks)[:P] for _ in range(B)])
                 .astype(np.int32), cuda)
    pos = _gpu(np.asarray([700, 3, 64, 1023, 200, 129, 0, 511], np.int32),
               cuda)
    kw = dict(block_size=bs, k_scale=ks, v_scale=vs, kv_dtype=kvd)
    batch = kdecode.flash_decode_attention(q, k, v, pages, pos, **kw)
    again = kdecode.flash_decode_attention(q, k, v, pages, pos, **kw)
    for b in range(B):
        one = kdecode.flash_decode_attention(
            q[b:b + 1].contiguous(), k, v, pages[b:b + 1].contiguous(),
            pos[b:b + 1].contiguous(), **kw)
        assert torch.equal(one[0], batch[b]), b
    torch.cuda.synchronize()
    assert torch.equal(batch, again)


@pytest.mark.gpu
@pytest.mark.parametrize("kvd", ["none", "int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [1, 15, 16, 63, 64, 65, 1000])
def test_gpu_chunk_prefill_edges_match_plain(cuda, kvd, dtype, C):
    """Every pool storage and query dtype at chunk lengths on both sides
    of the 16-row page and the 64-row tile, and C = 1000, cold and over a
    5-page context that ends inside a 64-column tile (G = 2: the
    flattened rows cross tile edges at other chunk rows than the
    columns do), within 1e-4; one launch per call, counted under the
    pool's storage when there is context and under "none" when cold."""
    rng = np.random.RandomState(14)
    Hkv, G, Dh, bs, nblocks = 2, 2, 64, 16, 12
    q = _gpu(rng.randn(C, Hkv, G, Dh), cuda, dtype)
    kck = _gpu(rng.randn(C, Hkv, Dh), cuda, dtype)
    vck = _gpu(rng.randn(C, Hkv, Dh), cuda, dtype)
    k, ks = _pool_on(rng, (Hkv, nblocks * bs, Dh), kvd, dtype, cuda)
    v, vs = _pool_on(rng, (Hkv, nblocks * bs, Dh), kvd, dtype, cuda)
    kw = dict(block_size=bs, k_scale=ks, v_scale=vs, kv_dtype=kvd)
    for P_ctx in (0, 5):
        pages = _gpu(rng.permutation(nblocks)[:P_ctx].astype(np.int32), cuda)
        branch = kvd if P_ctx else "none"
        before = dict(kprefill.flash_chunk_prefill.launches)
        got = kprefill.flash_chunk_prefill(q, kck, vck, k, v, pages, **kw)
        want = kprefill.flash_chunk_prefill_plain(q, kck, vck, k, v, pages,
                                                  **kw)
        torch.cuda.synchronize()
        assert kprefill.flash_chunk_prefill.launches == dict(
            before, **{branch: before[branch] + 1})
        assert (got - want).abs().max().item() <= 1e-4, P_ctx


@pytest.mark.gpu
@pytest.mark.parametrize("kvd", ["none", "int8", "int4"])
@pytest.mark.parametrize("Dh", [32, 96, 128])
def test_gpu_chunk_prefill_head_dims_and_repeat(cuda, kvd, Dh):
    """The bf16 kernel's other head dims (32 and 96 padded to 64 and 128
    columns), at a GQA group of 4 over a 33-page context, within 1e-4;
    two launches on the same inputs are bitwise equal."""
    rng = np.random.RandomState(15)
    C, Hkv, G, bs, nblocks = 100, 2, 4, 16, 40
    q = _gpu(rng.randn(C, Hkv, G, Dh), cuda, torch.bfloat16)
    kck = _gpu(rng.randn(C, Hkv, Dh), cuda, torch.bfloat16)
    vck = _gpu(rng.randn(C, Hkv, Dh), cuda, torch.bfloat16)
    k, ks = _pool_on(rng, (Hkv, nblocks * bs, Dh), kvd, torch.bfloat16, cuda)
    v, vs = _pool_on(rng, (Hkv, nblocks * bs, Dh), kvd, torch.bfloat16, cuda)
    pages = _gpu(rng.permutation(nblocks)[:33].astype(np.int32), cuda)
    kw = dict(block_size=bs, k_scale=ks, v_scale=vs, kv_dtype=kvd)
    got = kprefill.flash_chunk_prefill(q, kck, vck, k, v, pages, **kw)
    again = kprefill.flash_chunk_prefill(q, kck, vck, k, v, pages, **kw)
    want = kprefill.flash_chunk_prefill_plain(q, kck, vck, k, v, pages, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.gpu
def test_gpu_paged_attention_refuses_what_it_cannot_take(cuda):
    """A CUDA tensor the kernels cannot take raises; it never runs the
    plain version instead."""
    x = torch.zeros(4, 2, 1, 48, device=cuda, dtype=torch.bfloat16)
    kc = torch.zeros(4, 2, 48, device=cuda, dtype=torch.bfloat16)
    pool = torch.zeros(2, 64, 48, device=cuda, dtype=torch.bfloat16)
    pages = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head dim 48"):
        kprefill.flash_chunk_prefill(x, kc, kc, pool, pool, pages,
                                     block_size=16)
    q = torch.zeros(1, 2, 1, 64, device=cuda, dtype=torch.bfloat16)
    flat = torch.zeros(2 * 64 * 64 + 1, device=cuda, dtype=torch.bfloat16)
    pool = flat[1:].view(2, 64, 64)             # 2-byte offset
    with pytest.raises(ValueError, match="16-byte aligned"):
        kdecode.flash_decode_attention(
            q, pool, pool, pages[None], torch.zeros(1, dtype=torch.int32,
                                                    device=cuda),
            block_size=32)


@pytest.mark.gpu
def test_gpu_fused_sample_matches_plain(cuda):
    rng = np.random.RandomState(3)
    B, V = 8, 50257
    x = _gpu((3.0 * rng.randn(B, V)).astype(np.float32), cuda)
    temp = _gpu(np.asarray([0, 0.8, 0, 0.8, 0, 1.2, 0, 0.5], np.float32),
                cuda)
    topk = _gpu(np.asarray([0, 50, 0, 0, 3, 1, 50, 50257], np.int32), cuda)
    before = kdecode.fused_sample.launches["hash"]
    seed = torch.tensor(1234, dtype=torch.int32, device=cuda)
    got = kdecode.fused_sample(x, seed, temp, topk)
    want = kdecode.fused_sample_plain(x, seed, temp, topk)
    with pytest.raises(ValueError, match="seed"):
        kdecode.fused_sample(x, 1234, temp, topk)    # a host int
    torch.cuda.synchronize()
    assert kdecode.fused_sample.launches["hash"] == before + 1
    assert torch.equal(got, want)


def _sample_rows(rng, B, V):
    """Logits [B, V] and controls cycling through greedy rows and top_k
    0, 1, 50, V//4, V-1, V (at V = 50257, V//4 puts the k-th key in a
    digit too full for the kernel's direct selection); every third row
    has ties at its 50th value."""
    x = (3.0 * rng.randn(B, V)).astype(np.float32)
    for b in range(0, B, 3):
        order = np.argsort(-x[b])
        x[b, order[48:53]] = x[b, order[min(49, V - 1)]]
    ks = [0, 1, 50, V // 4, V - 1, V]
    topk = np.asarray([ks[b % 6] for b in range(B)], np.int32)
    temp = np.asarray([0.0 if b % 4 == 3 else 0.6 + 0.1 * (b % 7)
                       for b in range(B)], np.float32)
    return x, temp, topk


@pytest.mark.gpu
@pytest.mark.parametrize("stream", kdecode.STREAMS)
@pytest.mark.parametrize("B", [1, 8, 64])
@pytest.mark.parametrize("V", [64, 1000, 50257])
def test_gpu_fused_sample_streams_bitwise(cuda, stream, B, V):
    """Both streams bitwise the plain version at every batch and vocab
    size; two launches equal; row 0 alone (the one row whose stream
    index does not move with the batch) and every greedy row alone equal
    their rows of the batch."""
    rng = np.random.RandomState(B * 7 + V)
    x, temp, topk = _sample_rows(rng, B, V)
    seed = torch.tensor(4321, dtype=torch.int32, device=cuda)
    args = (_gpu(x, cuda), seed, _gpu(temp, cuda), _gpu(topk, cuda))
    before = dict(kdecode.fused_sample.launches)
    got = kdecode.fused_sample(*args, stream=stream)
    again = kdecode.fused_sample(*args, stream=stream)
    want = kdecode.fused_sample_plain(*args, stream=stream)
    torch.cuda.synchronize()
    assert kdecode.fused_sample.launches == dict(
        before, **{stream: before[stream] + 2})
    assert torch.equal(got, want)
    assert torch.equal(got, again)
    for b in [0] + [b for b in range(B) if temp[b] <= 0]:
        one = kdecode.fused_sample(
            args[0][b:b + 1].contiguous(), seed, args[2][b:b + 1].contiguous(),
            args[3][b:b + 1].contiguous(), stream=stream)
        assert int(one[0]) == int(got[b]), b


@pytest.mark.gpu
def test_gpu_fused_sample_uniform_of_one_never_wins(cuda):
    """Seed 33137 hashes row 0, lane 219 to u == 1.0: with that lane
    filtered by top-k its score is NaN, which must not win on the card
    either; kept, it wins outright."""
    rng = np.random.RandomState(6)
    V = 50257
    x = rng.randn(1, V).astype(np.float32)
    x[0, 219] = x.min() - 1.0
    temp = _gpu(np.ones(1, np.float32), cuda)
    topk = _gpu(np.full(1, 5, np.int32), cuda)
    seed = torch.tensor(33137, dtype=torch.int32, device=cuda)
    got = kdecode.fused_sample(_gpu(x, cuda), seed, temp, topk)
    want = kdecode.fused_sample_plain(_gpu(x, cuda), seed, temp, topk)
    assert torch.equal(got, want)
    assert int(got[0]) in np.argsort(-x[0])[:5]
    x[0, 219] = x.max() + 1.0
    got = kdecode.fused_sample(_gpu(x, cuda), seed, temp, topk)
    assert int(got[0]) == 219


@pytest.mark.gpu
@pytest.mark.parametrize("kvd", ["none", "int8", "int4"])
def test_gpu_span_write_page_groups_byte_exact(cuda, kvd):
    """A 9-page chunk (three CTAs of pages, the last holding one page)
    with full pages, a partial page and empty padding pages, at Dh = 64
    and the GQA width 128, byte for byte against the plain version."""
    rng = np.random.RandomState(16)
    L, Hkv, bs, pc, nblocks = 2, 3, 16, 9, 40
    for Dh in (64, 128):
        row = Dh // 2 if kvd == "int4" else Dh
        pool, spans = {}, {}
        for n in kprefill.span_names(kvd):
            if n.endswith("_scale"):
                pool[n] = _gpu(rng.rand(L, Hkv, nblocks * bs)
                               .astype(np.float32), cuda)
                spans[n] = _gpu(rng.rand(L, Hkv, pc * bs)
                                .astype(np.float32), cuda)
            elif kvd == "none":
                pool[n] = _gpu(rng.randn(L, Hkv, nblocks * bs, row), cuda,
                               torch.bfloat16)
                spans[n] = _gpu(rng.randn(L, Hkv, pc * bs, row), cuda,
                                torch.bfloat16)
            else:
                pool[n] = _gpu(rng.randint(-128, 128, (L, Hkv, nblocks * bs,
                                                       row)).astype(np.int8),
                               cuda)
                spans[n] = _gpu(rng.randint(-128, 128, (L, Hkv, pc * bs,
                                                        row)).astype(np.int8),
                                cuda)
        pages = _gpu(np.concatenate([rng.permutation(np.arange(1, nblocks))
                                     [:6], np.zeros(3, np.int64)])
                     .astype(np.int32), cuda)
        valid = _gpu(np.arange(pc * bs) < 5 * bs + 7, cuda)
        want = {n: t.clone() for n, t in pool.items()}
        kprefill.paged_span_write(pool, spans, pages, valid, block_size=bs,
                                  kv_dtype=kvd)
        kprefill.paged_span_write_plain(want, spans, pages, valid,
                                        block_size=bs, kv_dtype=kvd)
        torch.cuda.synchronize()
        for n in pool:
            assert torch.equal(pool[n].view(torch.uint8),
                               want[n].view(torch.uint8)), (Dh, n)


@pytest.mark.gpu
def test_gpu_span_write_refuses_what_it_cannot_take(cuda):
    """The one-pass operand check of the span write names what the
    kernel does not take: a wrong dtype, a span of another length, a
    misaligned buffer, a mask of another length."""
    L, Hkv, M, Dh, bs = 1, 2, 64, 8, 16
    pool = {n: torch.zeros(L, Hkv, M, Dh, device=cuda) for n in ("k", "v")}
    spans = {n: torch.ones(L, Hkv, bs, Dh, device=cuda) for n in ("k", "v")}
    pages = torch.zeros(1, dtype=torch.int32, device=cuda)
    valid = torch.ones(bs, dtype=torch.bool, device=cuda)
    kw = dict(block_size=bs)
    with pytest.raises(ValueError, match="spans\\['v'\\]: dtype"):
        kprefill.paged_span_write(pool, dict(spans, v=spans["v"].double()),
                                  pages, valid, **kw)
    with pytest.raises(ValueError, match="spans\\['k'\\]: shape"):
        kprefill.paged_span_write(pool, dict(spans, k=spans["k"][:, :, :8]
                                             .contiguous()), pages, valid,
                                  **kw)
    flat = torch.zeros(L * Hkv * bs * Dh + 1, device=cuda)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kprefill.paged_span_write(
            pool, dict(spans, k=flat[1:].view(L, Hkv, bs, Dh)), pages,
            valid, **kw)
    with pytest.raises(ValueError, match="valid: shape"):
        kprefill.paged_span_write(pool, spans, pages, valid[:8], **kw)
    kprefill.paged_span_write(pool, spans, pages, valid, **kw)
    torch.cuda.synchronize()
    assert torch.equal(pool["k"][:, :, :bs], spans["k"])


@pytest.mark.gpu
def test_gpu_split_kernels_on_two_streams(cuda):
    """Decode and chunk prefill launched on two streams at once give
    bitwise the outputs of the same launches one after the other: each
    stream has its own arrival counters."""
    rng = np.random.RandomState(17)
    B, Hkv, G, Dh, P, bs, nblocks = 8, 12, 1, 64, 64, 16, 600
    q = _gpu(rng.randn(B, Hkv, G, Dh), cuda, torch.bfloat16)
    k = _gpu(rng.randn(Hkv, nblocks * bs, Dh), cuda, torch.bfloat16)
    v = _gpu(rng.randn(Hkv, nblocks * bs, Dh), cuda, torch.bfloat16)
    pages = _gpu(np.stack([rng.permutation(nblocks)[:P] for _ in range(B)])
                 .astype(np.int32), cuda)
    pos = _gpu(rng.randint(100, P * bs, B).astype(np.int32), cuda)
    C = 256
    qc = _gpu(rng.randn(C, Hkv, G, Dh), cuda, torch.bfloat16)
    kc = _gpu(rng.randn(C, Hkv, Dh), cuda, torch.bfloat16)
    vc = _gpu(rng.randn(C, Hkv, Dh), cuda, torch.bfloat16)
    ctx = _gpu(rng.permutation(nblocks)[:40].astype(np.int32), cuda)

    def decode():
        return kdecode.flash_decode_attention(q, k, v, pages, pos,
                                              block_size=bs)

    def prefill():
        return kprefill.flash_chunk_prefill(qc, kc, vc, k, v, ctx,
                                            block_size=bs)

    want = [decode(), prefill()]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)]
    for _ in range(20):
        outs = [[], []]
        for _ in range(8):
            for i, (s, fn) in enumerate(zip(streams, (decode, prefill))):
                with torch.cuda.stream(s):
                    outs[i].append(fn())
        torch.cuda.synchronize()
        for i in range(2):
            assert all(torch.equal(o, want[i]) for o in outs[i]), i


@pytest.mark.gpu
def test_gpu_engine_runs_every_kernel(cuda):
    """A small bf16 engine on the card (``device="cuda"``, no index):
    every kernel of the path launches, and greedy output is the same
    with and without a prefix hit."""
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.serving import PagedDecodeEngine
    cfg = transformer.TransformerConfig(vocab=512, d_model=128, n_heads=2,
                                        n_layers=2, d_ff=256, max_len=256)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     "cuda")
    rng = np.random.RandomState(4)
    prompt = np.concatenate([rng.randint(0, 512, 64),
                             rng.randint(0, 512, 30)])
    outs = []
    for warm in (False, True):
        eng = PagedDecodeEngine.from_params(
            params, cfg, batch=4, cache_len=256, block_size=16,
            chunk_tokens=64, seed=0, device="cuda")
        if warm:                     # publishes the 64-token prefix
            eng.submit(prompt[:70], max_new=2)
            eng.run_until_idle()
        kernels.reset_launches()
        req = eng.submit(prompt, max_new=12)
        eng.run_until_idle()
        outs.append((req.tokens, req.prefix_hit_tokens))
        counts = kernels.launch_counts()
        assert counts["flash_decode_attention"] > 0
        assert counts["fused_sample"] > 0
        assert counts["fused_sample.threefry"] > 0
        assert counts["flash_chunk_prefill"] > 0
        assert counts["paged_span_write"] > 0
    assert outs[0][1] == 0 and outs[1][1] == 64
    assert outs[0][0] == outs[1][0]


# (B, H, Hkv, T, D): every head dim at one ragged and several tile-edge
# lengths, and one grouped-query case (k/v expanded as flash_attention
# expands them)
FLASH_SHAPES = [(1, 6, 6, T, D) for D in (32, 64, 96, 128)
                for T in (1, 63, 65, 300, 1000)] + [(2, 8, 2, 257, 128)]


def _flash_inputs(rng, B, H, Hkv, T, D, dtype, dev):
    """q, k, v, do as [B*H, T, D] in ``dtype`` on the card, k and v
    drawn at Hkv heads and expanded."""
    def rows(heads):
        x = torch.from_numpy(rng.randn(B, T, heads, D).astype(np.float32))
        x = kattention.expand_kv_heads(x, H)
        return _gpu(x.transpose(1, 2).reshape(B * H, T, D), dev, dtype)
    return rows(H), rows(Hkv), rows(Hkv), rows(H)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("B,H,Hkv,T,D", FLASH_SHAPES)
def test_gpu_flash_attention_matches_plain(cuda, dtype, causal, B, H, Hkv,
                                           T, D):
    rng = np.random.RandomState(5)
    q, k, v, do = _flash_inputs(rng, B, H, Hkv, T, D, dtype, cuda)
    scale = D ** -0.5
    branch = kattention.BRANCHES[dtype]
    before = (kattention.flash_attention_fwd.launches[branch],
              kattention.flash_attention_bwd.launches[branch])
    out, lse = kattention.flash_attention_fwd(q, k, v, sm_scale=scale,
                                              causal=causal)
    grads = kattention.flash_attention_bwd(q, k, v, out, lse, do,
                                           sm_scale=scale, causal=causal)
    want_out, want_lse = kattention.flash_attention_fwd_plain(
        q, k, v, sm_scale=scale, causal=causal)
    want = kattention.flash_attention_bwd_plain(
        q, k, v, out, lse, do, sm_scale=scale, causal=causal)
    torch.cuda.synchronize()
    assert (kattention.flash_attention_fwd.launches[branch],
            kattention.flash_attention_bwd.launches[branch]) == (
                before[0] + 1, before[1] + 1)
    assert (lse - want_lse).abs().max().item() <= 1e-4
    for got, ref in zip((out,) + grads, (want_out,) + want):
        assert got.dtype == dtype
        if dtype == torch.float32:
            assert (got - ref).abs().max().item() <= 1e-4
        else:
            assert kattention.bf16_ulps(got, ref) <= 2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_gpu_flash_attention_is_bitwise_repeatable(cuda, dtype, causal):
    """Two launches of each kernel on the same inputs give bitwise the
    same out, lse, dq, dk and dv: no atomics, a fixed summation order."""
    rng = np.random.RandomState(6)
    q, k, v, do = _flash_inputs(rng, 2, 4, 4, 333, 64, dtype, cuda)
    kw = dict(sm_scale=0.125, causal=causal)
    runs = []
    for _ in range(2):
        out, lse = kattention.flash_attention_fwd(q, k, v, **kw)
        runs.append((out, lse) + kattention.flash_attention_bwd(
            q, k, v, out, lse, do, **kw))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_gpu_flash_attention_counts_each_branch(cuda):
    """bf16 inputs launch the tensor-core kernels and fp32 inputs the
    CUDA-core ones; each moves only its own counter."""
    from paddle_tpu_torch.ops import kernels
    rng = np.random.RandomState(7)
    for dtype, name in ((torch.bfloat16, ""), (torch.float32, ".fp32")):
        q, k, v, do = _flash_inputs(rng, 1, 2, 2, 70, 32, dtype, cuda)
        kernels.reset_launches()
        out, lse = kattention.flash_attention_fwd(q, k, v, sm_scale=0.2,
                                                  causal=True)
        kattention.flash_attention_bwd(q, k, v, out, lse, do, sm_scale=0.2,
                                       causal=True)
        counts = {n: c for n, c in kernels.launch_counts().items() if c}
        assert counts == {f"flash_attention_fwd{name}": 1,
                          f"flash_attention_bwd{name}": 1}


@pytest.mark.gpu
def test_gpu_flash_attention_refuses_what_it_cannot_take(cuda):
    """A CUDA tensor the kernels cannot take raises; it never runs the
    plain version instead."""
    x = torch.zeros(2, 16, 48, device=cuda)
    with pytest.raises(ValueError, match="head dim 48"):
        kattention.flash_attention_fwd(x, x, x, sm_scale=1.0, causal=True)
    with pytest.raises(ValueError, match="head dim 48"):
        kattention.flash_attention_bwd(x, x, x, x, x[..., 0], x,
                                       sm_scale=1.0, causal=True)
    y = torch.zeros(2, 16, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        kattention.flash_attention_fwd(y, y, y, sm_scale=1.0, causal=True)
    z = torch.zeros(2 * 16 * 64 + 1, device=cuda, dtype=torch.bfloat16)
    z = z[1:].view(2, 16, 64)                   # contiguous, 2-byte offset
    with pytest.raises(ValueError, match="16-byte aligned"):
        kattention.flash_attention_fwd(z, z, z, sm_scale=1.0, causal=True)


@pytest.mark.gpu
def test_gpu_train_step_runs_both_attention_kernels(cuda):
    """One bf16 training step of a small LM on the card: a finite loss,
    one launch of each bf16 attention kernel per layer, none of the fp32
    branch."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.models import transformer
    cfg = transformer.TransformerConfig(
        vocab=512, d_model=128, n_heads=2, n_kv_heads=1, n_layers=2,
        d_ff=256, max_len=128)
    params = transformer.init_train_params(
        cfg, torch.Generator().manual_seed(0), "cuda")
    adam = optimizer.Adam(learning_rate=1e-3)
    state = adam.tree_init_state(params)
    toks = _gpu(np.random.RandomState(6).randint(0, 512, (2, 100)), cuda)
    before = (dict(kattention.flash_attention_fwd.launches),
              dict(kattention.flash_attention_bwd.launches))
    loss = transformer.lm_loss(params, toks, toks.roll(-1, 1), cfg)
    loss.backward()
    adam.tree_update(0, optimizer.take_grads(params), params, state)
    torch.cuda.synchronize()
    assert torch.isfinite(loss).item()
    assert (kattention.flash_attention_fwd.launches,
            kattention.flash_attention_bwd.launches) == (
                dict(before[0], bf16=before[0]["bf16"] + 2),
                dict(before[1], bf16=before[1]["bf16"] + 2))


def _small_lm(cuda):
    from paddle_tpu_torch.models import transformer
    cfg = transformer.TransformerConfig(vocab=512, d_model=128, n_heads=2,
                                        n_layers=2, d_ff=256, max_len=256)
    return cfg, transformer.init_params(
        cfg, torch.Generator().manual_seed(0), cuda)


def _random_pool(cfg, nb, bs, kv_dtype, cuda):
    from paddle_tpu_torch.models import transformer
    gen = torch.Generator().manual_seed(9)
    pool = transformer.init_block_pool(cfg, nb, bs, kv_dtype=kv_dtype,
                                       device="cpu")
    for name, t in pool.items():
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=gen))
        elif name.endswith("_scale"):
            t.copy_(torch.rand(t.shape, generator=gen) * 0.02 + 0.001)
        else:
            t.copy_(torch.randn(t.shape, generator=gen) * 0.5)
    return {n: t.to(cuda) for n, t in pool.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", [None, "int8", "int4"])
def test_gpu_step_graphs_replay_the_raw_steps(cuda, kv_dtype):
    """The engine's step programs (one CUDA graph per key) against their
    raw functions on the same inputs: ids and every pool byte equal, for
    a cold prefill chunk, a chunk with context, decode with greedy and
    sampled rows and two inactive rows, a replay with a new seed and a
    replay after a page-table remap."""
    from paddle_tpu_torch.serving import sampling
    cfg, params = _small_lm(cuda)
    bs, nb, B, P = 16, 64, 4, 16
    prefill, decode = sampling.paged_step_fns(cfg, bs)
    pool_g = _random_pool(cfg, nb, bs, kv_dtype, cuda)
    pool_r = {n: t.clone() for n, t in pool_g.items()}
    rng = np.random.RandomState(2)
    blocks = rng.permutation(np.arange(1, nb)).astype(np.int32)

    def scalar(v):
        return torch.tensor(v, dtype=torch.int32, device=cuda)

    def same_pools():
        return all(torch.equal(pool_g[n].view(torch.uint8),
                               pool_r[n].view(torch.uint8)) for n in pool_g)

    for off, c, temp, seed in ((0, 50, 0.8, 1), (64, 30, 0.8, 2),
                               (0, 50, 0.0, 3), (0, 50, 0.8, 4)):
        toks = np.zeros((1, 64), np.int32)
        toks[0, :c] = rng.randint(0, 512, c)
        pages = blocks[:off // bs + 4]
        ctl = (np.asarray([temp], np.float32), np.asarray([50], np.int32))
        got, _ = prefill(params, pool_g, toks, np.int32(c), pages, *ctl,
                         np.int32(seed))
        got = got.clone()
        want, _ = prefill.raw(params, pool_r, _gpu(toks, cuda), scalar(c),
                              _gpu(pages, cuda), *(_gpu(a, cuda) for a in ctl),
                              scalar(seed))
        assert torch.equal(got, want) and same_pools(), (off, seed)
    table = np.zeros((B, P), np.int32)
    table[0, :10], table[1, :10] = blocks[8:18], blocks[18:28]
    pages_dev = _gpu(table, cuda)
    pos = np.asarray([150, 90, 3, 100], np.int32)
    active = np.asarray([True, True, False, False])
    temp = np.asarray([0.0, 0.9, 0.0, 0.9], np.float32)
    topk = np.asarray([0, 0, 0, 50], np.int32)
    drawn = []
    for seed, remap in ((5, False), (6, False), (7, True)):
        if remap:
            table[1, :10] = blocks[28:38]
            pages_dev.copy_(_gpu(table, cuda))
        toks = rng.randint(0, 512, B).astype(np.int32)
        got, _ = decode(params, pool_g, toks, pos, active, pages_dev, temp,
                        topk, np.int32(seed))
        got = got.clone()
        want, _ = decode.raw(params, pool_r, _gpu(toks, cuda),
                             _gpu(pos, cuda), _gpu(active, cuda), pages_dev,
                             _gpu(temp, cuda), _gpu(topk, cuda), scalar(seed))
        assert torch.equal(got, want) and same_pools(), seed
        drawn.append(int(got[1]))
    assert prefill.graphs == 2 and decode.graphs == 1
    assert prefill.tracker.count() == 3


@pytest.mark.gpu
def test_gpu_capture_failure_names_the_operation(cuda):
    """A step that syncs with the host cannot be captured: the program
    raises, from the operation that broke the capture, and no graph is
    kept."""
    from paddle_tpu_torch.core import graphs

    def step(x, n):
        return x * int(x.sum().item()) + n

    prog = graphs.StepProgram(step, "sync_step")
    x = torch.ones(4, device=cuda)
    with pytest.raises(graphs.GraphCaptureError, match="sync_step") as err:
        prog(x, np.int32(1))
    assert err.value.__cause__ is not None
    assert prog.graphs == 0
    torch.cuda.synchronize()
    assert torch.equal(x + 1, torch.full((4,), 2.0, device=cuda))


@pytest.mark.gpu
def test_gpu_capture_runs_with_garbage_collection_off(cuda):
    """A collection during a capture could destroy an unreachable graph
    (an earlier engine's), which CUDA refuses mid-capture and which voids
    the capture: the program turns collection off for the capture only
    (the warm-up run before it, and everything after, keep it)."""
    import gc
    from paddle_tpu_torch.core import graphs
    seen = []

    def step(x):
        seen.append(gc.isenabled())
        return x * 2 + 1

    assert gc.isenabled()
    prog = graphs.StepProgram(step, "gc_step")
    x = torch.ones(8, device=cuda)
    out = prog(x)
    torch.cuda.synchronize()
    assert torch.equal(out, torch.full((8,), 3.0, device=cuda))
    assert seen == [True, False] and gc.isenabled()


@pytest.mark.gpu
def test_gpu_capture_survives_a_collectable_earlier_graph(cuda):
    """The failing case itself: an earlier program's captured graph is
    garbage in a reference cycle when a new capture begins, and collection
    runs at every allocation (``gc.set_threshold(1)``). The cycle is made
    inside the step, so it is young and the capture's own allocations
    would collect it, destroying the earlier graph mid-capture. The new
    capture succeeds and replays right; the earlier program is freed once
    the capture is over."""
    import gc
    import weakref
    from paddle_tpu_torch.core import graphs

    earlier = graphs.StepProgram(lambda x: x + 1, "earlier_step")
    x = torch.ones(8, device=cuda)
    earlier(x)
    torch.cuda.synchronize()
    gone = weakref.ref(earlier)
    olds = [earlier]
    del earlier
    calls = []

    def step(x):
        calls.append(len(calls))
        if len(calls) == 2 and olds:         # the capturing call
            cycle = [olds.pop()]
            cycle.append(cycle)
            del cycle
            junk = [[i] for i in range(256)]  # allocations that collect
            del junk
        return x * 2 + 1

    threshold = gc.get_threshold()
    gc.set_threshold(1)
    try:
        prog = graphs.StepProgram(step, "new_step")
        out = prog(x)
        torch.cuda.synchronize()
        assert torch.equal(out, torch.full((8,), 3.0, device=cuda))
        x.mul_(2)                   # a resident input: same tensor
        out = prog(x)
        torch.cuda.synchronize()
        assert torch.equal(out, torch.full((8,), 5.0, device=cuda))
    finally:
        gc.set_threshold(*threshold)
    assert calls == [0, 1] and not olds
    gc.collect()
    assert gone() is None


@pytest.mark.gpu
def test_gpu_engine_preempts_remap_and_replay(cuda):
    """A pool of 8 blocks and 2 slots: a latency arrival preempts a
    batch victim that resumes by remap; a second one whose worst case is
    the whole pool evicts the next victim's blocks, which resumes by
    replay. Both victims' greedy ids equal their runs alone, and the
    launch counts of the replayed graphs add up."""
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.serving import PagedDecodeEngine
    cfg, params = _small_lm(cuda)
    kw = dict(batch=2, cache_len=256, block_size=16, chunk_tokens=64,
              num_blocks=8, seed=0, device="cuda")
    rng = np.random.RandomState(8)
    eng = PagedDecodeEngine.from_params(params, cfg, **kw)
    kernels.reset_launches()
    victims = []
    for lat in ([(48, 16)], [(64, 64), (32, 16)]):
        v = eng.submit(rng.randint(0, 512, 48), 64, tier="batch")
        victims.append(v)
        while len(v.tokens) < 3:
            eng.step()
        for n, m in lat:
            eng.submit(rng.randint(0, 512, n), m, tier="latency")
        eng.run_until_idle()
    resumes = eng.metrics.get("engine_resumes_total")
    assert [int(resumes.value(mode=m)) for m in ("remap", "replay")] == [1, 1]
    assert eng.pool.idle and [v.preemptions for v in victims] == [1, 1]
    # every replay adds its graph's launches; each capture's warm-up
    # launched once more
    counts = kernels.launch_counts()
    assert counts["flash_decode_attention"] == cfg.n_layers * (
        eng.health()["decode_steps"] + eng.compile_counts()["decode"])
    for v in victims:
        solo = PagedDecodeEngine.from_params(params, cfg, **kw)
        r = solo.submit(v.prompt, v.max_new)
        solo.run_until_idle()
        assert r.tokens == v.tokens


def _serve(eng, prompt, max_new):
    r = eng.submit(prompt, max_new)
    eng.run_until_idle()
    assert r.status == "done" and len(r.tokens) == max_new
    return r


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", [None, "int8", "int4"])
def test_gpu_import_and_promotion_write_in_place(cuda, kv_dtype):
    """``import_prefix`` and tier promotion write the captured pool in
    place: every pool leaf keeps its ``data_ptr``, the graph count does
    not move, and the greedy ids over the adopted (or promoted) blocks
    equal the same prompt served cold."""
    from paddle_tpu_torch.serving import PagedDecodeEngine
    cfg, params = _small_lm(cuda)
    kw = dict(batch=2, cache_len=256, block_size=16, chunk_tokens=64,
              seed=0, device="cuda", kv_dtype=kv_dtype)
    rng = np.random.RandomState(12)
    prompt = rng.randint(0, 512, 150)        # 8 transferable blocks
    want = _serve(PagedDecodeEngine.from_params(params, cfg, **kw),
                  prompt, 16).tokens
    a = PagedDecodeEngine.from_params(params, cfg, **kw)
    _serve(a, prompt, 1)
    payload = a.export_prefix(prompt)
    b = PagedDecodeEngine.from_params(params, cfg, **kw)
    _serve(b, rng.randint(0, 512, 150), 16)  # captures the same keys
    ptrs = {n: t.data_ptr() for n, t in b.cache.items()}
    graphs = b.compile_counts()
    assert b.import_prefix(payload) == 8
    assert {n: t.data_ptr() for n, t in b.cache.items()} == ptrs
    assert b.compile_counts() == graphs
    r = _serve(b, prompt, 16)
    assert r.prefix_hit_tokens == 128 and r.tokens == want
    assert b.compile_counts() == graphs
    # promotion: a pool of 16 blocks, the prompt evicted by two others
    eng = PagedDecodeEngine.from_params(
        params, cfg, num_blocks=16, tiers={"dram_bytes": 1 << 28}, **kw)
    ptrs = {n: t.data_ptr() for n, t in eng.cache.items()}
    assert _serve(eng, prompt, 16).tokens == want
    for _ in range(2):
        _serve(eng, rng.randint(0, 512, 150), 16)
    graphs = eng.compile_counts()
    r = _serve(eng, prompt, 16)
    hits = eng.metrics.get("engine_prefix_tier_hit_blocks_total")
    assert hits.value(tier="dram") == 8 and r.prefix_hit_tokens == 128
    assert r.tokens == want
    assert {n: t.data_ptr() for n, t in eng.cache.items()} == ptrs
    assert eng.compile_counts() == graphs and eng.pool.idle


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", [None, "int8", "int4"])
def test_gpu_replay_after_import_is_the_raw_step(cuda, kv_dtype):
    """A chain written by ``transfer.write_blocks`` into a pool the step
    graphs captured: a prefill chunk whose context is the adopted blocks
    and a decode step over them, replayed, give bitwise the ids and pool
    bytes of the raw step functions on a copy written the same way."""
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.serving import sampling, transfer
    cfg, params = _small_lm(cuda)
    bs, nb = 16, 32
    kvd = kv_dtype or "none"
    prefill, decode = sampling.paged_step_fns(cfg, bs)
    pool_g = _random_pool(cfg, nb, bs, kv_dtype, cuda)
    pool_r = {n: t.clone() for n, t in pool_g.items()}
    src = {n: t.roll(7 * bs, dims=2).contiguous() for n, t in pool_g.items()}
    assert transformer.pool_kv_dtype(pool_g, cfg) == kvd
    ptrs = {n: t.data_ptr() for n, t in pool_g.items()}
    rng = np.random.RandomState(13)

    def scalar(v):
        return torch.tensor(v, dtype=torch.int32, device=cuda)

    def same_pools():
        return all(torch.equal(pool_g[n].view(torch.uint8),
                               pool_r[n].view(torch.uint8)) for n in pool_g)

    ctl = (np.asarray([0.0], np.float32), np.asarray([0], np.int32))
    pages = np.arange(1, 9, dtype=np.int32)        # 4 context + 4 chunk
    table = np.zeros((2, 16), np.int32)
    table[0, :6] = [1, 2, 3, 4, 5, 6]
    pages_dev = _gpu(table, cuda)                  # resident: one tensor
    for step in ("capture", "replay"):
        if step == "replay":
            meta, items = transfer.deserialize_blocks(
                transfer.serialize_blocks(src, [9, 10, 11, 12],
                                          [bytes([i]) * 16 for i in range(4)],
                                          bs, kvd))
            for pool in (pool_g, pool_r):
                transfer.check_pool_match(meta, pool, bs, kvd)
                transfer.write_blocks(
                    pool, [(b, arr) for b, (_, arr) in
                           zip((1, 2, 3, 4), items)], bs)
            assert {n: t.data_ptr() for n, t in pool_g.items()} == ptrs
            assert same_pools()
        toks = np.zeros((1, 64), np.int32)
        toks[0, :40] = rng.randint(0, 512, 40)
        got, _ = prefill(params, pool_g, toks, np.int32(40), pages, *ctl,
                         np.int32(3))
        got = got.clone()
        want, _ = prefill.raw(params, pool_r, _gpu(toks, cuda), scalar(40),
                              _gpu(pages, cuda), *(_gpu(a, cuda) for a in ctl),
                              scalar(3))
        assert torch.equal(got, want) and same_pools(), step
        toks1 = rng.randint(0, 512, 2).astype(np.int32)
        pos, active = (np.asarray([90, 0], np.int32),
                       np.asarray([True, False]))
        temp, topk = np.zeros(2, np.float32), np.zeros(2, np.int32)
        got, _ = decode(params, pool_g, toks1, pos, active, pages_dev, temp,
                        topk, np.int32(4))
        got = got.clone()
        want, _ = decode.raw(params, pool_r, _gpu(toks1, cuda),
                             _gpu(pos, cuda), _gpu(active, cuda), pages_dev,
                             _gpu(temp, cuda), _gpu(topk, cuda), scalar(4))
        assert torch.equal(got, want) and same_pools(), step
    assert prefill.graphs == 1 and decode.graphs == 1


@pytest.mark.gpu
def test_gpu_fused_spec_verify_matches_plain(cuda):
    """``fused_spec_verify`` (kernel 2 at a verify window's B*W rows) on
    the card: ids and accepted counts exactly the plain sampler's over
    the flattened rows and ``spec_accept``, with every slot's own
    temperature and top_k; one launch, counted under ``fused_sample``
    and in the entry point's own tally."""
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.serving import sampling
    rng = np.random.RandomState(14)
    B, W, V = 4, 5, 1000
    x = _gpu((3.0 * rng.randn(B, W, V)).astype(np.float32), cuda)
    draft = x.argmax(-1)[:, :W - 1].to(torch.int32).clone()
    draft[1, 2] = (draft[1, 2] + 1) % V
    temp = torch.tensor([0.0, 0.8, 1.2, 0.0], device=cuda)
    topk = torch.tensor([0, 50, 3, 7], dtype=torch.int32, device=cuda)
    valid = torch.tensor([5, 5, 2, 1], dtype=torch.int32, device=cuda)
    seed = torch.tensor(99, dtype=torch.int32, device=cuda)
    kernels.reset_launches()
    ids, n = kdecode.fused_spec_verify(x, draft, seed, temp, topk, valid)
    want = kdecode.fused_sample_plain(
        x.reshape(B * W, V), seed, sampling.window_rows(temp, W),
        sampling.window_rows(topk, W)).reshape(B, W)
    assert torch.equal(ids, want)
    assert torch.equal(n, sampling.spec_accept(want, draft, valid))
    assert n[0].item() == 5 and n[3].item() == 1
    assert kernels.launch_counts()["fused_sample"] == 1
    assert kernels.entry_counts() == {"fused_spec_verify": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", [None, "int8", "int4"])
def test_gpu_verify_window_matches_decode_steps(cuda, kv_dtype):
    """The window check at a small width: one verify window of 4 rows
    against 4 sequential raw decode steps from the same pool state (two
    active slots, one inactive). The attention is the decode kernel's
    own reduction per row; the GEMMs run at M = B * W against M = B, so
    logits agree within 1e-4 (fp32 model) and the greedy ids exactly;
    the written pool rows within the same bound (int8/int4: codes within
    one step)."""
    from paddle_tpu_torch.models import transformer
    cfg = transformer.TransformerConfig(vocab=512, d_model=128, n_heads=4,
                                        n_kv_heads=2, n_layers=2, d_ff=256,
                                        max_len=256, dtype="float32")
    params = transformer.init_params(cfg, torch.Generator().manual_seed(3),
                                     cuda)
    bs, nb, W = 16, 40, 4
    pool_s = _random_pool(cfg, nb, bs, kv_dtype, cuda)
    pool_v = {n: t.clone() for n, t in pool_s.items()}
    table = np.zeros((3, 16), np.int32)
    table[0], table[1] = np.arange(1, 17), np.arange(17, 33)
    pages = _gpu(table, cuda)
    active = _gpu(np.asarray([True, True, False]), cuda)
    pos = _gpu(np.asarray([100, 37, 4], np.int32), cuda)
    tok = _gpu(np.asarray([5, 9, 1], np.int32), cuda)
    seq, window = [], [tok]
    for j in range(W):
        lg, _ = transformer.decode_step_paged(params, pool_s, tok, pos + j,
                                              active, pages, cfg,
                                              block_size=bs)
        seq.append(lg)
        tok = lg.argmax(-1).to(torch.int32)
        if j < W - 1:
            window.append(tok)
    vlg, _ = transformer.verify_step_paged(
        params, pool_v, torch.stack(window, 1), pos,
        torch.full((3,), W, dtype=torch.int32, device=cuda), active, pages,
        cfg, block_size=bs)
    seq = torch.stack(seq, 1)
    assert (vlg[:2] - seq[:2]).abs().max().item() <= 1e-4
    assert torch.equal(vlg[:2].argmax(-1), seq[:2].argmax(-1))
    for n in pool_s:
        a, b = pool_v[n], pool_s[n]
        if a.dtype == torch.int8 and kv_dtype == "int4":
            # nibble pairs: each code on its own
            a, b = q8.unpack_int4(a), q8.unpack_int4(b)
        diff = (a.float() - b.float()).abs().max().item()
        assert diff <= (1e-4 if a.is_floating_point() else 1.0), n


@pytest.mark.gpu
def test_gpu_spec_graphs_replay_the_raw_steps(cuda):
    """The spec programs (propose, verify, draft_verify) captured and
    replayed against their raw functions on the same inputs, with new
    inputs and after a page-table remap: ids, accepted counts and every
    byte of both pools equal."""
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.serving import sampling
    cfg, params = _small_lm(cuda)
    dcfg = transformer.TransformerConfig(vocab=512, d_model=128, n_heads=2,
                                         n_layers=1, d_ff=256, max_len=256)
    draft = transformer.init_params(dcfg, torch.Generator().manual_seed(7),
                                    cuda)
    bs, nb, B, P, k = 16, 64, 4, 16, 3
    spec = sampling.paged_spec_fns(cfg, dcfg, bs, k)
    pool_g = _random_pool(cfg, nb, bs, None, cuda)
    dpool_g = _random_pool(dcfg, nb, bs, None, cuda)
    pool_r = {n: t.clone() for n, t in pool_g.items()}
    dpool_r = {n: t.clone() for n, t in dpool_g.items()}
    rng = np.random.RandomState(15)
    table = np.zeros((B, P), np.int32)
    table[0, :10], table[1, :10] = np.arange(1, 11), np.arange(11, 21)
    pages_dev = _gpu(table, cuda)
    active = np.asarray([True, True, False, False])
    temp = np.asarray([0.0, 0.9, 0.0, 0.9], np.float32)
    topk = np.asarray([0, 20, 0, 20], np.int32)

    def same(a, b):
        return all(torch.equal(a[n].view(torch.uint8), b[n].view(torch.uint8))
                   for n in a)

    for seed, remap in ((5, False), (6, False), (7, True)):
        if remap:
            table[1, :10] = np.arange(21, 31)
            pages_dev.copy_(_gpu(table, cuda))
        last = rng.randint(0, 512, B).astype(np.int32)
        pos = np.asarray([120, 60, 3, 9], np.int32)
        valid = np.asarray([4, 2, 1, 4], np.int32)
        props, _ = spec["propose"](draft, dpool_g, last, pos, active, valid,
                                   pages_dev)
        props = props.clone()
        want, _ = spec["propose"].raw(draft, dpool_r, _gpu(last, cuda),
                                      _gpu(pos, cuda), _gpu(active, cuda),
                                      _gpu(valid, cuda), pages_dev)
        assert torch.equal(props, want) and same(dpool_g, dpool_r), seed
        window = np.concatenate([last[:, None], props.cpu().numpy()], 1)
        X, n, _ = spec["verify"](params, pool_g, window, pos, valid, active,
                                 pages_dev, temp, topk, np.int32(seed))
        X, n = X.clone(), n.clone()
        wX, wn, _ = spec["verify"].raw(
            params, pool_r, _gpu(window, cuda), _gpu(pos, cuda),
            _gpu(valid, cuda), _gpu(active, cuda), pages_dev,
            _gpu(temp, cuda), _gpu(topk, cuda),
            torch.tensor(seed, dtype=torch.int32, device=cuda))
        assert torch.equal(X, wX) and torch.equal(n, wn), seed
        assert same(pool_g, pool_r), seed
        forced = np.asarray([False, True, False, False])
        spec["draft_verify"](draft, dpool_g, window, pos, valid, forced,
                             pages_dev)
        spec["draft_verify"].raw(draft, dpool_r, _gpu(window, cuda),
                                 _gpu(pos, cuda), _gpu(valid, cuda),
                                 _gpu(forced, cuda), pages_dev)
        assert same(dpool_g, dpool_r), seed
    assert {k: spec[k].graphs for k in ("propose", "verify",
                                        "draft_verify")} == {
        "propose": 1, "verify": 1, "draft_verify": 1}


# ---------------------------------------------------------------------------
# the row-arena slot engine and the lockstep paths
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("T", [16, 32, 200, 512])
def test_gpu_flash_attention_at_slot_prefill_shapes(cuda, T):
    """Kernel 5's forward at the slot prefill's shapes (one request, 12
    heads, D = 64, bf16, causal; T = the buckets below one 64-wide tile,
    a ragged length and the largest bucket) within 2 bf16 ulps of its
    plain version, lse within 1e-4."""
    rng = np.random.RandomState(T)
    q, k, v, _ = _flash_inputs(rng, 1, 12, 12, T, 64, torch.bfloat16, cuda)
    out, lse = kattention.flash_attention_fwd(q, k, v, sm_scale=0.125,
                                              causal=True)
    want, want_lse = kattention.flash_attention_fwd_plain(
        q, k, v, sm_scale=0.125, causal=True)
    assert kattention.bf16_ulps(out, want) <= 2
    assert (lse - want_lse).abs().max().item() <= 1e-4


def _arena_on(cfg, B, L, cuda, seed):
    from paddle_tpu_torch.models import transformer
    gen = torch.Generator().manual_seed(seed)
    arena = transformer.init_cache(cfg, B, L, device="cpu")
    for t in arena.values():
        t.copy_(torch.randn(t.shape, generator=gen) * 0.5)
    return {n: t.to(cuda) for n, t in arena.items()}


@pytest.mark.gpu
def test_gpu_slot_graphs_replay_the_raw_steps(cuda):
    """The slot engine's step programs against their raw functions on
    the same inputs: ids and every arena byte equal, for a prefill at
    bucket 64 into two slots, the same bucket replayed with two seeds
    (each replay draws its own seed's id: the seed is read on the
    device) and a decode step with greedy, sampled and inactive rows,
    replayed with a new seed. One graph per bucket, one for decode."""
    from paddle_tpu_torch.serving import sampling
    cfg, params = _small_lm(cuda)
    B, L = 4, 256
    prefill, decode = sampling.engine_step_fns(cfg)
    arena_g = _arena_on(cfg, B, L, cuda, 3)
    arena_r = {n: t.clone() for n, t in arena_g.items()}
    rng = np.random.RandomState(4)

    def scalar(v):
        return torch.tensor(v, dtype=torch.int32, device=cuda)

    def same():
        return all(torch.equal(arena_g[n].view(torch.int16),
                               arena_r[n].view(torch.int16)) for n in arena_g)

    prompt = rng.randint(0, 512, 50)
    drawn = []
    for slot, temp, seed in ((1, 0.8, 1), (2, 0.0, 2), (1, 5.0, 3),
                             (1, 5.0, 4)):
        toks = np.zeros((1, 64), np.int32)
        toks[0, :50] = prompt
        ctl = (np.asarray([temp], np.float32), np.asarray([50], np.int32))
        got, _ = prefill(params, arena_g, toks, np.int32(50), np.int32(slot),
                         *ctl, np.int32(seed))
        got = got.clone()
        want, _ = prefill.raw(params, arena_r, _gpu(toks, cuda), scalar(50),
                              scalar(slot), *(_gpu(a, cuda) for a in ctl),
                              scalar(seed))
        assert torch.equal(got, want) and same(), seed
        drawn.append(int(got[0]))
    assert drawn[2] != drawn[3], drawn  # a graph that froze its seed
    pos = np.asarray([100, 51, 3, 255], np.int32)
    active = np.asarray([True, True, False, False])
    temp = np.asarray([0.0, 0.9, 0.0, 0.9], np.float32)
    topk = np.asarray([0, 50, 0, 50], np.int32)
    for seed in (5, 6):
        toks = rng.randint(0, 512, B).astype(np.int32)
        got, _ = decode(params, arena_g, toks, pos, active, temp, topk,
                        np.int32(seed))
        got = got.clone()
        want, _ = decode.raw(params, arena_r, _gpu(toks, cuda),
                             _gpu(pos, cuda), _gpu(active, cuda),
                             _gpu(temp, cuda), _gpu(topk, cuda),
                             scalar(seed))
        assert torch.equal(got, want) and same(), seed
    assert prefill.graphs == 1 and decode.graphs == 1


@pytest.mark.gpu
def test_gpu_slot_step_bitwise_equals_lockstep_step(cuda):
    """On the card, at equal positions and equal B, ``decode_step_slots``
    gives bitwise the logits and arena of ``decode_step``."""
    from paddle_tpu_torch.models import transformer
    cfg, params = _small_lm(cuda)
    arena = _arena_on(cfg, 4, 256, cuda, 5)
    toks = torch.tensor([3, 7, 11, 13], dtype=torch.int32, device=cuda)
    c1 = {n: t.clone() for n, t in arena.items()}
    c2 = {n: t.clone() for n, t in arena.items()}
    l1, c1 = transformer.decode_step(params, c1, toks, 120, cfg)
    l2, c2 = transformer.decode_step_slots(
        params, c2, toks, torch.full((4,), 120, dtype=torch.int32,
                                     device=cuda),
        torch.ones(4, dtype=torch.bool, device=cuda), cfg)
    assert torch.equal(l1, l2)
    for n in c1:
        assert torch.equal(c1[n].view(torch.int16), c2[n].view(torch.int16))


@pytest.mark.gpu
def test_gpu_slot_walk_matches_cpu(cuda):
    """A short fp32 slot walk on the card and on the CPU from the same
    weights: a slot prefill, three slot decode steps with an inactive
    row, then ``generate`` and ``beam_search``; logits within 1e-4,
    greedy ids equal."""
    from paddle_tpu_torch.models import transformer
    cfg = transformer.TransformerConfig(vocab=512, d_model=128, n_heads=2,
                                        n_layers=2, d_ff=256, max_len=256,
                                        dtype="float32")
    cpu = transformer.init_params(cfg, torch.Generator().manual_seed(7),
                                  "cpu")
    gpu = transformer.params_from_numpy(
        transformer.params_to_numpy(cpu), cfg, device=cuda)
    rng = np.random.RandomState(8)
    padded = np.zeros((1, 64), np.int32)
    padded[0, :40] = rng.randint(0, 512, 40)
    out = {}
    for dev, p in (("cpu", cpu), (cuda, gpu)):
        arena = transformer.init_cache(cfg, 3, 128, device=dev)
        lg, arena = transformer.prefill_into_slot(
            p, arena, _gpu(padded, dev),
            torch.tensor(40, dtype=torch.int32, device=dev),
            torch.tensor(1, dtype=torch.int32, device=dev), cfg)
        logs = [lg[0]]
        tok = int(lg[0].argmax())
        for j in range(3):
            lg, arena = transformer.decode_step_slots(
                p, arena, torch.tensor([0, tok, 0], dtype=torch.int32,
                                       device=dev),
                torch.tensor([0, 40 + j, 5], dtype=torch.int32, device=dev),
                torch.tensor([False, True, False], device=dev), cfg)
            logs.append(lg[1])
            tok = int(lg[1].argmax())
        prompt = _gpu(rng.randint(0, 512, (2, 9)), dev) if dev == "cpu" \
            else out["cpu"][2].to(dev)
        gen = transformer.generate(p, prompt, cfg, max_new=6)
        beams, scores = transformer.beam_search(p, prompt, cfg, max_new=4,
                                                beam_size=3)
        out[str(dev)] = (torch.stack(logs).cpu(), gen.cpu(), prompt.cpu(),
                         beams.cpu(), scores.cpu())
    a, b = out["cpu"], out[str(cuda)]
    assert (a[0] - b[0]).abs().max().item() <= 1e-4
    assert torch.equal(a[1], b[1]) and torch.equal(a[3], b[3])
    assert (a[4] - b[4]).abs().max().item() <= 1e-4


def _fleet_prompts(seed, n, shared=96, vocab=512):
    """``n`` prompts sharing a ``shared``-token prefix (one chunk of 64
    and more), tails of 5 + 7·i tokens."""
    rng = np.random.RandomState(seed)
    head = rng.randint(0, vocab, shared)
    return [np.concatenate([head, rng.randint(0, vocab, 5 + 7 * i)])
            for i in range(n)]


def _fleet_engine(params, cfg, dev):
    from paddle_tpu_torch.serving import PagedDecodeEngine
    return PagedDecodeEngine.from_params(params, cfg, batch=2, cache_len=256,
                                         block_size=16, chunk_tokens=64,
                                         seed=0, device=dev)


def _single_ids(params, cfg, prompts, max_new, dev):
    eng = _fleet_engine(params, cfg, dev)
    reqs = [eng.submit(p, max_new) for p in prompts]
    eng.run_until_idle()
    return [r.tokens for r in reqs]


@pytest.mark.gpu
def test_gpu_two_replica_fleet_gives_single_engine_ids(cuda):
    """Two ``EngineReplica``s behind the ``Router``, sharing one weight
    dict: the shared-prefix trace converges onto one replica and every
    greedy id equals the single engine's (each replica replays graphs of
    the single engine's shapes)."""
    from paddle_tpu_torch.serving import EngineReplica, Router
    cfg, params = _small_lm(cuda)
    prompts = _fleet_prompts(21, 4) + [np.random.RandomState(22).randint(
        0, 512, 70) for _ in range(2)]
    want = _single_ids(params, cfg, prompts, 12, cuda)
    reps = [EngineReplica(_fleet_engine(params, cfg, cuda), f"r{i}")
            for i in range(2)]
    router = Router(reps, block_size=16, chunk_tokens=64, health_poll_s=0.0)
    reqs = [router.submit(p, 12) for p in prompts]
    router.run_until_idle()
    assert [r.tokens for r in reqs] == want
    assert len({r.replica for r in reqs[:4]}) == 1
    assert router.placement_hit_rate() > 0
    assert all(r.status == "done" for r in reqs)


@pytest.mark.gpu
def test_gpu_pd_replicas_adopt_and_match_colocated(cuda):
    """P/D on the card: the prefill replica's exported blocks adopt in
    the decode replica's pool (imported and hit blocks counted, the
    router's exports counted) and the greedy ids equal the colocated
    single engine's."""
    from paddle_tpu_torch.serving import EngineReplica, Router
    cfg, params = _small_lm(cuda)
    prompts = _fleet_prompts(23, 3)
    want = _single_ids(params, cfg, prompts, 10, cuda)
    pf = EngineReplica(_fleet_engine(params, cfg, cuda), "pf")
    dc = EngineReplica(_fleet_engine(params, cfg, cuda), "dc")
    router = Router([pf, dc], block_size=16, chunk_tokens=64,
                    prefill=["pf"], health_poll_s=0.0)
    reqs = [router.submit(p, 10) for p in prompts]
    router.run_until_idle()
    assert [r.tokens for r in reqs] == want
    assert all(r.replica == "dc" for r in reqs)
    assert router._m_pd_exports.value() >= 1
    assert dc.eng.metrics.get("engine_kv_blocks_imported_total").value() > 0
    assert dc.eng.metrics.get(
        "engine_prefix_cache_hit_blocks_total").value() > 0


@pytest.mark.gpu
def test_gpu_serve_thread_graphs_match_the_main_thread(cuda):
    """A ``ReplicaServer`` steps its engine on its serve thread, where
    the engine's CUDA graphs are captured and replayed: request by
    request over TCP it gives the ids, graph counts and pool bytes of a
    twin engine stepped on the main thread; after the drain the same
    graphs replay on the main thread, bitwise as the twin's again."""
    import threading
    import time

    from paddle_tpu_torch.serving import ReplicaServer, SocketReplica
    cfg, params = _small_lm(cuda)
    prompts = _fleet_prompts(25, 3) + [np.random.RandomState(26).randint(
        0, 512, 40)]
    served, twin = (_fleet_engine(params, cfg, cuda) for _ in range(2))
    srv = ReplicaServer(served, port=0)
    rc = []
    t = threading.Thread(target=lambda: rc.append(srv.serve_forever()),
                         daemon=True)
    t.start()
    h = SocketReplica("r0", ("127.0.0.1", srv.port))
    got = []
    try:
        for i, p in enumerate(prompts):
            h.submit({"id": i, "prompt": p.tolist(), "max_new": 8,
                      "temperature": 0.8 if i % 2 else 0.0, "top_k": 50})
            docs, deadline = [], time.time() + 120
            while not docs and time.time() < deadline:
                docs = h.poll()
                time.sleep(0.005)
            assert docs and docs[0]["id"] == i, docs
            got.append(docs[0]["tokens"])
    finally:
        srv.drain()
        t.join(timeout=60)
        h.close()
    assert rc == [0]
    want = []
    for i, p in enumerate(prompts):
        r = twin.submit(p, 8, temperature=0.8 if i % 2 else 0.0, top_k=50)
        twin.run_until_idle()
        want.append(r.tokens)

    def same_pools():
        return all(torch.equal(served.cache[n].view(torch.uint8),
                               twin.cache[n].view(torch.uint8))
                   for n in served.cache)
    assert got == want
    assert served.compile_counts() == twin.compile_counts()
    assert same_pools()
    graphs = served.compile_counts()
    again = []
    for eng in (served, twin):          # the main thread replays both
        reqs = [eng.submit(p, 8) for p in prompts[:2]]
        eng.run_until_idle()
        again.append([r.tokens for r in reqs])
    assert again[0] == again[1] and again[0][0] == want[0]
    assert served.compile_counts() == graphs == twin.compile_counts()
    assert same_pools()


@pytest.mark.gpu
def test_gpu_process_fleet_sigkill_healed_zero_lost(cuda, tmp_path):
    """Two ``serve --port`` replica processes on the card (each its own
    CUDA context, weights, pool and graphs) from a v4 artifact of the
    small LM, behind the router and the ``FleetController``: one is
    SIGKILLed while both hold work; the controller respawns it under its
    name, no request is lost, and every greedy id equals an in-process
    engine's."""
    import time

    from paddle_tpu_torch.io import lm_serving
    from paddle_tpu_torch.runtime.master import ServingFleet
    from paddle_tpu_torch.serving.autoscale import FleetController
    from paddle_tpu_torch.serving.engine import default_chunk_buckets
    cfg, params = _small_lm(cuda)
    model = str(tmp_path / "lm_v4.tar")
    # the in-process engine's chunk buckets: the replicas pad a tail
    # chunk alike, so their GEMMs run at the same shapes
    lm_serving.save_lm_artifact(model, params, cfg, batch=2, prompt_len=64,
                                cache_len=256,
                                engine_buckets=default_chunk_buckets(64),
                                engine_paged=True, engine_block_size=16)
    prompts = _fleet_prompts(27, 4) + [np.random.RandomState(28).randint(
        0, 512, 60 + 9 * i) for i in range(4)]
    want = _single_ids(params, cfg, prompts, 12, cuda)
    fleet = ServingFleet(model, replicas=2, startup_timeout_s=300)
    fleet.start()
    router = None
    try:
        router = fleet.router(max_in_flight=2, health_poll_s=0.05)
        ctrl = FleetController(router, fleet, backoff_base=0.05,
                               backoff_cap=0.1, scale_up_queue=0,
                               scale_down_idle_s=1e9)
        reqs = [router.submit(p, 12) for p in prompts]
        deadline = time.time() + 600
        while not all(st.in_flight for st in router._all):
            router.step()
            assert time.time() < deadline
        old = fleet.procs[1].pid
        fleet.kill(1)
        while not (router.idle
                   and router.replica_states()["replica1"] == "ok"):
            router.step()
            ctrl.step()
            assert time.time() < deadline, router.health()
        assert [r.status for r in reqs] == ["done"] * len(reqs)
        assert [r.tokens for r in reqs] == want
        assert router._m_requeued.value() >= 1
        assert ctrl._m_heals.value(result="healed") == 1
        assert fleet.procs[1].pid != old and fleet.proc_alive("replica1")
    finally:
        if router is not None:
            router.close()
        fleet.close()


# -- the op layer (since slice 13): card against CPU, same inputs --------
# Tolerances: max |card - CPU| over max |CPU|: 1e-4 in fp32 (sums in
# another order, CTC over 40 frames); 2^-5 where the compute dtype is bf16
# (conv_bn: operands rounded to bf16 at each product, so a value near a
# rounding boundary rounds the other way and travels through BN); the
# pools and ROI pooling's gradient 1e-5 (fp32 window and gradient sums in
# another order); NMS indices and ROI pooling's outputs (a max) exactly.

def _flat(out) -> list:
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    return [out]


def _card_and_cpu(fn, arrays, cuda, wrt=()):
    """[(outputs + gradients) on the card, the same on the CPU], CPU
    tensors: the gradients of sum(out_i * cot_i) over the outputs that
    carry one, cotangents from a seed."""
    res = []
    for dev in (cuda, torch.device("cpu")):
        ts = [torch.from_numpy(a).to(dev).requires_grad_(i in wrt)
              for i, a in enumerate(arrays)]
        outs = _flat(fn(*ts))
        grads = []
        if wrt:
            rng = np.random.RandomState(1)
            loss = sum((o.float() * torch.from_numpy(rng.randn(
                *o.shape).astype(np.float32)).to(dev)).sum()
                for o in outs if o.requires_grad)
            grads = list(torch.autograd.grad(loss, [ts[i] for i in wrt]))
        res.append([t.detach().cpu() for t in outs + grads])
    return res


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@pytest.mark.gpu
@pytest.mark.parametrize("save8", [False, True])
@pytest.mark.parametrize("stride", [1, 2])
def test_gpu_conv_bn_train_matches_cpu(cuda, save8, stride):
    from paddle_tpu_torch.ops import conv_bn
    rng = np.random.RandomState(0)
    args = [rng.randn(4, 12, 12, 16).astype(np.float32),
            (rng.randn(3, 3, 16, 32) * 0.1).astype(np.float32),
            (rng.rand(32) + 0.5).astype(np.float32),
            rng.randn(32).astype(np.float32),
            np.zeros(32, np.float32), np.ones(32, np.float32)]

    def fn(x, w, g, b, rm, rv):
        return conv_bn.conv_bn_train(x.to(torch.bfloat16), w, g, b, rm, rv,
                                     stride=stride, padding="SAME",
                                     save8=save8)

    card, cpu = _card_and_cpu(fn, args, cuda, wrt=(0, 1, 2, 3))
    for a, b in zip(card, cpu):
        assert a.dtype == b.dtype
        assert _rel(a, b) <= 2.0 ** -5


@pytest.mark.gpu
@pytest.mark.parametrize("k", [3, 4])
@pytest.mark.parametrize("hw", [7, 8])
def test_gpu_same_pooling_matches_cpu(cuda, k, hw):
    """XLA's SAME at stride 2 (extra pad bottom/right) on the card."""
    from paddle_tpu_torch.ops import pool
    x = np.random.RandomState(1).randn(2, hw, hw + 1, 5).astype(np.float32)
    for fn in (lambda a: pool.max_pool2d(a, k, stride=2, padding="SAME"),
               lambda a: pool.avg_pool2d(a, k, stride=2, padding="SAME")):
        card, cpu = _card_and_cpu(fn, [x], cuda, wrt=(0,))
        for a, b in zip(card, cpu):
            assert _rel(a, b) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("reverse", [False, True])
def test_gpu_lstm_matches_cpu(cuda, reverse):
    from paddle_tpu_torch.ops import rnn
    from paddle_tpu_torch.utils.flags import GLOBAL_FLAGS
    rng = np.random.RandomState(2)
    args = [rng.randn(4, 9, 8).astype(np.float32),
            np.array([9, 4, 1, 7], np.int32),
            (rng.randn(8, 24) * 0.3).astype(np.float32),
            (rng.randn(6, 24) * 0.3).astype(np.float32),
            (rng.randn(24) * 0.1).astype(np.float32)]
    old = GLOBAL_FLAGS.get("compute_dtype")
    GLOBAL_FLAGS.set("compute_dtype", "float32")
    try:
        card, cpu = _card_and_cpu(
            lambda x, l, *w: rnn.lstm(x, l, *w, reverse=reverse), args, cuda,
            wrt=(0, 2, 3, 4))
    finally:
        GLOBAL_FLAGS.set("compute_dtype", old)
    for a, b in zip(card, cpu):
        assert _rel(a, b) <= 1e-4


@pytest.mark.gpu
def test_gpu_ctc_loss_matches_cpu(cuda):
    from paddle_tpu_torch.ops import ctc
    rng = np.random.RandomState(3)
    args = [rng.randn(3, 40, 6).astype(np.float32),
            rng.randint(1, 6, (3, 10)).astype(np.int32),
            np.array([40, 31, 25], np.int32), np.array([10, 6, 0], np.int32)]
    card, cpu = _card_and_cpu(
        lambda lg, lb, il, ll: ctc.ctc_loss(torch.log_softmax(lg, -1), lb, il,
                                            ll), args, cuda, wrt=(0,))
    for a, b in zip(card, cpu):
        assert _rel(a, b) <= 1e-4


@pytest.mark.gpu
def test_gpu_nms_matches_cpu(cuda):
    from paddle_tpu_torch.ops import detection
    rng = np.random.RandomState(4)
    xy = rng.uniform(0, 0.8, (300, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0.02, 0.2, (300, 2))],
                           1).astype(np.float32)
    scores = rng.rand(300).astype(np.float32)
    card, cpu = _card_and_cpu(lambda b, s: detection.nms(b, s, 50),
                              [boxes, scores], cuda)
    assert torch.equal(card[0], cpu[0]) and torch.equal(card[1], cpu[1])


@pytest.mark.gpu
def test_gpu_roi_pool_matches_cpu(cuda):
    from paddle_tpu_torch.ops import detection
    rng = np.random.RandomState(5)
    feat = rng.randn(19, 19, 16).astype(np.float32)
    xy = rng.uniform(0, 15, (24, 2))
    rois = np.concatenate([xy, xy + rng.uniform(0, 12, (24, 2))],
                          1).astype(np.float32)
    card, cpu = _card_and_cpu(lambda f, r: detection.roi_pool(f, r, 7, 7),
                              [feat, rois], cuda, wrt=(0,))
    assert torch.equal(card[0], cpu[0])
    assert _rel(card[1], cpu[1]) <= 1e-5


# ---------------------------------------------------------------------------
# the v2 layer API on the card against the CPU: the same graph, the same
# parameters and rows; TF32 off, so fp32 products are full fp32 on both
# ---------------------------------------------------------------------------

def _layer_run(cuda, build, rows, *, is_training=False, key=None, seed=3):
    """(cpu, card) runs of ``build()``'s graph: outputs, new state and the
    gradients of sum(out * cot) over the floating outputs."""
    import paddle_tpu_torch as T
    from paddle_tpu_torch.ops import prng
    from paddle_tpu_torch.utils.flags import GLOBAL_FLAGS
    from paddle_tpu_torch.utils.rng import KeySource
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # fp32 compute on both sides (the card's machine runs this file
    # without tests/conftest.py, whose environment sets it for the CPU)
    old = GLOBAL_FLAGS.get("compute_dtype")
    GLOBAL_FLAGS.set("compute_dtype", "float32")
    try:
        return _layer_runs(cuda, build, rows, is_training, key, seed, T,
                           prng, KeySource)
    finally:
        GLOBAL_FLAGS.set("compute_dtype", old)


def _layer_runs(cuda, build, rows, is_training, key, seed, T, prng,
                KeySource):
    out = build(T)
    topo = T.topology.Topology(out)
    fwd = topo.compile()
    p0 = T.parameters.create(topo, KeySource(seed), device="cpu")
    types = {l.name: l.data_spec for l in topo.data_layers}
    res = []
    for dev in ("cpu", cuda):
        feeds = T.data_feeder.DataFeeder(types, device=dev).feed(rows)
        leaves = {k: v.to(dev).requires_grad_() for k, v in p0.values.items()}
        state = {k: v.to(dev) for k, v in p0.state.items()}
        outs, new = fwd(leaves, state, feeds, is_training=is_training,
                        dropout_key=None if key is None else
                        prng.prng_key(key))
        rng = np.random.RandomState(0)
        flo = {n: v.array for n, v in outs.items()
               if v.array.is_floating_point()}
        loss = sum((a.float() * torch.from_numpy(rng.randn(*a.shape).astype(
            np.float32)).to(dev)).sum() for a in flo.values())
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()), allow_unused=True))) \
            if leaves else {}
        res.append(({n: v.array.detach().cpu() for n, v in outs.items()},
                    {n: v.cpu() for n, v in new.items()},
                    {n: (g.cpu() if g is not None else None)
                     for n, g in grads.items()}))
    return res


def _layers_close(cpu, card, tol):
    for part_c, part_g in zip(cpu, card):
        assert set(part_c) == set(part_g)
        for n in part_c:
            a, b = part_g[n], part_c[n]
            if b is None:
                continue
            if not b.is_floating_point():
                assert torch.equal(a, b), n
            else:
                err = float((a.double() - b.double()).abs().max()
                            / max(1.0, float(b.abs().max())))
                assert err <= tol, (n, err)


@pytest.mark.gpu
def test_gpu_recurrent_group_matches_cpu(cuda):
    def build(P):
        L = P.layer

        def step(x_t):
            m = L.memory(name="h", size=16)
            return L.fc([x_t, m], size=16, act="tanh", name="h")
        x = L.data("x", P.data_type.dense_vector_sequence(8))
        g = L.recurrent_group(step, input=x, name="grp")
        return L.fc(L.last_seq(g, name="last"), 4, act="softmax", name="out")
    rng = np.random.RandomState(0)
    rows = [(rng.randn(n, 8).astype(np.float32),) for n in (9, 3, 12, 1)]
    cpu, card = _layer_run(cuda, build, rows)
    _layers_close(cpu, card, 1e-4)


@pytest.mark.gpu
def test_gpu_conv_bn_pool_matches_cpu(cuda):
    def build(P):
        L = P.layer
        img = L.data("im", P.data_type.dense_vector(3 * 16 * 16))
        c = L.img_conv(img, 3, num_filters=8, num_channels=3, name="c1")
        c = L.batch_norm(c, act="relu", name="bn1")
        c = L.img_pool(c, 2, name="p1")
        return L.fc(c, 5, act="softmax", name="out")
    rng = np.random.RandomState(1)
    rows = [(rng.randn(768).astype(np.float32),) for _ in range(4)]
    cpu, card = _layer_run(cuda, build, rows, is_training=True)
    _layers_close(cpu, card, 1e-4)


@pytest.mark.gpu
def test_gpu_dropout_masks_match_cpu(cuda):
    def build(P):
        x = P.layer.data("x", P.data_type.dense_vector(300))
        return P.layer.dropout(x, 0.4, name="drop")
    rows = [(np.ones(300, np.float32),)] * 8
    for key in (0, 17):
        cpu, card = _layer_run(cuda, build, rows, is_training=True, key=key)
        assert torch.equal(card[0]["drop"] == 0, cpu[0]["drop"] == 0)


@pytest.mark.gpu
def test_gpu_merged_round_trip(cuda, tmp_path):
    """An artifact saved from the card loads on the card: ``infer`` equals
    the in-process forward, ``call_exported`` (a captured CUDA graph)
    equals ``infer`` bitwise, and a beam-search generator, whose stop test
    reads the device, refuses capture."""
    import paddle_tpu_torch as T
    from paddle_tpu_torch.core.graphs import GraphCaptureError
    from paddle_tpu_torch.io import merged
    from paddle_tpu_torch.utils.rng import KeySource
    L, dt = T.layer, T.data_type
    words = L.data("w", dt.integer_value_sequence(100))
    e = L.embedding(words, 16, name="emb")
    h = T.networks.simple_lstm(e, 16, name="lstm")
    out = L.fc(L.pool(h, pooling_type=T.pooling.Max(), name="pool"), 2,
               act="softmax", name="out")
    params = T.parameters.create(out, KeySource(2), device=cuda)
    path = str(tmp_path / "m.tar")
    merged.save_inference_model(path, out, params, export_batch_sizes=(4,))
    m = merged.load_inference_model(path)
    assert m.device == cuda
    feeds = merged.example_feeds(m.topology, 4)
    rng = np.random.RandomState(0)
    feeds["w"] = rng.randint(0, 100, feeds["w"].shape).astype(np.int32)
    feeds["w.lengths"] = np.array([16, 3, 9, 1], np.int32)
    got = m.infer(feeds)["out"]
    want = T.infer(out, params, [(list(r[:n]),) for r, n in
                                 zip(feeds["w"], feeds["w.lengths"])])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    for _ in range(2):
        np.testing.assert_array_equal(m.call_exported(feeds)["out"], got)

    src = L.data("s", dt.dense_vector(8))

    def step(emb_t):
        mem = L.memory(name="dh", size=8, boot_layer=src)
        hh = L.fc([emb_t, mem], size=8, act="tanh", name="dh")
        return L.fc(hh, size=10, act="softmax", name="dist")
    gen = L.beam_search(step, input=[L.GeneratedInput(
        size=10, embedding_name="gemb", embedding_size=4)], bos_id=1,
        eos_id=0, beam_size=2, max_length=5, name="gen")
    gpath = str(tmp_path / "g.tar")
    merged.save_inference_model(gpath, gen, T.parameters.create(
        gen, KeySource(1), device=cuda))
    g = merged.load_inference_model(gpath)
    with pytest.raises(GraphCaptureError):
        g.aot_compile(2)


# ---------------------------------------------------------------------------
# the single-card trainer (trainer.SGD, cli.measure_time, the CLI's train
# job) on the card
# ---------------------------------------------------------------------------

def _conv_bn_net(T):
    L = T.layer
    img = L.data("im", T.data_type.dense_vector(3 * 16 * 16))
    lbl = L.data("lbl", T.data_type.integer_value(5))
    c = L.img_conv(img, 3, num_filters=8, num_channels=3, name="tc1",
                   bias_attr=False)
    c = L.batch_norm(c, act="relu", name="tbn1")
    c = L.img_pool(c, 2, name="tp1")
    out = L.fc(c, 5, act="softmax", name="tout")
    return L.classification_cost(out, lbl, name="tcost")


def _conv_rows(n, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(768).astype(np.float32), int(rng.randint(5)))
            for _ in range(n)]


def _fp32_flags():
    from paddle_tpu_torch.utils.flags import GLOBAL_FLAGS
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    old = GLOBAL_FLAGS.get("compute_dtype")
    GLOBAL_FLAGS.set("compute_dtype", "float32")
    return lambda: GLOBAL_FLAGS.set("compute_dtype", old)


@pytest.mark.gpu
def test_gpu_trainer_step_matches_hand_composed_step(cuda):
    """The trainer's step on the card against forward + ``autograd.grad``
    + ``optimizer.update`` composed by hand from the same state."""
    import paddle_tpu_torch as T
    from paddle_tpu_torch.ops import prng
    from paddle_tpu_torch.utils.rng import KeySource
    restore = _fp32_flags()
    try:
        cost = _conv_bn_net(T)
        p = T.parameters.create(cost, KeySource(1), device=cuda)
        values = {k: v.clone() for k, v in p.values.items()}
        state = {k: v.clone() for k, v in p.state.items()}
        tr = T.trainer.SGD(cost, p, T.optimizer.Momentum(
            momentum=0.9, learning_rate=0.1))
        assert tr.device == cuda
        feeds = tr._feeder(None).feed(_conv_rows(8))
        assert all(v.array.device == cuda for v in feeds.values())
        leaves = {k: v.clone().requires_grad_() for k, v in values.items()}
        outs, new_state = tr._forward(leaves, state, feeds,
                                      is_training=True,
                                      dropout_key=prng.prng_key(0))
        loss = outs["tcost"].array.float().mean()
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
        loss = loss.detach()
        opt = T.optimizer.Momentum(momentum=0.9, learning_rate=0.1)
        hand = {k: v.clone() for k, v in values.items()}
        opt.update(0, grads, hand, opt.init_state(hand))
        tl, _ = tr._plain_train_step(feeds, 0, prng.prng_key(0))
        assert abs(float(tl) - float(loss)) <= 1e-6 * abs(float(loss))
        for k in hand:
            assert torch.allclose(p.values[k], hand[k], rtol=0, atol=1e-6), k
        for k in new_state:
            assert torch.allclose(p.state[k], new_state[k], rtol=0,
                                  atol=1e-6), k
    finally:
        restore()


@pytest.mark.gpu
def test_gpu_conv_bn_trainer_matches_cpu(cuda):
    """Three ``SGD.train`` steps of a small conv-BN net on the card and on
    the CPU from the same parameters and rows: costs, parameters and the
    batch-norm statistics within 1e-4."""
    import paddle_tpu_torch as T
    from paddle_tpu_torch.utils.rng import KeySource
    restore = _fp32_flags()
    try:
        cost = _conv_bn_net(T)
        p0 = T.parameters.create(cost, KeySource(2), device="cpu")
        runs = []
        for dev in ("cpu", cuda):
            p = T.parameters.create(cost, KeySource(2), device=dev)
            # copies: the trainer writes its updates into the values
            p.values = {k: v.to(dev).clone() for k, v in p0.values.items()}
            p.state = {k: v.to(dev).clone() for k, v in p0.state.items()}
            tr = T.trainer.SGD(cost, p, T.optimizer.Momentum(
                momentum=0.9, learning_rate=0.01))
            costs = []
            tr.train(T.batch(lambda: iter(_conv_rows(24, 1)), 8),
                     event_handler=lambda e: costs.append(e.cost)
                     if isinstance(e, T.event.EndIteration) else None)
            runs.append((costs, p))
        np.testing.assert_allclose(runs[1][0], runs[0][0], rtol=0,
                                   atol=1e-4)
        for part in ("values", "state"):
            for k, v in getattr(runs[0][1], part).items():
                got = getattr(runs[1][1], part)[k].cpu()
                assert got.device.type == "cpu"
                assert float((got - v).abs().max()) <= 1e-4 * max(
                    1.0, float(v.abs().max())), (part, k)
    finally:
        restore()


_CLI_CONFIG = """
import numpy as np
import paddle_tpu_torch as paddle
from paddle_tpu_torch import layer

img = layer.data("image", paddle.data_type.dense_vector(16))
lbl = layer.data("label", paddle.data_type.integer_value(4))
h = layer.fc(img, 8, act=paddle.activation.Relu(), name="cli_h")
out = layer.fc(h, 4, act=paddle.activation.Softmax(), name="cli_out")
cost = layer.classification_cost(out, lbl, name="cost")
outputs = [out]
batch_size = 8
_rng = np.random.RandomState(0)
_data = [(_rng.rand(16).astype("float32"), int(_rng.randint(4)))
         for _ in range(32)]


def reader():
    return iter(_data)
"""


@pytest.mark.gpu
def test_gpu_measure_time(cuda, tmp_path):
    from paddle_tpu_torch import cli
    conf = tmp_path / "conf.py"
    conf.write_text(_CLI_CONFIG)
    r = cli.measure_time(cli._load_config(str(conf)), time_batches=3,
                         warmup_batches=1)
    assert r["ms_per_batch"] > 0 and r["timed_batches"] == 3
    assert r["flops_per_batch"] == 2 * 8 * (16 * 8 + 8 * 4) \
        + 2 * 8 * 8 * 4 * 2 + 2 * 8 * 16 * 8
    assert r["mfu"] is not None and r["peak_memory_bytes"] > 0


@pytest.mark.gpu
def test_gpu_cli_train_job(cuda, tmp_path):
    """``python -m paddle_tpu_torch train`` in process, on the card (no
    --device), saving per-pass parameters that load back."""
    from paddle_tpu_torch import cli
    import paddle_tpu_torch as T
    conf = tmp_path / "conf.py"
    conf.write_text(_CLI_CONFIG)
    out = tmp_path / "out"
    assert cli.main(["train", f"--config={conf}", "--num_passes=2",
                     f"--save_dir={out}"]) == 0
    tar = out / "pass-00001" / "params.tar"
    with open(tar, "rb") as f:
        p = T.parameters.Parameters.from_tar(f)
    assert p.device == cuda and set(p.names()) == {
        "cli_h.w", "cli_h.b", "cli_out.w", "cli_out.b"}


# ---------------------------------------------------------------------------
# the input pipeline's device stage and the checkpoint snapshot
# ---------------------------------------------------------------------------

def _host_batches(n, rows=64, dim=4096):
    """``n`` pre-batched (features, labels) host batches, each its own
    seeded draw."""
    for i in range(n):
        r = np.random.RandomState(i)
        yield (r.randn(rows, dim).astype(np.float32),
               r.randint(0, 10, rows).astype(np.int32))


@pytest.mark.gpu
def test_gpu_pipeline_transfer_matches_sync_copy(cuda):
    """50 batches through ``DeviceTransfer`` at ``prefetch=3`` equal a
    synchronous ``.to(device)`` of the same arrays. The consumer delays
    its stream, then overwrites each batch's inputs in place and drops
    them: memory handed back to the copy stream too early, or a pinned
    buffer refilled before its copy ended, would corrupt a later batch."""
    from paddle_tpu_torch import data_type, pipeline
    from paddle_tpu_torch.data_feeder import DataFeeder
    from paddle_tpu_torch.trainer import DeviceTransfer, adopt
    feeder = DataFeeder({"x": data_type.dense_vector(4096),
                         "y": data_type.integer_value(10)}, device="cpu")
    want = list(_host_batches(50))
    got = []
    with pipeline.Pipeline(lambda: _host_batches(50), prefetch=3,
                           convert=feeder.feed,
                           transfer=DeviceTransfer(cuda)) as pipe:
        for feeds in iter(pipe):
            adopt(feeds)
            x, y = feeds["x"].array, feeds["y"].array
            assert x.device == cuda and y.device == cuda
            got.append((x.clone(), y.clone()))
            torch.cuda._sleep(2_000_000)        # hold the stream a while
            x.fill_(-1.0)                       # the step overwrites
            y.fill_(-1)
            del feeds, x, y
    torch.cuda.synchronize()
    assert len(got) == 50
    for (gx, gy), (wx, wy) in zip(got, want):
        assert torch.equal(gx, torch.from_numpy(wx).to(cuda))
        assert torch.equal(gy, torch.from_numpy(wy).to(cuda))


@pytest.mark.gpu
def test_gpu_async_checkpoint_snapshot_precedes_in_place_update(
        cuda, tmp_path):
    """A save followed at once by an in-place update on the card (as the
    trainer's next step does) writes the values from before it."""
    from paddle_tpu_torch.io import checkpoint as ck
    w = torch.arange(1 << 22, dtype=torch.float32, device=cuda)
    m = (torch.ones(1 << 20, device=cuda, dtype=torch.bfloat16),)
    ac = ck.AsyncCheckpointer(str(tmp_path))
    try:
        for step in range(1, 4):
            want = (w.cpu(), m[0].cpu())
            ac.save(step, {"w": w}, {"m": m})
            w.add_(1.0)
            m[0].mul_(2.0)
            ac.wait()
            _, p, o, _ = ck.load_checkpoint(ck.latest_checkpoint(
                str(tmp_path)), {"w": w}, {"m": m})
            assert torch.equal(p["w"].cpu(), want[0])
            assert torch.equal(o["m"][0].cpu(), want[1])
    finally:
        ac.close()


@pytest.mark.gpu
def test_gpu_load_checkpoint_places_on_the_template_device(cuda, tmp_path):
    from paddle_tpu_torch.io import checkpoint as ck
    path = ck.save_checkpoint(str(tmp_path), 3,
                              {"a": torch.arange(6.0), "b": torch.ones(2)},
                              {"a": (torch.zeros(6),)}, {"s": torch.ones(1)})
    tmpl = {"a": torch.zeros(6, device=cuda),
            "b": torch.zeros(2, device=cuda, dtype=torch.bfloat16)}
    step, p, o, s = ck.load_checkpoint(
        path, tmpl, {"a": (torch.ones(6, device=cuda),)},
        {"s": torch.zeros(1, device=cuda)})
    assert step == 3
    for t in (p["a"], p["b"], o["a"][0], s["s"]):
        assert t.device == cuda
    assert p["b"].dtype == torch.bfloat16 and p["a"].dtype == torch.float32
    assert p["a"].cpu().tolist() == [0.0, 1.0, 2.0, 3.0, 4.0, 5.0]


@pytest.mark.gpu
def test_gpu_trainer_prefetch_matches_sync(cuda):
    """``SGD.train(prefetch=3)`` (host convert, side-stream copies) trains
    bitwise equal to the synchronous feed on the card."""
    import paddle_tpu_torch as T
    from paddle_tpu_torch.utils.rng import KeySource
    L, A = T.layer, T.activation
    x = L.data("gp_x", T.data_type.dense_vector(256))
    y = L.data("gp_y", T.data_type.integer_value(10))
    h = L.fc(x, 128, act=A.Relu(), name="gp_h")
    cost = L.classification_cost(L.fc(h, 10, act=A.Softmax(), name="gp_o"),
                                 y, name="gp_c")
    rng = np.random.RandomState(0)
    rows = [(rng.randn(256).astype(np.float32), int(rng.randint(10)))
            for _ in range(640)]
    runs = []
    for kw in ({}, {"prefetch": 3}):
        params = T.parameters.create(cost, KeySource(4), device=cuda)
        tr = T.trainer.SGD(cost, params, T.optimizer.Momentum(
            momentum=0.9, learning_rate=0.05))
        costs = []
        tr.train(T.batch(lambda: iter(rows), 32), num_passes=2,
                 event_handler=lambda e: costs.append(e.cost)
                 if isinstance(e, T.event.EndIteration) else None, **kw)
        runs.append((costs, {k: v.clone() for k, v in
                             params.values.items()}))
    assert runs[0][0] == runs[1][0] and len(runs[0][0]) == 40
    for k, v in runs[0][1].items():
        assert torch.equal(runs[1][1][k], v), k


def _book_chapters():
    """``tests/torch_book_chapters.py``, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        "torch_book_chapters",
        os.path.join(os.path.dirname(__file__), "torch_book_chapters.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.gpu
def test_gpu_book_chapter_matches_cpu(cuda):
    """Four ``SGD.train`` steps of the semantic-role chapter, read from
    ``dataset.conll05.train()``, on the card and on the CPU from the same
    parameters: per-step costs within 1e-4 relative."""
    import paddle_tpu_torch as T
    from paddle_tpu_torch.utils.rng import KeySource
    restore = _fp32_flags()
    try:
        ch = _book_chapters().chapter("srl", T)
        p0 = T.parameters.create(ch.cost, KeySource(3), device="cpu")
        reader = T.reader.firstn(ch.reader, 4 * ch.batch)
        runs = []
        for dev in ("cpu", cuda):
            p = T.parameters.create(ch.cost, KeySource(3), device=dev)
            p.values = {k: v.to(dev).clone() for k, v in p0.values.items()}
            tr = T.trainer.SGD(ch.cost, p, ch.opt())
            costs = []
            tr.train(T.batch(reader, ch.batch), feeding=ch.feeding,
                     event_handler=lambda e: costs.append(e.cost)
                     if isinstance(e, T.event.EndIteration) else None)
            runs.append(costs)
        assert len(runs[0]) == len(runs[1]) == 4
        for a, b in zip(runs[1], runs[0]):
            assert abs(a - b) <= 1e-4 * abs(b), runs
    finally:
        restore()


@pytest.mark.gpu
def test_gpu_convert_recordio_trains_as_the_reader(cuda, tmp_path):
    """``dataset.uci_housing.convert`` writes recordio; the port's
    ``reader.creator.recordio`` over it yields the in-memory reader's
    samples, and the fit-a-line chapter trains from it on the card
    bitwise as from the in-memory reader."""
    import paddle_tpu_torch as T
    from paddle_tpu_torch.utils.rng import KeySource
    paths = T.dataset.uci_housing.convert(str(tmp_path), line_count=128)
    train = [p for p in paths if "uci_housing_train" in p]
    rio = T.reader.creator.recordio(train)
    mem = T.dataset.uci_housing.train()
    got, want = list(rio()), list(mem())
    assert len(got) == len(want) == 404
    for (gx, gy), (wx, wy) in zip(got, want):
        assert np.array_equal(gx, wx) and np.array_equal(gy, wy)
    L = T.layer
    x = L.data("gf_x", T.data_type.dense_vector(13))
    y = L.data("gf_y", T.data_type.dense_vector(1))
    cost = L.square_error_cost(L.fc(x, 1, act=None, name="gf_fc"), y,
                               name="gf_cost")
    runs = []
    for reader in (rio, mem):
        p = T.parameters.create(cost, KeySource(6), device=cuda)
        tr = T.trainer.SGD(cost, p, T.optimizer.Adam(learning_rate=5e-2))
        costs = []
        tr.train(T.batch(reader, 32), num_passes=2,
                 event_handler=lambda e: costs.append(e.cost)
                 if isinstance(e, T.event.EndIteration) else None)
        assert p.values["gf_fc.w"].device == cuda
        runs.append(costs)
    assert runs[0] == runs[1] and len(runs[0]) == 24
    assert np.mean(runs[0][-3:]) < np.mean(runs[0][:3])


# ---------------------------------------------------------------------------
# the single-card parallel tier: q8 blocks, layer remat, MoE serving


@pytest.mark.gpu
def test_gpu_q8_blocks_match_cpu(cuda):
    """The q8 blocks (entry, a stride-2 conv_q8 with the input ReLU,
    add_q8, the exit) on the card against the same Functions on the CPU
    from the same operands, fp32: codes equal but for counted one-step
    flips after the convolution (at most 0.5 %), the other outputs and
    every gradient within 1e-4 of max|CPU value|."""
    from paddle_tpu_torch.ops import q8
    restore = _fp32_flags()
    try:
        rng = np.random.RandomState(0)
        x = rng.randn(4, 16, 16, 32).astype(np.float32)
        w = (rng.randn(3, 3, 32, 32) * 0.1).astype(np.float32)
        M = rng.uniform(0.8, 1.2, 32).astype(np.float32)
        B = rng.uniform(-0.1, 0.1, 32).astype(np.float32)

        def run(dev):
            t = {k: torch.from_numpy(v).to(dev).requires_grad_()
                 for k, v in (("x", x), ("w", w), ("M", M), ("B", B))}
            z, o = torch.zeros(32, device=dev), torch.ones(32, device=dev)
            yh, q, mu, _ = q8.entry_stash(t["x"], z, o * 0.03)
            yh2, q2, mu2, v2, _ = q8.make_conv_q8(2, 1, True)(
                yh, q, t["w"], t["M"], t["B"], z, o * 0.03, z, o * 0.05)
            yh3, q3, mu3, _ = q8.make_add_q8(True, False)(
                yh2, q2, *q8.fold_bn_affine(mu2, v2, o, z), z, o * 0.05,
                yh2, q2, o, z, z, o * 0.05, z, o * 0.06)
            out = q8.make_exit(True)(yh3, q3, o, z, z, o * 0.06)
            g = torch.autograd.grad((out ** 2).sum(), list(t.values()))
            return [q.cpu(), q2.cpu(), q3.cpu()], [out.detach().cpu()] + [
                a.cpu() for a in g]

        (qc, fc), (qg, fg) = run("cpu"), run(cuda)
        assert torch.equal(qc[0], qg[0])                 # no conv before
        for a, b in zip(qg[1:], qc[1:]):
            d = (a.int() - b.int()).abs()
            assert int(d.max()) <= 1 and int((d > 0).sum()) <= 5e-3 * \
                a.numel()
        if torch.equal(qc[1], qg[1]) and torch.equal(qc[2], qg[2]):
            for a, b in zip(fg, fc):
                assert float((a - b).abs().max()) <= 1e-4 * max(
                    1.0, float(b.abs().max()))
    finally:
        restore()


@pytest.mark.gpu
def test_gpu_remat_forward_exact_and_launches(cuda):
    """Layer remat on the card: the first loss bitwise the plain one;
    kernel 5 launches twice a layer a step (the forward under no_grad and
    the backward's recompute), kernel 6 once."""
    from paddle_tpu_torch.models import transformer
    base = dict(vocab=512, d_model=128, n_heads=2, n_layers=2, d_ff=256,
                max_len=128)
    toks = _gpu(np.random.RandomState(6).randint(0, 512, (2, 100)), cuda)
    losses = {}
    for mode in ("none", "bf16", "q8"):
        cfg = transformer.TransformerConfig(remat=mode, **base)
        params = transformer.init_train_params(
            cfg, torch.Generator().manual_seed(0), cuda)
        before = (kattention.flash_attention_fwd.launches["bf16"],
                  kattention.flash_attention_bwd.launches["bf16"])
        loss = transformer.lm_loss(params, toks, toks.roll(-1, 1), cfg)
        loss.backward()
        torch.cuda.synchronize()
        fwd = kattention.flash_attention_fwd.launches["bf16"] - before[0]
        bwd = kattention.flash_attention_bwd.launches["bf16"] - before[1]
        assert (fwd, bwd) == ((2, 2) if mode == "none" else (4, 2)), mode
        losses[mode] = loss.detach()
    assert torch.equal(losses["bf16"], losses["none"])
    assert torch.equal(losses["q8"], losses["none"])


@pytest.mark.gpu
def test_gpu_moe_engine_matches_cpu_engine(cuda):
    """A small fp32 top-2 MoE model served by the paged engine on the
    card (its steps captured as CUDA graphs: the routing reads nothing
    on the host) and on the CPU: the greedy ids equal, and kernels 1-4
    launched."""
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.serving import PagedDecodeEngine
    cfg = transformer.TransformerConfig(
        vocab=256, d_model=64, n_heads=2, n_layers=2, d_ff=128,
        max_len=256, dtype="float32", moe_experts=4, moe_top_k=2)
    restore = _fp32_flags()
    try:
        ids = {}
        for dev in ("cpu", cuda):
            params = transformer.init_params(
                cfg, torch.Generator().manual_seed(1), dev)
            eng = PagedDecodeEngine.from_params(
                params, cfg, batch=4, cache_len=128, block_size=16,
                chunk_tokens=32, seed=0, device=dev)
            kernels.reset_launches()
            rng = np.random.RandomState(2)
            reqs = [eng.submit(rng.randint(0, 256, n), 12, temperature=0.0)
                    for n in (5, 40, 23)]
            eng.run_until_idle()
            ids[str(dev)] = [list(r.tokens) for r in reqs]
            if dev != "cpu":
                counts = kernels.launch_counts()
                assert all(counts[k] > 0 for k in (
                    "flash_decode_attention", "fused_sample",
                    "flash_chunk_prefill", "paged_span_write"))
                assert sum(eng.compile_counts().values()) > 0
        assert ids["cpu"] == ids[str(cuda)]
    finally:
        restore()


# ---------------------------------------------------------------------------
# the multi-rank tier on one card (ROADMAP A10a)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_ring_schedule_matches_plain_schedule(cuda, dtype):
    """The flash ring's schedule over 4 virtual ranks on kernels 5/6
    against the same schedule on their plain versions and against the
    whole-sequence kernels (GQA, causal, T_local 64): fp32 within 1e-4,
    bf16 within 8e-3 (out) and 1e-2 (gradients) of max, lse 1e-4."""
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.parallel import ring
    g = torch.Generator(device=cuda).manual_seed(3)
    B, T, H, Hkv, D = 2, 256, 4, 2, 64
    q, do = (torch.randn(B, T, H, D, generator=g, device=cuda).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(B, T, Hkv, D, generator=g, device=cuda).to(dtype)
            for _ in range(2))
    kernels.reset_launches()
    got = ring.ring_flash_schedule(q, k, v, 4, causal=True, do=do)
    counts = kernels.launch_counts()
    name = "" if dtype == torch.bfloat16 else ".fp32"
    assert counts[f"flash_attention_fwd{name}"] == 16
    assert counts[f"flash_attention_bwd{name}"] == 16
    plain = ring.ring_flash_schedule(q, k, v, 4, causal=True, do=do,
                                     engine="plain")
    tol = (1e-4, 1e-4) if dtype == torch.float32 else (8e-3, 1e-2)
    for i, (a, b) in enumerate(zip(got, plain)):
        t = tol[0] if i < 2 else tol[1]
        if i == 1:
            assert (a - b).abs().max().item() <= 1e-4
            continue
        err = (a.float() - b.float()).abs().max() / b.float().abs().max()
        assert err.item() <= t, (i, err.item())
    qq, kk, vv = (x.detach().requires_grad_() for x in (q, k, v))
    whole = kattention.flash_attention(qq, kk, vv, causal=True)
    gw = torch.autograd.grad(whole, (qq, kk, vv), do)
    for a, b, t in zip((got[0],) + got[2:], (whole,) + gw,
                       (tol[0],) + (tol[1],) * 3):
        err = (a.float() - b.float()).abs().max() / b.float().abs().max()
        assert err.item() <= t


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_masked_block_lse_is_exactly_zero(cuda, dtype):
    """A block wholly in the future is fed lse = +1e30: kernel 6 gives
    exactly zero dq, dk, dv, never NaN, even where the block's scores
    are far above the true logsumexp (which would overflow exp)."""
    from paddle_tpu_torch.parallel import ring
    g = torch.Generator(device=cuda).manual_seed(4)
    BH, T, D = 4, 128, 64
    q = (torch.ones(BH, T, D, device=cuda) * 3).to(dtype)
    k = (torch.ones(BH, T, D, device=cuda) * 3).to(dtype)
    v, out, do = (torch.randn(BH, T, D, generator=g, device=cuda).to(dtype)
                  for _ in range(3))
    lse = torch.zeros(BH, T, device=cuda)
    dq, dk, dv = kattention.flash_attention_bwd(
        q, k, v, out, ring.masked_lse(lse, 2, 1, True), do, sm_scale=1.0,
        causal=False)
    for x in (dq, dk, dv):
        assert torch.isfinite(x).all()
        assert (x == 0).all()
    # the same block against the lse that excludes it overflows: what
    # zeroing the kernel's output afterwards would have turned into NaN
    dq2, _, _ = kattention.flash_attention_bwd(q, k, v, out, lse, do,
                                              sm_scale=1.0, causal=False)
    assert not torch.isfinite(dq2).all()


@pytest.mark.gpu
def test_gpu_distributed_init_nccl_world_one(cuda):
    """``distributed.init`` from the env contract at world 1: NCCL on
    the card (no PADDLE_PLATFORM), a mesh over the one rank, an NCCL
    all-reduce on cuda:0, the port's collectives over axes of one rank
    skipped (nothing recorded), a data-parallel trainer step equal to
    the unsharded one."""
    import paddle_tpu_torch as T
    from paddle_tpu_torch import distributed
    from paddle_tpu_torch.core import place
    from paddle_tpu_torch.parallel import spmd
    from paddle_tpu_torch.runtime import launch
    env = {"PADDLE_COORDINATOR": f"127.0.0.1:{launch.free_port()}",
           "PADDLE_NUM_PROCESSES": "1", "PADDLE_PROCESS_ID": "0"}
    old = {k: os.environ.get(k) for k in (*env, "PADDLE_PLATFORM")}
    os.environ.update(env)
    os.environ.pop("PADDLE_PLATFORM", None)
    try:
        distributed.init()
        assert distributed.backend() == "nccl"
        mesh = place.make_mesh((1, 1), ("data", "model"))
        import torch.distributed as tdist
        x = torch.full((3,), 2.0, device=cuda)
        tdist.all_reduce(x, group=mesh.get_group("data"))
        assert x.device == cuda and x.tolist() == [2.0, 2.0, 2.0]
        with spmd.record_collectives() as rec:
            assert spmd.all_reduce(x, mesh, ("data", "model")) is x
        assert rec == []
        assert distributed.barrier("gpu") >= 0.0

        def net():
            L, A = T.layer, T.activation
            xi = L.data("x", T.data_type.dense_vector(8))
            lbl = L.data("lbl", T.data_type.integer_value(3))
            h = L.fc(xi, 16, act=A.Relu(), name="h")
            o = L.fc(h, 3, act=A.Softmax(), name="o")
            return L.classification_cost(o, lbl, name="cost")
        rng = np.random.RandomState(0)
        rows = [(rng.randn(8).astype(np.float32), int(rng.randint(3)))
                for _ in range(32)]
        costs = {}
        for label, par in (("none", None),
                           ("zero3", spmd.data_parallel(mesh, zero=3))):
            cost = net()
            p = T.parameters.create(cost, device=cuda)
            torch.manual_seed(0)
            for k2 in sorted(p.values):
                p.values[k2].copy_(torch.randn_like(p.values[k2]) * 0.1)
            tr = T.trainer.SGD(cost, p, T.optimizer.Adam(learning_rate=0.01),
                               parallel=par)
            out = []
            tr.train(T.batch(lambda: iter(rows), 16), num_passes=2,
                     event_handler=lambda e: out.append(e.cost) if
                     isinstance(e, T.event.EndIteration) else None)
            costs[label] = out
        assert costs["none"] == costs["zero3"]
    finally:
        distributed.shutdown()
        for k2, v2 in old.items():
            if v2 is None:
                os.environ.pop(k2, None)
            else:
                os.environ[k2] = v2
