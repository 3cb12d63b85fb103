"""Each Hopper kernel against its plain PyTorch version, on the card.

Marked ``gpu``; whether a card exists is decided inside the ``cuda``
fixture, so the tests collect the same everywhere and skip without one.
This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch (there: ``python -m pytest --noconftest
-m gpu tests/test_torch_gpu.py``, since ``tests/conftest.py`` sets up
JAX).

Tolerances: attention outputs agree to 1e-4 absolute (fp32 accumulation
in both, summed in another order over up to 640 positions of O(1)
values); the span write and the sampler's ids are exact (no arithmetic
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


@pytest.mark.gpu
def test_gpu_fused_sample_matches_plain(cuda):
    rng = np.random.RandomState(3)
    B, V = 8, 50257
    x = _gpu((3.0 * rng.randn(B, V)).astype(np.float32), cuda)
    temp = _gpu(np.asarray([0, 0.8, 0, 0.8, 0, 1.2, 0, 0.5], np.float32),
                cuda)
    topk = _gpu(np.asarray([0, 50, 0, 0, 3, 1, 50, 50257], np.int32), cuda)
    before = kdecode.fused_sample.launches
    got = kdecode.fused_sample(x, 1234, temp, topk)
    want = kdecode.fused_sample_plain(x, 1234, temp, topk)
    torch.cuda.synchronize()
    assert kdecode.fused_sample.launches == before + 1
    assert torch.equal(got, want)


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
