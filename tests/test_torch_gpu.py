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
same IEEE operations in both).
"""

import numpy as np
import pytest
import torch

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
