"""The port's paged serving engine against ``paddle_tpu``'s.

- ``chain_hash`` / ``prompt_block_hashes`` digests are byte-identical;
- the block pool makes the same allocation, sharing and eviction
  decisions on the same operation sequence;
- on the same params and prompt trace (multi-chunk prompts, a prefix
  hit, requests running side by side) the port's ``PagedDecodeEngine``
  on the CPU emits exactly the greedy token ids of the JAX engine
  (``pallas="off"``);
- the port's own bookkeeping: reservations released, hits counted,
  submissions validated, MFU absent on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core import ragged as jragged
from paddle_tpu.models import transformer as jt
from paddle_tpu.serving import PagedDecodeEngine as JaxEngine
from paddle_tpu.serving import blocks as jblocks
from paddle_tpu.serving import sampling as jsampling
from paddle_tpu_torch.core import ragged as tragged
from paddle_tpu_torch.models import transformer as tt
from paddle_tpu_torch.observe import costs
from paddle_tpu_torch.ops import prng
from paddle_tpu_torch.serving import PagedDecodeEngine
from paddle_tpu_torch.serving import blocks as tblocks
from paddle_tpu_torch.serving import sampling as tsampling

# the suite runs several test processes side by side on a few cores:
# one intra-op thread keeps these tiny-shape tests from crowding the
# cores the other processes' JAX tests use
torch.set_num_threads(1)

KW = dict(vocab=64, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
          d_ff=64, max_len=64, use_rope=True)
JCFG = jt.TransformerConfig(dtype=jnp.float32, **KW)
TCFG = tt.TransformerConfig(dtype=torch.float32, **KW)
ENGINE = dict(batch=2, cache_len=48, block_size=8, chunk_tokens=16, seed=0)


@pytest.fixture(scope="module")
def params():
    jp = jt.init_params(jax.random.PRNGKey(3), JCFG)
    return jp, tt.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                    TCFG, device="cpu")


def test_chain_hashes_byte_identical(rng):
    assert tblocks.ROOT_HASH == jblocks.ROOT_HASH
    for n in (0, 7, 8, 33):
        prompt = rng.randint(0, 50257, n).astype(np.int32)
        assert (tblocks.prompt_block_hashes(prompt, 8)
                == jblocks.prompt_block_hashes(prompt, 8))
    assert (tblocks.chain_hash(b"x", [1, 2, 3])
            == jblocks.chain_hash(b"x", [1, 2, 3]))


def test_bucket_length_matches():
    assert tragged.DEFAULT_BUCKETS == jragged.DEFAULT_BUCKETS
    for n in (1, 16, 17, 500, 1024, 1025, 5000):
        assert (tragged.bucket_length(n)
                == jragged.bucket_length(n))
        assert (tragged.bucket_length(n, (8, 16))
                == jragged.bucket_length(n, (8, 16)))


def test_block_pool_same_decisions():
    """One operation sequence through both pools: every returned block,
    refcount and occupancy figure agrees, eviction included."""
    pools = [tblocks.BlockPool(4, 8), jblocks.BlockPool(4, 8)]
    log = [[], []]
    for pool, out in zip(pools, log):
        pool.reserve(3)
        a, b, c = pool.alloc(), pool.alloc(), pool.alloc()
        pool.publish(b"h1", a)
        pool.publish(b"h2", b)
        pool.publish(b"h1", c)                   # first writer wins
        pool.release(a)
        pool.release(b)                          # a, b park in the LRU
        pool.share(pool.lookup(b"h2"))           # revive b
        pool.reserve(2)
        d, e = pool.alloc(), pool.alloc()        # free one, then evict a
        out += [a, b, c, d, e, pool.lookup(b"h1"), pool.lookup(b"h2"),
                pool.refcount(b), pool.in_use, pool.free_count,
                pool.cached_free_count, pool.cached_count, pool.evictions,
                pool.reserved, pool.idle]
        with pytest.raises(RuntimeError):
            pool.alloc()                         # no reservation left
    assert log[0] == log[1]


def _trace(rng):
    prefix = rng.randint(0, 64, 16).astype(np.int32)
    return [np.concatenate([prefix, rng.randint(0, 64, 5)]),
            np.concatenate([prefix, rng.randint(0, 64, 7)]),   # a hit
            rng.randint(0, 64, 35).astype(np.int32),           # 3 chunks
            rng.randint(0, 64, 3).astype(np.int32)]


def test_engine_greedy_ids_match_jax(params, rng):
    jp, tp = params
    prompts = _trace(rng)
    jeng = JaxEngine.from_params(jp, JCFG, pallas="off", **ENGINE)
    teng = PagedDecodeEngine.from_params(tp, TCFG, device="cpu", **ENGINE)
    outs = []
    for eng in (jeng, teng):
        reqs = []
        for p in prompts[:2]:                # sequential: the second
            reqs.append(eng.submit(p, max_new=6))   # hits the cache
            eng.run_until_idle()
        reqs += [eng.submit(p, max_new=9) for p in prompts[2:]]
        eng.run_until_idle()                 # side by side
        outs.append(([r.output.tolist() for r in reqs],
                     [r.prefix_hit_tokens for r in reqs]))
        assert eng.pool.idle
    assert outs[0] == outs[1]
    assert outs[1][1][1] == 16               # the hit path ran


def test_top_k_one_sampling_is_greedy(params, rng):
    """temperature > 0 with top_k = 1 keeps only the argmax: the fused
    sampler's draw must land on the greedy id."""
    _, tp = params
    prompt = rng.randint(0, 64, 21).astype(np.int32)
    outs = []
    for temp, k in ((0.0, 0), (0.9, 1)):
        eng = PagedDecodeEngine.from_params(tp, TCFG, device="cpu", **ENGINE)
        r = eng.submit(prompt, max_new=8, temperature=temp, top_k=k)
        eng.run_until_idle()
        outs.append(r.tokens)
    assert outs[0] == outs[1]


def test_engine_bookkeeping_and_validation(params, rng):
    _, tp = params
    eng = PagedDecodeEngine.from_params(tp, TCFG, device="cpu", **ENGINE)
    with pytest.raises(ValueError):
        eng.submit([], max_new=1)
    with pytest.raises(ValueError):
        eng.submit([1, 2], max_new=0)
    with pytest.raises(ValueError):
        eng.submit(np.zeros(40, np.int32), max_new=9)   # > cache_len
    r = eng.submit(rng.randint(0, 64, 30), max_new=4, eos_id=None)
    eng.run_until_idle()
    h = eng.health()
    assert h["completed"] == 1 and h["tokens"] == 4 and r.ttft_s > 0
    assert h["decode_steps"] == 3 and "decode_mfu" not in h
    assert eng.decode_mfu() is None          # no declared peak on a CPU
    assert eng.pool.idle and h["prefix_cache_entries"] == 3
    text = eng.metrics_text()
    assert "engine_requests_rejected_total" in text
    assert 'engine_requests_completed_total{reason="max_tokens"} 1' in text
    with pytest.raises(ValueError, match="params live on"):
        PagedDecodeEngine.from_params(tp, TCFG, device="meta", **ENGINE)


def test_decode_flops_from_shapes():
    per_token = 2 * costs.matmul_params(TCFG)
    D, F, kvd = 32, 64, 2 * 8
    assert costs.matmul_params(TCFG) == 2 * (D * (D + 2 * kvd) + D * D
                                             + 2 * D * F) + D * 64
    attn = 4 * 2 * 4 * 8 * (5 + 1)
    assert costs.decode_step_flops(TCFG, [5]) == per_token + attn
    assert costs.mfu(1e12, 1.0, 989e12) == pytest.approx(1 / 989)
    assert costs.mfu(1e12, 1.0, None) is None


def test_sample_tokens_greedy_and_top_k(rng):
    x = rng.randn(4, 50).astype(np.float32)
    temp = np.asarray([0.0, 0.0, 1.0, 0.7], np.float32)
    topk = np.asarray([0, 3, 1, 2], np.int32)
    got = tsampling.sample_tokens(
        torch.from_numpy(x), prng.prng_key(0), torch.from_numpy(temp),
        torch.from_numpy(topk)).numpy()
    want = np.asarray(jsampling.sample_tokens(
        jnp.asarray(x), jax.random.PRNGKey(0), jnp.asarray(temp),
        jnp.asarray(topk)))
    np.testing.assert_array_equal(got, want)   # the same key, the same ids
    assert got[3] in np.argsort(-x[3])[:2]             # inside the top-2
