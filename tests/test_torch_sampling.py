"""The port's sampling streams against ``jax.random`` and the reference
samplers, on the CPU.

- ``ops/prng.py``: key data, random bits, uniforms and Gumbel noise are
  bitwise JAX's for int32 seeds at both ends of the range, and the Gumbel
  transform is bitwise JAX's on every one of the 2**23 uniforms it can
  see;
- ``serving/sampling.sample_tokens`` and the threefry stream of the
  ``fused_sample`` plain version give ``paddle_tpu``'s
  ``sample_tokens`` ids for the same key: greedy rows, top_k 0 / 1 / 50
  / V, ties at the threshold, one GPT-2-wide row;
- the port's ``PagedDecodeEngine`` on the CPU emits the JAX engine's
  SAMPLED ids (temperature 0.8, top_k 50, the same seed), the JAX engine
  running its Pallas kernels in interpret mode: the prefill tail on
  threefry, the decode tail on the hashed stream, both ids equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import transformer as jt
from paddle_tpu.ops.pallas import decode as jdecode
from paddle_tpu.serving import PagedDecodeEngine as JaxEngine
from paddle_tpu.serving import sampling as jsampling
from paddle_tpu_torch.models import transformer as tt
from paddle_tpu_torch.ops import prng
from paddle_tpu_torch.ops.kernels import decode as kdecode
from paddle_tpu_torch.serving import PagedDecodeEngine
from paddle_tpu_torch.serving import sampling as tsampling

# the suite runs several test processes side by side on a few cores:
# one intra-op thread keeps these small tests from crowding the cores
# the other processes' JAX tests use
torch.set_num_threads(1)

SEEDS = (0, 1, 2 ** 31 - 1, -1, -2 ** 31)
TINY = np.finfo(np.float32).tiny


def _bits(a):
    return np.asarray(a).view(np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_bits_uniform_gumbel_bitwise(seed):
    key = prng.prng_key(seed)
    jkey = jax.random.PRNGKey(seed)
    assert key.tolist() == np.asarray(jax.random.key_data(jkey)).tolist()
    for shape in ((), (7,), (3, 50257), (2, 3, 5)):
        np.testing.assert_array_equal(
            prng.random_bits(key, shape).numpy().astype(np.uint32),
            np.asarray(jax.random.bits(jkey, shape, jnp.uint32)))
        np.testing.assert_array_equal(
            _bits(prng.uniform(key, shape)),
            _bits(jax.random.uniform(jkey, shape, minval=TINY)))
        np.testing.assert_array_equal(
            _bits(prng.gumbel(key, shape)),
            _bits(jax.random.gumbel(jkey, shape)))


def test_seed_outside_int32_raises():
    with pytest.raises(OverflowError):
        prng.prng_key(2 ** 31)


def test_gumbel_transform_bitwise_on_every_uniform():
    """``-log(-log(u))`` for each float32 the uniform draw can give:
    XLA:CPU's log is not correctly rounded (torch.log differs from it on
    a tenth of these inputs or more), and ``prng.xla_log`` must equal it
    on all."""
    mant = np.arange(1 << 23, dtype=np.uint32)
    f = (mant | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    u = np.maximum(np.float32(TINY), f + np.float32(TINY))
    want = jax.jit(lambda u: -jnp.log(-jnp.log(u)))(u)
    got = -prng.xla_log(-prng.xla_log(torch.from_numpy(u)))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    plain = -torch.log(-torch.log(torch.from_numpy(u)))
    assert (_bits(plain) != _bits(want)).mean() > 0.1


def _rows(rng, V):
    """Logits [6, V] and controls: greedy rows, top_k 0, 1, 50 and V,
    ties at the 50th value, and a +0.0 threshold with -0.0 beside it."""
    x = (3.0 * rng.randn(6, V)).astype(np.float32)
    order = np.argsort(-x[3])
    x[3, order[48:53]] = x[3, order[49]]           # ties at the k-th value
    x[4] = np.where(np.arange(V) % 2 == 0, 0.0, -1.0).astype(np.float32)
    x[4, 5:V:4] = -0.0                             # -0.0 ties a +0.0 kth
    x[4, :3] = 2.0
    temp = np.asarray([0.0, 0.8, 1.0, 0.8, 1.3, 0.5], np.float32)
    topk = np.asarray([50, 0, 1, 50, V // 2, V], np.int32)
    return x, temp, topk


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("V", [64, 1000])
def test_sample_tokens_ids_match_jax(seed, V):
    x, temp, topk = _rows(np.random.RandomState(V + seed % 97), V)
    want = np.asarray(jsampling.sample_tokens(
        jnp.asarray(x), jax.random.PRNGKey(seed), jnp.asarray(temp),
        jnp.asarray(topk)))
    args = (torch.from_numpy(x), seed, torch.from_numpy(temp),
            torch.from_numpy(topk))
    got = tsampling.sample_tokens(args[0], prng.prng_key(seed), *args[2:])
    np.testing.assert_array_equal(got.numpy(), want)
    # the kernel's plain version on the threefry stream: radix-select
    # threshold, float compare, the same draw
    plain = kdecode.fused_sample_plain(*args, stream="threefry")
    np.testing.assert_array_equal(plain.numpy(), want)
    # the float compare keeps the -0.0 lanes that tie a +0.0 threshold
    keep = kdecode.top_k_keep(args[0], args[3], compare_floats=True)
    assert bool(keep[4, 5]) and not kdecode.top_k_keep(args[0],
                                                       args[3])[4, 5]


def test_gpt2_wide_row_matches_jax():
    rng = np.random.RandomState(5)
    V = 50257
    x = (3.0 * rng.randn(1, V)).astype(np.float32)
    for seed, temp, k in ((17, 0.8, 50), (99, 1.0, 0), (3, 0.7, V - 1)):
        t = np.asarray([temp], np.float32)
        kk = np.asarray([k], np.int32)
        want = np.asarray(jsampling.sample_tokens(
            jnp.asarray(x), jax.random.PRNGKey(seed), jnp.asarray(t),
            jnp.asarray(kk)))
        got = kdecode.fused_sample(torch.from_numpy(x), seed,
                                   torch.from_numpy(t), torch.from_numpy(kk),
                                   stream="threefry")
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("V", [7, 64, 1000])
def test_radix_kth_key_matches_binary_search(V):
    """The plain radix select against the JAX kernel's ``_kth_key`` (a
    32-step binary search), with ties, signed zeros and infinities."""
    rng = np.random.RandomState(V)
    x = rng.randn(3, V).astype(np.float32)
    x[1] = np.round(x[1])                          # many ties
    x[2, :4] = [0.0, -0.0, np.inf, -np.inf][:min(4, V)]
    keys = kdecode.sortable_key(torch.from_numpy(x))
    jkeys = jdecode._sortable_key(jnp.asarray(x))
    for k in sorted({1, 2, V // 2, V - 1, V} - {0}):
        got = kdecode.kth_key(keys, torch.full((3,), k)).tolist()
        want = [int(jdecode._kth_key(jkeys[r:r + 1], jnp.int32(k)))
                for r in range(3)]
        assert got == want, k
    back = kdecode.key_float(keys).numpy()
    np.testing.assert_array_equal(back.view(np.uint32), x.view(np.uint32))


KW = dict(vocab=64, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
          d_ff=64, max_len=64, use_rope=True)
ENGINE = dict(batch=2, cache_len=48, block_size=8, chunk_tokens=16, seed=7)


def test_engine_sampled_ids_match_jax_interpret():
    """temperature 0.8, top_k 50, the same weights and engine seed:
    every sampled id of the port's engine (the prefill tail's first
    token on threefry, the decode tail on the hashed stream) equals the
    JAX engine's under ``pallas="interpret"``."""
    jcfg = jt.TransformerConfig(dtype=jnp.float32, **KW)
    tcfg = tt.TransformerConfig(dtype=torch.float32, **KW)
    jp = jt.init_params(jax.random.PRNGKey(3), jcfg)
    tp = tt.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                              device="cpu")
    rng = np.random.RandomState(12)
    prompts = [rng.randint(0, 64, n).astype(np.int32) for n in (21, 35, 3)]
    outs = []
    for eng in (JaxEngine.from_params(jp, jcfg, pallas="interpret",
                                      **ENGINE),
                PagedDecodeEngine.from_params(tp, tcfg, device="cpu",
                                              **ENGINE)):
        reqs = [eng.submit(p, max_new=8, temperature=0.8, top_k=50)
                for p in prompts]
        eng.run_until_idle()
        outs.append([list(map(int, r.tokens)) for r in reqs])
    assert outs[0] == outs[1]
