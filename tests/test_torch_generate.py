"""The port's lockstep generation against ``paddle_tpu``'s, on the CPU.

- ``ops/prng.split`` is ``jax.random.split`` bitwise, over several keys,
  ``num`` and a chain of splits;
- ``transformer.generate`` gives JAX's ids, greedy and sampled
  (temperature 0.8 under the same key), over fp32 and int8 weights and
  both position schemes;
- ``transformer.beam_search`` gives JAX's tokens, scores within 1e-4,
  for K = 1, 3, 4 and ``max_new`` 1 and 6, and keeps ``lax.top_k``'s
  lower-index order on a constructed tie;
- the JAX functions' argument checks raise the same errors.

Small configs (2 layers, d_model 32, vocab 64; MHA with learned
positions, GQA with RoPE). Tolerances: ids exact, scores 1e-4 absolute
(sums of fp32 log-probabilities; the two libraries' matmuls and
softmaxes differ by ~1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.io import lm_serving as jlm
from paddle_tpu.models import transformer as jt
from paddle_tpu_torch.models import transformer as tt
from paddle_tpu_torch.ops import prng

# the suite runs several test processes side by side on a few cores:
# one intra-op thread keeps these tiny-shape tests from crowding the
# cores the other processes' JAX tests use
torch.set_num_threads(1)

ATOL = 1e-4
CONFIGS = {"mha-learned": dict(n_kv_heads=0, use_rope=False),
           "gqa-rope": dict(n_kv_heads=2, use_rope=True)}


def _cfgs(name):
    kw = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
              max_len=64, **CONFIGS[name])
    return (jt.TransformerConfig(dtype=jnp.float32, **kw),
            tt.TransformerConfig(dtype=torch.float32, **kw))


def _params(name, seed=0, int8=False):
    jcfg, tcfg = _cfgs(name)
    jp = jt.init_params(jax.random.PRNGKey(seed), jcfg)
    if int8:
        jp = jlm.quantize_lm_params(jp)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jcfg, tcfg, jp, tt.params_from_numpy(tree, tcfg, device="cpu")


def _prompt(seed, B, Tp, vocab=64):
    return np.random.RandomState(seed).randint(0, vocab, (B, Tp)).astype(
        np.int32)


@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 31 - 1, -1])
@pytest.mark.parametrize("num", [1, 2, 3, 7])
def test_split_bitwise(seed, num):
    key, jkey = prng.prng_key(seed), jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(
        prng.split(key, num).numpy().astype(np.uint32),
        np.asarray(jax.random.split(jkey, num)))


def test_split_chain_and_draws_bitwise():
    """A chain of splits, as ``generate`` walks it, and the Gumbel noise
    under each key: bitwise JAX's."""
    key, jkey = prng.prng_key(5), jax.random.PRNGKey(5)
    for _ in range(6):
        key, k = prng.split(key)
        jkey, jk = jax.random.split(jkey)
        np.testing.assert_array_equal(k.numpy().astype(np.uint32),
                                      np.asarray(jk))
        np.testing.assert_array_equal(
            prng.gumbel(k, (3, 64)).numpy().view(np.uint32),
            np.asarray(jax.random.gumbel(jk, (3, 64))).view(np.uint32))


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("temperature", [0.0, 0.8], ids=["greedy",
                                                          "sampled"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_generate_ids_equal_jax(name, temperature, int8):
    jcfg, tcfg, jp, tp = _params(name, int8=int8)
    prompt = _prompt(1, 3, 7)
    jkw = dict(max_new=9, temperature=temperature)
    tkw = dict(jkw)
    if temperature:
        jkw["key"], tkw["key"] = jax.random.PRNGKey(11), prng.prng_key(11)
    want = np.asarray(jt.generate(jp, jnp.asarray(prompt), jcfg, **jkw))
    got = tt.generate(tp, torch.from_numpy(prompt), tcfg, **tkw)
    assert got.dtype == torch.int32 and got.shape == (3, 16)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_one_token_and_default_key():
    """``max_new=1`` returns the prefill's own token; greedy needs no
    key."""
    jcfg, tcfg, jp, tp = _params("gqa-rope")
    prompt = _prompt(2, 2, 5)
    want = np.asarray(jt.generate(jp, jnp.asarray(prompt), jcfg, max_new=1))
    got = tt.generate(tp, torch.from_numpy(prompt), tcfg, max_new=1)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("K,max_new", [(1, 6), (3, 6), (4, 6), (1, 1),
                                       (3, 1), (4, 1)])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_beam_search_equals_jax(name, K, max_new):
    jcfg, tcfg, jp, tp = _params(name, seed=3)
    prompt = _prompt(4, 2, 6)
    want_t, want_s = jt.beam_search(jp, jnp.asarray(prompt), jcfg,
                                    max_new=max_new, beam_size=K)
    got_t, got_s = tt.beam_search(tp, torch.from_numpy(prompt), tcfg,
                                  max_new=max_new, beam_size=K)
    assert got_t.shape == (2, K, 6 + max_new)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=0, atol=ATOL)


def test_beam_search_tie_keeps_lower_index():
    """Token j's embedding row made a copy of token i's (i < j, i the
    prefill's top token, j not in the prompt): their vocab logits tie
    exactly, so both hypotheses open with the same score, and the lower
    index ranks first, as ``lax.top_k`` ranks it. The port's tokens and
    scores equal JAX's."""
    jcfg, tcfg, jp, _ = _params("mha-learned", seed=5)
    prompt = _prompt(6, 1, 6)
    lg, _ = jt.prefill(jp, jnp.asarray(prompt), jcfg, 12)
    i = int(np.argmax(np.asarray(lg[0])))
    j = next(t for t in range(i + 1, 64) if t not in prompt[0])
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tree["embed"] = tree["embed"].copy()
    tree["embed"][j] = tree["embed"][i]
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = tt.params_from_numpy(tree, tcfg, device="cpu")
    tl, _ = tt.prefill(tp, torch.from_numpy(prompt), tcfg, 12)
    jl, _ = jt.prefill(jp, jnp.asarray(prompt), jcfg, 12)
    assert tl[0, i] == tl[0, j] and np.asarray(jl)[0, i] == \
        np.asarray(jl)[0, j]
    want_t, want_s = jt.beam_search(jp, jnp.asarray(prompt), jcfg,
                                    max_new=4, beam_size=3)
    got_t, got_s = tt.beam_search(tp, torch.from_numpy(prompt), tcfg,
                                  max_new=4, beam_size=3)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=0, atol=ATOL)
    vals, idx = tt._top_k(torch.log_softmax(tl, -1), 2)
    assert idx[0].tolist() == [i, j] and vals[0, 0] == vals[0, 1]


@pytest.mark.parametrize("call,kw,match", [
    ("generate", dict(max_new=0), "max_new must be >= 1"),
    ("generate", dict(max_new=60), "exceed cfg.max_len"),
    ("generate", dict(max_new=4, temperature=0.5), "needs a key"),
    ("beam_search", dict(max_new=0), "max_new must be >= 1"),
    ("beam_search", dict(max_new=60), "exceed cfg.max_len"),
    ("beam_search", dict(max_new=2, beam_size=0), "beam_size 0"),
    ("beam_search", dict(max_new=2, beam_size=65), "beam_size 65"),
])
def test_argument_checks_raise_as_jax(call, kw, match):
    jcfg, tcfg, jp, tp = _params("mha-learned")
    prompt = _prompt(7, 1, 8)
    with pytest.raises(ValueError, match=match):
        getattr(jt, call)(jp, jnp.asarray(prompt), jcfg, **kw)
    with pytest.raises(ValueError, match=match):
        getattr(tt, call)(tp, torch.from_numpy(prompt), tcfg, **kw)
