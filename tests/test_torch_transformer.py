"""The port's transformer serving path against ``paddle_tpu``'s.

Small fp32 configs (2 layers, d_model 32, vocab 64): MHA and GQA, rope
and learned positions. The chunk prefill's tests are in
``tests/test_torch_prefill.py`` and share this file's helpers. The JAX
parameters go through ``params_from_numpy``; pools and inputs are made
from a seed with numpy and handed to both packages. The JAX side runs its XLA path
(``pallas="off"``), the port its kernel wrappers' plain versions.

Tolerances: logits and attention-fed pool rows agree to 1e-4 absolute
(fp32 throughout; the two libraries sum matmuls and softmaxes in
different orders, and the differences grow through two layers and the
vocab head — observed about 1e-6); pool rows the step writes straight
from a projection agree to the same bound; untouched rows are equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import transformer as jt
from paddle_tpu.ops import norm as jnorm
from paddle_tpu_torch.core import dtypes
from paddle_tpu_torch.models import transformer as tt
from paddle_tpu_torch.ops import norm as tnorm

# the suite runs several test processes side by side on a few cores:
# one intra-op thread keeps these tiny-shape tests from crowding the
# cores the other processes' JAX tests use
torch.set_num_threads(1)

ATOL = 1e-4
BS = 8


def _cfgs(gqa: bool, rope: bool):
    kw = dict(vocab=64, d_model=32, n_heads=4, n_kv_heads=2 if gqa else 0,
              n_layers=2, d_ff=64, max_len=64, use_rope=rope)
    return (jt.TransformerConfig(dtype=jnp.float32, **kw),
            tt.TransformerConfig(dtype=torch.float32, **kw))


CONFIGS = [(False, False), (True, False), (False, True), (True, True)]
IDS = ["mha-learned", "gqa-learned", "mha-rope", "gqa-rope"]


def _params(jcfg, tcfg, seed=0):
    jp = jt.init_params(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jp, tt.params_from_numpy(tree, tcfg, device="cpu")


def _pool(rng, cfg, nblocks):
    shape = (cfg.n_layers, cfg.kv_heads, nblocks * BS, cfg.head_dim)
    return {n: rng.randn(*shape).astype(np.float32) for n in ("k", "v")}


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=atol)


def test_layer_norm_matches(rng):
    x = rng.randn(5, 32).astype(np.float32) * 3 + 1
    g = rng.randn(32).astype(np.float32)
    b = rng.randn(32).astype(np.float32)
    want = jnorm.layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    got = tnorm.layer_norm(torch.from_numpy(x), torch.from_numpy(g),
                           torch.from_numpy(b))
    _close(got, want, 1e-5)


def test_rope_tables_and_rows_match(rng):
    pos = np.asarray([0, 3, 17, 63], np.int32)
    jc, js = jt._rope_tables(jnp.asarray(pos), 8, 10000.0)
    tc, ts = tt._rope_tables(torch.from_numpy(pos), 8, 10000.0)
    _close(tc, jc, 1e-6)
    _close(ts, js, 1e-6)
    x = rng.randn(4, 2, 8).astype(np.float32)
    want = jt._rope_rows(jnp.asarray(x), (jc, js))
    got = tt._rope_rows(torch.from_numpy(x), (tc, ts))
    _close(got, want, 1e-5)


@pytest.mark.parametrize("gqa,rope", CONFIGS, ids=IDS)
def test_init_params_shapes_and_dtypes(gqa, rope):
    jcfg, tcfg = _cfgs(gqa, rope)
    jp = jt.init_params(jax.random.PRNGKey(0), jcfg)
    tp = tt.init_params(tcfg, torch.Generator().manual_seed(0),
                        device="cpu")
    jshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
    tshapes = {k: ({kk: tuple(vv.shape) for kk, vv in v.items()}
                   if isinstance(v, dict) else tuple(v.shape))
               for k, v in tp.items()}
    assert tshapes == jshapes
    bf = tt.init_params(
        tt.TransformerConfig(vocab=64, d_model=32, n_heads=4, n_layers=2,
                             d_ff=64, max_len=64, dtype="bf16"),
        torch.Generator().manual_seed(0), device="cpu")
    assert bf["blocks"]["qkv"].dtype == torch.bfloat16
    assert bf["embed"].dtype == torch.float32       # fp32 vocab head
    assert bf["blocks"]["ln1"].dtype == torch.float32


def test_dtype_names_round_trip():
    for name in ("float32", "bfloat16", "float16", "int32", "bool"):
        assert dtypes.name(dtypes.resolve(name)) == name
    assert dtypes.resolve("bf16") is torch.bfloat16
    with pytest.raises(ValueError):
        dtypes.resolve("float8")


def test_config_rejects_unported_fields():
    """Ring attention still raises (ROADMAP A10); experts and remat are
    ported: their configs build, and the forward and loss match JAX's
    (the full parity cases are ``tests/test_torch_moe.py`` and
    ``tests/test_torch_remat.py``)."""
    with pytest.raises(NotImplementedError, match="A10"):
        tt.TransformerConfig(vocab=8, use_ring_attention=True)
    with pytest.raises(ValueError, match="remat"):
        tt.TransformerConfig(vocab=8, remat="fp8")
    toks = np.random.RandomState(0).randint(0, 64, (2, 8)).astype(np.int32)
    for kw in ({"moe_experts": 4}, {"remat": "bf16"}, {"remat": "q8"}):
        jcfg, tcfg = (dataclasses.replace(c, **kw)
                      for c in _cfgs(False, False))
        jp, tp = _params(jcfg, tcfg)
        want = jt.lm_loss(jp, jnp.asarray(toks), jnp.asarray(toks), jcfg)
        got = tt.lm_loss(tp, torch.from_numpy(toks), torch.from_numpy(toks),
                         tcfg)
        _close(got, want)
    # quantized pools are ported: int8 codes beside fp32 scale tables
    pool = tt.init_block_pool(_cfgs(False, False)[1], 2, BS, kv_dtype="int8",
                              device="cpu")
    assert pool["k"].dtype == torch.int8 and set(pool) == {
        "k", "v", "k_scale", "v_scale"}
    with pytest.raises(ValueError, match="kv_dtype"):
        tt.init_block_pool(_cfgs(False, False)[1], 2, BS, kv_dtype="fp8",
                           device="cpu")


@pytest.mark.parametrize("scrambled", [False, True],
                         ids=["identity", "scrambled"])
@pytest.mark.parametrize("gqa,rope", CONFIGS, ids=IDS)
def test_decode_step_paged_matches(gqa, rope, scrambled, rng):
    jcfg, tcfg = _cfgs(gqa, rope)
    jp, tp = _params(jcfg, tcfg)
    B, P, nblocks = 3, 4, 14
    pool = _pool(rng, tcfg, nblocks)
    if scrambled:
        pages = np.stack([rng.permutation(nblocks)[:P]
                          for _ in range(B)]).astype(np.int32)
        pages[2] = pages[0]          # inactive row aliases a live row's
    else:                            # pages: it must write nothing
        pages = np.arange(B * P, dtype=np.int32).reshape(B, P) % nblocks
    tokens = rng.randint(0, 64, B).astype(np.int32)
    pos = np.asarray([5, 31, 9], np.int32)
    active = np.asarray([True, True, False])
    jl, jpool = jt.decode_step_paged(
        jp, {n: jnp.asarray(a) for n, a in pool.items()},
        jnp.asarray(tokens), jnp.asarray(pos), jnp.asarray(active),
        jnp.asarray(pages), jcfg, block_size=BS, pallas="off")
    tpool = {n: torch.from_numpy(a.copy()) for n, a in pool.items()}
    tl, out = tt.decode_step_paged(
        tp, tpool, torch.from_numpy(tokens), torch.from_numpy(pos),
        torch.from_numpy(active), torch.from_numpy(pages), tcfg,
        block_size=BS)
    assert out is tpool and tl.shape == (B, 64) and tl.dtype == torch.float32
    _close(tl, jl)
    for n in ("k", "v"):
        _close(tpool[n], jpool[n])
        # only the two active rows' write positions changed
        diff = (tpool[n].numpy() != pool[n]).any(axis=(0, 1, 3))
        changed = np.argwhere(diff)
        want = sorted(int(pages[b, pos[b] // BS]) * BS + int(pos[b]) % BS
                      for b in (0, 1))
        assert changed[:, 0].tolist() == want


def test_pool_from_numpy_and_params_device_roundtrip():
    jcfg, tcfg = _cfgs(True, False)
    jpool = jt.init_block_pool(jcfg, 3, BS)
    tpool = tt.pool_from_numpy(jax.tree_util.tree_map(np.asarray, jpool),
                               tcfg, device="cpu")
    assert tuple(tpool["k"].shape) == tuple(jpool["k"].shape)
    assert tpool["v"].dtype == torch.float32
    fresh = tt.init_block_pool(tcfg, 3, BS, device="cpu")
    assert torch.equal(fresh["k"], tpool["k"])
