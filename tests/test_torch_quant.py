"""The port's quantized serving against ``paddle_tpu``'s: int8/int4 KV
pools and int8 weights.

- Exact, on the same fp32 inputs: ``quantize_kv`` codes and scales,
  ``pack_int4``/``unpack_int4`` (every byte value), ``dequantize_kv``,
  ``quantize_weight`` and ``quantize_lm_params`` (integers and IEEE
  divisions, the same op chain).
- The quantized kernels' plain versions against the Pallas kernels in
  interpret mode, MHA and GQA, fp32 queries: attention within 1e-5
  absolute (the same function, sums in another order), the span write
  byte for byte with padded rows untouched.
- The step functions (fp32 models of ``test_torch_engine.py``'s size)
  against the JAX XLA path (``pallas="off"``): logits within 1e-4 (fp32
  sums in another order through two layers and the vocab head); pool
  codes within 1 of JAX's and equal on at least 99.9 % of elements,
  scales within 1e-6 relative. Pools cannot be bitwise: the fp32
  projections differ by an ulp between the libraries, which can move a
  value across a rounding boundary, and XLA folds the ``/ qmax`` of the
  jitted step into a multiply by the reciprocal, which can move a
  scale by an ulp.
- Inactive rows write neither codes nor scales; pages scrambled with
  their codes and scales leave the logits bitwise unchanged; decode
  logits off a quantized pool stay within ``kv_rel_l2_budget`` of the
  unquantized pool.
- The engine emits the JAX engine's greedy ids for int8 and int4 pools
  and for int8 weights over an int8 pool, and a prefix hit equals the
  cold run.
- A JAX quantized pool and a JAX ``quantize_lm_params`` tree carried
  across through numpy continue the decode as JAX does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.io import lm_serving as jlm
from paddle_tpu.models import transformer as jt
from paddle_tpu.ops import q8 as jq8
from paddle_tpu.ops.pallas import decode as jdecode
from paddle_tpu.ops.pallas import prefill as jprefill
from paddle_tpu.serving import PagedDecodeEngine as JaxEngine
from paddle_tpu_torch.io import lm_serving as tlm
from paddle_tpu_torch.models import transformer as tt
from paddle_tpu_torch.ops import q8 as tq8
from paddle_tpu_torch.ops.kernels import decode as kdecode
from paddle_tpu_torch.ops.kernels import prefill as kprefill
from paddle_tpu_torch.serving import PagedDecodeEngine

# the suite runs several test processes side by side on a few cores:
# one intra-op thread keeps these tiny-shape tests from crowding the
# cores the other processes' JAX tests use
torch.set_num_threads(1)

KV = ("int8", "int4")
ATOL_KERNEL = 1e-5
ATOL_STEP = 1e-4
KW = dict(vocab=64, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
          d_ff=64, max_len=64, use_rope=True)
JCFG = jt.TransformerConfig(dtype=jnp.float32, **KW)
TCFG = tt.TransformerConfig(dtype=torch.float32, **KW)
ENGINE = dict(batch=2, cache_len=48, block_size=8, chunk_tokens=16, seed=0)
BS = 8


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def params():
    """(JAX fp32 params, port serving params, JAX int8 tree, port int8
    tree made by the port from the same fp32 draws)."""
    jp = jt.init_params(jax.random.PRNGKey(3), JCFG)
    fp32 = _np_tree(jp)
    return (jp, tt.params_from_numpy(fp32, TCFG, device="cpu"),
            jlm.quantize_lm_params(jp),
            tlm.quantize_lm_params(fp32, device="cpu"))


# ---------------------------------------------------------------------------
# exact equality
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kvd", KV)
def test_quantize_kv_bitwise(kvd, rng):
    for spread in (1e-3, 1.0, 40.0):
        x = (rng.randn(9, 3, 16) * spread).astype(np.float32)
        x[0, 0] = 0.0                                   # amax 0: the 1e-8 floor
        jq, js = jq8.quantize_kv(jnp.asarray(x), kvd)
        tq, ts = tq8.quantize_kv(_t(x), kvd)
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(
            tq8.dequantize_kv(tq, ts, kvd).numpy(),
            np.asarray(jq8.dequantize_kv(jq, js, kvd)))
    with pytest.raises(ValueError, match="kv_dtype"):
        tq8.quantize_kv(torch.zeros(2, 4), "int2")


def test_int4_pack_unpack_every_byte():
    every = np.arange(-128, 128, dtype=np.int8).reshape(4, 64)
    got = tq8.unpack_int4(_t(every))
    assert got.dtype == torch.int32 and got.shape == (4, 128)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jq8.unpack_int4(every)))
    # the nibble grid [-7, 7] packs back to the same bytes
    codes = np.random.RandomState(0).randint(-7, 8, (5, 16)).astype(np.int8)
    packed = tq8.pack_int4(_t(codes))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jq8.pack_int4(codes)))
    np.testing.assert_array_equal(tq8.unpack_int4(packed).numpy(), codes)
    with pytest.raises(ValueError, match="even"):
        tq8.pack_int4(torch.zeros(2, 3, dtype=torch.int8))


def test_quantize_weight_bitwise(rng):
    w = (rng.randn(3, 24, 40) * 0.05).astype(np.float32)
    w[1, :, 7] = 0.0                                    # a dead channel
    for axis in (-2, -1):
        jw = jq8.quantize_weight(jnp.asarray(w), axis)
        tw = tq8.quantize_weight(_t(w), axis)
        assert tw["scale"].shape == tuple(jw["scale"].shape)
        np.testing.assert_array_equal(tw["q8"].numpy(), np.asarray(jw["q8"]))
        np.testing.assert_array_equal(tw["scale"].numpy(),
                                      np.asarray(jw["scale"]))
        np.testing.assert_array_equal(
            tq8.dequantize_weight(tw).numpy(),
            np.asarray(jq8.dequantize_weight(jw)))


def test_quantize_lm_params_bitwise(params):
    _, _, jq, tq = params
    flat_j = jax.tree_util.tree_leaves_with_path(_np_tree(jq))
    assert len(flat_j) == 12 + 5                # 5 {"q8", "scale"} nodes
    for path, want in flat_j:
        node = tq
        for key in path:
            node = node[key.key]
        assert node.device == torch.device("cpu")
        np.testing.assert_array_equal(node.numpy(), want)
        assert node.numpy().dtype == want.dtype
    assert tt._blocks_quantized(tq)
    # the same tree carried across from JAX through numpy
    carried = tt.params_from_numpy(_np_tree(jq), TCFG, device="cpu")
    for name in tt.MATMUL_WEIGHTS:
        for part in ("q8", "scale"):
            assert torch.equal(carried["blocks"][name][part],
                               tq["blocks"][name][part])
    assert torch.equal(carried["embed"]["q8"], tq["embed"]["q8"])


def test_quantize_lm_params_takes_the_fp32_tree_only():
    bf = tt.init_params(tt.TransformerConfig(dtype="bf16", **KW),
                        torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="fp32"):
        tlm.quantize_lm_params(bf, device="cpu")
    with pytest.raises(ValueError, match="fp32"):
        tlm.quantize_lm_params({"embed": np.zeros((4, 4), np.float16),
                                "blocks": {}}, device="cpu")
    tree = tt.init_train_params(TCFG, torch.Generator().manual_seed(0),
                                device="cpu")
    q = tlm.quantize_lm_params(tree, device="cpu")
    assert q["blocks"]["qkv"]["q8"].dtype == torch.int8
    assert q["blocks"]["qkv"]["scale"].shape == (2, 1, 32 + 2 * 16)
    assert q["embed"]["scale"].shape == (64, 1)
    assert not q["blocks"]["ln1"].requires_grad


# ---------------------------------------------------------------------------
# the quantized kernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------


def _quant_pool(rng, Hkv, M, Dh, kvd):
    """A quantized per-layer pool view made from random rows: codes
    [Hkv, M, Dh-stored] and scales [Hkv, M] for k and v."""
    out = {}
    for n in ("k", "v"):
        x = (rng.randn(Hkv, M, Dh) * rng.uniform(0.2, 3.0, (Hkv, M, 1))
             ).astype(np.float32)
        q, s = tq8.quantize_kv(_t(x), kvd)
        out[n], out[n + "_scale"] = q.numpy(), s.numpy()
    return out


@pytest.mark.parametrize("kvd", KV)
@pytest.mark.parametrize("G,Dh", [(1, 16), (4, 8)], ids=["mha", "gqa4"])
def test_decode_attention_plain_matches_pallas(kvd, G, Dh, rng):
    B, Hkv, P, bs, nblocks = 3, 2, 4, 8, 10
    q = rng.randn(B, Hkv, G, Dh).astype(np.float32)
    pool = _quant_pool(rng, Hkv, nblocks * bs, Dh, kvd)
    pages = np.stack([rng.permutation(nblocks)[:P]
                      for _ in range(B)]).astype(np.int32)
    pos = np.asarray([0, P * bs - 1, 13], np.int32)
    want = np.asarray(jdecode.flash_decode_attention(
        jnp.asarray(q), jnp.asarray(pool["k"]), jnp.asarray(pool["v"]),
        jnp.asarray(pages), jnp.asarray(pos), block_size=bs,
        k_scale=jnp.asarray(pool["k_scale"]),
        v_scale=jnp.asarray(pool["v_scale"]), kv_dtype=kvd,
        interpret=True))
    got = kdecode.flash_decode_attention(
        _t(q), _t(pool["k"]), _t(pool["v"]), _t(pages), _t(pos),
        block_size=bs, k_scale=_t(pool["k_scale"]),
        v_scale=_t(pool["v_scale"]), kv_dtype=kvd)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL_KERNEL)


@pytest.mark.parametrize("kvd", KV)
@pytest.mark.parametrize("G", [1, 2], ids=["mha", "gqa"])
def test_chunk_prefill_plain_matches_pallas(kvd, G, rng):
    C, Hkv, Dh, bs, nblocks, P_ctx = 8, 2, 16, 8, 8, 3
    q = rng.randn(C, Hkv, G, Dh).astype(np.float32)
    kck = rng.randn(C, Hkv, Dh).astype(np.float32)
    vck = rng.randn(C, Hkv, Dh).astype(np.float32)
    pool = _quant_pool(rng, Hkv, nblocks * bs, Dh, kvd)
    pages = rng.permutation(nblocks)[:P_ctx].astype(np.int32)
    want = np.asarray(jprefill.flash_chunk_prefill(
        jnp.asarray(q), jnp.asarray(kck), jnp.asarray(vck),
        jnp.asarray(pool["k"]), jnp.asarray(pool["v"]), jnp.asarray(pages),
        block_size=bs, k_scale=jnp.asarray(pool["k_scale"]),
        v_scale=jnp.asarray(pool["v_scale"]), kv_dtype=kvd,
        interpret=True))
    got = kprefill.flash_chunk_prefill(
        _t(q), _t(kck), _t(vck), _t(pool["k"]), _t(pool["v"]), _t(pages),
        block_size=bs, k_scale=_t(pool["k_scale"]),
        v_scale=_t(pool["v_scale"]), kv_dtype=kvd)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL_KERNEL)


@pytest.mark.parametrize("kvd", KV)
def test_span_write_four_arrays_bitwise(kvd, rng):
    L, Hkv, Dh, bs, nblocks, pc = 2, 2, 8, 4, 6, 3
    Dst = Dh // 2 if kvd == "int4" else Dh
    pool = {n: rng.randint(-128, 128, (L, Hkv, nblocks * bs, Dst)
                           ).astype(np.int8) for n in ("k", "v")}
    spans = {n: rng.randint(-128, 128, (L, Hkv, pc * bs, Dst)
                            ).astype(np.int8) for n in ("k", "v")}
    for n in ("k_scale", "v_scale"):
        pool[n] = rng.rand(L, Hkv, nblocks * bs).astype(np.float32)
        spans[n] = rng.rand(L, Hkv, pc * bs).astype(np.float32)
    pages = np.asarray([4, 1, 0], np.int32)
    valid = np.arange(pc * bs) < 2 * bs + 1         # last page mostly pad
    want = jprefill.paged_span_write(
        {n: jnp.asarray(a) for n, a in pool.items()},
        {n: jnp.asarray(a) for n, a in spans.items()},
        jnp.asarray(pages), jnp.asarray(valid), block_size=bs,
        interpret=True)
    tpool = {n: _t(a.copy()) for n, a in pool.items()}
    out = kprefill.paged_span_write(
        tpool, {n: _t(a) for n, a in spans.items()}, _t(pages), _t(valid),
        block_size=bs, kv_dtype=kvd)
    assert out is tpool
    for n in pool:
        np.testing.assert_array_equal(tpool[n].numpy(), np.asarray(want[n]))
        # page 0 backs only padded rows past its first: old bytes survive
        np.testing.assert_array_equal(tpool[n][:, :, 1:bs].numpy(),
                                      pool[n][:, :, 1:bs])
        for b in (2, 3, 5):                          # pages not written
            np.testing.assert_array_equal(
                tpool[n][:, :, b * bs:(b + 1) * bs].numpy(),
                pool[n][:, :, b * bs:(b + 1) * bs])
    with pytest.raises(ValueError, match="expected"):
        kprefill.paged_span_write(tpool, {"k": _t(spans["k"]),
                                          "v": _t(spans["v"])}, _t(pages),
                                  _t(valid), block_size=bs, kv_dtype=kvd)


# ---------------------------------------------------------------------------
# the step functions against the JAX XLA path
# ---------------------------------------------------------------------------


def _walk(step, pool, prompt, pages, chunks):
    """Chunk-walk ``prompt`` through ``step(pool, padded, c, pv)``."""
    off, lg = 0, None
    for c in chunks:
        bucket = 8 if c <= 8 else 16
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :c] = prompt[off:off + c]
        pv = pages[:off // BS + -(-bucket // BS)]
        lg, pool = step(pool, padded, c, pv)
        off += c
    return lg, pool


def _jax_prefill(jp):
    # paddle_tpu's prefill takes the int8 tree dequantized to fp32, as its
    # engine hands it over (serving/sampling.py::_prefill_live)
    if jt._blocks_quantized(jp):
        jp = jq8.dequantize_tree(jp)

    def step(pool, padded, c, pv):
        return jt.prefill_into_blocks(
            jp, pool, jnp.asarray(padded), jnp.asarray(c, jnp.int32),
            jnp.asarray(pv, jnp.int32), JCFG, block_size=BS, pallas="off")
    return step


def _port_prefill(tp):
    def step(pool, padded, c, pv):
        return tt.prefill_into_blocks(tp, pool, _t(padded), c, _t(pv),
                                      TCFG, block_size=BS)
    return step


def _jax_decode(jp, pool, tok, pos, active, pages):
    return jt.decode_step_paged(
        jp, pool, jnp.asarray(tok), jnp.asarray(pos), jnp.asarray(active),
        jnp.asarray(pages), JCFG, block_size=BS, pallas="off")


def _port_decode(tp, pool, tok, pos, active, pages):
    return tt.decode_step_paged(tp, pool, _t(tok), _t(pos), _t(active),
                                _t(pages), TCFG, block_size=BS)


def _pools_close(tpool, jpool):
    """Codes within 1 of JAX's and equal on >= 99.9 % of elements (int4
    compared nibble by nibble); scales within 1e-6 relative."""
    kvd = tt.pool_kv_dtype(tpool, TCFG)
    for n in ("k", "v"):
        a, b = tpool[n], torch.from_numpy(np.array(jpool[n]))
        if kvd == "int4":
            a, b = tq8.unpack_int4(a), tq8.unpack_int4(b)
        d = (a.int() - b.int()).abs()
        assert d.max() <= 1
        assert (d == 0).float().mean() >= 0.999
        np.testing.assert_allclose(tpool[n + "_scale"].numpy(),
                                   np.asarray(jpool[n + "_scale"]),
                                   rtol=1e-6, atol=0)


def _prompt_and_pages(rng):
    prompt = rng.randint(0, 64, 22).astype(np.int32)
    pages = np.zeros(5, np.int32)                  # unallocated tail = 0
    pages[:3] = [5, 2, 7]
    return prompt, pages


@pytest.mark.parametrize("weights", ["fp32", "int8"])
@pytest.mark.parametrize("kvd", KV)
def test_steps_match_jax(kvd, weights, params, rng):
    """Two prefill chunks (16 + 6 tokens, the second with context), then
    a decode step with one inactive row, on an int8/int4 pool."""
    jp, tp, jq, tq = params
    if weights == "int8":
        jp, tp = jq, tq
    prompt, pages = _prompt_and_pages(rng)
    jpool = jt.init_block_pool(JCFG, 9, BS, kv_dtype=kvd)
    tpool = tt.init_block_pool(TCFG, 9, BS, kv_dtype=kvd, device="cpu")
    jl, jpool = _walk(_jax_prefill(jp), jpool, prompt, pages, (16, 6))
    tl, tpool = _walk(_port_prefill(tp), tpool, prompt, pages, (16, 6))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=ATOL_STEP)
    _pools_close(tpool, jpool)
    # block 0 backs only padded rows: its codes and scales stay zero
    for n in tpool:
        assert not tpool[n][:, :, :BS].any()
    tok = np.asarray([int(np.argmax(np.asarray(jl))), 9], np.int32)
    pos = np.asarray([22, 3], np.int32)
    active = np.asarray([True, False])
    # row 0 writes pos 22 on its third page (7); row 1 is inactive
    dpages = np.stack([pages[:4], [8, 0, 0, 0]]).astype(np.int32)
    jl2, jpool = _jax_decode(jp, jpool, tok, pos, active, dpages)
    tl2, tpool = _port_decode(tp, tpool, tok, pos, active, dpages)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), rtol=0,
                               atol=ATOL_STEP)
    _pools_close(tpool, jpool)
    assert (tpool["k_scale"][:, :, 7 * BS + 22 % BS] > 0).all()


@pytest.mark.parametrize("kvd", KV)
def test_inactive_rows_write_neither_codes_nor_scales(kvd, params, rng):
    _, tp, _, _ = params
    prompt, pages = _prompt_and_pages(rng)
    tpool = tt.init_block_pool(TCFG, 9, BS, kv_dtype=kvd, device="cpu")
    _, tpool = _walk(_port_prefill(tp), tpool, prompt, pages, (16, 6))
    before = {n: t.clone() for n, t in tpool.items()}
    tok = np.asarray([3, 5], np.int32)
    pos = np.asarray([22, 9], np.int32)
    active = np.asarray([True, False])
    # the inactive row's pages alias the live row's: it must write nothing
    dpages = np.stack([pages[:4], pages[:4]]).astype(np.int32)
    _port_decode(tp, tpool, tok, pos, active, dpages)
    w = 7 * BS + 22 % BS                           # row 0's write position
    for n, t in tpool.items():
        changed = (t != before[n])
        changed = changed.reshape(changed.shape[0], changed.shape[1],
                                  changed.shape[2], -1).any(-1)
        cols = changed.any(0).any(0).nonzero()[:, 0].tolist()
        assert cols == [w], (n, cols)


@pytest.mark.parametrize("kvd", KV)
def test_page_scramble_leaves_logits_bitwise(kvd, params, rng):
    """Physical placement is invisible: blocks move with their codes
    and scales, the page table follows, logits are bitwise the same."""
    _, tp, _, _ = params
    prompt, pages = _prompt_and_pages(rng)
    tpool = tt.init_block_pool(TCFG, 9, BS, kv_dtype=kvd, device="cpu")
    lg, tpool = _walk(_port_prefill(tp), tpool, prompt, pages, (16, 6))
    tok = np.asarray([int(lg.argmax())], np.int32)
    pos, active = np.asarray([22], np.int32), np.asarray([True])
    dpages = np.asarray([[5, 2, 7, 1]], np.int32)
    ref = {n: t.clone() for n, t in tpool.items()}
    l_id, _ = _port_decode(tp, ref, tok, pos, active, dpages)
    perm = rng.permutation(9)                       # block i -> perm[i]
    gidx = np.empty(9 * BS, np.int64)
    for i in range(9):
        gidx[perm[i] * BS:(perm[i] + 1) * BS] = np.arange(i * BS,
                                                          (i + 1) * BS)
    moved = {n: t[:, :, torch.from_numpy(gidx)].contiguous()
             for n, t in tpool.items()}
    l_sc, _ = _port_decode(tp, moved, tok, pos, active,
                           perm[dpages].astype(np.int32))
    assert torch.equal(l_id, l_sc)


@pytest.mark.parametrize("kvd", KV)
def test_decode_logits_within_rel_l2_budget(kvd, params, rng):
    _, tp, _, _ = params
    prompt, pages = _prompt_and_pages(rng)
    logits = {}
    for pool_kvd in (None, kvd):
        pool = tt.init_block_pool(TCFG, 9, BS, kv_dtype=pool_kvd,
                                  device="cpu")
        lg, pool = _walk(_port_prefill(tp), pool, prompt, pages, (16, 6))
        tok = np.asarray([int(lg.argmax())], np.int32)
        logits[pool_kvd], _ = _port_decode(
            tp, pool, tok, np.asarray([22], np.int32), np.asarray([True]),
            np.asarray([[5, 2, 7, 1]], np.int32))
    rel = float((logits[kvd] - logits[None]).norm() / logits[None].norm())
    budget = tt.kv_rel_l2_budget(TCFG, kvd)
    assert budget == jt.kv_rel_l2_budget(JCFG, kvd)
    assert 0 < rel < budget, (rel, budget)


def test_pool_layouts_bytes_and_budgets():
    for kvd in (None, "int8", "int4"):
        jpool = jt.init_block_pool(JCFG, 3, BS, kv_dtype=kvd)
        tpool = tt.init_block_pool(TCFG, 3, BS, kv_dtype=kvd, device="cpu")
        assert {n: tuple(t.shape) for n, t in tpool.items()} == {
            n: tuple(a.shape) for n, a in jpool.items()}
        assert {n: str(t.dtype).split(".")[1] for n, t in tpool.items()} == {
            n: str(a.dtype) for n, a in jpool.items()}
        assert tt.pool_kv_dtype(tpool, TCFG) == jt.pool_kv_dtype(jpool, JCFG)
        assert (tt.kv_pool_bytes_per_token(TCFG, kvd)
                == jt.kv_pool_bytes_per_token(JCFG, kvd))
    bf = tt.TransformerConfig(dtype="bf16", **KW)
    assert tt.kv_pool_bytes_per_token(bf) == 2 * 2 * 2 * 8 * 2
    with pytest.raises(ValueError, match="kv_dtype"):
        tt.init_block_pool(TCFG, 2, BS, kv_dtype="fp8", device="cpu")
    odd = tt.TransformerConfig(vocab=8, d_model=6, n_heads=2, n_layers=1,
                               d_ff=8, max_len=16, dtype="float32")
    with pytest.raises(ValueError, match="even"):
        tt.init_block_pool(odd, 2, 4, kv_dtype="int4", device="cpu")


# ---------------------------------------------------------------------------
# carrying a JAX quantized pool and int8 weights across
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kvd", KV)
def test_jax_pool_and_int8_tree_carried_across(kvd, params, rng):
    """JAX prefills into an int8/int4 pool with int8 weights; pool and
    weights go through numpy into the port, which continues the decode
    for three steps as JAX does."""
    _, _, jq, _ = params
    prompt, pages = _prompt_and_pages(rng)
    jpool = jt.init_block_pool(JCFG, 9, BS, kv_dtype=kvd)
    jl, jpool = _walk(_jax_prefill(jq), jpool, prompt, pages, (16, 6))
    tpool = tt.pool_from_numpy(_np_tree(jpool), TCFG, device="cpu")
    for n in jpool:
        np.testing.assert_array_equal(tpool[n].numpy(), np.asarray(jpool[n]))
    tq = tt.params_from_numpy(_np_tree(jq), TCFG, device="cpu")
    tok = np.asarray([int(np.argmax(np.asarray(jl)))], np.int32)
    dpages = np.asarray([[5, 2, 7, 1]], np.int32)
    for step in range(3):
        pos = np.asarray([22 + step], np.int32)
        jl2, jpool = _jax_decode(jq, jpool, tok, pos, np.asarray([True]),
                                 dpages)
        tl2, tpool = _port_decode(tq, tpool, tok, pos, np.asarray([True]),
                                  dpages)
        np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), rtol=0,
                                   atol=ATOL_STEP)
        _pools_close(tpool, jpool)
        tok = np.asarray([int(np.argmax(np.asarray(jl2)))], np.int32)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _trace(rng):
    prefix = rng.randint(0, 64, 16).astype(np.int32)
    return [np.concatenate([prefix, rng.randint(0, 64, 5)]),
            np.concatenate([prefix, rng.randint(0, 64, 7)]),   # a hit
            rng.randint(0, 64, 35).astype(np.int32),           # 3 chunks
            rng.randint(0, 64, 3).astype(np.int32)]


def _serve(eng, prompts):
    reqs = []
    for p in prompts[:2]:                    # sequential: the second
        reqs.append(eng.submit(p, max_new=6))   # hits the cache
        eng.run_until_idle()
    reqs += [eng.submit(p, max_new=9) for p in prompts[2:]]
    eng.run_until_idle()                     # side by side
    assert eng.pool.idle
    return ([r.output.tolist() for r in reqs],
            [r.prefix_hit_tokens for r in reqs])


@pytest.mark.parametrize("kvd,weights", [("int8", "fp32"), ("int4", "fp32"),
                                         ("int8", "int8")],
                         ids=["int8-pool", "int4-pool", "int8-weights"])
def test_engine_greedy_ids_match_jax(kvd, weights, params, rng):
    jp, tp, jq, tq = params
    if weights == "int8":
        jp, tp = jq, tq
    prompts = _trace(rng)
    jeng = JaxEngine.from_params(jp, JCFG, pallas="off", kv_dtype=kvd,
                                 **ENGINE)
    teng = PagedDecodeEngine.from_params(tp, TCFG, device="cpu",
                                         kv_dtype=kvd, **ENGINE)
    want, got = _serve(jeng, prompts), _serve(teng, prompts)
    assert got == want
    assert got[1][1] == 16                   # the hit path ran
    h = teng.health()
    assert h["kv_dtype"] == jeng.kv_dtype == kvd
    assert h["kv_bytes_per_token"] == jeng.kv_bytes_per_token
    assert teng.pool_bytes == jeng.pool_bytes
    # within the port, the hit equals the same prompt served cold
    cold = PagedDecodeEngine.from_params(tp, TCFG, device="cpu",
                                         kv_dtype=kvd, **ENGINE)
    r = cold.submit(prompts[1], max_new=6)
    cold.run_until_idle()
    assert r.prefix_hit_tokens == 0
    assert r.output.tolist() == got[0][1]
