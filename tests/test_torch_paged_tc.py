"""The arithmetic of the paged attention kernels, emulated on the CPU.

The card kernels of ``flash_decode_attention`` and
``flash_chunk_prefill`` cannot run here; their order of operations can.
Each emulation below repeats, in plain torch, what the CUDA source
computes, and is held against ``paddle_tpu``'s Pallas kernel in
interpret mode on the same numpy inputs:

- decode (``csrc/decode_attention.cu``): positions in splits of
  ``DECODE_SPLIT``, each split's own max, exp, sum and p @ V, the splits
  combined in ascending order; a quantized pool's codes taken as they
  are, K's row scale after the q . code product and V's folded into p.
  fp32 throughout, so it must agree within 1e-5 (sums in another
  order), at context lengths on both sides of every split edge and past
  the page vector, for each pool storage;
- chunk prefill (``csrc/chunk_prefill.cu``, bf16 queries): q, the
  chunk's K/V and the pool's values or codes as bf16 operands (the
  inputs are bf16 values, and codes are exact in bf16), fp32 products,
  64-column tiles with an online softmax in the exp2 domain, K's row
  scale after the product, V's into p, and p split into bf16 hi + lo
  before p @ V. Within 1e-4, the card's gate, for each pool storage,
  cold and with context, across a 64-row tile edge;
- chunk prefill with fp32 queries (the same source's fp32
  instantiation): q, the chunk's K/V, an fp32 pool's values and p each
  split into three bf16 terms x0 + x1 + x2, every product the six
  cross terms x_i . y_j with i + j <= 2 into fp32 (codes stay one
  term), the same tiles, softmax and ascending split combine. Within
  1e-4 of the Pallas kernel at the serving slice's shape and at the
  card's fp32 step-parity shape, over an fp32 and an int8 pool; one
  bf16 rounding of every operand instead misses 1e-4.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import decode as jdecode
from paddle_tpu.ops.pallas import prefill as jprefill
from paddle_tpu_torch.ops import q8
from paddle_tpu_torch.ops.kernels import decode as kdecode
from paddle_tpu_torch.ops.kernels import prefill as kprefill

# the suite runs several test processes side by side on a few cores
torch.set_num_threads(1)

SPLIT = kdecode.DECODE_SPLIT
SPLIT_TILES = kprefill._TC_SPLIT_TILES     # 64-column tiles a prefill CTA takes
LOG2E = 1.4426950408889634


def _codes(x, kv_dtype):
    """Pool rows as the kernels read them: fp32 values, or the integer
    codes (int4 nibbles unpacked) as fp32."""
    if kv_dtype == "none":
        return x.float()
    if kv_dtype == "int4":
        x = q8.unpack_int4(x)
    return x.float()


def _pool(rng, shape, kv_dtype, bf16=False):
    """A pool [Hkv, M, Dh] as the wrappers take it: fp32 values (bf16
    values held in fp32 when ``bf16``), or codes and fp32 row scales."""
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    if bf16:
        x = x.bfloat16().float()
    if kv_dtype == "none":
        return x, None
    return q8.quantize_kv(x, kv_dtype)


def decode_split_emulation(q, k, v, pages, pos, *, block_size, k_scale=None,
                           v_scale=None, kv_dtype="none"):
    """``csrc/decode_attention.cu``'s order of operations, fp32."""
    B, Hkv, G, Dh = q.shape
    bs = block_size
    TP = pages.shape[1] * bs
    out = torch.zeros(B, Hkv, G, Dh)
    for b in range(B):
        T = min(int(pos[b]) + 1, TP)
        t = torch.arange(T)
        rows = pages[b].long()[t // bs] * bs + t % bs
        kc, vc = _codes(k[:, rows], kv_dtype), _codes(v[:, rows], kv_dtype)
        ks = k_scale[:, rows] if kv_dtype != "none" else torch.ones(Hkv, T)
        vs = v_scale[:, rows] if kv_dtype != "none" else torch.ones(Hkv, T)
        parts = []
        for t0 in range(0, T, SPLIT):
            sl = slice(t0, min(t0 + SPLIT, T))
            s = (torch.einsum("kgd,ktd->kgt", q[b].float(), kc[:, sl])
                 * ks[:, None, sl] / math.sqrt(Dh))
            m = s.amax(dim=-1)
            e = torch.exp(s - m[..., None])
            p = e * vs[:, None, sl]
            parts.append((m, e.sum(dim=-1),
                          torch.einsum("kgt,ktd->kgd", p, vc[:, sl])))
        if len(parts) == 1:
            m, l, o = parts[0]
            out[b] = o / l[..., None]
            continue
        m = torch.stack([p[0] for p in parts]).amax(dim=0)
        l = torch.zeros_like(m)
        o = torch.zeros(Hkv, G, Dh)
        for mi, li, oi in parts:                 # ascending split order
            w = torch.exp(mi - m)
            l = l + w * li
            o = o + w[..., None] * oi
        out[b] = o / l[..., None]
    return out


def split_terms(x, n):
    """The ``n`` bf16 terms of fp32 ``x`` (as fp32 tensors): term i is
    bf16 of what the terms before it leave (``flash_tc.cuh``'s
    ``split_terms``; each subtraction is exact)."""
    terms = []
    for _ in range(n):
        t = x.bfloat16().float()
        terms.append(t)
        x = x - t
    return terms


def split_product(a, b, f=torch.matmul):
    """``f(a, b)`` over split operands (lists of terms) as the kernels
    take it: the cross terms f(a_i, b_j) with i + j <= 2, each an fp32
    product of bf16 values, summed into one fp32 result smallest first
    (``ss_split`` / ``rs_split``)."""
    out = 0
    for w in (2, 1, 0):
        for i, ai in enumerate(a):
            if 0 <= w - i < len(b):
                out = out + f(ai, b[w - i])
    return out


def prefill_tc_emulation(q, k_chunk, v_chunk, k, v, pages, *, block_size,
                         k_scale=None, v_scale=None, kv_dtype="none",
                         split=True, terms=1):
    """``csrc/chunk_prefill.cu``'s arithmetic: operands as bf16 terms
    (``terms``: 1, the bf16 instantiation, or 3, the fp32 one; a
    quantized context's codes are one term either way), fp32 products
    of the cross terms, 64-column tiles (context, then the chunk),
    online softmax in the exp2 domain over each split of
    ``SPLIT_TILES`` tiles, the splits combined in ascending order,
    scales outside the products, p split into hi + lo for one-term
    operands and into three terms for three (``split=False``: p
    rounded once to bf16)."""
    C, Hkv, G, Dh = q.shape
    bs = block_size
    S = pages.shape[0] * bs
    t = torch.arange(S)
    rows = pages.long()[t // bs] * bs + t % bs
    c2 = LOG2E / math.sqrt(Dh)
    out = torch.zeros(C, Hkv, G, Dh)
    see = torch.arange(C * G) // G              # last chunk column a row sees
    p_terms = (3 if terms == 3 else 2) if split else 1
    for h in range(Hkv):
        quant = kv_dtype != "none"
        ctx_terms = 1 if quant else terms
        Q = split_terms(q[:, h].reshape(C * G, Dh).float(), terms)
        ctx_k = split_terms(_codes(k[h, rows], kv_dtype), ctx_terms)
        ctx_v = split_terms(_codes(v[h, rows], kv_dtype), ctx_terms)
        ks = k_scale[h, rows] if quant else torch.ones(S)
        vs = v_scale[h, rows] if quant else torch.ones(S)
        tiles = [([t[i:i + 64] for t in ctx_k], [t[i:i + 64] for t in ctx_v],
                  ks[i:i + 64], vs[i:i + 64], None) for i in range(0, S, 64)]
        ck = split_terms(k_chunk[:, h].float(), terms)
        cv = split_terms(v_chunk[:, h].float(), terms)
        ones = torch.ones(C)
        tiles += [([t[j:j + 64] for t in ck], [t[j:j + 64] for t in cv],
                   ones[j:j + 64], ones[j:j + 64], j)
                  for j in range(0, C, 64)]
        parts = []
        for s0 in range(0, len(tiles), SPLIT_TILES):
            m = torch.full((C * G,), -1e30)
            l = torch.zeros(C * G)
            o = torch.zeros(C * G, Dh)
            for kt, vt, kst, vst, j0 in tiles[s0:s0 + SPLIT_TILES]:
                s = (split_product(Q, kt, lambda a, b: a @ b.T) * c2
                     * kst[None, :])
                if j0 is not None:
                    col = j0 + torch.arange(kt[0].shape[0])
                    s = torch.where(col[None, :] <= see[:, None], s, -1e30)
                m_new = torch.maximum(m, s.amax(dim=-1))
                alpha = torch.exp2(m - m_new)
                p = torch.exp2(s - m_new[:, None])
                l = l * alpha + p.sum(dim=-1)
                pv = split_terms(p * vst[None, :], p_terms)
                o = o * alpha[:, None] + split_product(pv, vt)
                m = m_new
            parts.append((m, l, o))
        if len(parts) == 1:
            m, l, o = parts[0]
            out[:, h] = (o / l[:, None]).reshape(C, G, Dh)
            continue
        mm = torch.stack([p[0] for p in parts]).amax(dim=0)
        ll = torch.zeros(C * G)
        oo = torch.zeros(C * G, Dh)
        for m, l, o in parts:                    # ascending split order
            w = torch.exp2(m - mm)
            ll = ll + w * l
            oo = oo + w[:, None] * o
        out[:, h] = (oo / ll[:, None]).reshape(C, G, Dh)
    return out


def _j(t):
    return None if t is None else jnp.asarray(t.numpy())


@pytest.mark.parametrize("kvd", ["none", "int8", "int4"])
def test_decode_split_order_matches_pallas(kvd, rng):
    """Context lengths 1, SPLIT - 1, SPLIT, SPLIT + 1, two whole splits
    and past the page vector, in one batch: within 1e-5 of the Pallas
    kernel."""
    B, Hkv, G, Dh, P, bs, nblocks = 6, 2, 2, 32, 20, 8, 24
    TP = P * bs
    assert TP > 2 * SPLIT
    q = torch.from_numpy(rng.randn(B, Hkv, G, Dh).astype(np.float32))
    k, ks = _pool(rng, (Hkv, nblocks * bs, Dh), kvd)
    v, vs = _pool(rng, (Hkv, nblocks * bs, Dh), kvd)
    pages = torch.from_numpy(np.stack(
        [rng.permutation(nblocks)[:P] for _ in range(B)]).astype(np.int32))
    pos = torch.tensor([0, SPLIT - 2, SPLIT - 1, SPLIT, 2 * SPLIT - 1,
                        TP + 9], dtype=torch.int32)
    kw = dict(block_size=bs, k_scale=ks, v_scale=vs, kv_dtype=kvd)
    want = np.asarray(jdecode.flash_decode_attention(
        _j(q), _j(k), _j(v), _j(pages), _j(pos), interpret=True,
        **dict(kw, k_scale=_j(ks), v_scale=_j(vs))))
    got = decode_split_emulation(q, k, v, pages, pos, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # the wrapper's plain version, on the CPU, computes the same function
    plain = kdecode.flash_decode_attention(q, k, v, pages, pos, **kw)
    np.testing.assert_allclose(plain.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("P_ctx", [0, 5, 14], ids=["cold", "context",
                                                  "long_context"])
@pytest.mark.parametrize("kvd", ["none", "int8", "int4"])
def test_prefill_tensor_core_arithmetic_matches_pallas(kvd, P_ctx, rng):
    """40 chunk rows x G = 2 is 80 query rows (two 64-row tiles); a
    context of 5 pages of 16 ends inside its second 64-column tile (with
    the chunk's tile, two splits), one of 14 pages makes four context
    tiles and one chunk tile (three splits)."""
    C, Hkv, G, Dh, bs, nblocks = 40, 2, 2, 32, 16, 16

    def bf16(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)
                                ).bfloat16().float()

    q, kck, vck = bf16(C, Hkv, G, Dh), bf16(C, Hkv, Dh), bf16(C, Hkv, Dh)
    k, ks = _pool(rng, (Hkv, nblocks * bs, Dh), kvd, bf16=True)
    v, vs = _pool(rng, (Hkv, nblocks * bs, Dh), kvd, bf16=True)
    pages = torch.from_numpy(rng.permutation(nblocks)[:P_ctx]
                             .astype(np.int32))
    kw = dict(block_size=bs, k_scale=ks, v_scale=vs, kv_dtype=kvd)
    want = np.asarray(jprefill.flash_chunk_prefill(
        _j(q), _j(kck), _j(vck), _j(k), _j(v), _j(pages), interpret=True,
        **dict(kw, k_scale=_j(ks), v_scale=_j(vs))))
    got = prefill_tc_emulation(q, kck, vck, k, v, pages, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_prefill_hi_lo_split_is_what_keeps_the_gate(rng):
    """The hi/lo split is needed: with p rounded once to bf16 the same
    emulation at a 300-position context lands further from the fp32
    plain version than with the split, which stays within 1e-5."""
    C, Hkv, G, Dh, bs, nblocks = 64, 1, 1, 64, 16, 24
    q = torch.from_numpy(rng.randn(C, Hkv, G, Dh).astype(np.float32)
                         ).bfloat16().float()
    kck = q[:, :, 0].clone()
    vck = torch.from_numpy(rng.randn(C, Hkv, Dh).astype(np.float32)
                           ).bfloat16().float()
    k, _ = _pool(rng, (Hkv, nblocks * bs, Dh), "none", bf16=True)
    v, _ = _pool(rng, (Hkv, nblocks * bs, Dh), "none", bf16=True)
    pages = torch.from_numpy(rng.permutation(nblocks)[:19].astype(np.int32))
    want = kprefill.flash_chunk_prefill_plain(q, kck, vck, k, v, pages,
                                              block_size=bs)
    split = prefill_tc_emulation(q, kck, vck, k, v, pages, block_size=bs)
    err_split = (split - want).abs().max().item()
    once = prefill_tc_emulation(q, kck, vck, k, v, pages, block_size=bs,
                                split=False)
    err_once = (once - want).abs().max().item()
    assert err_split <= 1e-5 < err_once, (err_split, err_once)


# the serving slice (GPT-2 small: 12 kv heads of 64, a 256-row chunk over
# 512 context positions) and the card's fp32 step-parity widths (G = 2,
# Dh = 32) over a context that ends inside its second 64-column tile
FP32_SHAPES = {"slice": (256, 12, 1, 64, 32), "step_parity": (40, 2, 2, 32, 5)}


def _fp32_inputs(rng, shape, kvd):
    """fp32 q and chunk K/V and an fp32 (or int8) pool at one of
    ``FP32_SHAPES`` (C, Hkv, G, Dh, context pages of 16)."""
    C, Hkv, G, Dh, P_ctx = FP32_SHAPES[shape]
    bs, nblocks = 16, 40

    def f32(*shape_):
        return torch.from_numpy(rng.randn(*shape_).astype(np.float32))

    q, kck, vck = f32(C, Hkv, G, Dh), f32(C, Hkv, Dh), f32(C, Hkv, Dh)
    k, ks = _pool(rng, (Hkv, nblocks * bs, Dh), kvd)
    v, vs = _pool(rng, (Hkv, nblocks * bs, Dh), kvd)
    pages = torch.from_numpy(rng.permutation(nblocks)[:P_ctx]
                             .astype(np.int32))
    kw = dict(block_size=bs, k_scale=ks, v_scale=vs, kv_dtype=kvd)
    return (q, kck, vck, k, v, pages), kw


@pytest.mark.parametrize("kvd", ["none", "int8"])
@pytest.mark.parametrize("shape", list(FP32_SHAPES))
def test_prefill_fp32_three_term_arithmetic_matches_pallas(shape, kvd, rng):
    """The fp32 instantiation's arithmetic (every fp32 operand and p as
    three bf16 terms, six cross terms a product) within 1e-4 of the
    Pallas kernel, fp32 queries over an fp32 and an int8 pool."""
    args, kw = _fp32_inputs(rng, shape, kvd)
    q, kck, vck, k, v, pages = args
    want = np.asarray(jprefill.flash_chunk_prefill(
        *(_j(t) for t in args), interpret=True,
        **dict(kw, k_scale=_j(kw["k_scale"]), v_scale=_j(kw["v_scale"]))))
    got = prefill_tc_emulation(*args, terms=3, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("kvd", ["none", "int8"])
def test_prefill_fp32_one_rounding_misses_the_gate(kvd, rng):
    """Why the fp32 queries' operands are split in three: rounded once
    to bf16 (q, K, V and p, the bf16 kernel's operands with p unsplit)
    the slice lands more than 1e-4 from the fp32 plain version; three
    terms stay within 1e-5."""
    args, kw = _fp32_inputs(rng, "slice", kvd)
    want = kprefill.flash_chunk_prefill_plain(*args, **kw)
    err3 = (prefill_tc_emulation(*args, terms=3, **kw) - want).abs().max()
    err1 = (prefill_tc_emulation(*args, terms=1, split=False, **kw)
            - want).abs().max()
    assert err3.item() <= 1e-5 and err1.item() > 1e-4, (err3, err1)
