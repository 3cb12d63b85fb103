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
  cold and with context, across a 64-row tile edge.
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


def prefill_tc_emulation(q, k_chunk, v_chunk, k, v, pages, *, block_size,
                         k_scale=None, v_scale=None, kv_dtype="none",
                         split=True):
    """``csrc/chunk_prefill.cu``'s arithmetic: bf16 operands, fp32
    products, 64-column tiles (context, then the chunk), online softmax
    in the exp2 domain over each split of ``SPLIT_TILES`` tiles, the
    splits combined in ascending order, scales outside the products, p
    split hi + lo (``split=False``: p rounded once to bf16)."""
    C, Hkv, G, Dh = q.shape
    bs = block_size
    S = pages.shape[0] * bs
    t = torch.arange(S)
    rows = pages.long()[t // bs] * bs + t % bs
    c2 = LOG2E / math.sqrt(Dh)
    out = torch.zeros(C, Hkv, G, Dh)
    see = torch.arange(C * G) // G              # last chunk column a row sees
    for h in range(Hkv):
        Q = q[:, h].reshape(C * G, Dh).bfloat16().float()
        ctx_k = _codes(k[h, rows], kv_dtype).bfloat16().float()
        ctx_v = _codes(v[h, rows], kv_dtype).bfloat16().float()
        quant = kv_dtype != "none"
        ks = k_scale[h, rows] if quant else torch.ones(S)
        vs = v_scale[h, rows] if quant else torch.ones(S)
        tiles = [(ctx_k[i:i + 64], ctx_v[i:i + 64], ks[i:i + 64],
                  vs[i:i + 64], None) for i in range(0, S, 64)]
        ck = k_chunk[:, h].bfloat16().float()
        cv = v_chunk[:, h].bfloat16().float()
        ones = torch.ones(C)
        tiles += [(ck[j:j + 64], cv[j:j + 64], ones[j:j + 64],
                   ones[j:j + 64], j) for j in range(0, C, 64)]
        parts = []
        for s0 in range(0, len(tiles), SPLIT_TILES):
            m = torch.full((C * G,), -1e30)
            l = torch.zeros(C * G)
            o = torch.zeros(C * G, Dh)
            for kt, vt, kst, vst, j0 in tiles[s0:s0 + SPLIT_TILES]:
                s = (Q @ kt.T) * c2 * kst[None, :]
                if j0 is not None:
                    col = j0 + torch.arange(kt.shape[0])
                    s = torch.where(col[None, :] <= see[:, None], s, -1e30)
                m_new = torch.maximum(m, s.amax(dim=-1))
                alpha = torch.exp2(m - m_new)
                p = torch.exp2(s - m_new[:, None])
                l = l * alpha + p.sum(dim=-1)
                pv = p * vst[None, :]
                hi = pv.bfloat16().float()
                lo = (pv - hi).bfloat16().float() if split else 0 * hi
                o = o * alpha[:, None] + hi @ vt + lo @ vt
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
