"""The port's flash attention against ``paddle_tpu``'s Pallas kernels.

On the CPU the two kernel wrappers run their plain versions, so these
tests hold the plain forward and backward, and the autograd
``FlashAttention`` that calls them, against the Pallas kernels in
interpret mode on the same numpy inputs (scaled by 0.5, as
``tests/test_pallas_attention.py`` makes them):

- forward ``(out, lse)`` (fp32): 2e-5, the JAX tests' tolerance — the
  same function with sums taken in another order;
- gradients of ``flash_attention`` against ``jax.vjp`` of the Pallas
  path for the same ``do`` (fp32): 2e-4, the JAX tests' tolerance;
- bf16: the forward against the fp32 reference on the same
  bf16-rounded inputs — both compute in fp32, so the port differs only
  where it rounds its output to bf16, at most half a bf16 ulp; checked
  at one ulp (relative 2**-7) plus 1e-5 absolute for the fp32 sums.
  The gradients against the Pallas path run in bf16 too: both save the
  output in bf16 and take ``delta = sum(do * out)`` from it (an fp32
  reference would not, and differs by up to 6e-4 on early causal rows,
  where few keys carry large probabilities), so they differ only in
  sum order and the final rounding — one ulp plus 1e-5.

The kernels themselves are held against these plain versions on the
card in ``tests/test_torch_gpu.py``. ``TestTensorCoreArithmetic``
records why the bf16 kernels split p and ds into two bf16 halves: it
emulates their arithmetic (bf16 operands, fp32 sums) on the CPU against
the plain versions, under the card's 2-ulp gate.
``TestFp32TensorCoreArithmetic`` does the same for the fp32
instantiations of both: every operand, p and ds included, split into
three bf16 terms, each product the six cross terms into fp32, within
1e-4 of the Pallas forward and VJP, where one bf16 rounding of each
operand misses 1e-4.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import attention as ja
from paddle_tpu_torch.ops.kernels import attention as ka
from test_torch_paged_tc import LOG2E, split_product, split_terms

# the suite runs several test processes side by side on a few cores:
# one intra-op thread keeps these tiny-shape tests from crowding the
# cores the other processes' JAX tests use
torch.set_num_threads(1)

FWD_ATOL = 2e-5
GRAD_ATOL = 2e-4
BF16_RTOL = 2.0 ** -7


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _arrays(rng, *shape, n=3):
    return [(rng.randn(*shape) * 0.5).astype(np.float32) for _ in range(n)]


class TestForwardPlain:
    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("t,bq,bk", [(32, 16, 16), (48, 32, 32),
                                         (10, 6, 8)],
                             ids=["even", "ragged", "mismatched"])
    def test_matches_pallas_interpret(self, rng, causal, t, bq, bk):
        q, k, v = _arrays(rng, 4, t, 16)
        scale = 1.0 / math.sqrt(16)
        want_out, want_lse = ja._flash_fwd(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, causal,
            bq, bk, True)
        out, lse = ka.flash_attention_fwd(_t(q), _t(k), _t(v),
                                          sm_scale=scale, causal=causal)
        assert out.dtype == torch.float32 and lse.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                                   rtol=0, atol=FWD_ATOL)
        np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                                   rtol=0, atol=FWD_ATOL)

    def test_cpu_runs_plain_and_counts_no_launch(self, rng):
        q, k, v = _arrays(rng, 2, 8, 32)
        before = (dict(ka.flash_attention_fwd.launches),
                  dict(ka.flash_attention_bwd.launches))
        for dtype in (torch.float32, torch.bfloat16):
            out = ka.flash_attention(*(
                _t(a, dtype).reshape(1, 8, 2, 32).requires_grad_()
                for a in (q, k, v)))
            out.float().sum().backward()
        assert (ka.flash_attention_fwd.launches,
                ka.flash_attention_bwd.launches) == before

    def test_launch_counts_name_the_four_attention_branches(self):
        """bf16 (tensor cores) under the wrapper's own name, fp32 (CUDA
        cores) as ``.fp32``, like the quantized pool branches."""
        from paddle_tpu_torch.ops import kernels
        assert ka.BRANCHES == {torch.bfloat16: "bf16", torch.float32: "fp32"}
        assert list(ka.flash_attention_fwd.launches) == ["bf16", "fp32"]
        assert list(ka.flash_attention_bwd.launches) == ["bf16", "fp32"]
        names = [n for n in kernels.launch_counts() if "flash_attention" in n]
        assert names == ["flash_attention_fwd", "flash_attention_fwd.fp32",
                         "flash_attention_bwd", "flash_attention_bwd.fp32"]

    def test_other_devices_raise(self):
        q = torch.zeros(2, 8, 32, device="meta")
        with pytest.raises(ValueError, match="no kernel for device"):
            ka.flash_attention_fwd(q, q, q, sm_scale=1.0, causal=True)
        with pytest.raises(ValueError, match="no kernel for device"):
            ka.flash_attention_bwd(q, q, q, q, q[..., 0], q, sm_scale=1.0,
                                   causal=True)


def _grads_both(q, k, v, do, *, causal, bq=16, bk=16, dtype=torch.float32,
                jax_dtype=jnp.float32):
    """(port out, port grads) with inputs in ``dtype``, and (JAX out,
    JAX grads) of the Pallas path in interpret mode with inputs in
    ``jax_dtype``, both on the same (dtype-rounded) values, as fp32
    numpy. q [B, T, H, D], k/v [B, T, Hkv, D]."""
    tq, tk, tv = (_t(a, dtype).requires_grad_() for a in (q, k, v))
    out = ka.flash_attention(tq, tk, tv, causal=causal)
    out.backward(_t(do, dtype))
    got = [out.detach().float().numpy()] + [
        t.grad.float().numpy() for t in (tq, tk, tv)]
    assert all(t.grad.dtype == dtype for t in (tq, tk, tv))
    rounded = [_t(a, dtype).float().numpy() for a in (q, k, v, do)]

    def fn(q_, k_, v_):
        return ja.flash_attention(q_, k_, v_, causal=causal, interpret=True,
                                  block_q=bq, block_k=bk)

    want_out, vjp = jax.vjp(fn, *(jnp.asarray(a, jax_dtype)
                                  for a in rounded[:3]))
    want = [want_out] + list(vjp(jnp.asarray(rounded[3], jax_dtype)))
    return got, [np.asarray(w, np.float32) for w in want]


class TestBackward:
    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("t,bq,bk", [(32, 16, 16), (48, 16, 16),
                                         (10, 6, 8)],
                             ids=["even", "ragged", "mismatched"])
    def test_grads_match_pallas_vjp(self, rng, causal, t, bq, bk):
        q, k, v, do = _arrays(rng, 2, t, 2, 16, n=4)
        got, want = _grads_both(q, k, v, do, causal=causal, bq=bq, bk=bk)
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=FWD_ATOL)
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_allclose(a, b, rtol=0, atol=GRAD_ATOL)

    @pytest.mark.parametrize("causal", [False, True])
    def test_gqa_grads_sum_over_groups(self, rng, causal):
        """H=4 query heads over Hkv=2: k/v gradients come back at 2
        heads, each the sum over its group, as ``jnp.repeat``'s VJP."""
        q, do = _arrays(rng, 2, 24, 4, 8, n=2)
        k, v = _arrays(rng, 2, 24, 2, 8, n=2)
        got, want = _grads_both(q, k, v, do, causal=causal)
        assert got[2].shape == (2, 24, 2, 8)
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=FWD_ATOL)
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_allclose(a, b, rtol=0, atol=GRAD_ATOL)

    @pytest.mark.parametrize("causal", [False, True])
    def test_bf16(self, rng, causal):
        q, k, v, do = _arrays(rng, 2, 40, 2, 16, n=4)
        got, want = _grads_both(q, k, v, do, causal=causal,
                                dtype=torch.bfloat16)
        np.testing.assert_allclose(got[0], want[0], rtol=BF16_RTOL,
                                   atol=1e-5)
        got, want = _grads_both(q, k, v, do, causal=causal,
                                dtype=torch.bfloat16, jax_dtype=jnp.bfloat16)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=BF16_RTOL, atol=1e-5)

    def test_block_bwd_with_global_lse(self, rng):
        """One q-shard against two k/v blocks (non-causal, as a ring step
        sees a remote block): each block's gradients from the GLOBAL
        (out, lse) match the Pallas ``flash_block_bwd``, and the blocks'
        dq sum to the full attention's dq."""
        BH, T, D = 3, 16, 8
        scale = 1.0 / math.sqrt(D)
        q, do = _arrays(rng, BH, T, D, n=2)
        k, v = _arrays(rng, BH, 2 * T, D, n=2)
        out, lse = ka.flash_attention_fwd_plain(_t(q), _t(k), _t(v),
                                                sm_scale=scale, causal=False)
        dq = 0
        for blk in (slice(0, T), slice(T, 2 * T)):
            kb, vb = k[:, blk], v[:, blk]
            got = ka.flash_block_bwd(_t(q), _t(kb), _t(vb), out, lse, _t(do),
                                     scale, False)
            want = ja.flash_block_bwd(
                jnp.asarray(q), jnp.asarray(kb), jnp.asarray(vb),
                jnp.asarray(out.numpy()), jnp.asarray(lse.numpy()),
                jnp.asarray(do), scale, False, block_q=8, block_k=8,
                interpret=True)
            for a, b in zip(got, want):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                           atol=GRAD_ATOL)
            dq = dq + got[0]
        full = jax.grad(lambda q_: jnp.sum(ja._reference(
            q_, jnp.asarray(k), jnp.asarray(v), scale, False)
            * jnp.asarray(do)))(jnp.asarray(q))
        np.testing.assert_allclose(dq.numpy(), np.asarray(full), rtol=0,
                                   atol=GRAD_ATOL)

    def test_block_fwd_is_the_forward(self, rng):
        q, k, v = _arrays(rng, 2, 12, 8)
        a = ka.flash_block_fwd(_t(q), _t(k), _t(v), 0.3, True)
        b = ja.flash_block_fwd(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), 0.3, True, block_q=8,
                               block_k=8, interpret=True)
        for x, y in zip(a, b):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0,
                                       atol=FWD_ATOL)

    @pytest.mark.parametrize("causal", [False, True])
    def test_gradcheck_float64(self, causal):
        g = torch.Generator().manual_seed(0)
        q, k, v = (torch.randn(2, 5, 4, generator=g, dtype=torch.float64,
                               requires_grad=True) for _ in range(3))
        assert torch.autograd.gradcheck(
            lambda a, b, c: ka.FlashAttention.apply(a, b, c, 0.5, causal),
            (q, k, v))

    def test_expand_kv_heads_is_repeat_interleave(self, rng):
        x = _t(rng.randn(2, 3, 2, 4))
        assert torch.equal(ka.expand_kv_heads(x, 6),
                           x.repeat_interleave(3, dim=2))


def _bf(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _tensor_core_emulation(q, k, v, do, out, lse, scale, causal, split):
    """(out, dq, dk, dv) in bf16 as the bf16 kernels compute them: bf16
    operands into fp32 sums, with each fp32 operand (p, p^T, ds, ds^T)
    rounded once to bf16 (``split=False``, FlashAttention-2's scheme) or
    taken as bf16(x) + bf16(x - bf16(x)), two products into one fp32
    sum (``split=True``, the kernels' scheme). Row statistics stay fp32
    from the unrounded p, and the backward uses the plain forward's
    (out, lse), as the kernels do."""
    def product(a, b):
        hi = _bf(a)
        r = hi @ b
        return r + _bf(a - hi) @ b if split else r

    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    T = q.shape[1]
    s = (qf @ kf.transpose(-1, -2)) * scale
    valid = torch.ones(T, T, dtype=torch.bool)
    if causal:
        valid = valid.tril()
    p = torch.where(valid, torch.exp(s - lse[..., None]), 0.0)
    o = product(p, vf) / p.sum(-1)[..., None]
    delta = (dof * out.float()).sum(-1)
    ds = p * (dof @ vf.transpose(-1, -2) - delta[..., None]) * scale
    grads = (product(ds, kf), product(ds.transpose(-1, -2), qf),
             product(p.transpose(-1, -2), dof))
    return [t.to(torch.bfloat16) for t in (o,) + grads]


class TestTensorCoreArithmetic:
    """Why the bf16 kernels split p and ds: at BH=2, T=512, D=64 (seeded
    numpy inputs, bf16), rounding p and ds once to bf16 before their
    products puts out, dq, dk and dv more than 2 bf16 ulps (the card's
    gate) from the plain versions, which take those products in fp32;
    splitting each into a hi and a lo bf16 half keeps all four within
    2."""

    @pytest.mark.parametrize("causal", [False, True])
    def test_one_rounding_misses_the_gate_and_the_split_keeps_it(
            self, causal):
        rng = np.random.RandomState(0)
        q, k, v, do = (_t(rng.randn(2, 512, 64).astype(np.float32),
                          torch.bfloat16) for _ in range(4))
        scale = 64 ** -0.5
        out, lse = ka.flash_attention_fwd_plain(q, k, v, sm_scale=scale,
                                                causal=causal)
        want = [out] + list(ka.flash_attention_bwd_plain(
            q, k, v, out, lse, do, sm_scale=scale, causal=causal))
        for split in (False, True):
            got = _tensor_core_emulation(q, k, v, do, out, lse, scale,
                                         causal, split)
            ulps = [ka.bf16_ulps(a, b) for a, b in zip(got, want)]
            if split:
                assert max(ulps) <= 2, ulps
            else:
                assert min(ulps) > 2, ulps


def _fp32_tensor_core_emulation(q, k, v, do, out, lse, scale, causal,
                                terms):
    """(dq, dk, dv) as the backward's fp32 instantiation computes them
    (``terms=3``): q, k, v, do, p, ds, p^T and ds^T each split into three
    bf16 terms, every product the cross terms of order 2^-16 and up
    into fp32; ``terms=1`` rounds each of those operands once to bf16.
    p and ds come from fp32 scores and the forward's (out, lse), as in
    the kernels."""
    T = q.shape[1]
    valid = torch.ones(T, T, dtype=torch.bool)
    if causal:
        valid = valid.tril()

    def terms_of(x):
        return split_terms(x, terms)

    def by_rows(a, b):
        return a @ b.transpose(-1, -2)

    def tr(ts):
        return [t.transpose(-1, -2) for t in ts]

    Q, K, V, DO = (terms_of(t) for t in (q, k, v, do))
    s = split_product(Q, K, by_rows) * scale
    p = torch.where(valid, torch.exp(s - lse[..., None]), 0.0)
    delta = (do * out).sum(-1)
    ds = p * (split_product(DO, V, by_rows) - delta[..., None]) * scale
    P, DS = terms_of(p), terms_of(ds)
    return (split_product(DS, K), split_product(tr(DS), Q),
            split_product(tr(P), DO))


def _fp32_forward_emulation(q, k, v, scale, causal, terms):
    """(out, lse) as the forward's fp32 instantiation computes them
    (``terms=3``): q, k, v and p split into three bf16 terms, S and
    P . V each the cross terms of order 2^-16 and up into fp32, an
    online softmax over 64-key tiles in the exp2 domain, o rescaled by
    alpha before each tile's share is added; ``terms=1`` rounds each of
    those operands once to bf16. A causal row's tiles past its diagonal
    add exactly nothing (p = 0, alpha = 1), so all tiles are taken."""
    BH, T, _ = q.shape
    c = scale * LOG2E
    Q, K, V = (split_terms(t, terms) for t in (q, k, v))
    row = torch.arange(T)
    m = torch.full((BH, T), -1e30)
    l = torch.zeros(BH, T)
    o = torch.zeros_like(q)
    for k0 in range(0, T, 64):
        kt = [t[:, k0:k0 + 64] for t in K]
        vt = [t[:, k0:k0 + 64] for t in V]
        s = split_product(Q, kt, lambda a, b: a @ b.transpose(-1, -2)) * c
        if causal:
            col = k0 + torch.arange(kt[0].shape[1])
            s = torch.where(col[None, :] > row[:, None], -1e30, s)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + split_product(split_terms(p, terms), vt)
        m = m_new
    l_safe = l.clamp_min(1e-30)
    return o / l_safe[..., None], (m + torch.log2(l_safe)) / LOG2E


class TestFp32TensorCoreArithmetic:
    """The fp32 forward and backward on the tensor cores: at BH=2,
    T=512, D=64 (seeded numpy inputs, fp32), three bf16 terms per
    operand keep out and lse within 1e-4 (the card's fp32 gate) of the
    Pallas forward (``flash_block_fwd``, the entry that returns lse), and
    dq, dk and dv within 1e-4 of ``jax.vjp`` of the Pallas path; one
    bf16 rounding of each operand misses it."""

    @staticmethod
    def _forward(causal):
        rng = np.random.RandomState(0)
        q, k, v = (rng.randn(2, 512, 64).astype(np.float32)
                   for _ in range(3))
        want = ja.flash_block_fwd(*(jnp.asarray(a) for a in (q, k, v)),
                                  0.125, causal, block_q=128, block_k=128,
                                  interpret=True)

        def errs(terms):
            got = _fp32_forward_emulation(_t(q), _t(k), _t(v), 0.125,
                                          causal, terms)
            return [float(np.abs(g.numpy() - np.asarray(w)).max())
                    for g, w in zip(got, want)]
        return errs

    @pytest.mark.parametrize("causal", [False, True])
    def test_forward_three_terms_match_pallas(self, causal):
        errs = self._forward(causal)(3)
        assert max(errs) <= 1e-4, errs

    @pytest.mark.parametrize("causal", [False, True])
    def test_forward_one_rounding_misses_the_gate(self, causal):
        errs = self._forward(causal)(1)
        assert min(errs) > 1e-4, errs

    @staticmethod
    def _both(causal):
        rng = np.random.RandomState(0)
        q, k, v, do = (rng.randn(1, 512, 2, 64).astype(np.float32)
                       for _ in range(4))

        def fn(q_, k_, v_):
            return ja.flash_attention(q_, k_, v_, causal=causal,
                                      interpret=True, block_q=128,
                                      block_k=128)

        _, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))
        want = [np.asarray(g).transpose(0, 2, 1, 3).reshape(2, 512, 64)
                for g in vjp(jnp.asarray(do))]

        def rows(a):
            return _t(a.transpose(0, 2, 1, 3).reshape(2, 512, 64))

        tq, tk, tv, tdo = (rows(a) for a in (q, k, v, do))
        out, lse = ka.flash_attention_fwd_plain(tq, tk, tv, sm_scale=0.125,
                                                causal=causal)

        def errs(terms):
            got = _fp32_tensor_core_emulation(tq, tk, tv, tdo, out, lse,
                                              0.125, causal, terms)
            return [float(np.abs(g.numpy() - w).max())
                    for g, w in zip(got, want)]
        return errs

    @pytest.mark.parametrize("causal", [False, True])
    def test_three_terms_match_the_pallas_vjp(self, causal):
        errs = self._both(causal)(3)
        assert max(errs) <= 1e-4, errs

    @pytest.mark.parametrize("causal", [False, True])
    def test_one_rounding_misses_the_gate(self, causal):
        errs = self._both(causal)(1)
        assert min(errs) > 1e-4, errs
