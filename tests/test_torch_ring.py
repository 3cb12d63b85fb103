"""The port's context parallelism against ``paddle_tpu`` on the CPU: ring
attention (the plain blocked engine with ragged lengths, and the flash
engine on the plain versions of kernels 5/6), all-to-all attention,
grouped-query heads, the causal no-NaN case, the transformer's
DP x SP x TP loss and gradients, ``cp_mode="alltoall"``, and the int8
wire (codes and scales equal to the JAX package's exactly).

The reference is ``tests/test_ring_transformer.py``; the port runs on 4
gloo ranks (``tests/torch_dist_util.pool``; a JAX mesh of 8 maps to 4
ranks, (2, 4) to (2, 2), (2, 2, 2) to each pair of its axes), the JAX
functions here. Tolerances: outputs within 1e-5 of the reference's max,
gradients within 1e-5 of their max (relative), q8 codes and scales
exactly equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from paddle_tpu.models import transformer as jtt
from paddle_tpu.ops import q8 as jq8
from paddle_tpu.parallel import ring as jring
from tests.torch_dist_util import pool

TOL = 1e-5


def _close(got, want, label="", tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (label, err, scale)


def _qkv(seed, B, T, H, D, Hkv=None, scale=1.0):
    rng = np.random.RandomState(seed)
    Hkv = Hkv or H
    return {"q": rng.randn(B, T, H, D).astype(np.float32) * scale,
            "k": rng.randn(B, T, Hkv, D).astype(np.float32) * scale,
            "v": rng.randn(B, T, Hkv, D).astype(np.float32)}


def _full(inp, causal, lens=None, grads=False):
    """The JAX package's full_attention (and grads of sum(out**2))."""
    q, k, v = (jnp.asarray(inp[n]) for n in "qkv")
    G = q.shape[2] // k.shape[2]
    ln = None if lens is None else jnp.asarray(lens)

    def f(q_, k_, v_):
        return jring.full_attention(q_, jnp.repeat(k_, G, axis=2),
                                    jnp.repeat(v_, G, axis=2),
                                    causal=causal, lengths=ln)
    out = f(q, k, v)
    if not grads:
        return np.asarray(out), None
    g = jax.grad(lambda *a: jnp.sum(f(*a) ** 2), argnums=(0, 1, 2))(q, k, v)
    return np.asarray(out), [np.asarray(x) for x in g]


def _run(inp, **kw):
    return pool().run("case_attn", inputs=inp, **kw)


def _check(res, want, gwant=None, gtol=TOL):
    for r in res:
        _close(r["out"], want, "out")
        if gwant is not None:
            for n, gw in zip(("dq", "dk", "dv"), gwant):
                _close(r[n], gw, n, gtol)


class TestRingAttention:
    @pytest.mark.parametrize("causal", [False, True])
    def test_matches_full_attention(self, causal):
        inp = _qkv(0, 4, 16, 2, 8)
        inp["lens"] = np.array([16, 9, 12, 5], np.int64)
        want, _ = _full(inp, causal, inp["lens"])
        _check(_run(inp, mesh_shape=(2, 2), causal=causal,
                    use_lengths=True), want)

    def test_grads_match_full_attention(self):
        inp = _qkv(1, 2, 16, 2, 4)
        want, g = _full(inp, True, grads=True)
        _check(_run(inp, causal=True, grads=True), want, g)


class TestRingFlashAttention:
    """The flash ring on the plain versions of kernels 5 and 6 (the same
    code path drives the CUDA kernels on the card)."""

    @pytest.mark.parametrize("causal", [False, True])
    def test_matches_full_attention(self, causal):
        inp = _qkv(2, 2, 32, 2, 16)
        want, _ = _full(inp, causal)
        _check(_run(inp, mesh_shape=(2, 2), causal=causal, use_flash=True),
               want)

    @pytest.mark.parametrize("causal", [False, True])
    def test_grads_match_full_attention(self, causal):
        inp = _qkv(3, 2, 16, 2, 16)
        want, g = _full(inp, causal, grads=True)
        _check(_run(inp, causal=causal, use_flash=True, grads=True), want, g)

    def test_rejects_ragged_lengths(self):
        inp = _qkv(4, 2, 16, 2, 4)
        inp["lens"] = np.array([16, 9], np.int64)
        for r in _run(inp, use_flash=True, use_lengths=True):
            assert "packed equal-length" in r["error"]

    def test_causal_bwd_outlier_no_nan(self):
        """Queries far more aligned with FUTURE-shard keys than any
        allowed key: the masked blocks' backward takes lse = +1e30, so
        p = exp(s - lse) is exactly 0 instead of 0 * inf. The scores
        reach 100 (exp overflows fp32 past 88), so fp32 rounds s - lse
        to ~6e-6 relative before the sums: gradients within 1e-4 of
        their max here."""
        rng = np.random.RandomState(5)
        B, T, H, D = 1, 16, 1, 16
        u = np.ones((D,), np.float32)
        q = np.tile(u * 5, (B, T, H, 1)).astype(np.float32)
        k = rng.randn(B, T, H, D).astype(np.float32) * 0.01
        k[:, 12:] = u * 5
        v = rng.randn(B, T, H, D).astype(np.float32)
        inp = {"q": q, "k": k, "v": v}
        want, g = _full(inp, True, grads=True)
        res = _run(inp, causal=True, use_flash=True, grads=True)
        for r in res:
            for n in ("dq", "dk", "dv"):
                assert np.isfinite(r[n]).all(), n
        _check(res, want, g, gtol=1e-4)

    @pytest.mark.parametrize("Hkv", [2, 1])
    def test_virtual_rank_schedule_matches_full(self, Hkv):
        """``ring_flash_schedule``: the loops ``ring_flash_attention``
        runs, over 4 virtual ranks in this process (the hop a rotation
        of the rank list), on the plain versions of kernels 5/6 (CPU
        tensors). Out, dq, dk, dv within 1e-5 of the JAX package's full
        attention; each of the 6 masked blocks' gradients exactly 0."""
        import torch

        from paddle_tpu_torch.parallel import ring
        inp = _qkv(7, 2, 32, 2, 16, Hkv=Hkv)
        do = np.random.RandomState(8).randn(2, 32, 2, 16).astype(np.float32)
        G = 2 // Hkv

        def f(q_, k_, v_):
            return jring.full_attention(q_, jnp.repeat(k_, G, axis=2),
                                        jnp.repeat(v_, G, axis=2),
                                        causal=True)
        want, vjp = jax.vjp(f, *(jnp.asarray(inp[n]) for n in "qkv"))
        gwant = vjp(jnp.asarray(do))
        masked = []
        got = ring.ring_flash_schedule(
            *(torch.from_numpy(inp[n]) for n in "qkv"), 4, causal=True,
            do=torch.from_numpy(do),
            on_block=lambda ph, r, src, outs: masked.append(outs)
            if src > r else None)
        _close(got[0], want, "out")
        for n, a, b in zip(("dq", "dk", "dv"), got[2:], gwant):
            _close(a, b, n)
        assert len(masked) == 6
        assert all(bool((x == 0).all()) for outs in masked for x in outs)


class TestGQAEngines:
    @pytest.mark.parametrize("use_flash", [False, True])
    def test_ring_matches_full_and_kv_grads_grouped(self, use_flash):
        inp = _qkv(6, 2, 16, 4, 16, Hkv=2)
        want, g = _full(inp, True, grads=True)
        res = _run(inp, causal=True, use_flash=use_flash, grads=True)
        assert res[0]["dk"].shape == (2, 16, 2, 16)
        _check(res, want, g)


class TestAllToAllAttention:
    @pytest.mark.parametrize("causal", [False, True])
    def test_matches_full_attention(self, causal):
        inp = _qkv(7, 4, 16, 4, 8)
        inp["lens"] = np.array([16, 9, 12, 5], np.int64)
        want, _ = _full(inp, causal, inp["lens"])
        _check(_run(inp, engine="alltoall", mesh_shape=(2, 2),
                    causal=causal, use_lengths=True), want)

    @pytest.mark.parametrize("use_flash", [False, True])
    def test_grads_and_gqa(self, use_flash):
        inp = _qkv(8, 2, 16, 8, 16, Hkv=4)
        want, g = _full(inp, True, grads=True)
        _check(_run(inp, engine="alltoall", causal=True, use_flash=use_flash,
                    grads=True), want, g)

    def test_rejects_nondividing_heads(self):
        inp = {n: np.zeros((2, 16, 6, 4), np.float32) for n in "qkv"}
        for r in _run(inp, engine="alltoall", causal=True):
            assert "must divide" in r["error"]

    def test_head_axis_tp_composes(self):
        inp = _qkv(9, 2, 16, 8, 4)
        want, _ = _full(inp, True)
        _check(_run(inp, engine="alltoall", mesh_shape=(1, 2, 2),
                    mesh_axes=("data", "seq", "model"), causal=True), want)


# ---------------------------------------------------------------------------
# the transformer under a mesh
# ---------------------------------------------------------------------------

CFG = dict(vocab=50, d_model=32, n_heads=4, n_layers=2, d_ff=64,
           max_len=32)


def _lm_inputs(cfg, seed=1, B=4, T=16, lens=None):
    params = jtt.init_params(jax.random.PRNGKey(seed), cfg)
    rng = np.random.RandomState(seed)
    out = {f"p/{k}": np.asarray(v) for k, v in params.items()
           if k != "blocks"}
    out.update({f"p/blocks/{k}": np.asarray(v)
                for k, v in params["blocks"].items()})
    out["toks"] = rng.randint(0, cfg.vocab, (B, T)).astype(np.int64)
    out["tgt"] = rng.randint(0, cfg.vocab, (B, T)).astype(np.int64)
    if lens is not None:
        out["lens"] = np.asarray(lens, np.int64)
    return params, out


def _jax_loss_grads(params, inp, cfg, lens):
    ln = None if lens is None else jnp.asarray(lens, jnp.int32)
    toks = jnp.asarray(inp["toks"], jnp.int32)
    tgt = jnp.asarray(inp["tgt"], jnp.int32)
    return jax.value_and_grad(lambda p: jtt.lm_loss(
        p, toks, tgt, cfg, lengths=ln))(params)


def _jleaf(tree, name):
    return np.asarray(tree["blocks"][name[7:]] if name.startswith("blocks/")
                      else tree[name])


@pytest.mark.parametrize("mesh_shape", [(2, 2, 1), (1, 2, 2), (2, 1, 2)])
@pytest.mark.parametrize("ragged", [False, True])
def test_spmd_dp_sp_tp_matches_single_device(mesh_shape, ragged):
    """DP over batch, ring CP over seq, TP over heads / MLP / vocab: the
    port's loss and gradients (each rank's shard, summed over the token
    axes) against the JAX package's single-device loss and gradients."""
    jcfg = jtt.TransformerConfig(**CFG, dtype=jnp.float32)
    lens = [16, 10, 16, 7] if ragged else None
    params, inp = _lm_inputs(jcfg, lens=lens)
    loss, g = _jax_loss_grads(params, inp, jcfg, lens)
    res = pool().run("case_lm", inputs=inp,
                     cfg={**CFG, "use_ring_attention": True},
                     mesh_shape=mesh_shape,
                     mesh_axes=("data", "seq", "model"),
                     use_lengths=ragged)
    for r in res:
        np.testing.assert_allclose(r["loss"], float(loss), rtol=TOL)
        for name, (gg, sl) in r["grads"].items():
            want = _jleaf(g, name)
            piece = want[tuple(slice(a, b) for a, b in sl)]
            err = np.abs(gg - piece).max()
            assert err <= TOL * np.abs(want).max(), (name, err)


@pytest.mark.parametrize("B,T", [(3, 16), (4, 15)])
def test_spmd_refuses_tokens_that_do_not_split(B, T):
    """A batch that does not divide over ``data`` or a sequence that does
    not divide over ``seq`` raises ValueError on every rank (an uneven
    split would drop the remainder rows or tokens from the loss)."""
    jcfg = jtt.TransformerConfig(**CFG, dtype=jnp.float32)
    _, inp = _lm_inputs(jcfg, B=B, T=T)
    res = pool().run("case_lm", inputs=inp,
                     cfg={**CFG, "use_ring_attention": True},
                     mesh_shape=(2, 2, 1),
                     mesh_axes=("data", "seq", "model"))
    for r in res:
        assert f"tokens [{B}, {T}] do not split" in r["error"], r


@pytest.mark.parametrize("top_k", [1, 2])
def test_ep_sharded_moe_loss_and_grads(top_k):
    """``TestMoETransformer::test_ep_sharded_train_step``: the MoE
    transformer with its experts over ``expert`` and the batch over
    ``data`` (the routing capacity over the global tokens, as the JAX
    forward counts it): loss and gradients against the JAX package's
    single-device ones."""
    cfg = dict(CFG, moe_experts=4, moe_top_k=top_k,
               moe_capacity_factor=2.0)
    jcfg = jtt.TransformerConfig(**cfg, dtype=jnp.float32)
    params, inp = _lm_inputs(jcfg, seed=2)
    loss, g = _jax_loss_grads(params, inp, jcfg, None)
    res = pool().run("case_lm", inputs=inp, cfg=cfg, mesh_shape=(2, 2),
                     mesh_axes=("data", "expert"))
    for r in res:
        np.testing.assert_allclose(r["loss"], float(loss), rtol=TOL)
        for name, (gg, sl) in r["grads"].items():
            want = _jleaf(g, name)
            piece = want[tuple(slice(a, b) for a, b in sl)]
            err = np.abs(gg - piece).max()
            assert err <= TOL * np.abs(want).max(), (name, err)


def test_remat_composes_with_ring_flash():
    """``TestLayerRemat::test_composes_with_ring_flash``: remat "q8"
    under ring CP with the flash engine on a seq axis of 4 trains (two
    SGD steps), and its forward is the JAX package's loss (remat changes
    only the backward)."""
    cfg = dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
               max_len=64)
    jcfg = jtt.TransformerConfig(**cfg, dtype=jnp.float32)
    params, inp = _lm_inputs(jcfg, seed=0, B=1, T=64)
    inp["tgt"] = inp["toks"]
    want = jtt.lm_loss(params, jnp.asarray(inp["toks"], jnp.int32),
                       jnp.asarray(inp["tgt"], jnp.int32), jcfg)
    res = pool().run("case_lm", inputs=inp,
                     cfg={**cfg, "use_ring_attention": True, "remat": "q8"},
                     mesh_shape=(1, 4, 1),
                     mesh_axes=("data", "seq", "model"), steps=2)
    for r in res:
        l1, l2 = r["losses"]
        np.testing.assert_allclose(l1, float(want), rtol=TOL)
        assert l2 < l1


def test_transformer_cp_mode_alltoall():
    jcfg = jtt.TransformerConfig(**{**CFG, "max_len": 32},
                                 dtype=jnp.float32)
    params, inp = _lm_inputs(jcfg, seed=0, B=2, T=32)
    want = np.asarray(jtt.forward(params, jnp.asarray(inp["toks"],
                                                      jnp.int32), jcfg))
    res = pool().run("case_lm", inputs=inp,
                     cfg={**CFG, "use_ring_attention": True,
                          "cp_mode": "alltoall"},
                     mesh_shape=(2, 2), mesh_axes=("data", "seq"),
                     want="logits")
    for r in res:
        _close(r["logits"], want, "logits")


def test_cp_mode_validated():
    import paddle_tpu_torch.models.transformer as tt
    with pytest.raises(ValueError, match="cp_mode"):
        dataclasses.replace(jtt.TransformerConfig(**CFG), cp_mode="ulysses")
    with pytest.raises(ValueError, match="cp_mode"):
        tt.TransformerConfig(**CFG, cp_mode="ulysses")
    c = tt.TransformerConfig(**CFG, use_ring_attention=True,
                             cp_mode="alltoall")
    assert c.use_ring_attention and c.cp_mode == "alltoall"


# ---------------------------------------------------------------------------
# the int8 wire
# ---------------------------------------------------------------------------

class TestWireInt8:
    def test_codes_and_hops_equal_jax(self):
        """The port's quantized hop and all-to-all against the JAX
        package's under ``shard_map`` on 4 devices: equal exactly (codes,
        scales, and the dequantized values each rank receives)."""
        from jax.sharding import Mesh, PartitionSpec as P

        from paddle_tpu.parallel.compat import shard_map
        rng = np.random.RandomState(11)
        x = (rng.randn(4, 2, 8, 4) * rng.rand(4, 1, 1, 1) * 3).astype(
            np.float32)
        y = rng.randn(4, 4, 3, 5).astype(np.float32)
        mesh = Mesh(np.array(jax.devices()[:4]), ("seq",))
        perm = [(i, (i + 1) % 4) for i in range(4)]
        hop = shard_map(lambda a: jq8.ppermute_q8_raw(a[0], "seq", perm)[None],
                        mesh=mesh, in_specs=P("seq"), out_specs=P("seq"),
                        check_vma=False)(jnp.asarray(x))
        a2a = shard_map(lambda a: jq8.all_to_all_q8_raw(a[0], "seq")[None],
                        mesh=mesh, in_specs=P("seq"), out_specs=P("seq"),
                        check_vma=False)(jnp.asarray(y))
        res = pool().run("case_wire", inputs={"x": x, "y": y})
        for r, got in enumerate(res):
            xf = jnp.asarray(x[r])
            sc = jnp.maximum(jnp.max(jnp.abs(xf)), 1e-8) / 127.0
            codes = np.asarray(jq8._quantize(xf / sc))
            np.testing.assert_array_equal(got["codes"], codes)
            assert got["scale"] == float(sc)
            np.testing.assert_array_equal(got["hop"], np.asarray(hop[r]))
            np.testing.assert_array_equal(got["a2a"], np.asarray(a2a[r]))
            # int8 payloads cross the wire: one byte a value
            wire = [w for w in got["wire"] if w[1] == "wire_int8"]
            assert ("ppermute", "wire_int8", x[r].size) in wire
            assert ("all_to_all", "wire_int8", y[r].size) in wire

    def test_ring_attention_wire_int8_close(self):
        inp = _qkv(12, 2, 32, 2, 8, scale=0.5)
        want, g = _full(inp, True, grads=True)
        for r in pool().run("case_ring_wire_grads", inputs=inp):
            rel = np.abs(r["out"] - want).max() / np.abs(want).max()
            assert rel < 0.05, rel
            for n in ("dq", "dk", "dv"):
                assert np.isfinite(r[n]).all() and np.abs(r[n]).max() > 0

    def test_flash_ring_wire_int8_close(self):
        inp = _qkv(13, 1, 64, 2, 16, scale=0.5)
        want, g = _full(inp, True, grads=True)
        for r in pool().run("case_ring_wire_grads", inputs=inp,
                            use_flash=True):
            rel = np.abs(r["out"] - want).max() / np.abs(want).max()
            assert rel < 0.05, rel
            for n, gw in zip(("dq", "dk", "dv"), g):
                rr = np.abs(r[n] - gw).max() / np.abs(gw).max()
                assert rr < 0.08, (n, rr)

