"""The transformer's layer remat (``cfg.remat`` "bf16" / "q8",
``paddle_tpu_torch/ops/q8.q8_remat``) against ``paddle_tpu``'s on the
CPU: the counterparts of ``tests/test_ring_transformer.py``'s
``TestLayerRemat`` (less the ring-attention case, which is
``tests/test_torch_ring.py::test_remat_composes_with_ring_flash``) and of
``test_moe_composes_with_layer_remat``.

Tolerances: the remat forward is the plain forward bitwise (the stash
is read by the backward only); the remat gradients within the
reference's bounds of the port's own "none" gradients (0.02 bf16, 0.08
q8, worst leaf relative to its max) and within 1e-4 of JAX's remat
gradients, which rebuild each block at the same stash (fp32 model, the
two packages' x differ by ulps, so a stash element can round the other
way: one bf16 ulp or one int8 step of x~, observed up to 9.4e-5 of a
leaf's max).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import transformer as jt
from paddle_tpu_torch.models import transformer as tt
from paddle_tpu_torch.ops import q8 as tq8
from tests.torch_ops_util import scaled_err

torch.set_num_threads(1)

JAX_TOL = 1e-4
REF_TOL = {"bf16": 0.02, "q8": 0.08}


def _setup(max_len=64, T=32, **kw):
    base = dict(vocab=64, d_model=32, n_heads=4, n_layers=3, d_ff=64,
                max_len=max_len, **kw)
    jcfg = jt.TransformerConfig(dtype=jnp.float32, **base)
    tcfg = tt.TransformerConfig(dtype=torch.float32, **base)
    jp = jt.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.RandomState(0)
    toks = rng.randint(0, 64, (2, T)).astype(np.int32)
    tgt = rng.randint(0, 64, (2, T)).astype(np.int32)
    return jcfg, tcfg, jp, toks, tgt


def _port_grads(jp, tcfg, toks, tgt, generator=None):
    tp = tt.train_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                    device="cpu")
    loss = tt.lm_loss(tp, torch.from_numpy(toks), torch.from_numpy(tgt),
                      tcfg, generator=generator)
    loss.backward()
    flat = {k: v.grad for k, v in tp.items() if k != "blocks"}
    flat.update({f"blocks/{k}": v.grad for k, v in tp["blocks"].items()})
    return loss.detach(), flat


def _jax_grads(jp, jcfg, toks, tgt):
    loss, g = jax.value_and_grad(jt.lm_loss)(jp, jnp.asarray(toks),
                                             jnp.asarray(tgt), jcfg)
    flat = {"/".join(p.key for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(g)}
    return loss, flat


def _worst(a, b):
    """The worst leaf's max |a - b| over the max |b|."""
    return max(float((a[k].float() - b[k].float()).abs().max())
               / (float(b[k].abs().max()) + 1e-9) for k in b)


@pytest.mark.parametrize("mode", ["bf16", "q8"])
def test_forward_exact_grads_close(mode):
    jcfg, tcfg, jp, toks, tgt = _setup()
    ref_l, ref_g = _port_grads(jp, tcfg, toks, tgt)
    rcfg = dataclasses.replace(tcfg, remat=mode)
    loss, g = _port_grads(jp, rcfg, toks, tgt)
    assert float(loss) == float(ref_l), "remat changed the forward"
    worst = _worst(g, ref_g)
    assert worst < REF_TOL[mode], f"remat={mode} worst grad rel err {worst}"
    jl, jg = _jax_grads(jp, dataclasses.replace(jcfg, remat=mode), toks, tgt)
    assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
    for k in jg:
        err = scaled_err(g[k], jg[k])
        assert err <= JAX_TOL, f"remat={mode} grad {k}: {err} vs JAX"


def test_saved_bytes_shrink():
    """The counterpart of ``test_temp_memory_shrinks``: the bytes saved
    for backward (distinct storages, under ``saved_tensors_hooks``) at
    T = 512; q8 saves under half of "none"'s, bf16 between the two."""
    jcfg, tcfg, jp, _, _ = _setup(max_len=512, T=512)
    toks = np.random.RandomState(1).randint(0, 64, (2, 512)).astype(np.int32)
    tp = tt.train_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                    device="cpu")

    def saved(mode):
        seen = {}

        def pack(t):
            if t.requires_grad and t.is_leaf:
                return t                      # a parameter, not a saving
            seen[t.untyped_storage().data_ptr()] = \
                t.untyped_storage().nbytes()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            tt.lm_loss(tp, torch.from_numpy(toks), torch.from_numpy(toks),
                       dataclasses.replace(tcfg, remat=mode))
        return sum(seen.values())

    none, bf16, q8r = saved("none"), saved("bf16"), saved("q8")
    assert q8r < 0.5 * none, (none, q8r)
    assert q8r < bf16 < none, (none, bf16, q8r)


def test_dropout_masks_redrawn_in_the_recompute():
    """With dropout, the recompute restores the generator: a bf16 model
    with a bf16 stash rebuilds each block at x itself, so the remat
    gradients equal the plain ones (to the summation order of the
    weight gradients), and the forward is the plain forward bitwise;
    the generator ends where the plain forward leaves it."""
    base = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                max_len=64, dropout=0.2, dtype=torch.bfloat16)
    rng = np.random.RandomState(3)
    toks = torch.from_numpy(rng.randint(0, 64, (2, 16)).astype(np.int32))
    runs = {}
    for mode in ("none", "bf16"):
        cfg = tt.TransformerConfig(remat=mode, **base)
        tp = tt.init_train_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu")
        gen = torch.Generator().manual_seed(11)
        loss = tt.lm_loss(tp, toks, toks, cfg, generator=gen)
        loss.backward()
        runs[mode] = (loss.detach(), {k: v.grad for k, v in
                                      tp["blocks"].items()},
                      gen.get_state())
    assert torch.equal(runs["none"][0], runs["bf16"][0])
    assert torch.equal(runs["none"][2], runs["bf16"][2])
    worst = _worst(runs["bf16"][1], runs["none"][1])
    assert worst < 1e-5, worst


def test_moe_composes_with_layer_remat():
    """MoE FFN + remat: both block outputs (x and the aux scalar) get
    their cotangents. bf16 stash: per-leaf within 0.05 of the port's
    "none" and the global relative L2 under 0.02 (the reference's); q8:
    relative L2 under 0.3 and cosine over 0.95 (the reference's: a
    stash perturbation may flip a near-tie routing); each mode's
    gradients within 1e-4 of JAX's same mode, 1e-3 for q8 (the
    recompute at x~ routes each token again: an int8 step of x~ that
    rounds the other way moves a gate's probabilities by ~1e-3 of
    their spread, observed 1.7e-4 of a leaf's max)."""
    kw = dict(vocab=50, d_model=32, n_heads=4, n_layers=2, d_ff=64,
              max_len=32, moe_experts=4, moe_capacity_factor=4.0)
    jcfg = jt.TransformerConfig(dtype=jnp.float32, **kw)
    tcfg = tt.TransformerConfig(dtype=torch.float32, **kw)
    jp = jt.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.RandomState(1234)
    toks = rng.randint(0, 50, (4, 16)).astype(np.int32)
    tgt = rng.randint(0, 50, (4, 16)).astype(np.int32)
    ld, gd = _port_grads(jp, tcfg, toks, tgt)
    fd = torch.cat([gd[k].reshape(-1) for k in sorted(gd)])
    for mode in ("bf16", "q8"):
        lr, gr = _port_grads(jp, dataclasses.replace(tcfg, remat=mode),
                             toks, tgt)
        assert float(lr) == float(ld)
        fr = torch.cat([gr[k].reshape(-1) for k in sorted(gr)])
        rel = float((fr - fd).norm() / fd.norm())
        cos = float(fr @ fd / (fr.norm() * fd.norm()))
        if mode == "bf16":
            assert rel < 0.02, rel
            assert _worst(gr, gd) < 0.05
        else:
            assert rel < 0.30 and cos > 0.95, (rel, cos)
        assert float(gr["blocks/gate"].abs().max()) > 0
        _, jg = _jax_grads(jp, dataclasses.replace(jcfg, remat=mode), toks,
                           tgt)
        tol = JAX_TOL if mode == "bf16" else 1e-3
        for k in jg:
            err = scaled_err(gr[k], jg[k])
            assert err <= tol, f"remat={mode} grad {k}: {err} vs JAX"


def test_stash_is_the_references():
    """``q8_remat``'s stash: int8 with one per-tensor scale
    ``max(amax, 1e-6) / 127`` (the codes JAX's for the same x), or the
    bf16 cast; a bad stash name raises."""
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 8, 16).astype(
        np.float32))
    seen = []

    def fn(x_, w):
        return x_ * w

    w = torch.ones(16, requires_grad=True)
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: seen.append(t) or t, lambda t: t):
        tq8.q8_remat(fn, "int8")(x.clone().requires_grad_(), w)
    q, scale = seen[0], seen[1]
    amax = float(jnp.max(jnp.abs(jnp.asarray(x.numpy()))))
    jq = np.clip(np.round(x.numpy() / (max(amax, 1e-6) / 127.0)), -127,
                 127).astype(np.int8)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), jq)
    assert float(scale) == np.float32(max(amax, 1e-6)) / np.float32(127.0)
    with pytest.raises(ValueError, match="stash"):
        tq8.q8_remat(fn, "fp8")
