"""The port's MoE (``paddle_tpu_torch/parallel/moe.py``, the dense path)
and the MoE transformer against ``paddle_tpu``'s on the CPU.

- ``moe_ffn`` at top-1 and top-2: the unsharded cases of
  ``tests/test_moe_pipeline.py``'s ``TestMoE`` and ``TestTopKMoE``, each
  held against the JAX function on the same numpy draws (outputs, aux
  and gradients within 1e-5 of max(1, max|JAX value|)); the mesh paths
  run on gloo ranks in ``tests/test_torch_parallel_pipeline.py``.
- The transformer with experts: ``tests/test_ring_transformer.py``'s
  ``TestMoETransformer`` cases (less the sharded train step), the loss
  and every gradient against JAX's (1e-4), and every serving step with
  experts (lockstep and slot decode, paged decode, verify, chunk and
  slot prefill) against JAX's (logits and pools within 1e-4). The JAX
  package has no test of its paged MoE steps: each is first held to the
  JAX package's own ``forward`` here (ROADMAP C5).
- A JAX-exported v4 MoE artifact serves the JAX engine's ids in the
  port; the port's save / load round trip serves its in-process ids;
  ``quantize_lm_params`` refuses an expert tree, as the JAX one does.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.io import lm_serving as jlm
from paddle_tpu.models import transformer as jt
from paddle_tpu.parallel import moe as jmoe
from paddle_tpu_torch.io import lm_serving as tlm
from paddle_tpu_torch.models import transformer as tt
from paddle_tpu_torch.parallel import moe as tmoe
from tests.torch_ops_util import as_np, scaled_err

torch.set_num_threads(1)

TOL = 1e-5
STEP_TOL = 1e-4
BS = 8


def _close(got, want, tol=TOL, label=""):
    err = scaled_err(got, want)
    assert err <= tol, f"{label}: scaled error {err} > {tol}"


def _cfg_pair(**kw):
    return jmoe.MoEConfig(**kw), tmoe.MoEConfig(**kw)


def _params(jcfg, seed):
    jp = jmoe.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def _both(jcfg, tcfg, seed, x, grad=False):
    """moe_ffn in both packages on the same params and tokens: ((out,
    aux), (out, aux)) and, with ``grad``, the gradients of sum(out * c)
    + aux by every parameter and x."""
    jp, tp = _params(jcfg, seed)
    jo = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg)
    if not grad:
        return jo, tmoe.moe_ffn(tp, torch.from_numpy(x), tcfg)
    c = np.random.RandomState(9).randn(*x.shape).astype(np.float32)

    def jloss(p, xx):
        o, a = jmoe.moe_ffn(p, xx, jcfg)
        return jnp.sum(o * c) + a

    jg = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: v.requires_grad_() for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    to = tmoe.moe_ffn(tp, tx, tcfg)
    g = torch.autograd.grad((to[0] * torch.from_numpy(c)).sum() + to[1],
                            [tp["gate"], tp["w_in"], tp["w_out"], tx])
    return jo, to, jg, g


class TestMoE:
    CFG = dict(d_model=8, d_ff=16, num_experts=4, capacity_factor=2.0)

    def test_dense_equivalence_single_expert_path(self, rng):
        """Capacity >= N: the output is each token's expert FFN times its
        gate, in both packages."""
        jcfg, tcfg = _cfg_pair(d_model=8, d_ff=16, num_experts=4,
                               capacity_factor=8.0)
        x = rng.randn(16, 8).astype(np.float32)
        (jo, ja), (to, ta) = _both(jcfg, tcfg, 0, x)
        _, tp = _params(jcfg, 0)
        logits = x @ tp["gate"].numpy()
        p = np.exp(logits - logits.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        want = np.zeros((16, 8), np.float32)
        for n in range(16):
            e = p[n].argmax()
            h = torch.nn.functional.gelu(torch.from_numpy(
                x[n] @ tp["w_in"][e].numpy()), approximate="tanh").numpy()
            want[n] = (h @ tp["w_out"][e].numpy()) * p[n].max()
        np.testing.assert_allclose(as_np(to), want, rtol=1e-4, atol=1e-5)
        _close(to, jo, label="out")
        _close(ta, ja, label="aux")
        assert float(ta) > 0

    def test_capacity_drops_overflow(self, rng):
        jcfg, tcfg = _cfg_pair(d_model=4, d_ff=8, num_experts=2,
                               capacity_factor=0.25)   # cap = 2 tokens
        x = rng.randn(16, 4).astype(np.float32)
        (jo, _), (to, _) = _both(jcfg, tcfg, 1, x)
        out = as_np(to)
        assert np.sum(np.all(out == 0, axis=1)) >= 12     # <= 4 kept
        np.testing.assert_array_equal(np.all(out == 0, axis=1),
                                      np.all(np.asarray(jo) == 0, axis=1))
        _close(to, jo, label="out")

    @pytest.mark.parametrize("top_k", [1, 2])
    def test_outputs_and_gradients_match(self, top_k, rng):
        """Tight capacity (drops occur), top-1 and top-2: output, aux and
        the gradients of the gate, both expert weights and the tokens."""
        jcfg, tcfg = _cfg_pair(d_model=8, d_ff=16, num_experts=4,
                               capacity_factor=1.0, top_k=top_k)
        x = rng.randn(32, 8).astype(np.float32)
        jo, to, jg, tg = _both(jcfg, tcfg, 2, x, grad=True)
        _close(to[0], jo[0], label="out")
        _close(to[1], jo[1], label="aux")
        jgs = [jg[0]["gate"], jg[0]["w_in"], jg[0]["w_out"], jg[1]]
        for name, a, b in zip(("gate", "w_in", "w_out", "x"), tg, jgs):
            _close(a, b, label=f"grad {name}")

    def test_router_trains_toward_balance(self, rng):
        """60 SGD steps of the port (the reference's case): the loss falls
        below 0.8 of its start; the first loss and gradients are JAX's."""
        jcfg, tcfg = _cfg_pair(d_model=8, d_ff=16, num_experts=4,
                               capacity_factor=1.0, aux_loss_weight=0.1)
        x = rng.randn(64, 8).astype(np.float32)
        w_true = rng.randn(8, 8).astype(np.float32) * 0.5
        y = np.tanh(x @ w_true)
        jp, tp = _params(jcfg, 3)

        def jloss(p):
            out, aux = jmoe.moe_ffn(p, jnp.asarray(x), jcfg)
            return jnp.mean((out - y) ** 2) + aux

        jl, jg = jax.value_and_grad(jloss)(jp)
        tp = {k: v.requires_grad_() for k, v in tp.items()}
        hist = []
        for i in range(60):
            out, aux = tmoe.moe_ffn(tp, torch.from_numpy(x), tcfg)
            loss = ((out - torch.from_numpy(y)) ** 2).mean() + aux
            g = torch.autograd.grad(loss, list(tp.values()))
            if i == 0:
                _close(loss, jl, label="loss")
                for (k, _), gg in zip(tp.items(), g):
                    _close(gg, jg[k], label=f"grad {k}")
            with torch.no_grad():
                for v, gg in zip(tp.values(), g):
                    v -= 0.1 * gg
            hist.append(float(loss))
        assert hist[-1] < hist[0] * 0.8

    def test_mesh_paths_raise_a10(self):
        """Ported (the name is kept): the experts' layout is the JAX
        package's, a mesh without an ``expert`` axis leaves ``moe_ffn``
        dense (the JAX constraints are no-ops there), and the
        all-to-all form refuses such a mesh as the JAX one does. The
        sharded paths run on gloo ranks in
        ``tests/test_torch_parallel_pipeline.py``."""
        class NoExpertMesh:
            mesh_dim_names = ("data",)
            shape = (1,)

        jcfg, tcfg = _cfg_pair(**self.CFG)
        _, tp = _params(jcfg, 0)
        x = torch.from_numpy(np.random.RandomState(0).randn(8, 8)
                             .astype(np.float32))
        got = tmoe.moe_ffn(tp, x, tcfg, mesh=NoExpertMesh())
        want = tmoe.moe_ffn(tp, x, tcfg)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        lays = tmoe.param_shardings(tcfg, NoExpertMesh())
        assert {k: tuple(v.spec) for k, v in lays.items()} == {
            "gate": (), "w_in": ("expert", None, None),
            "w_out": ("expert", None, None)}
        with pytest.raises(ValueError, match="expert"):
            tmoe.moe_ffn_a2a(tp, x, tcfg, NoExpertMesh())

    def test_init_params_shapes_and_scales(self):
        """JAX's shapes, fp32, normal draws at JAX's scales (each
        leaf's sample std within 5 % of its scale: >= 4096 draws, about
        4.5 standard errors)."""
        kw = dict(d_model=256, d_ff=512, num_experts=16)
        p = tmoe.init_params(tmoe.MoEConfig(**kw),
                             torch.Generator().manual_seed(0), device="cpu")
        jp = jmoe.init_params(jax.random.PRNGKey(0), jmoe.MoEConfig(**kw))
        scale = {"gate": 256 ** -0.5, "w_in": 256 ** -0.5,
                 "w_out": 512 ** -0.5}
        for k in p:
            assert tuple(p[k].shape) == tuple(jp[k].shape)
            assert p[k].dtype == torch.float32
            assert abs(float(p[k].std()) / scale[k] - 1) < 0.05


class TestTopKMoE:
    def _manual(self, x, tp, k):
        logits = x @ tp["gate"].numpy()
        p = np.exp(logits - logits.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        want = np.zeros(x.shape, np.float32)
        for n in range(x.shape[0]):
            top = np.argsort(-p[n], kind="stable")[:k]
            g = p[n][top] / (p[n][top].sum() if k > 1 else 1.0)
            for e, gv in zip(top, g):
                h = torch.nn.functional.gelu(torch.from_numpy(
                    x[n] @ tp["w_in"][e].numpy()), approximate="tanh")
                want[n] += gv * (h.numpy() @ tp["w_out"][e].numpy())
        return want

    @pytest.mark.parametrize("top_k", [1, 2], ids=["top1_path_unchanged",
                                                   "top2_dense_equivalence"])
    def test_dense_equivalence(self, top_k, rng):
        """Capacity ample: the sum over the picked experts of the
        (renormalized, at k = 2) gate times the expert's FFN."""
        jcfg, tcfg = _cfg_pair(d_model=8, d_ff=16, num_experts=4,
                               capacity_factor=8.0, top_k=top_k)
        x = rng.randn(16, 8).astype(np.float32)
        (jo, ja), (to, ta) = _both(jcfg, tcfg, 0, x)
        _, tp = _params(jcfg, 0)
        np.testing.assert_allclose(as_np(to), self._manual(x, tp, top_k),
                                   rtol=1e-4, atol=1e-5)
        _close(to, jo, label="out")
        _close(ta, ja, label="aux")
        assert float(ta) > 0

    def test_first_choices_keep_priority(self, rng):
        jcfg, tcfg = _cfg_pair(d_model=4, d_ff=8, num_experts=2,
                               capacity_factor=0.5, top_k=2)
        N = 16
        x = rng.randn(N, 4).astype(np.float32)
        (jo, _), (to, _) = _both(jcfg, tcfg, 1, x)
        _, tp = _params(jcfg, 1)
        first = (x @ tp["gate"].numpy()).argmax(-1)
        cap = int(0.5 * 2 * N / 2)
        out = as_np(to)
        count = {0: 0, 1: 0}
        for n in range(N):
            e = first[n]
            if count[e] < cap:
                assert np.abs(out[n]).sum() > 0, n
            count[e] += 1
        _close(to, jo, label="out")

    def test_top2_utilization_balances_under_training(self, rng):
        """The reference's case without its mesh (its sharded form is
        racy under load, ROADMAP C5; the port's sharded run is in
        ``tests/test_torch_parallel_pipeline.py``): 60 steps of
        top-2 training with aux weight 0.5 in both packages; no expert
        below half its fair share of first choices in either."""
        jcfg, tcfg = _cfg_pair(d_model=8, d_ff=16, num_experts=4,
                               capacity_factor=2.0, top_k=2,
                               aux_loss_weight=0.5)
        x = rng.randn(128, 8).astype(np.float32)
        y = np.tanh(x @ (rng.randn(8, 8).astype(np.float32) * 0.5))
        jp, tp = _params(jcfg, 3)

        @jax.jit
        def jstep(p):
            def loss(p_):
                out, aux = jmoe.moe_ffn(p_, jnp.asarray(x), jcfg)
                return jnp.mean((out - y) ** 2) + aux
            g = jax.grad(loss)(p)
            return jax.tree_util.tree_map(lambda w, gr: w - 0.1 * gr, p, g)

        tp = {k: v.requires_grad_() for k, v in tp.items()}
        for _ in range(60):
            jp = jstep(jp)
            out, aux = tmoe.moe_ffn(tp, torch.from_numpy(x), tcfg)
            loss = ((out - torch.from_numpy(y)) ** 2).mean() + aux
            g = torch.autograd.grad(loss, list(tp.values()))
            with torch.no_grad():
                for v, gg in zip(tp.values(), g):
                    v -= 0.1 * gg
        for gate in (np.asarray(jp["gate"]), tp["gate"].detach().numpy()):
            frac = np.bincount((x @ gate).argmax(-1), minlength=4) / 128
            assert frac.min() > 0.125, frac


# ---------------------------------------------------------------------------
# the MoE transformer

KW = dict(vocab=50, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_len=32,
          moe_experts=4, moe_capacity_factor=4.0)


def _tcfgs(**kw):
    kw = dict(KW, **kw)
    return (jt.TransformerConfig(dtype=jnp.float32, **kw),
            tt.TransformerConfig(dtype=torch.float32, **kw))


def _tparams(jcfg, tcfg, seed=0, train=False):
    jp = jt.init_params(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    if train:
        return jp, tt.train_params_from_numpy(tree, device="cpu")
    return jp, tt.params_from_numpy(tree, tcfg, device="cpu")


def _leaf_grads(jg, tp):
    for path, g in jax.tree_util.tree_leaves_with_path(jg):
        t = tp
        for p in path:
            t = t[p.key]
        yield "/".join(p.key for p in path), t.grad, g


class TestMoETransformer:
    def test_config_and_params(self):
        jcfg, tcfg = _tcfgs(moe_top_k=2)
        assert tcfg.moe_cfg() == tmoe.MoEConfig(
            d_model=32, d_ff=64, num_experts=4, capacity_factor=4.0,
            aux_loss_weight=0.01, top_k=2)
        assert tcfg.serving_moe_cfg().capacity_factor == 2.0
        tp = tt.init_params(tcfg, torch.Generator().manual_seed(0),
                            device="cpu")
        jp = jt.init_params(jax.random.PRNGKey(0), jcfg)
        assert {k: tuple(v.shape) for k, v in tp["blocks"].items()} == \
            {k: tuple(v.shape) for k, v in jp["blocks"].items()}
        for k in ("gate", "moe_w_in", "moe_w_out"):
            assert tp["blocks"][k].dtype == torch.float32
        back = tt.params_to_numpy(tt.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu"))
        for k in ("gate", "moe_w_in", "moe_w_out"):
            np.testing.assert_array_equal(back["blocks"][k],
                                          np.asarray(jp["blocks"][k]))

    def test_single_expert_matches_dense(self, rng):
        dense_j, dense_t = (
            jt.TransformerConfig(dtype=jnp.float32, **dict(
                KW, moe_experts=0)),
            tt.TransformerConfig(dtype=torch.float32, **dict(
                KW, moe_experts=0)))
        cfg1_j, cfg1_t = _tcfgs(moe_experts=1, moe_capacity_factor=64.0)
        dense = jt.init_params(jax.random.PRNGKey(0), dense_j)
        p1 = jt.init_params(jax.random.PRNGKey(0), cfg1_j)
        for k in ("embed", "pos", "ln_f", "ln_f_b"):
            p1[k] = dense[k]
        for k in ("ln1", "ln1_b", "qkv", "attn_out", "ln2", "ln2_b"):
            p1["blocks"][k] = dense["blocks"][k]
        p1["blocks"]["moe_w_in"] = dense["blocks"]["mlp_in"][:, None]
        p1["blocks"]["moe_w_out"] = dense["blocks"]["mlp_out"][:, None]
        toks = rng.randint(0, 50, (2, 16)).astype(np.int32)
        a = tt.forward(tt.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, dense), dense_t,
            device="cpu"), torch.from_numpy(toks), dense_t)
        b = tt.forward(tt.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, p1), cfg1_t, device="cpu"),
            torch.from_numpy(toks), cfg1_t)
        np.testing.assert_allclose(as_np(a), as_np(b), rtol=2e-5, atol=2e-5)
        _close(b, jt.forward(p1, jnp.asarray(toks), cfg1_j), STEP_TOL)

    @pytest.mark.parametrize("top_k", [1, 2])
    def test_moe_lm_learns_with_aux(self, top_k, rng):
        """aux > 0 and JAX's; the loss and every gradient JAX's (1e-4);
        30 SGD steps of the port bring the loss below 0.6 of its
        start."""
        jcfg, tcfg = _tcfgs(moe_top_k=top_k)
        jp, tp = _tparams(jcfg, tcfg, train=True)
        z = np.zeros((2, 8), np.int32)
        _, ja = jt.forward(jp, jnp.asarray(z), jcfg, return_aux=True)
        _, ta = tt.forward(tp, torch.from_numpy(z), tcfg, return_aux=True)
        assert float(ta) > 0
        _close(ta, ja, label="aux")
        B, T = 8, 16
        toks = (rng.randint(0, 50, (B, 1)) + np.arange(T)[None, :]) % 50
        tgt = ((toks + 1) % 50).astype(np.int32)
        toks = toks.astype(np.int32)
        jl, jg = jax.value_and_grad(jt.lm_loss)(
            jp, jnp.asarray(toks), jnp.asarray(tgt), jcfg)
        hist = []
        for i in range(30):
            loss = tt.lm_loss(tp, torch.from_numpy(toks),
                              torch.from_numpy(tgt), tcfg)
            loss.backward()
            if i == 0:
                _close(loss, jl, STEP_TOL, "loss")
                for name, a, b in _leaf_grads(jg, tp):
                    _close(a, b, STEP_TOL, f"grad {name}")
            with torch.no_grad():
                for t in [tp[k] for k in tp if k != "blocks"] + list(
                        tp["blocks"].values()):
                    t -= 0.1 * t.grad
                    t.grad = None
            hist.append(float(loss))
        assert hist[-1] < hist[0] * 0.6, (hist[0], hist[-1])

    @pytest.mark.parametrize("top_k", [1, 2])
    def test_moe_decode_matches_forward(self, top_k, rng):
        """The lockstep decode (serving capacity E / k) reproduces the
        full forward position by position, and JAX's decode steps."""
        jcfg, tcfg = _tcfgs(d_model=16, n_heads=2, d_ff=32, max_len=24,
                            moe_top_k=top_k)
        jp, tp = _tparams(jcfg, tcfg)
        B, T = 2, 8
        toks = rng.randint(0, 50, (B, T)).astype(np.int32)
        want = tt.forward(tp, torch.from_numpy(toks), tcfg)
        jcache = jt.init_cache(jcfg, B, 16)
        cache = tt.init_cache(tcfg, B, 16, device="cpu")
        for t in range(T):
            lg, cache = tt.decode_step(tp, cache, torch.from_numpy(
                toks[:, t]), t, tcfg)
            jl, jcache = jt.decode_step(jp, jcache, jnp.asarray(toks[:, t]),
                                        jnp.asarray(t, jnp.int32), jcfg)
            np.testing.assert_allclose(as_np(lg), as_np(want[:, t]),
                                       rtol=2e-4, atol=2e-4)
            _close(lg, jl, STEP_TOL, f"decode logits {t}")


# ---------------------------------------------------------------------------
# the serving steps with experts


def _pool(rng, cfg, nblocks):
    shape = (cfg.n_layers, cfg.kv_heads, nblocks * BS, cfg.head_dim)
    return {n: rng.randn(*shape).astype(np.float32) * 0.5 for n in "kv"}


def _prefill_both(jp, tp, jcfg, tcfg, prompt, pages, nblocks):
    """The prompt prefilled in chunks of 8 (the last padded) into both
    packages' zeroed pools: (JAX logits, pool), (port logits, pool)."""
    jpool = {n: jnp.zeros((jcfg.n_layers, jcfg.kv_heads, nblocks * BS,
                           jcfg.head_dim)) for n in "kv"}
    tpool = tt.init_block_pool(tcfg, nblocks, BS, device="cpu")
    off = 0
    while off < len(prompt):
        c = min(8, len(prompt) - off)
        padded = np.zeros((1, 8), np.int32)
        padded[0, :c] = prompt[off:off + c]
        pv = pages[:off // BS + 1]
        jl, jpool = jt.prefill_into_blocks(
            jp, jpool, jnp.asarray(padded), jnp.asarray(c, jnp.int32),
            jnp.asarray(pv), jcfg, block_size=BS, pallas="off")
        tl, tpool = tt.prefill_into_blocks(
            tp, tpool, torch.from_numpy(padded), c, torch.from_numpy(pv),
            tcfg, block_size=BS)
        off += c
    return (jl, jpool), (tl, tpool)


@pytest.mark.parametrize("top_k", [1, 2])
def test_paged_steps_match(top_k, rng):
    """Chunk prefill, paged decode and a verify window with experts:
    the JAX package's paged steps against its own ``forward`` first
    (they have no JAX test), then the port's against JAX's (logits and
    pools within 1e-4)."""
    jcfg, tcfg = _tcfgs(max_len=64, moe_top_k=top_k)
    jp, tp = _tparams(jcfg, tcfg)
    nblocks = 8
    prompt = rng.randint(0, 50, 19).astype(np.int32)
    pages = np.asarray([5, 2, 7, 1], np.int32)
    (jl, jpool), (tl, tpool) = _prefill_both(jp, tp, jcfg, tcfg, prompt,
                                             pages, nblocks)
    full = np.asarray(jt.forward(jp, jnp.asarray(prompt[None]), jcfg))
    np.testing.assert_allclose(np.asarray(jl)[0], full[0, -1], atol=2e-4)
    _close(tl, jl, STEP_TOL, "prefill logits")
    for n in "kv":
        _close(tpool[n], jpool[n], STEP_TOL, f"prefill pool {n}")
    # one decode step at position 19, then a 3-token verify window
    nxt = np.asarray([int(np.argmax(full[0, -1]))], np.int32)
    seq = np.concatenate([prompt, nxt])
    full2 = np.asarray(jt.forward(jp, jnp.asarray(seq[None]), jcfg))
    pos = np.asarray([19], np.int32)
    act = np.asarray([True])
    jd, jpool = jt.decode_step_paged(
        jp, jpool, jnp.asarray(nxt), jnp.asarray(pos), jnp.asarray(act),
        jnp.asarray(pages[None]), jcfg, block_size=BS, pallas="off")
    td, tpool = tt.decode_step_paged(
        tp, tpool, torch.from_numpy(nxt), torch.from_numpy(pos),
        torch.from_numpy(act), torch.from_numpy(pages[None]), tcfg,
        block_size=BS)
    np.testing.assert_allclose(np.asarray(jd)[0], full2[0, -1], atol=2e-4)
    _close(td, jd, STEP_TOL, "decode logits")
    win = rng.randint(0, 50, (1, 3)).astype(np.int32)
    vpos = np.asarray([20], np.int32)
    valid = np.asarray([3], np.int32)
    jv, jpool = jt.verify_step_paged(
        jp, jpool, jnp.asarray(win), jnp.asarray(vpos), jnp.asarray(valid),
        jnp.asarray(act), jnp.asarray(pages[None]), jcfg, block_size=BS)
    tv, tpool = tt.verify_step_paged(
        tp, tpool, torch.from_numpy(win), torch.from_numpy(vpos),
        torch.from_numpy(valid), torch.from_numpy(act),
        torch.from_numpy(pages[None]), tcfg, block_size=BS)
    full3 = np.asarray(jt.forward(jp, jnp.asarray(
        np.concatenate([seq, win[0]])[None]), jcfg))
    np.testing.assert_allclose(np.asarray(jv)[0], full3[0, 20:23],
                               atol=2e-4)
    _close(tv, jv, STEP_TOL, "verify logits")
    for n in "kv":
        _close(tpool[n], jpool[n], STEP_TOL, f"pool {n}")


@pytest.mark.parametrize("top_k", [1, 2])
def test_slot_steps_match(top_k, rng):
    """The slot path with experts: a slot prefill (the training
    capacity, as JAX's) and two slot decode steps (serving capacity)
    against JAX's."""
    jcfg, tcfg = _tcfgs(max_len=64, moe_top_k=top_k)
    jp, tp = _tparams(jcfg, tcfg)
    padded = np.zeros((1, 8), np.int32)
    padded[0, :6] = rng.randint(0, 50, 6)
    jarena = jt.init_cache(jcfg, 3, 24)
    jl, jarena = jt.prefill_into_slot(jp, jarena, jnp.asarray(padded),
                                      jnp.int32(6), jnp.int32(1), jcfg)
    tarena = tt.init_cache(tcfg, 3, 24, device="cpu")
    tl, tarena = tt.prefill_into_slot(
        tp, tarena, torch.from_numpy(padded),
        torch.tensor(6, dtype=torch.int32), torch.tensor(1,
                                                         dtype=torch.int32),
        tcfg)
    _close(tl, jl, STEP_TOL, "slot prefill")
    for i in range(2):
        tok = rng.randint(0, 50, 3).astype(np.int32)
        pos = np.asarray([3, 6 + i, 0], np.int32)
        active = np.asarray([False, True, False])
        jl, jarena = jt.decode_step_slots(jp, jarena, jnp.asarray(tok),
                                          jnp.asarray(pos),
                                          jnp.asarray(active), jcfg)
        tl, tarena = tt.decode_step_slots(
            tp, tarena, torch.from_numpy(tok), torch.from_numpy(pos),
            torch.from_numpy(active), tcfg)
        _close(tl[1], np.asarray(jl)[1], STEP_TOL, f"slot decode {i}")
    for n in "kv":
        _close(tarena[n], jarena[n], STEP_TOL, f"arena {n}")


def test_config_fields_carry_through_artifacts():
    """The MoE fields are config fields of both packages now: a stamped
    JAX config with experts loads as the port's, and back."""
    d = dict(KW, dtype="float32", cp_mode="ring", use_flash_attention=False,
             moe_top_k=2, moe_capacity_factor=1.5, moe_aux_weight=0.02)
    cfg = tlm._cfg_from_dict(d)
    assert (cfg.moe_experts, cfg.moe_top_k, cfg.moe_capacity_factor,
            cfg.moe_aux_weight) == (4, 2, 1.5, 0.02)
    back = tlm._cfg_to_dict(cfg)
    assert {k: back[k] for k in ("moe_experts", "moe_top_k")} == {
        "moe_experts": 4, "moe_top_k": 2}


def test_quantize_refuses_expert_trees():
    jcfg, tcfg = _tcfgs()
    jp = jt.init_params(jax.random.PRNGKey(0), jcfg)
    with pytest.raises(KeyError):
        jlm.quantize_lm_params(jp)
    with pytest.raises(KeyError, match="mlp_in"):
        tlm.quantize_lm_params(jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")


ART = dict(vocab=40, d_model=16, n_heads=2, n_kv_heads=1, n_layers=2,
           d_ff=32, max_len=64, use_rope=True, moe_experts=4)


def _serve(eng, prompts, temps):
    reqs = [eng.submit(p, max_new=8, temperature=t, top_k=20 if t else 0)
            for p, t in zip(prompts, temps)]
    eng.run_until_idle()
    return [list(map(int, r.tokens)) for r in reqs]


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_artifact_roundtrip(top_k, tmp_path):
    """A JAX v4 MoE artifact (exported with the Pallas kernels in
    interpret mode) served by the port's engine gives the JAX artifact
    engine's greedy and sampled ids; the greedy ids are JAX's
    ``generate``'s too. The port's save of the same weights loads and
    serves the in-process engine's ids."""
    from paddle_tpu_torch.serving import PagedDecodeEngine
    cfg = jt.TransformerConfig(dtype=jnp.float32, moe_top_k=top_k, **ART)
    params = jt.init_params(jax.random.PRNGKey(0), cfg)
    path = str(tmp_path / "jax-moe.tar")
    old = os.environ.get("PADDLE_TPU_PALLAS")
    os.environ["PADDLE_TPU_PALLAS"] = "interpret"
    try:
        jlm.save_lm_artifact(path, params, cfg, batch=3, prompt_len=8,
                             cache_len=32, engine_buckets=(8,),
                             engine_paged=True, engine_block_size=BS)
        rng = np.random.RandomState(1)
        prompts = [rng.randint(0, 40, n).astype(np.int32)
                   for n in (5, 9, 13)]
        temps = (0.0, 0.8, 0.0)
        want = _serve(jlm.load_lm_artifact(path).engine(seed=0), prompts,
                      temps)
    finally:
        if old is None:
            os.environ.pop("PADDLE_TPU_PALLAS")
        else:
            os.environ["PADDLE_TPU_PALLAS"] = old
    srv = tlm.load_lm_artifact(path)
    assert srv.cfg.moe_experts == 4 and srv.cfg.moe_top_k == top_k
    assert _serve(srv.engine(seed=0, device="cpu"), prompts, temps) == want
    for i in (0, 2):
        g = jt.generate(params, jnp.asarray(prompts[i])[None], cfg,
                        max_new=8)
        assert np.asarray(g)[0, len(prompts[i]):].tolist() == want[i]
    tcfg = srv.cfg
    tp = tt.params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                              tcfg, device="cpu")
    mine = str(tmp_path / "port-moe.tar")
    tlm.save_lm_artifact(mine, tp, tcfg, batch=3, prompt_len=8,
                         cache_len=32, engine_buckets=(8,),
                         engine_paged=True, engine_block_size=BS)
    eng = PagedDecodeEngine.from_params(tp, tcfg, batch=3, cache_len=32,
                                        block_size=BS, chunk_tokens=8,
                                        seed=0, device="cpu")
    assert _serve(tlm.load_lm_artifact(mine).engine(seed=0, device="cpu"),
                  prompts, temps) == _serve(eng, prompts, temps)
