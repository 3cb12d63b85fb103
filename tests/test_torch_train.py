"""The port's LM training path against ``paddle_tpu``'s.

Small fp32 configs (2 layers, d_model 32, vocab 64, T 16): MHA and GQA,
rope and learned positions. The JAX parameters go through
``train_params_from_numpy``; tokens, targets and lengths are made from a
seed with numpy and handed to both packages.

- Model: ``forward`` logits, ``lm_loss`` and every parameter gradient
  against ``jax.value_and_grad(lm_loss)``. Without ``lengths`` both
  sides run flash attention: the JAX side its Pallas kernels under
  ``PADDLE_TPU_PALLAS=interpret`` (about a second per config), the port
  the plain versions its kernel wrappers run on the CPU. With
  ``lengths`` both run plain attention (the JAX forward takes flash
  only without lengths). Tolerance 1e-4 absolute, as the serving tests:
  fp32 throughout, sums in another order through two layers and the
  vocab head (observed about 2e-7).
- Trajectory (the training slice's gate): 20 Adam steps from the same
  weights on the same batches. The JAX step is jitted on its XLA path
  (interpreted Pallas kernels under jit take minutes to compile); the
  port runs its flash path. Losses within 1e-4 at every step, final
  parameters within 1e-4.
- Optimizer: every rule, each without a schedule, with one, with
  global-norm clipping and with L2, against the JAX rule for two
  ``tree_update`` steps on a nested tree: 1e-6 absolute (elementwise
  fp32 arithmetic, one rounding apart at most per operation).
- Dropout: the port alone (``torch.Generator`` and ``jax.random`` give
  different bits from one seed).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import optimizer as jopt
from paddle_tpu.models import transformer as jt
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.models import transformer as tt
from paddle_tpu_torch.observe import costs

# the suite runs several test processes side by side on a few cores:
# one intra-op thread keeps these tiny-shape tests from crowding the
# cores the other processes' JAX tests use
torch.set_num_threads(1)

ATOL = 1e-4
OPT_ATOL = 1e-6
B, T, V = 2, 16, 64


def _cfgs(gqa: bool, rope: bool, flash: bool = True, **extra):
    """The JAX config with ``use_flash_attention=flash`` and the port's,
    which always runs flash attention without ``lengths``."""
    kw = dict(vocab=V, d_model=32, n_heads=4, n_kv_heads=2 if gqa else 0,
              n_layers=2, d_ff=64, max_len=64, use_rope=rope, **extra)
    return (jt.TransformerConfig(dtype=jnp.float32,
                                 use_flash_attention=flash, **kw),
            tt.TransformerConfig(dtype=torch.float32, **kw))


CONFIGS = [(False, False), (True, False), (False, True), (True, True)]
IDS = ["mha-learned", "gqa-learned", "mha-rope", "gqa-rope"]


def _params(jcfg, tcfg, seed=0):
    jp = jt.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, tt.train_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _batch(rng, b=B, t=T):
    toks = rng.randint(0, V, (b, t)).astype(np.int32)
    return toks, np.roll(toks, -1, axis=1)


def _flat(tree):
    return dict(topt.tree_leaves(jax.tree_util.tree_map(np.asarray, tree)))


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=0, atol=atol)


class TestModel:
    @pytest.mark.parametrize("gqa,rope", CONFIGS, ids=IDS)
    def test_flash_loss_logits_and_grads_match_jax(self, rng, monkeypatch,
                                                   gqa, rope):
        monkeypatch.setenv("PADDLE_TPU_PALLAS", "interpret")
        jcfg, tcfg = _cfgs(gqa, rope)
        jp, tp = _params(jcfg, tcfg)
        toks, tgts = _batch(rng)
        jl, jg = jax.value_and_grad(jt.lm_loss)(jp, jnp.asarray(toks),
                                                jnp.asarray(tgts), jcfg)
        loss = tt.lm_loss(tp, torch.from_numpy(toks),
                          torch.from_numpy(tgts), tcfg)
        loss.backward()
        grads = dict(topt.tree_leaves(topt.take_grads(tp)))
        _close(loss.item(), float(jl))
        want = _flat(jg)
        assert set(grads) == set(want)
        for name, g in grads.items():
            _close(g.numpy(), want[name])
        assert all(p.grad is None for _, p in topt.tree_leaves(tp))
        with torch.no_grad():
            logits = tt.forward(tp, torch.from_numpy(toks), tcfg)
        assert logits.dtype == torch.float32 and logits.shape == (B, T, V)
        _close(logits.numpy(), jt.forward(jp, jnp.asarray(toks), jcfg))

    @pytest.mark.parametrize("gqa,rope", CONFIGS, ids=IDS)
    def test_lengths_loss_and_grads_match_jax(self, rng, gqa, rope):
        jcfg, tcfg = _cfgs(gqa, rope)
        jp, tp = _params(jcfg, tcfg, seed=1)
        toks, tgts = _batch(rng)
        lengths = np.asarray([T, 5], np.int32)
        jl, jg = jax.value_and_grad(jt.lm_loss)(
            jp, jnp.asarray(toks), jnp.asarray(tgts), jcfg,
            lengths=jnp.asarray(lengths))
        loss = tt.lm_loss(tp, torch.from_numpy(toks), torch.from_numpy(tgts),
                          tcfg, lengths=torch.from_numpy(lengths))
        loss.backward()
        _close(loss.item(), float(jl))
        want = _flat(jg)
        for name, g in topt.tree_leaves(topt.take_grads(tp)):
            _close(g.numpy(), want[name])

    @pytest.mark.parametrize("with_lengths", [False, True])
    def test_attention_is_flash_unless_lengths(self, rng, monkeypatch,
                                               with_lengths):
        """Without ``lengths`` every layer's attention is the flash
        ``Function`` (its kernels on the card, with no setting to turn
        them off); with ``lengths``, which the flash kernels do not take,
        the plain masked attention, as in the JAX forward."""
        calls = []
        real = tt.kattention.flash_attention

        def spy(*a, **kw):
            calls.append(1)
            return real(*a, **kw)

        monkeypatch.setattr(tt.kattention, "flash_attention", spy)
        _, tcfg = _cfgs(True, True)
        tp = tt.init_train_params(tcfg, torch.Generator().manual_seed(0),
                                  "cpu")
        lengths = torch.tensor([T, 5]) if with_lengths else None
        with torch.no_grad():
            tt.forward(tp, torch.from_numpy(_batch(rng)[0]), tcfg,
                       lengths=lengths)
        assert len(calls) == (0 if with_lengths else tcfg.n_layers)

    def test_serving_params_run_the_training_forward(self, rng):
        """The cast at use is a no-op on the serving dict: its bf16
        forward equals the fp32 tree's bf16 forward."""
        cfg = dataclasses.replace(_cfgs(False, False)[1],
                                  dtype=torch.bfloat16)
        gen = torch.Generator().manual_seed(3)
        serving = tt.init_params(cfg, gen, "cpu")
        train = tt.init_train_params(cfg, torch.Generator().manual_seed(3),
                                     "cpu")
        assert serving["blocks"]["qkv"].dtype == torch.bfloat16
        assert all(p.dtype == torch.float32 and p.requires_grad
                   for _, p in topt.tree_leaves(train))
        toks = torch.from_numpy(_batch(rng)[0])
        with torch.no_grad():
            a = tt.forward(serving, toks, cfg)
            b = tt.forward(train, toks, cfg)
        assert torch.equal(a, b)

    def test_train_params_round_trip_numpy(self):
        jcfg, tcfg = _cfgs(True, True)
        jp, tp = _params(jcfg, tcfg)
        back = tt.params_to_numpy(tp)
        for name, a in _flat(jp).items():
            np.testing.assert_array_equal(dict(topt.tree_leaves(back))[name],
                                          a)


def _adam_step_fns(jcfg, tcfg, lr):
    jadam = jopt.Adam(learning_rate=lr)

    @jax.jit
    def jstep(p, o, toks, tgts, i):
        loss, g = jax.value_and_grad(jt.lm_loss)(p, toks, tgts, jcfg)
        p, o = jadam.tree_update(i, g, p, o)
        return loss, p, o

    tadam = topt.Adam(learning_rate=lr)

    def tstep(p, o, toks, tgts, i):
        loss = tt.lm_loss(p, toks, tgts, tcfg)
        loss.backward()
        p, o = tadam.tree_update(i, topt.take_grads(p), p, o)
        return loss.item(), p, o

    return jadam, jstep, tadam, tstep


def test_twenty_adam_steps_track_jax(rng):
    """ROADMAP A3's gate: 20 steps of a tiny LM with Adam (lr 3e-3), a
    fresh batch each step, losses and final weights within 1e-4."""
    jcfg, tcfg = _cfgs(True, True, flash=False)
    jp, tp = _params(jcfg, tcfg, seed=2)
    jadam, jstep, tadam, tstep = _adam_step_fns(jcfg, tcfg, 3e-3)
    jo, to = jadam.tree_init_state(jp), tadam.tree_init_state(tp)
    jl, tl = [], []
    for i in range(20):
        toks, tgts = _batch(rng, b=4)
        loss, jp, jo = jstep(jp, jo, jnp.asarray(toks), jnp.asarray(tgts),
                             jnp.asarray(i, jnp.int32))
        jl.append(float(loss))
        loss, tp, to = tstep(tp, to, torch.from_numpy(toks),
                             torch.from_numpy(tgts), i)
        tl.append(loss)
    _close(tl, jl)
    assert tl[-1] < tl[0] - 0.1                 # it does learn
    final = _flat(jp)
    for name, p in topt.tree_leaves(tp):
        _close(p.detach().numpy(), final[name])


def test_adam_state_moves_jax_to_port_to_jax(rng):
    """Two steps in JAX, the (m, v) state and weights carried to the
    port, one step there, carried back, one more step in JAX: the same
    as four JAX steps."""
    jcfg, tcfg = _cfgs(False, False, flash=False)
    jp, _ = _params(jcfg, tcfg, seed=4)
    jadam, jstep, tadam, tstep = _adam_step_fns(jcfg, tcfg, 1e-2)
    batches = [_batch(rng) for _ in range(4)]

    def j_run(p, o, steps):
        for i in steps:
            toks, tgts = batches[i]
            _, p, o = jstep(p, o, jnp.asarray(toks), jnp.asarray(tgts),
                            jnp.asarray(i, jnp.int32))
        return p, o

    ref_p, ref_o = j_run(jp, jadam.tree_init_state(jp), range(4))
    p, o = j_run(jp, jadam.tree_init_state(jp), range(2))
    tp = tt.train_params_from_numpy(jax.tree_util.tree_map(np.asarray, p),
                                    device="cpu")
    to = topt.state_from_numpy(jax.tree_util.tree_map(np.asarray, o), "cpu")
    toks, tgts = batches[2]
    _, tp, to = tstep(tp, to, torch.from_numpy(toks), torch.from_numpy(tgts),
                      2)
    p = jax.tree_util.tree_map(jnp.asarray, tt.params_to_numpy(tp))
    o = jax.tree_util.tree_map(jnp.asarray, topt.state_to_numpy(to))
    p, o = j_run(p, o, [3])
    for name, a in _flat(ref_p).items():
        _close(_flat(p)[name], a)
    for name, (m, v) in ref_o.items():
        _close(o[name][0], m)
        _close(o[name][1], v)


# ---------------------------------------------------------------------------
# optimizer rules
# ---------------------------------------------------------------------------

RULES = {
    "SGD": {}, "Momentum": {"momentum": 0.9, "use_nesterov": True},
    "AdaGrad": {}, "AdaDelta": {}, "RMSProp": {"momentum": 0.5},
    "Adam": {}, "AdamW": {"weight_decay": 0.1}, "AdaMax": {},
    "DecayedAdagrad": {}, "ProximalGD": {"l1": 0.01, "l2": 0.1},
    "ProximalAdagrad": {"l1": 0.01, "l2": 0.1},
}
VARIANTS = {
    "plain": {},
    "schedule": {"learning_rate_schedule": "poly",
                 "learning_rate_args": "0.5,0.75"},
    "clip": {"gradient_clipping_threshold": 0.5},
    "l2": "l2",
}


def _tree(rng):
    return {"a": rng.randn(3, 4).astype(np.float32),
            "blocks": {"w": rng.randn(2, 3, 4).astype(np.float32),
                       "b": rng.randn(5).astype(np.float32)}}


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree).copy())


def _both(rule, variant, **extra):
    kw = {"learning_rate": 0.1, **RULES[rule], **extra}
    if variant == "l2":
        j_kw = {**kw, "regularization": jopt.L2Regularization(0.05)}
        t_kw = {**kw, "regularization": topt.L2Regularization(0.05)}
    else:
        j_kw = t_kw = {**kw, **variant}
    return getattr(jopt, rule)(**j_kw), getattr(topt, rule)(**t_kw)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("rule", list(RULES))
def test_optimizer_rule_matches_jax(rng, rule, variant):
    """Two ``tree_update`` steps of each rule on a nested tree, the
    same gradients to both; AdamW refuses L2 in both packages."""
    if rule == "AdamW" and variant == "l2":
        with pytest.raises(ValueError, match="decay parameters twice"):
            _both(rule, VARIANTS[variant])
        with pytest.raises(ValueError, match="decay parameters twice"):
            jopt.AdamW(regularization=jopt.L2Regularization(0.05))
        return
    jo, to = _both(rule, VARIANTS[variant])
    params = _tree(rng)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, params), _to_torch(params)
    js, ts = jo.tree_init_state(jp), to.tree_init_state(tp)
    for step in range(2):
        grads = jax.tree_util.tree_map(
            lambda a: (3.0 * rng.randn(*a.shape)).astype(np.float32), params)
        jp, js = jo.tree_update(step, jax.tree_util.tree_map(jnp.asarray,
                                                             grads), jp, js)
        tp, ts = to.tree_update(step, _to_torch(grads), tp, ts)
    for name, p in topt.tree_leaves(tp):
        _close(p.numpy(), _flat(jp)[name], OPT_ATOL)
    want_state = jax.tree_util.tree_map(np.asarray, js)
    got_state = topt.state_to_numpy(ts)
    assert set(got_state) == set(want_state)
    for name, s in want_state.items():
        for a, b in zip(jax.tree_util.tree_leaves(got_state[name]),
                        jax.tree_util.tree_leaves(s)):
            _close(a, b, OPT_ATOL)


@pytest.mark.parametrize("mask", ["no_1d", "callable"])
def test_adamw_decay_mask_matches_jax(rng, mask):
    """``no_1d`` skips the 1-d leaf; the callable sees keystr names."""
    seen = []

    def by_name(name, p):
        seen.append(name)
        return "blocks" in name

    m = by_name if mask == "callable" else "no_1d"
    jo = jopt.AdamW(learning_rate=0.1, weight_decay=0.5, decay_mask=m)
    to = topt.AdamW(learning_rate=0.1, weight_decay=0.5, decay_mask=m)
    params = _tree(rng)
    grads = jax.tree_util.tree_map(lambda a: np.ones_like(a), params)
    jp, js = jo.tree_update(0, jax.tree_util.tree_map(jnp.asarray, grads),
                            jax.tree_util.tree_map(jnp.asarray, params),
                            jo.tree_init_state(params))
    tp = _to_torch(params)
    tp, _ = to.tree_update(0, _to_torch(grads), tp, to.tree_init_state(tp))
    for name, p in topt.tree_leaves(tp):
        _close(p.numpy(), _flat(jp)[name], OPT_ATOL)
    if mask == "callable":
        assert "['blocks']['w']" in seen and "['a']" in seen


@pytest.mark.parametrize("name,args", [
    ("constant", ""), ("poly", "0.5,0.75"), ("exp", "0.5,3"),
    ("discexp", "0.5,3"), ("linear", "0.01,0.02")])
def test_schedules_match_jax(name, args):
    js = jopt.make_schedule(0.1, name, args)
    ts = topt.make_schedule(0.1, name, args)
    for step in (0, 1, 4, 10):
        _close(ts(step).item(), float(js(jnp.asarray(step, jnp.int32))),
               1e-7)
    jw = jopt.warmup_cosine_schedule(0.1, 3, 10, 0.01)
    tw = topt.warmup_cosine_schedule(0.1, 3, 10, 0.01)
    for step in (0, 2, 3, 7, 12):
        _close(tw(step).item(), float(jw(jnp.asarray(step))), 1e-7)


# ---------------------------------------------------------------------------
# dropout, FLOPs
# ---------------------------------------------------------------------------


class TestDropout:
    def test_keep_rate_and_scaling(self):
        h = torch.ones(200, 500)
        out = tt._dropout(h, 0.25, torch.Generator().manual_seed(0))
        kept = out != 0
        assert abs(kept.float().mean().item() - 0.75) < 0.01
        assert torch.allclose(out[kept], torch.full_like(out[kept],
                                                         1 / 0.75))

    def test_same_seed_same_loss_and_none_is_off(self, rng):
        _, tcfg = _cfgs(False, True, dropout=0.3)
        tp = tt.init_train_params(tcfg, torch.Generator().manual_seed(0),
                                  "cpu")
        toks, tgts = (torch.from_numpy(a) for a in _batch(rng))

        def loss(gen):
            with torch.no_grad():
                return tt.lm_loss(tp, toks, tgts, tcfg, generator=gen).item()

        a = loss(torch.Generator().manual_seed(7))
        b = loss(torch.Generator().manual_seed(7))
        c = loss(torch.Generator().manual_seed(8))
        off = loss(None)
        no_drop = dataclasses.replace(tcfg, dropout=0.0)
        with torch.no_grad():
            ref = tt.lm_loss(tp, toks, tgts, no_drop).item()
        assert a == b and a != c
        assert off == ref and a != off

    def test_rate_out_of_range_raises(self, rng):
        _, tcfg = _cfgs(False, False, dropout=1.0)
        tp = tt.init_train_params(tcfg, torch.Generator().manual_seed(0),
                                  "cpu")
        with pytest.raises(ValueError, match="dropout"):
            tt.forward(tp, torch.from_numpy(_batch(rng)[0]), tcfg)


def test_train_step_flops_from_shapes():
    _, cfg = _cfgs(True, False)
    D, F_, L, Dh = 32, 64, 2, 8
    per_layer = D * (D + 2 * 2 * Dh) + D * D + 2 * D * F_
    params = L * per_layer + D * V
    attn = 12 * L * 4 * Dh * 3 * (16 * 17 // 2)
    assert costs.train_step_flops(cfg, 3, 16) == 6 * params * 3 * 16 + attn
    assert math.isclose(costs.train_step_flops(
        tt.TransformerConfig(vocab=50257, d_model=768, n_heads=12,
                             n_layers=12, d_ff=3072, max_len=1024),
        8, 1024), 6.536e12, rel_tol=1e-3)
