"""The optimizer's per-parameter rules, ``ModelAverage`` and
``StaticPruning`` against ``paddle_tpu``'s on the CPU, within 1e-6.

``bind(specs)`` with the layer API's attributes (learning-rate scale,
``is_static``, per-parameter L1 / L2 over the global regularization)
through several update rules and steps; the ``tree_update`` warning for
specs that match no leaf; ``ModelAverage`` over a nested tree;
``StaticPruning`` masks equal to JAX's, the pruned trajectory equal to
JAX's, its two refusals, and ``tests/test_parity_layers.py::
test_static_pruning_masks_stick`` (the last reference case of the layer
API's files), plus ``tests/test_optimizers.py``'s per-parameter cases.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import optimizer as jopt
from paddle_tpu.core.param import ParamAttr as JAttr
from paddle_tpu.core.param import ParamSpec as JSpec
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.core.param import ParamAttr as TAttr
from paddle_tpu_torch.core.param import ParamSpec as TSpec

TOL = 1e-6

ATTRS = {"a": dict(learning_rate=2.0), "b": dict(is_static=True),
         "c": dict(l1_rate=0.01), "d": dict(l2_rate=0.05),
         "e": dict(learning_rate=0.5, l2_rate=0.0)}
SHAPES = {"a": (3, 4), "b": (4,), "c": (5, 2), "d": (6,), "e": (2, 3),
          "f": (4, 2)}


def _specs(Spec, Attr):
    return [Spec(k, SHAPES[k], attr=Attr(**ATTRS.get(k, {})))
            for k in SHAPES]


def _arrays(seed):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}


def _run(make, steps=4, bind=True):
    """(JAX params, port params) after ``steps`` updates of the same
    gradients from the same values."""
    jo, to = make(jopt), make(topt)
    if bind:
        jo.bind(_specs(JSpec, JAttr))
        to.bind(_specs(TSpec, TAttr))
    p0 = _arrays(0)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    js, ts = jo.init_state(jp), to.init_state(tp)
    for i in range(steps):
        g = _arrays(10 + i)
        jp, js = jo.update(jnp.asarray(i, jnp.int32),
                           {k: jnp.asarray(v) for k, v in g.items()}, jp, js)
        tp, ts = to.update(i, {k: torch.from_numpy(v) for k, v in g.items()},
                           tp, ts)
    return jp, tp, js, ts


def _close(jp, tp, tol=TOL):
    for k in jp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=tol, err_msg=k)


@pytest.mark.parametrize("make", [
    lambda m: m.SGD(learning_rate=0.1),
    lambda m: m.SGD(learning_rate=0.1,
                    regularization=m.L2Regularization(0.01)),
    lambda m: m.Momentum(momentum=0.9, learning_rate=0.05,
                         regularization=m.L1Regularization(0.002)),
    lambda m: m.Adam(learning_rate=0.01),
    lambda m: m.AdaGrad(learning_rate=0.1,
                        gradient_clipping_threshold=1.0),
], ids=["sgd", "sgd_l2", "momentum_l1", "adam", "adagrad_clip"])
def test_bound_rules_match_jax(make):
    jp, tp, js, ts = _run(make)
    _close(jp, tp)
    np.testing.assert_array_equal(tp["b"].numpy(), _arrays(0)["b"])
    assert topt.state_to_numpy(ts).keys() == js.keys()


def test_static_leaf_keeps_its_state():
    _, _, js, ts = _run(lambda m: m.Momentum(momentum=0.9,
                                             learning_rate=0.1))
    assert float(ts["b"].abs().max()) == 0.0
    assert float(np.abs(np.asarray(js["b"])).max()) == 0.0
    assert float(ts["a"].abs().max()) > 0.0


def test_per_param_lr_and_static():
    """test_optimizers.py::test_per_param_lr_and_static."""
    specs = [TSpec("a", (2,), attr=TAttr(learning_rate=2.0)),
             TSpec("b", (2,), attr=TAttr(is_static=True))]
    o = topt.SGD(learning_rate=0.1).bind(specs)
    p = {"a": torch.ones(2), "b": torch.ones(2)}
    s = o.init_state(p)
    p, s = o.update(0, {"a": torch.ones(2), "b": torch.ones(2)}, p, s)
    np.testing.assert_allclose(p["a"].numpy(), 1 - 0.2, rtol=1e-5)
    np.testing.assert_allclose(p["b"].numpy(), 1.0)


def test_l2_regularization():
    """test_optimizers.py::test_l2_regularization."""
    o = topt.SGD(learning_rate=0.1,
                 regularization=topt.L2Regularization(0.5))
    o.bind([TSpec("w", (4,))])
    p = {"w": torch.ones(4)}
    p, _ = o.update(0, {"w": torch.zeros(4)}, p, o.init_state(p))
    np.testing.assert_allclose(p["w"].numpy(), 0.95, rtol=1e-5)


def test_tree_update_warns_for_unmatched_specs(caplog):
    o = topt.SGD(learning_rate=0.1).bind([TSpec("nope", (2,))])
    params = {"blocks": {"w": torch.ones(2)}}
    state = o.tree_init_state(params)
    with caplog.at_level(logging.WARNING):
        o.tree_update(0, {"blocks": {"w": torch.ones(2)}}, params, state)
        o.tree_update(1, {"blocks": {"w": torch.ones(2)}}, params, state)
    warned = [r for r in caplog.records if "match no pytree leaf" in
              r.getMessage()]
    assert len(warned) == 1               # once per optimizer
    np.testing.assert_allclose(params["blocks"]["w"].numpy(), 0.8,
                               rtol=1e-6)


def test_tree_update_applies_path_named_specs():
    o = topt.SGD(learning_rate=0.1).bind(
        [TSpec("['blocks']['w']", (2,), attr=TAttr(is_static=True))])
    params = {"blocks": {"w": torch.ones(2)}, "head": torch.ones(2)}
    o.tree_update(0, {"blocks": {"w": torch.ones(2)},
                      "head": torch.ones(2)}, params,
                  o.tree_init_state(params))
    np.testing.assert_array_equal(params["blocks"]["w"].numpy(), 1.0)
    np.testing.assert_allclose(params["head"].numpy(), 0.9, rtol=1e-6)


# ---------------------------------------------------------------------------
# ModelAverage

def test_model_average():
    """test_optimizers.py::test_model_average."""
    ma = topt.ModelAverage()
    p = {"w": torch.ones(2)}
    s = ma.init_state(p)
    s = ma.accumulate(p, s)
    s = ma.accumulate({"w": torch.ones(2) * 3}, s)
    np.testing.assert_allclose(ma.averaged(p, s)["w"].numpy(), [2.0, 2.0])


def test_model_average_matches_jax_over_a_tree():
    """A short window (it turns into an EMA after 3 steps), nested
    parameters, bf16 leaves averaged in fp32 and cast back."""
    import jax
    jm, tm = jopt.ModelAverage(max_average_window=3), \
        topt.ModelAverage(max_average_window=3)

    def tree(i):
        r = np.random.RandomState(i)
        return {"enc": {"w": r.randn(3, 4).astype(np.float32)},
                "b": r.randn(4).astype(np.float32)}
    t0 = tree(0)
    js = jm.init_state(jax.tree.map(jnp.asarray, t0))
    ts = tm.init_state({"enc": {"w": torch.from_numpy(t0["enc"]["w"])},
                        "b": torch.from_numpy(t0["b"])})
    for i in range(1, 7):
        t = tree(i)
        js = jm.accumulate(jax.tree.map(jnp.asarray, t), js)
        ts = tm.accumulate({"enc": {"w": torch.from_numpy(t["enc"]["w"])},
                            "b": torch.from_numpy(t["b"])}, ts)
    assert float(ts["count"]) == float(js["count"]) == 6.0
    np.testing.assert_allclose(ts["avg"]["enc"]["w"].numpy(),
                               np.asarray(js["avg"]["enc"]["w"]), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(ts["avg"]["b"].numpy(),
                               np.asarray(js["avg"]["b"]), rtol=0, atol=TOL)
    bf = {"enc": {"w": torch.zeros(3, 4, dtype=torch.bfloat16)},
          "b": torch.zeros(4)}
    avg = tm.averaged(bf, ts)
    assert avg["enc"]["w"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# StaticPruning

def test_static_pruning_masks_stick():
    """test_parity_layers.py::test_static_pruning_masks_stick: the pruned
    entries stay 0 through an update; the rest take the plain step. The
    port prunes in place."""
    params = {"w": torch.tensor([0.01, -0.02, 5.0, -6.0])}
    hook = topt.StaticPruning(0.5)
    hook.make_masks(params)
    np.testing.assert_array_equal(hook.masks["w"].numpy(), [0, 0, 1, 1])
    opt = hook.apply(topt.SGD(learning_rate=0.1))
    opt.bind([])
    state = opt.init_state(params)
    pruned = hook.prune(params)
    assert pruned is params
    newp, _ = opt.update(0, {"w": torch.ones(4)}, pruned, state)
    out = newp["w"].numpy()
    assert out[0] == 0.0 and out[1] == 0.0
    np.testing.assert_allclose(out[2:], [4.9, -6.1], rtol=1e-6)
    assert newp["w"] is params["w"]


def test_static_pruning_matches_jax():
    """Masks from the same magnitudes equal JAX's (rank-based, ties never
    over-prune); four pruned Momentum steps on the same gradients match
    JAX's within 1e-6; ``names`` restricts the hooked leaves."""
    p0 = _arrays(3)
    p0["f"][:] = 0.0                          # all-tie leaf
    jh, th = jopt.StaticPruning(0.4), topt.StaticPruning(0.4)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    names = {"a", "c", "f"}
    jh.make_masks(jp, names)
    th.make_masks(tp, names)
    assert set(th.masks) == names
    for k in names:
        np.testing.assert_array_equal(th.masks[k].numpy(),
                                      np.asarray(jh.masks[k]))
    jo = jh.apply(jopt.Momentum(momentum=0.9, learning_rate=0.05))
    to = th.apply(topt.Momentum(momentum=0.9, learning_rate=0.05))
    jo.bind([])
    to.bind([])
    jp, tp = jh.prune(jp), th.prune(tp)
    js, ts = jo.init_state(jp), to.init_state(tp)
    for i in range(4):
        g = _arrays(20 + i)
        jp, js = jo.update(jnp.asarray(i, jnp.int32),
                           {k: jnp.asarray(v) for k, v in g.items()}, jp, js)
        tp, ts = to.update(i, {k: torch.from_numpy(v) for k, v in g.items()},
                           tp, ts)
    _close(jp, tp)
    for k in names:
        assert np.all(tp[k].numpy()[th.masks[k].numpy() == 0] == 0.0)


def test_static_pruning_refusals():
    hook = topt.StaticPruning(0.5)
    with pytest.raises(ValueError, match="make_masks"):
        hook.apply(topt.SGD())
    hook.make_masks({"w": torch.tensor([1.0, 2.0])})
    opt = hook.apply(topt.SGD())
    other = topt.StaticPruning(0.5)
    other.make_masks({"w": torch.ones(2)})
    with pytest.raises(ValueError, match="already wrapped"):
        other.apply(opt)


def test_static_pruning_through_tree_update():
    """``tree_update`` calls the wrapped ``update``: a hooked keystr leaf
    stays pruned."""
    params = {"blocks": {"w": torch.tensor([0.1, 3.0, -0.2, 4.0])}}
    hook = topt.StaticPruning(0.5)
    hook.make_masks({"['blocks']['w']": params["blocks"]["w"]})
    opt = hook.apply(topt.SGD(learning_rate=1.0))
    hook.prune({"['blocks']['w']": params["blocks"]["w"]})
    opt.tree_update(0, {"blocks": {"w": torch.ones(4)}}, params,
                    opt.tree_init_state(params))
    np.testing.assert_allclose(params["blocks"]["w"].numpy(),
                               [0.0, 2.0, 0.0, 3.0])
