"""Shared harness of ``tests/test_torch_layers*.py``,
``test_torch_networks.py``, ``test_torch_recurrent.py``,
``test_torch_merged.py`` and ``test_torch_evaluators.py``: one graph
built in both packages by the same builder, the JAX package's
parameters carried into the port through ``Parameters.to_tar`` →
``from_tar_into``, the same rows fed through each package's
``DataFeeder``, outputs, new state and gradients compared.

``Net(builder)`` calls ``builder(pkg)`` with ``paddle_tpu`` and with
``paddle_tpu_torch``; the builder makes the same layer calls on
``pkg.layer`` / ``pkg.networks`` and returns the output layer(s). Layers
carry explicit names (the packages' auto-name counters advance apart);
the parameter specs must agree in name and shape. ``Net.run`` returns the
two runs; ``Net.check`` holds floating outputs and state within ``atol``
(of max(1, max|JAX value|)), integer outputs and sequence metadata
equal, and, with ``grad=True``, the gradient of sum(out * cot) over the
floating outputs (seeded cotangents) with respect to every parameter
within ``gatol`` (a parameter the port leaves unreached must have a zero
JAX gradient).
"""

import importlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu.utils.rng import KeySource as JKeySource
from paddle_tpu_torch.ops import prng
from tests.torch_ops_util import as_np, scaled_err

for _m in ("layer", "networks", "data_type", "activation", "pooling",
           "attr", "projection", "evaluator", "parameters", "data_feeder",
           "topology", "recurrent", "inference", "io.merged"):
    importlib.import_module(f"paddle_tpu.{_m}")     # bind the submodules
    importlib.import_module(f"paddle_tpu_torch.{_m}")


def carry(jparams, ttopo):
    """The port's Parameters for ``ttopo`` on the CPU holding the JAX
    Parameters' values and state, through the pickled tar."""
    buf = io.BytesIO()
    jparams.to_tar(buf)
    buf.seek(0)
    tparams = T.parameters.Parameters(ttopo.param_specs(),
                                      state_specs=ttopo.state_specs(),
                                      device="cpu")
    return tparams.from_tar_into(buf)


def _floating(a) -> bool:
    a = as_np(a)
    return np.issubdtype(a.dtype, np.floating) or a.dtype == jnp.bfloat16


def assert_values(tv, jv, atol, label=""):
    """A port Value against a JAX Value: every field."""
    for field in ("array", "lengths", "sub_lengths", "weights"):
        a, b = getattr(tv, field), getattr(jv, field)
        assert (a is None) == (b is None), (label, field)
        if b is None:
            continue
        if _floating(b):
            err = scaled_err(a, b)
            assert err <= atol, f"{label}.{field}: scaled error {err} > {atol}"
        else:
            np.testing.assert_array_equal(as_np(a), as_np(b),
                                          err_msg=f"{label}.{field}")


def numpy_params(jtopo, seed):
    """JAX Parameters for ``jtopo`` drawn with numpy (normal, std
    1/sqrt(fan_in); constants as their specs say): the JAX package's
    eager ``parameters.create`` compiles a draw per shape, seconds for a
    VGG. The draws are shared by both packages all the same."""
    rng = np.random.RandomState(seed)

    def draw(s):
        a = s.attr
        if a.initial_value is not None or a.initializer == "constant":
            return np.full(s.shape, a.initial_value or 0.0, np.float32)
        fan = s.fan_in or (int(np.prod(s.shape[:-1])) if len(s.shape) > 1
                           else int(s.shape[0]))
        return (rng.randn(*s.shape) / np.sqrt(max(fan, 1))).astype(
            np.float32)
    p = J.parameters.Parameters(jtopo.param_specs(),
                                state_specs=jtopo.state_specs())
    p.values = {s.name: jnp.asarray(draw(s)) for s in jtopo.param_specs()}
    p.state = {s.name: jnp.asarray(draw(s)) for s in jtopo.state_specs()}
    return p


class Net:
    """One graph in both packages, parameters carried across:
    ``parameters.create`` of the JAX package under ``KeySource(seed)``, or
    ``numpy_params`` with ``init="numpy"``, or ``jparams`` given."""

    def __init__(self, builder, seed=5, jparams=None, init="create"):
        self.jout = builder(J)
        self.tout = builder(T)
        self.jtopo = J.topology.Topology(self.jout)
        self.ttopo = T.topology.Topology(self.tout)
        js = [(s.name, tuple(s.shape)) for s in self.jtopo.param_specs()]
        ts = [(s.name, tuple(s.shape)) for s in self.ttopo.param_specs()]
        assert js == ts, (js, ts)
        if jparams is None:
            jparams = (numpy_params(self.jtopo, seed) if init == "numpy"
                       else J.parameters.create(self.jtopo, JKeySource(seed)))
        self.jparams = jparams
        self.tparams = carry(self.jparams, self.ttopo)
        self.jfwd = self.jtopo.compile()
        self.tfwd = self.ttopo.compile()

    def feeds(self, rows, feeding=None):
        jt = {l.name: l.data_spec for l in self.jtopo.data_layers}
        tt = {l.name: l.data_spec for l in self.ttopo.data_layers}
        return (J.data_feeder.DataFeeder(jt, feeding).feed(rows),
                T.data_feeder.DataFeeder(tt, feeding, device="cpu").feed(rows))

    def run(self, jfeeds, tfeeds, *, is_training=False, key=None,
            grad=False, cot_seed=0):
        """((jouts, jstate, jgrads), (touts, tstate, tgrads))."""
        jkey = None if key is None else jax.random.PRNGKey(key)
        tkey = None if key is None else prng.prng_key(key)
        jouts, jstate = jax.jit(self.jfwd, static_argnames="is_training")(
            self.jparams.values, self.jparams.state, jfeeds,
            is_training=is_training, dropout_key=jkey)
        names = sorted(jouts)
        cots = {}
        rng = np.random.RandomState(cot_seed)
        for n in names:
            if _floating(jouts[n].array):
                cots[n] = rng.randn(*np.shape(jouts[n].array)).astype(
                    np.float32)
        leaves = {k: v.detach().clone().requires_grad_(grad)
                  for k, v in self.tparams.values.items()}
        touts, tstate = self.tfwd(leaves, self.tparams.state, tfeeds,
                                  is_training=is_training, dropout_key=tkey)
        jg = tg = None
        if grad and not leaves:
            jg, tg = {}, {}
        elif grad:
            def jloss(params):
                o, _ = self.jfwd(params, self.jparams.state, jfeeds,
                                 is_training=is_training, dropout_key=jkey)
                return sum(jnp.sum(o[n].array.astype(jnp.float32) * c)
                           for n, c in cots.items())

            jg = jax.jit(jax.grad(jloss))(self.jparams.values)
            tl = sum((touts[n].array.float() * torch.from_numpy(c)).sum()
                     for n, c in cots.items())
            keys = list(leaves)
            got = torch.autograd.grad(tl, [leaves[k] for k in keys],
                                      allow_unused=True)
            tg = {k: (g if g is not None else torch.zeros_like(leaves[k]))
                  for k, g in zip(keys, got)}
        return (jouts, jstate, jg), (touts, tstate, tg)

    def check(self, jfeeds, tfeeds, *, atol=1e-5, gatol=1e-4, grad=False,
              **kw):
        """Run both and hold the port to JAX; returns the two runs."""
        j, t = self.run(jfeeds, tfeeds, grad=grad, **kw)
        assert set(j[0]) == set(t[0])
        for n in j[0]:
            assert_values(t[0][n], j[0][n], atol, n)
        assert set(j[1]) == set(t[1])
        for n in j[1]:
            err = scaled_err(t[1][n], j[1][n])
            assert err <= atol, f"state {n}: scaled error {err} > {atol}"
        if grad:
            assert set(j[2]) == set(t[2])
            for n in j[2]:
                err = scaled_err(t[2][n], j[2][n])
                assert err <= gatol, f"grad {n}: scaled error {err} > {gatol}"
        return j, t

    def check_rows(self, rows, feeding=None, **kw):
        jf, tf = self.feeds(rows, feeding)
        return self.check(jf, tf, **kw)


def both_values(arrays: dict):
    """{name: ndarray or (ndarray, lengths)} -> (JAX feeds, port feeds)
    of Values made from the same arrays."""
    jf, tf = {}, {}
    for k, v in arrays.items():
        arr, lens = v if isinstance(v, tuple) else (v, None)
        jf[k] = J.topology.Value(jnp.asarray(arr),
                                 None if lens is None else jnp.asarray(lens))
        tf[k] = T.topology.Value(
            torch.from_numpy(np.array(arr, copy=True)),
            None if lens is None else torch.from_numpy(
                np.asarray(lens, np.int32)))
    return jf, tf
