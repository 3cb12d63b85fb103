"""Shared harness of the q8 pipeline's graph tests
(``tests/test_torch_q8.py``, ``tests/test_torch_models.py``).

``Q8Net`` is ``tests/torch_layers_util.Net`` for graphs on the q8
pipeline. Each stash site's codes are read in both packages (the JAX
forward returns them from inside its jitted function). Stash codes
after a convolution may differ by one step where the value before the
round lies at a half, because oneDNN's and XLA:CPU's convolutions (and
their batch statistics) differ by ulps: every code is compared, the
sites' differing codes are counted (``flips``), each may be one step
(int8) or one bf16 ulp (bf16; at a ReLU's zero, the float tolerance of
the dense values before the cast) and no more than ``FLIP_SHARE`` of a
site's codes. The port's consumers then read the JAX codes, so what
follows a flip is held to the float tolerance alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from paddle_tpu_torch.ops import prng
from tests.torch_layers_util import Net, _floating

STASH_SITES = ("q8_entry", "img_conv_bn_q8", "addto_q8")
# a flip needs the pre-round value within the convolutions' ulp
# difference of a rounding boundary: a small share of a site's codes
FLIP_SHARE = 5e-3


def codes_np(q) -> np.ndarray:
    """A stash (either package) as int32 codes or fp32 values."""
    if isinstance(q, torch.Tensor):
        q = q.detach().cpu()
        return (q.to(torch.int32) if not q.is_floating_point()
                else q.float()).numpy()
    a = np.asarray(q)
    return a.astype(np.int32) if np.issubdtype(a.dtype, np.integer) \
        else a.astype(np.float32)


def count_flips(got, want, label="", tol=1e-4) -> int:
    """Codes that differ between two stashes; each may differ by one
    int8 step, or one bf16 ulp (``tol`` of the largest value where the
    values before the cast differ across a ReLU's zero), and at most
    ``FLIP_SHARE`` of them."""
    g, w = codes_np(got), codes_np(want)
    assert g.shape == w.shape and g.dtype == w.dtype, (label, g.shape,
                                                       w.shape)
    diff = g != w
    n = int(diff.sum())
    if n:
        if g.dtype == np.int32:
            assert np.abs(g - w).max() <= 1, (label, np.abs(g - w).max())
        else:
            # one bf16 ulp of the larger value, or (at a ReLU's zero) the
            # float tolerance of the values before the cast
            lim = np.maximum(np.maximum(np.abs(g[diff]), np.abs(w[diff]))
                             * 2.0 ** -7, tol * max(1.0, np.abs(w).max()))
            assert (np.abs(g[diff] - w[diff]) <= lim).all(), (
                label, g[diff][:8], w[diff][:8], n)
    assert n <= max(1, FLIP_SHARE * g.size), (label, n, g.size)
    return n


def to_torch_codes(q) -> torch.Tensor:
    a = np.asarray(q)
    if np.issubdtype(a.dtype, np.integer):
        return torch.tensor(a.astype(np.int8))
    return torch.tensor(a.astype(np.float32)).to(torch.bfloat16)


class Q8Net(Net):
    """``Net`` over a graph with q8 stash sites; ``flips`` maps each
    site to the codes that differed in the last run."""

    def __init__(self, builder, **kw):
        super().__init__(builder, **kw)
        self._jrec, self._jcodes, self.flips = {}, {}, {}
        for l in self.jtopo.layers:
            if l.layer_type in STASH_SITES:
                l.fn = self._jrecord(l.name, l.fn)
        for l in self.ttopo.layers:
            if l.layer_type in STASH_SITES:
                l.fn = self._tforce(l.name, l.fn)
        self.jfwd = self.jtopo.compile()
        self.tfwd = self.ttopo.compile()

    def _jrecord(self, name, fn):
        def wrapped(params, parents, ctx):
            v = fn(params, parents, ctx)
            if v.aux is not None:
                self._jrec[name] = v.aux["q"]
            return v
        return wrapped

    def _tforce(self, name, fn):
        def wrapped(params, parents, ctx):
            v = fn(params, parents, ctx)
            if v.aux is None:
                return v
            want = self._jcodes[name]
            self.flips[name] = count_flips(v.aux["q"], want, name)
            v.aux = dict(v.aux, q=to_torch_codes(want))
            return v
        return wrapped

    def run(self, jfeeds, tfeeds, *, is_training=False, key=None,
            grad=False, cot_seed=0):
        jkey = None if key is None else jax.random.PRNGKey(key)
        tkey = None if key is None else prng.prng_key(key)
        state = self.jparams.state

        def jrun(params):
            self._jrec.clear()
            o, st = self.jfwd(params, state, jfeeds,
                              is_training=is_training, dropout_key=jkey)
            return o, st, dict(self._jrec)

        jouts, jstate, jcodes = jax.jit(jrun)(self.jparams.values)
        self._jcodes = {k: np.asarray(v) for k, v in jcodes.items()}
        rng = np.random.RandomState(cot_seed)
        cots = {n: rng.randn(*np.shape(jouts[n].array)).astype(np.float32)
                for n in sorted(jouts) if _floating(jouts[n].array)}
        leaves = {k: v.detach().clone().requires_grad_(grad)
                  for k, v in self.tparams.values.items()}
        touts, tstate = self.tfwd(leaves, self.tparams.state, tfeeds,
                                  is_training=is_training, dropout_key=tkey)
        jg = tg = None
        if grad:
            def jloss(params):
                o, _, _ = jrun(params)
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
