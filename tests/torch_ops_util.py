"""Shared helpers of ``tests/test_torch_ops_*.py``: one numpy input set
through a JAX op and its port, outputs and gradients compared.

``parity`` runs ``jfn`` on jax arrays and ``tfn`` on CPU torch tensors
made from the same numpy arrays, flattens both outputs (tuples, named
tuples, lists), and holds floating outputs within ``atol`` of the JAX
values scaled by max(1, max|JAX value|) (so O(1) values are held to
``atol`` absolute) and integer or boolean outputs equal. With ``wrt``,
it also holds the gradients of sum(out_i * cot_i) over the floating
outputs, for a seeded cotangent, with respect to those argument
positions: ``jax.grad`` against ``torch.autograd.grad``, within
``gatol`` on the same scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch


def to_j(a):
    return jnp.asarray(a)


def to_t(a, requires_grad=False):
    t = torch.from_numpy(np.array(a, copy=True))
    return t.requires_grad_(True) if requires_grad else t


def flat(out) -> list:
    if isinstance(out, (tuple, list)):
        return [x for o in out for x in flat(o)]
    return [out]


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def scaled_err(got, want) -> float:
    """max|got - want| / max(1, max finite |want|), in float64; equal
    entries (infinities included, NaN against NaN) count as no error."""
    g = as_np(got).astype(np.float64)
    w = np.asarray(as_np(want), np.float64)
    assert g.shape == w.shape, (g.shape, w.shape)
    same = (g == w) | (np.isnan(g) & np.isnan(w))
    if same.all():
        return 0.0
    fin = np.abs(w[np.isfinite(w)])
    scale = max(1.0, float(fin.max()) if fin.size else 1.0)
    return float(np.max(np.where(same, 0.0, np.abs(g - w))) / scale)


def assert_same(got, want, atol):
    """Floating outputs within ``atol`` (scaled), others equal."""
    gs, ws = flat(got), flat(want)
    assert len(gs) == len(ws), (len(gs), len(ws))
    for i, (g, w) in enumerate(zip(gs, ws)):
        wn = as_np(w)
        if np.issubdtype(wn.dtype, np.floating) or wn.dtype == jnp.bfloat16:
            err = scaled_err(g, w)
            assert err <= atol, f"output {i}: scaled error {err} > {atol}"
        else:
            np.testing.assert_array_equal(as_np(g), wn, err_msg=f"output {i}")


def _cotangents(outs, seed):
    rng = np.random.RandomState(seed)
    return [np.asarray(rng.randn(*np.shape(as_np(o))), np.float32)
            if np.issubdtype(as_np(o).dtype, np.floating)
            or as_np(o).dtype == jnp.bfloat16 else None for o in outs]


def parity(jfn, tfn, args, *, wrt=(), atol=1e-5, gatol=1e-4, seed=0):
    """Hold ``tfn`` against ``jfn`` on ``args`` (numpy arrays or python
    values); returns (torch outputs, jax outputs)."""
    jargs = [to_j(a) if isinstance(a, np.ndarray) else a for a in args]
    targs = [to_t(a, requires_grad=(i in wrt)) if isinstance(a, np.ndarray)
             else a for i, a in enumerate(args)]
    jout = jfn(*jargs)
    tout = tfn(*targs)
    assert_same(tout, jout, atol)
    if not wrt:
        return tout, jout
    cots = _cotangents(flat(jout), seed)

    def jloss(*wargs):
        a = list(jargs)
        for i, w in zip(wrt, wargs):
            a[i] = w
        return sum(jnp.sum(o.astype(jnp.float32) * c)
                   for o, c in zip(flat(jfn(*a)), cots) if c is not None)

    jg = jax.grad(jloss, argnums=tuple(range(len(wrt))))(
        *[jargs[i] for i in wrt])
    tl = sum((o.float() * torch.from_numpy(c)).sum()
             for o, c in zip(flat(tout), cots) if c is not None)
    tg = torch.autograd.grad(tl, [targs[i] for i in wrt])
    for i, g, w in zip(wrt, tg, jg):
        err = scaled_err(g, w)
        assert err <= gatol, f"grad of arg {i}: scaled error {err} > {gatol}"
    return tout, jout


def bf16_ulp_err(got, want) -> float:
    """max |got - want| in bf16 ulps of max(|want|, 2**-6)."""
    g = as_np(got).astype(np.float64)
    w = np.asarray(as_np(want), np.float64)
    assert g.shape == w.shape
    mag = np.maximum(np.abs(w), 2.0 ** -6)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    return float(np.max(np.abs(g - w) / ulp))
