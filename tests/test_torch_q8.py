"""The port's q8 training pipeline (``paddle_tpu_torch/ops/q8.py`` and the
``q8_entry`` / ``img_conv_bn_q8`` / ``addto_q8`` / ``q8_exit`` layers)
against ``paddle_tpu``'s on the CPU: the counterparts of
``tests/test_q8.py``'s cases (less ``test_dp_sharding_invariance``, a
mesh case: ROADMAP A10), each held against the JAX function on the same
numpy inputs, and the blocks one by one.

Tolerances: block outputs and gradients within 1e-5 of max(1, max|JAX
value|) (fp32, one op chain each side); stash codes equal where no
convolution precedes them, else counted flips of one step
(``tests/torch_q8_util.py``); graph steps within 1e-4 (``Q8Net``).
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu.models  # noqa: F401
import paddle_tpu.trainer  # noqa: F401
import paddle_tpu_torch as T
import paddle_tpu_torch.models  # noqa: F401
import paddle_tpu_torch.trainer  # noqa: F401
from paddle_tpu.ops import q8 as jq8
from paddle_tpu_torch.ops import prng
from paddle_tpu_torch.ops import q8 as tq8
from paddle_tpu_torch.utils.rng import KeySource
from tests.torch_layers_util import both_values, keep_global_seed  # noqa
from tests.torch_ops_util import as_np, scaled_err
from tests.torch_q8_util import Q8Net, count_flips

pytestmark = pytest.mark.usefixtures("keep_global_seed")

BLOCK_TOL = 1e-5
GRAPH_TOL = 1e-4


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_(grad)


def _close(got, want, tol=BLOCK_TOL, label=""):
    err = scaled_err(got, want)
    assert err <= tol, f"{label}: scaled error {err} > {tol}"


# ---------------------------------------------------------------------------
# the two-layer chain of tests/test_q8.py, in both packages


def _draws(C=16, N=4, H=8, W=8):
    rng = np.random.RandomState(0)
    x = rng.randn(N, H, W, C).astype(np.float32)
    w1 = (rng.randn(3, 3, C, C) * 0.1).astype(np.float32)
    w2 = (rng.randn(3, 3, C, C) * 0.1).astype(np.float32)
    g1 = np.full(C, 1.1, np.float32)
    b1 = np.full(C, 0.05, np.float32)
    g2 = np.full(C, 0.8, np.float32)
    b2 = np.zeros(C, np.float32)
    st = {k: (np.zeros(C, np.float32) if k.endswith("mu")
              else np.ones(C, np.float32))
          for k in ("e_mu", "e_s", "c1_mu", "c1_s", "c2_mu", "c2_s")}
    return x, (w1, g1, b1, w2, g2, b2), st


def _chain(q8, x, w1, g1, b1, w2, g2, b2, st, codes=None):
    """``tests/test_q8.py::_q8_two_layer`` over either package's module;
    ``codes`` collects the three stashes."""
    yh, q, mu_x, amax_x = q8.entry_stash(x, st["e_mu"], st["e_s"])
    M0, B0 = q8.fold_identity(st["e_mu"])
    yh1, q1, mu1, v1, a1 = q8.make_conv_q8(1, 1, False)(
        yh, q, w1, M0, B0, st["e_mu"], st["e_s"], st["c1_mu"], st["c1_s"])
    M1, B1 = q8.fold_bn_affine(mu1, v1, g1, b1)
    yh2, q2, mu2, v2, a2 = q8.make_conv_q8(1, 1, True)(
        yh1, q1, w2, M1, B1, st["c1_mu"], st["c1_s"], st["c2_mu"],
        st["c2_s"])
    M2, B2 = q8.fold_bn_affine(mu2, v2, g2, b2)
    out = q8.make_exit(True)(yh2, q2, M2, B2, st["c2_mu"], st["c2_s"])
    if codes is not None:
        codes.extend([q, q1, q2])
    new = dict(e_mu=mu_x, e_s=q8.scale_from_amax(amax_x), c1_mu=mu1,
               c1_s=q8.scale_from_amax(a1), c2_mu=mu2,
               c2_s=q8.scale_from_amax(a2))
    return out, new


def _calibrated():
    """The draws and, in each package, the state after one calibration
    step (``tests/test_q8.py::_setup``)."""
    x, p, st = _draws()
    _, jst = _chain(jq8, jnp.asarray(x), *map(jnp.asarray, p),
                    {k: jnp.asarray(v) for k, v in st.items()})
    with torch.no_grad():
        _, tst = _chain(tq8, _t(x), *map(_t, p),
                        {k: _t(v) for k, v in st.items()})
    for k in jst:
        _close(tst[k], jst[k], label=f"calibrated {k}")
    return x, p, {k: np.asarray(v) for k, v in jst.items()}


def _dense_j(x, w1, g1, b1, w2, g2, b2):
    import tests.test_q8 as ref
    return ref._dense_two_layer(x, w1, g1, b1, w2, g2, b2)


def _dense_t(x, w1, g1, b1, w2, g2, b2, eps=1e-5):
    from paddle_tpu_torch.ops import conv as tconv

    def bn_relu(y, g, b):
        mu = y.mean((0, 1, 2))
        v = ((y - mu) ** 2).mean((0, 1, 2))
        return torch.clamp_min((y - mu) * torch.rsqrt(v + eps) * g + b, 0)

    t1 = bn_relu(tconv.conv2d(x, w1, stride=1, padding=1).float(), g1, b1)
    return bn_relu(tconv.conv2d(t1, w2, stride=1, padding=1).float(), g2, b2)


@pytest.fixture
def exact_quantizer(monkeypatch):
    """A float passthrough for the quantizer in both packages (the
    reference's ``exact_quantizer``)."""
    monkeypatch.setattr(jq8, "_quantize",
                        lambda z, stash="int8", key=None: z)
    monkeypatch.setattr(tq8, "_quantize",
                        lambda z, stash="int8", key=None: z)
    for m in (jq8, tq8):
        for f in (m.make_conv_q8, m.make_add_q8, m.make_exit, m.make_entry):
            f.cache_clear()
    yield
    for m in (jq8, tq8):
        for f in (m.make_conv_q8, m.make_add_q8, m.make_exit, m.make_entry):
            f.cache_clear()


def _loss_grads(fn, params, pkg):
    """(loss, gradients) of sum(fn(*params)**2) in one package."""
    if pkg == "jax":
        def loss(*p):
            return jnp.sum(fn(*p).astype(jnp.float32) ** 2)
        ps = tuple(jnp.asarray(p) for p in params)
        return jax.value_and_grad(loss, argnums=tuple(range(len(ps))))(*ps)
    ps = [_t(p, True) for p in params]
    loss = (fn(*ps).float() ** 2).sum()
    return loss, torch.autograd.grad(loss, ps)


class TestGradientRouting:
    """With the float passthrough quantizer the q8 chain is the dense
    conv + BN + ReLU chain in both packages; the port's chain and
    gradients equal the JAX chain's."""

    def test_forward_matches_dense(self, exact_quantizer):
        x, p, st = _calibrated()
        jout, _ = _chain(jq8, jnp.asarray(x), *map(jnp.asarray, p),
                         {k: jnp.asarray(v) for k, v in st.items()})
        tout, _ = _chain(tq8, _t(x), *map(_t, p),
                         {k: _t(v) for k, v in st.items()})
        _close(tout, jout, label="q8 chain")
        np.testing.assert_allclose(as_np(tout), as_np(_dense_t(
            _t(x), *map(_t, p))), rtol=1e-3, atol=1e-3)
        _close(_dense_t(_t(x), *map(_t, p)),
               _dense_j(jnp.asarray(x), *map(jnp.asarray, p)),
               label="dense chain")

    def test_grads_match_dense(self, exact_quantizer):
        x, p, st = _calibrated()
        jl, jg = _loss_grads(lambda *q: _chain(
            jq8, jnp.asarray(x), *q,
            {k: jnp.asarray(v) for k, v in st.items()})[0], p, "jax")
        tl, tg = _loss_grads(lambda *q: _chain(
            tq8, _t(x), *q, {k: _t(v) for k, v in st.items()})[0], p,
            "torch")
        _, dg = _loss_grads(lambda *q: _dense_t(_t(x), *q), p, "torch")
        assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
        for name, a, b, d in zip("w1 g1 b1 w2 g2 b2".split(), tg, jg, dg):
            _close(a, b, 1e-4, f"grad {name}")
            rel = float((a - d).abs().max() / (d.abs().max() + 1e-9))
            assert rel < 0.02, f"grad {name} vs dense: {rel}"

    def test_add_block_grads(self, exact_quantizer):
        C = 8
        rng = np.random.RandomState(3)
        za, zb = (rng.randn(4, 4, 4, C).astype(np.float32) for _ in "ab")
        Ma0 = np.full(C, 1.3, np.float32)
        Ba0 = np.full(C, 0.1, np.float32)

        def chain(q8, za, zb, Ma, Ba, mk):
            zmu, ones = mk(np.zeros(C)), mk(np.ones(C))
            ya, qa, _, _ = q8.entry_stash(za, zmu, ones * 0.02)
            yb, qb, _, _ = q8.entry_stash(zb, zmu, ones * 0.02)
            yh, q, mu, amax = q8.make_add_q8(False, True)(
                ya, qa, Ma, Ba, zmu, ones * 0.02, yb, qb, ones, zmu,
                zmu, ones * 0.02, zmu, ones * 0.05)
            return q8.make_exit(True)(yh, q, ones, zmu, zmu, ones * 0.05)

        jl, jg = _loss_grads(lambda *a: chain(
            jq8, *a, lambda v: jnp.asarray(v, jnp.float32)),
            (za, zb, Ma0, Ba0), "jax")
        tl, tg = _loss_grads(lambda *a: chain(tq8, *a, _t),
                             (za, zb, Ma0, Ba0), "torch")
        for name, a, b in zip("za zb Ma Ba".split(), tg, jg):
            _close(a, b, 1e-4, f"grad {name}")

    def test_entry_mu_output_is_differentiable(self):
        x = np.random.RandomState(0).randn(2, 4, 4, 3).astype(np.float32)
        jg = jax.grad(lambda v: jnp.sum(jq8.entry_stash(
            v, jnp.zeros(3), jnp.ones(3))[2]))(jnp.asarray(x))
        tx = _t(x, True)
        tg, = torch.autograd.grad(
            tq8.entry_stash(tx, torch.zeros(3), torch.ones(3))[2].sum(), tx)
        np.testing.assert_allclose(as_np(tg), 1.0 / 32, rtol=1e-6)
        _close(tg, jg, label="d mean / dx")

    def test_carrier_is_dead_in_forward(self):
        """The carriers hold one element each (no dense activation kept
        between blocks) while their gradients have the full shape, and
        the chain saves for backward its three int8 stashes, the two
        weights and O(C) vectors, nothing else of activation size."""
        x, p, st = _calibrated()
        ps = [_t(a, True) for a in p]
        xt = _t(x, True)
        saved = []

        def pack(t):
            saved.append((tuple(t.shape), t.dtype,
                          t.untyped_storage().nbytes(), t.data_ptr()))
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            yh, q, mu, _ = tq8.entry_stash(xt, _t(st["e_mu"]),
                                           _t(st["e_s"]))
            out, _ = _chain(tq8, xt, *ps, {k: _t(v) for k, v in st.items()})
        assert yh.shape == x.shape
        assert yh.untyped_storage().nbytes() == yh.element_size()
        act = int(np.prod(x.shape))
        distinct = {s[3]: s for s in saved}.values()
        big = [s for s in distinct if int(np.prod(s[0])) >= act]
        assert [s[1] for s in big] == [torch.int8] * 3, big
        small = sum(n for shape, _, n, _ in distinct
                    if int(np.prod(shape)) < act)
        weights = 2 * p[0].nbytes
        assert small <= weights + 64 * 16 * 4, (small, weights)
        g, = torch.autograd.grad((out.float() ** 2).sum(), ps[0])
        assert g.shape == p[0].shape and float(g.abs().max()) > 0


class TestInt8Mode:
    def _both(self):
        x, p, st = _calibrated()
        jc, tc = [], []
        jout, jst = _chain(jq8, jnp.asarray(x), *map(jnp.asarray, p),
                           {k: jnp.asarray(v) for k, v in st.items()}, jc)
        with torch.no_grad():
            tout, tst = _chain(tq8, _t(x), *map(_t, p),
                               {k: _t(v) for k, v in st.items()}, tc)
        return x, p, (jout, jst, jc), (tout, tst, tc)

    def test_forward_close(self):
        x, p, (jout, _, jc), (tout, _, tc) = self._both()
        # the entry reads the input itself: its codes are exact
        np.testing.assert_array_equal(as_np(tc[0]), np.asarray(jc[0]))
        for i in (1, 2):
            count_flips(tc[i], jc[i], f"conv{i}")
        _close(tout, jout, 1e-4, "out")
        ref = as_np(_dense_t(_t(x), *map(_t, p)))
        err = np.abs(as_np(tout) - ref).max() / np.abs(ref).max()
        assert err < 0.06, f"int8 fwd rel err {err}"

    def test_scale_state_tracks_amax(self):
        _, _, (_, jst, _), (_, tst, _) = self._both()
        for k in ("e_s", "c1_s", "c2_s"):
            s = as_np(tst[k])
            assert np.isfinite(s).all() and (s > 0).all()
            _close(tst[k], jst[k], label=k)

    def test_stash_is_int8(self):
        x, _, st = _calibrated()
        yh, q, mu, amax = tq8.entry_stash(_t(x), _t(st["e_mu"]),
                                          _t(st["e_s"]))
        jq = jq8.entry_stash(jnp.asarray(x), jnp.asarray(st["e_mu"]),
                             jnp.asarray(st["e_s"]))[1]
        assert q.dtype == torch.int8
        assert yh.dtype == torch.float32   # the compute dtype in tests
        np.testing.assert_array_equal(as_np(q), np.asarray(jq))


# ---------------------------------------------------------------------------
# the blocks one by one, same operands in both packages


def _block_operands(C, N=4, H=8, seed=0, stash="int8"):
    rng = np.random.RandomState(seed)
    s_in = np.full(C, 0.03, np.float32)
    mu_in = (rng.randn(C) * 0.1).astype(np.float32)
    if stash == "int8":
        q_in = rng.randint(-127, 128, (N, H, H, C)).astype(np.int8)
    else:
        q_in = (rng.randn(N, H, H, C) * 3).astype(np.float32)
    return rng, q_in, mu_in, s_in


def _stash_pair(q, stash):
    if stash == "int8":
        return jnp.asarray(q), torch.from_numpy(q.copy())
    return (jnp.asarray(q, jnp.bfloat16),
            torch.from_numpy(q.copy()).to(torch.bfloat16))


@pytest.mark.parametrize("stash,stochastic", [("int8", False),
                                              ("bf16", False),
                                              ("int8", True)])
def test_entry_block_matches(stash, stochastic):
    """The entry: stash bytes equal (the q8sr draws from the same key),
    mu and amax within 1e-5, the input gradient from cotangents on the
    carrier and mu within 1e-5."""
    rng = np.random.RandomState(1)
    C = 8
    x = rng.randn(4, 8, 8, C).astype(np.float32)
    mu_p = (rng.randn(C) * 0.1).astype(np.float32)
    s_p = np.full(C, 0.02, np.float32)
    jkey = (jax.random.PRNGKey(11),) if stochastic else ()
    tkey = (prng.prng_key(11),) if stochastic else ()
    jy, jqq, jmu, ja = jq8.make_entry(stash, stochastic)(
        jnp.asarray(x), jnp.asarray(mu_p), jnp.asarray(s_p), *jkey)
    tx = _t(x, True)
    ty, tqq, tmu, ta = tq8.make_entry(stash, stochastic)(
        tx, _t(mu_p), _t(s_p), *tkey)
    np.testing.assert_array_equal(as_np(tqq), as_np(np.asarray(
        jqq).astype(np.float32) if stash == "bf16" else jqq))
    _close(tmu, jmu, label="mu")
    _close(ta, ja, label="amax")
    gy = rng.randn(*x.shape).astype(np.float32)
    gm = rng.randn(C).astype(np.float32)
    jg = jax.grad(lambda v: jnp.sum(jq8.make_entry(stash, stochastic)(
        v, jnp.asarray(mu_p), jnp.asarray(s_p), *jkey)[0] * gy)
        + jnp.sum(jq8.make_entry(stash, stochastic)(
            v, jnp.asarray(mu_p), jnp.asarray(s_p), *jkey)[2] * gm))(
        jnp.asarray(x))
    tg, = torch.autograd.grad((ty * _t(gy)).sum() + (tmu * _t(gm)).sum(), tx)
    _close(tg, jg, label="dx")


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("relu_in", [False, True])
@pytest.mark.parametrize("stash", ["int8", "bf16"])
def test_conv_block_matches(stride, relu_in, stash):
    """conv_q8 from the same stash: the dequantized output stash, mu,
    var and amax against JAX's carrier and outputs, its codes (flips
    after the convolution counted), and every input gradient from
    cotangents on the carrier, mu and var."""
    C = 8
    rng, q_in, mu_in, s_in = _block_operands(C, stash=stash)
    w = (rng.randn(3, 3, C, 2 * C) * 0.1).astype(np.float32)
    M = (1 + rng.randn(C) * 0.1).astype(np.float32)
    B = (rng.randn(C) * 0.1).astype(np.float32)
    mu_po = np.zeros(2 * C, np.float32)
    s_po = np.full(2 * C, 0.05, np.float32)
    jq_in, tq_in = _stash_pair(q_in, stash)
    N, H = q_in.shape[:2]
    Ho = H // stride
    gy = rng.randn(N, Ho, Ho, 2 * C).astype(np.float32)
    gm, gv = (rng.randn(2 * C).astype(np.float32) for _ in "mv")
    carrier = np.zeros(q_in.shape, np.float32)

    def jrun(car, w_, M_, B_):
        return jq8.make_conv_q8(stride, 1, relu_in, stash)(
            car, jq_in, w_, M_, B_, jnp.asarray(mu_in), jnp.asarray(s_in),
            jnp.asarray(mu_po), jnp.asarray(s_po))

    def jloss(*a):
        o = jrun(*a)
        return (jnp.sum(o[0] * gy) + jnp.sum(o[2] * gm)
                + jnp.sum(o[3] * gv))

    jargs = tuple(map(jnp.asarray, (carrier, w, M, B)))
    jo = jrun(*jargs)
    jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(*jargs)
    targs = [_t(a, True) for a in (carrier, w, M, B)]
    to = tq8.make_conv_q8(stride, 1, relu_in, stash)(
        targs[0], tq_in, targs[1], targs[2], targs[3], _t(mu_in), _t(s_in),
        _t(mu_po), _t(s_po))
    count_flips(to[1], jo[1], "q_out")
    _close(tq8._dequant(to[1], _t(mu_po), _t(s_po)), jo[0], 1e-4, "yhat")
    for i, name in ((2, "mu"), (3, "var"), (4, "amax")):
        _close(to[i], jo[i], label=name)
    tl = ((to[0] * _t(gy)).sum() + (to[2] * _t(gm)).sum()
          + (to[3] * _t(gv)).sum())
    tg = torch.autograd.grad(tl, targs)
    for name, a, b in zip(("d_yhat_in", "dw", "dM", "dB"), tg, jg):
        _close(a, b, 1e-4, name)


@pytest.mark.parametrize("relu_a,relu_b", [(False, True), (True, False)])
def test_add_and_exit_blocks_match(relu_a, relu_b):
    """add_q8 and the exit from the same stashes: the sum's stash bytes
    equal (no convolution precedes them), mu and amax within 1e-5, the
    exit's output and every gradient within 1e-5."""
    C = 8
    rng, qa, mu_a, s_a = _block_operands(C, seed=2)
    _, qb, mu_b, s_b = _block_operands(C, seed=3)
    vec = [(1 + rng.randn(C) * 0.1).astype(np.float32) if i % 2 == 0
           else (rng.randn(C) * 0.1).astype(np.float32) for i in range(4)]
    mu_po = np.zeros(C, np.float32)
    s_po = np.full(C, 0.06, np.float32)
    car = np.zeros(qa.shape, np.float32)
    gx = rng.randn(*qa.shape).astype(np.float32)

    def run(q8, mk, qs, args):
        ya, Ma, Ba, yb, Mb, Bb = args
        yh, q, mu, amax = q8.make_add_q8(relu_a, relu_b)(
            ya, qs[0], Ma, Ba, mk(mu_a), mk(s_a), yb, qs[1], Mb, Bb,
            mk(mu_b), mk(s_b), mk(mu_po), mk(s_po))
        M2, B2 = q8.fold_identity(mu)
        out = q8.make_exit(True)(yh, q, M2 * 1.1, B2 + 0.05, mk(mu_po),
                                 mk(s_po))
        return q, mu, amax, out

    jargs = tuple(map(jnp.asarray, (car, vec[0], vec[1], car, vec[2],
                                    vec[3])))
    jq = (jnp.asarray(qa), jnp.asarray(qb))
    jres = run(jq8, jnp.asarray, jq, jargs)
    jg = jax.grad(lambda *a: jnp.sum(run(jq8, jnp.asarray, jq, a)[3] * gx),
                  argnums=tuple(range(6)))(*jargs)
    targs = [_t(a, True) for a in (car, vec[0], vec[1], car, vec[2],
                                   vec[3])]
    tq = (torch.from_numpy(qa.copy()), torch.from_numpy(qb.copy()))
    tres = run(tq8, _t, tq, targs)
    np.testing.assert_array_equal(as_np(tres[0]), np.asarray(jres[0]))
    for i, name in ((1, "mu"), (2, "amax"), (3, "exit")):
        _close(tres[i], jres[i], label=name)
    tg = torch.autograd.grad((tres[3] * _t(gx)).sum(), targs)
    for name, a, b in zip("ya Ma Ba yb Mb Bb".split(), tg, jg):
        _close(a, b, label=f"grad {name}")


# ---------------------------------------------------------------------------
# the layer graph (tests/test_q8.py::_build_q8_graph)


def _build_q8_graph(P, C=8, img=8, classes=5):
    layer, act = P.layer, P.activation
    img_l = layer.data("image", P.data_type.dense_vector(C * img * img))
    lbl = layer.data("label", P.data_type.integer_value(classes))
    stem = layer.img_conv(img_l, 3, C, num_channels=C, stride=1, padding=1,
                          act=act.Relu(), bias_attr=False,
                          name="q8t_stem", img_size=img)
    ent = layer.q8_entry(stem, name="q8t_entry")
    c1 = layer.img_conv_bn_q8(ent, 3, C, num_channels=C, stride=1,
                              padding=1, act=act.Relu(), name="q8t_1",
                              conv_name="q8t_1_conv", bn_name="q8t_1_bn")
    c2 = layer.img_conv_bn_q8(c1, 3, C, num_channels=C, stride=1,
                              padding=1, act=None, name="q8t_2",
                              conv_name="q8t_2_conv", bn_name="q8t_2_bn")
    add = layer.addto_q8([c2, ent], act=act.Relu(), name="q8t_add")
    ex = layer.q8_exit(add, name="q8t_exit")
    fc = layer.fc(ex, classes, act=act.Softmax(), name="q8t_fc")
    return layer.classification_cost(fc, lbl, name="q8t_cost")


def _graph_rows():
    rng = np.random.RandomState(0)
    return both_values({
        "image": rng.rand(8, 8 * 8 * 8).astype(np.float32),
        "label": rng.randint(0, 5, 8).astype(np.int32)})


class TestLayerGraph:
    def _steps(self, P, n, device_kw):
        """``n`` Momentum steps of the graph in one package (the JAX
        package's jitted step of the reference test; the port's eager
        autograd): (losses, parameters, state, forward)."""
        cost = _build_q8_graph(P)
        topo = P.topology.Topology(cost)
        params = P.parameters.create(cost, KeySource(7) if P is T else
                                     J.utils.rng.KeySource(7), **device_kw)
        opt = P.optimizer.Momentum(momentum=0.9, learning_rate=0.05)
        opt.bind(topo.param_specs())
        fwd = topo.compile()
        jf, tf = _graph_rows()
        feeds = tf if P is T else jf
        p, s = params.values, params.state
        o = opt.init_state(p)
        losses = []
        for i in range(n):
            if P is T:
                leaves = {k: v.detach().requires_grad_() for k, v in
                          p.items()}
                outs, ns = fwd(leaves, s, feeds, is_training=True)
                loss = outs["q8t_cost"].array.float().mean()
                g = torch.autograd.grad(loss, list(leaves.values()))
                p, o = opt.update(i, dict(zip(leaves, g)), p, o)
                s = {k: v.detach() for k, v in ns.items()}
            else:
                def loss_fn(p_, s_=s):
                    outs, ns = fwd(p_, s_, feeds, is_training=True)
                    return jnp.mean(outs["q8t_cost"].array), ns
                (loss, s), g = jax.value_and_grad(loss_fn,
                                                  has_aux=True)(p)
                p, o = opt.update(jnp.asarray(i, jnp.int32), g, p, o)
            losses.append(float(loss))
        return losses, p, s, fwd

    def test_trains_and_state_updates(self):
        """8 steps in each package: finite losses that fall, the delayed
        scales moved off 1; the first step's loss within 1e-4."""
        jl, _, js, _ = self._steps(J, 8, {})
        tl, _, ts, _ = self._steps(T, 8, {"device": "cpu"})
        for losses, s in ((jl, js), (tl, ts)):
            assert all(np.isfinite(losses))
            assert float(np.abs(as_np(s["q8t_1.q_scale"]) - 1).max()) > 1e-3
            assert losses[-1] < losses[1]
        assert abs(tl[0] - jl[0]) <= GRAPH_TOL * max(1.0, abs(jl[0]))

    def test_first_step_matches_jax(self):
        """One training step of the graph from the same parameters: every
        stash's codes (flips counted), the cost, the new state (running
        BN statistics, q_mean, q_scale) and every gradient."""
        net = Q8Net(_build_q8_graph, seed=7)
        jf, tf = _graph_rows()
        net.check(jf, tf, is_training=True, grad=True, atol=GRAPH_TOL,
                  gatol=GRAPH_TOL)
        assert set(net.flips) == {"q8t_entry", "q8t_1", "q8t_2", "q8t_add"}

    def test_eval_path_is_dense_bn_infer(self):
        """Eval runs conv -> BN(running statistics) -> act, the same in
        both packages, after 3 training steps of the port."""
        _, p, s, fwd = self._steps(T, 3, {"device": "cpu"})
        net = Q8Net(_build_q8_graph, seed=7)
        buf = io.BytesIO()
        tp = net.tparams
        tp.values = {k: v.detach() for k, v in p.items()}
        tp.state = s
        tp.to_tar(buf)
        buf.seek(0)
        net.jparams.from_tar_into(buf)
        net.tparams = tp
        jf, tf = _graph_rows()
        (jo, js, _), (to, ts, _) = net.run(jf, tf, is_training=False)
        _close(to["q8t_cost"].array, jo["q8t_cost"].array, GRAPH_TOL,
               "eval cost")
        assert np.isfinite(as_np(to["q8t_cost"].array)).all()
        for k in js:
            np.testing.assert_array_equal(as_np(ts[k]), as_np(js[k]))

    def test_param_names_match_dense_pair(self):
        jt = J.topology.Topology(_build_q8_graph(J))
        tt = T.topology.Topology(_build_q8_graph(T))
        for get in ("param_specs", "state_specs"):
            assert [(s.name, tuple(s.shape)) for s in getattr(tt, get)()] \
                == [(s.name, tuple(s.shape)) for s in getattr(jt, get)()]
        names = {s.name for s in tt.param_specs()}
        assert {"q8t_1_conv.w", "q8t_1_bn.gamma", "q8t_1_bn.beta"} <= names
        state = {s.name for s in tt.state_specs()}
        assert {"q8t_1_bn.mean", "q8t_1_bn.var", "q8t_1.q_scale",
                "q8t_add.q_mean"} <= state

    def test_resnet50_q8_builds(self):
        def build(P):
            img = P.layer.data("image",
                               P.data_type.dense_vector(3 * 224 * 224))
            return P.models.resnet.resnet_imagenet(img, depth=50,
                                                   class_num=1000,
                                                   fused_bn="q8")
        jt, tt = (P.topology.Topology(build(P)) for P in (J, T))
        names = [(s.name, tuple(s.shape)) for s in tt.param_specs()]
        assert names == [(s.name, tuple(s.shape))
                         for s in jt.param_specs()]
        assert ("res2_0_a_conv.w", (1, 1, 64, 64)) in names
        assert "res2_0_a_bn.gamma" in dict(names)


def _twin(P, mode, prefix, stash="int8"):
    """The reference twin: a dense stem, then a stride-2 bottleneck with
    projection and an identity bottleneck, on ``mode``."""
    resnet, layer = P.models.resnet, P.layer
    img = layer.data("image", P.data_type.dense_vector(8 * 8 * 8))
    body = resnet.conv_bn_layer(img, 8, 3, 1, 1, P.activation.Relu(),
                                ch_in=8, name=f"{prefix}_stem")
    if mode:
        body = layer.q8_entry(body, name=f"{prefix}_entry", stash=stash)
    body = resnet.bottleneck_block(body, 8, 4, 2, name=f"{prefix}_b0",
                                   fused=mode)
    body = resnet.bottleneck_block(body, 16, 4, 1, name=f"{prefix}_b1",
                                   fused=mode)
    if mode:
        body = layer.q8_exit(body, name=f"{prefix}_exit")
    return body


def _twin_check(mode, prefix, stash, mean_tol, max_tol):
    """Both packages' q8 twin against JAX's (codes counted, outputs and
    state within 1e-4), then the port's q8 twin against its dense twin
    from the same parameters after a calibration step (the reference's
    bounds)."""
    net = Q8Net(lambda P: _twin(P, mode, prefix, stash), seed=11)
    # the reference's input: NHWC images fed whole
    x = np.random.RandomState(0).rand(8, 8, 8, 8).astype(np.float32)
    jf, tf = both_values({"image": x})
    (jo, js, _), (to, ts, _) = net.check(jf, tf, is_training=True,
                                         atol=GRAPH_TOL)
    q8_topo = T.topology.Topology(_twin(T, mode, prefix, stash))
    q8_fwd = q8_topo.compile()
    dense = T.topology.Topology(_twin(T, False, prefix))
    dense_fwd = dense.compile()
    vals = net.tparams.values
    assert {s.name for s in dense.param_specs()} <= set(vals)
    out_name = q8_topo.outputs[0].name
    _, st = q8_fwd(vals, net.tparams.state, tf, is_training=True)
    with torch.no_grad():
        outs, _ = q8_fwd(vals, st, tf, is_training=True)
        dstate = {s.name: net.tparams.state[s.name]
                  for s in dense.state_specs()}
        douts, _ = dense_fwd(vals, dstate, tf, is_training=True)
    a = outs[out_name].array.float()
    b = douts[dense.outputs[0].name].array.float()
    diff = (a - b).abs()
    mean_rel = float(diff.mean() / (b.abs().mean() + 1e-9))
    max_rel = float(diff.max() / (b.abs().max() + 1e-9))
    assert mean_rel < mean_tol, mean_rel
    assert max_rel < max_tol, max_rel


class TestBottleneckTwin:
    def test_forward_tracks_dense_twin(self):
        # the reference's bounds: int8 noise over 7 quantized layers at
        # toy widths
        _twin_check("q8", "tw", "int8", 0.05, 0.25)

    def test_non_q8_consumer_rejected(self):
        for P in (J, T):
            resnet, layer = P.models.resnet, P.layer
            img = layer.data("image", P.data_type.dense_vector(8 * 8 * 8))
            stem = resnet.conv_bn_layer(img, 8, 3, 1, 1,
                                        P.activation.Relu(), ch_in=8,
                                        name="tg_stem")
            ent = layer.q8_entry(stem, name="tg_entry")
            c1 = layer.img_conv_bn_q8(ent, 3, 8, num_channels=8, stride=1,
                                      padding=1, act=P.activation.Relu(),
                                      name="tg_c1")
            pool = layer.img_pool(c1, pool_size=4, stride=4)
            with pytest.raises(Exception, match="q8"):
                P.topology.Topology(pool)


class TestDeferMode:
    def test_bottleneck_twin_tight(self):
        # bf16 stash: the reference's bf16-noise bound
        _twin_check("defer", "td", "bf16", 0.02, 0.02)

    def test_stash_dtype_is_bf16(self):
        x = np.random.RandomState(0).randn(2, 4, 4, 8).astype(np.float32)
        q = tq8.make_entry("bf16")(_t(x), torch.zeros(8), torch.ones(8))[1]
        jq = jq8.make_entry("bf16")(jnp.asarray(x), jnp.zeros(8),
                                    jnp.ones(8))[1]
        assert q.dtype == torch.bfloat16 and jq.dtype == jnp.bfloat16
        np.testing.assert_array_equal(as_np(q),
                                      np.asarray(jq).astype(np.float32))

    def test_grads_flow(self):
        C = 8
        rng = np.random.RandomState(1)
        x = rng.randn(2, 4, 4, C).astype(np.float32)
        w = (rng.randn(3, 3, C, C) * 0.1).astype(np.float32)

        def loss(q8, mk, x_, w_):
            z, o = mk(np.zeros(C)), mk(np.ones(C))
            yh, q, mu, amax = q8.make_entry("bf16")(x_, z, o)
            M, B = q8.fold_identity(mu)
            yh2, q2, mu2, v2, a2 = q8.make_conv_q8(1, 1, False, "bf16")(
                yh, q, w_, M, B, z, o, z, o)
            out = q8.make_exit(True)(yh2, q2, *q8.fold_bn_affine(
                mu2, v2, o, z), z, o)
            return (out.astype(jnp.float32) ** 2).sum() if q8 is jq8 \
                else (out.float() ** 2).sum()

        jg = jax.grad(lambda a, b: loss(jq8, jnp.asarray, a, b),
                      argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
        tx, tw = _t(x, True), _t(w, True)
        tg = torch.autograd.grad(loss(tq8, _t, tx, tw), (tx, tw))
        for a, b in zip(tg, jg):
            assert torch.isfinite(a).all() and float(a.abs().max()) > 0
            _close(a, b, 1e-4)


# ---------------------------------------------------------------------------
# the trainer: gradient accumulation, checkpoints, stochastic rounding


def _small_net(P, fused="q8", prefix="qc", stochastic=False):
    resnet, layer = P.models.resnet, P.layer
    img = layer.data("img", P.data_type.dense_vector(3 * 8 * 8))
    lbl = layer.data("lbl", P.data_type.integer_value(4))
    stem = resnet.conv_bn_layer(img, 8, 3, 1, 1, P.activation.Relu(),
                                ch_in=3, name=f"{prefix}_stem")
    ent = layer.q8_entry(stem, name=f"{prefix}_entry", stochastic=stochastic)
    b1 = resnet.basic_block(ent, 8, 8, 1, name=f"{prefix}_b1", fused=fused)
    ex = layer.q8_exit(b1, name=f"{prefix}_exit")
    pool = layer.img_pool(ex, pool_size=8, stride=1,
                          pool_type=P.pooling.Avg(), name=f"{prefix}_pool")
    sm = layer.fc(pool, 4, act=P.activation.Softmax(), name=f"{prefix}_sm")
    return layer.classification_cost(sm, lbl, name=f"{prefix}_cost")


def _small_data(n=32):
    rng = np.random.RandomState(0)
    protos = rng.randn(4, 8, 8, 3).astype(np.float32)
    ys = rng.randint(0, 4, n)
    xs = (protos[ys] + rng.randn(n, 8, 8, 3) * 0.3).astype(np.float32)
    return [(xs[i].reshape(-1), int(ys[i])) for i in range(n)]


def _train(P, cost, passes, **sgd):
    if P is T:
        params = T.parameters.create(cost, KeySource(3), device="cpu")
    else:
        params = J.parameters.create(cost, J.utils.rng.KeySource(3))
    tr = P.trainer.SGD(cost=cost, parameters=params,
                       update_equation=P.optimizer.Momentum(
                           momentum=0.9, learning_rate=0.1), **sgd)
    data = _small_data()
    costs = []
    tr.train(reader=P.batch(lambda: iter(data), 16), num_passes=passes,
             event_handler=lambda e: costs.append(e.cost)
             if isinstance(e, P.event.EndIteration) else None)
    return tr, costs


class TestComposition:
    def test_grad_accum(self):
        """``grad_accum_steps=2``: the microbatch loop threads the
        delayed-scaling state in both packages; the first cost within
        1e-4 of JAX's, the costs fall, ``q_scale`` moved."""
        runs = [_train(P, _small_net(P), 6, grad_accum_steps=2)
                for P in (J, T)]
        (jtr, jc), (ttr, tc) = runs
        assert abs(tc[0] - jc[0]) <= GRAPH_TOL * max(1.0, abs(jc[0]))
        for tr, costs in runs:
            assert all(np.isfinite(costs)) and costs[-1] < costs[0]
            s = as_np(tr.parameters.state["qc_b1_a_q8.q_scale"])
            assert float(np.abs(s - 1.0).max()) > 1e-3

    def test_checkpoint_roundtrip_carries_q8_state(self, tmp_path):
        """The q8 state rides the parameters' tar (both packages read the
        port's) and ``io/checkpoint.py``'s save / resume."""
        from paddle_tpu_torch.io import checkpoint as ck
        tr, _ = _train(T, _small_net(T), 2)
        want = as_np(tr.parameters.state["qc_b1_a_q8.q_scale"])
        assert np.abs(want - 1.0).max() > 1e-3
        buf = io.BytesIO()
        tr.save_parameter_to_tar(buf)
        for P, kw in ((T, {"device": "cpu"}), (J, {})):
            buf.seek(0)
            got = P.parameters.Parameters.from_tar(buf, **kw)
            np.testing.assert_array_equal(
                as_np(got.state["qc_b1_a_q8.q_scale"]), want)
        path = ck.save_checkpoint(str(tmp_path), 2, tr.parameters.values,
                                  tr.opt_state, tr.parameters.state)
        assert path
        template = {k: torch.zeros_like(v)
                    for k, v in tr.parameters.state.items()}
        _, _, _, state = ck.load_checkpoint(
            path, tr.parameters.values, tr.opt_state, template)
        np.testing.assert_array_equal(as_np(state["qc_b1_a_q8.q_scale"]),
                                      want)


class TestStochasticRounding:
    def test_rounding_is_unbiased(self):
        """floor(z + U[0, 1)) with JAX's draws: the stash is JAX's byte
        for byte, and its mean is 0.3 where rounding gives 0."""
        z = np.full((200, 200), 0.3, np.float32)
        q = tq8._quantize(_t(z), "int8", prng.prng_key(0))
        jq = jq8._quantize(jnp.asarray(z), "int8", jax.random.PRNGKey(0))
        np.testing.assert_array_equal(as_np(q), np.asarray(jq))
        assert abs(float(q.float().mean()) - 0.3) < 0.02
        assert float(tq8._quantize(_t(z), "int8").float().mean()) == 0.0

    def test_trains_through_sgd(self):
        """q8sr through ``SGD.train``: the per-step dropout key reaches
        the stash sites (the first cost is JAX's within 1e-4: the same
        draws), and the costs fall."""
        runs = [_train(P, _small_net(P, "q8sr", "sr", True), 6)
                for P in (J, T)]
        (_, jc), (_, tc) = runs
        assert abs(tc[0] - jc[0]) <= GRAPH_TOL * max(1.0, abs(jc[0]))
        assert all(np.isfinite(tc)) and tc[-1] < tc[0]

    def test_bf16_stochastic_rejected(self):
        for q8 in (jq8, tq8):
            with pytest.raises(ValueError, match="int8 stash only"):
                q8.make_conv_q8(1, 1, False, "bf16", True)

    def test_missing_key_fails_loudly(self):
        layer = T.layer
        img = layer.data("img2", T.data_type.dense_vector(3 * 8 * 8))
        stem = T.models.resnet.conv_bn_layer(img, 8, 3, 1, 1,
                                             T.activation.Relu(), ch_in=3,
                                             name="srk_stem")
        ent = layer.q8_entry(stem, name="srk_entry", stochastic=True)
        ex = layer.q8_exit(ent, name="srk_exit")
        topo = T.topology.Topology(ex)
        params = T.parameters.create(ex, KeySource(1), device="cpu")
        with pytest.raises(Exception, match="dropout_key"):
            topo.compile()(params.values, params.state,
                           {"img2": torch.zeros(2, 3 * 8 * 8)},
                           is_training=True)
