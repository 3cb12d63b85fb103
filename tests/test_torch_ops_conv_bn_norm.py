"""The port's batch norm, conv_bn and the other norms against
``paddle_tpu``'s on the CPU.

Every case of ``tests/test_ops_norm_loss.py``'s norm half (train and
infer BN, layer norm, LRN, the fused BN backward against autodiff, BN
end to end) and ``tests/test_conv_bn_fused.py``'s op, plus ``rms_norm``,
the running statistics as new tensors, and ``conv_bn_train`` with
``save8`` off and on at strides 1 and 2: its int8 stash byte for byte
and its gradients against the JAX package's ``save8`` gradients (the
stash rounding is lossy by design, so never against the exact path).

Tolerances: fp32 forward 1e-5; gradients through BN and conv_bn 1e-4
(of max(1, max|JAX value|)); the save8 codes exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import conv_bn as jcb
from paddle_tpu.ops import norm as jnorm
from paddle_tpu_torch.ops import conv_bn as tcb
from paddle_tpu_torch.ops import norm as tnorm
from tests.torch_ops_util import parity, to_j, to_t

torch.set_num_threads(1)


def _bn_args(rng, shape, c):
    return [(rng.randn(*shape) * 2 + 1).astype(np.float32),
            (rng.rand(c) + 0.5).astype(np.float32),
            rng.randn(c).astype(np.float32),
            rng.randn(c).astype(np.float32),
            (rng.rand(c) + 0.5).astype(np.float32)]


@pytest.mark.parametrize("shape", [(16, 4), (4, 6, 6, 8)])
def test_batch_norm_train(rng, shape):
    args = _bn_args(rng, shape, shape[-1])
    t, _ = parity(lambda *a: jnorm.batch_norm_train(*a),
                  lambda *a: tnorm.batch_norm_train(*a), args,
                  wrt=(0, 1, 2))
    y = t[0].detach().numpy().reshape(-1, shape[-1])
    g, b = args[1], args[2]
    np.testing.assert_allclose(((y - b) / g).mean(0), 0, atol=1e-5)


def test_batch_norm_running_stats_are_new_tensors(rng):
    x, g, b, rm, rv = [to_t(a) for a in _bn_args(rng, (8, 3), 3)]
    rm0, rv0 = rm.clone(), rv.clone()
    _, nm, nv = tnorm.batch_norm_train(x, g, b, rm, rv, momentum=0.5)
    assert torch.equal(rm, rm0) and torch.equal(rv, rv0)
    assert nm.data_ptr() != rm.data_ptr() and nv.data_ptr() != rv.data_ptr()
    np.testing.assert_allclose(nm.numpy(), 0.5 * rm0.numpy()
                               + 0.5 * x.numpy().mean(0), rtol=1e-5)


def test_batch_norm_infer(rng):
    parity(lambda *a: jnorm.batch_norm_infer(*a),
           lambda *a: tnorm.batch_norm_infer(*a),
           _bn_args(rng, (8, 4), 4), wrt=(0, 1, 2))


def test_layer_norm(rng):
    x = rng.randn(6, 10).astype(np.float32)
    g, b = rng.rand(10).astype(np.float32) + 0.5, rng.randn(10).astype(
        np.float32)
    parity(lambda *a: jnorm.layer_norm(*a), lambda *a: tnorm.layer_norm(*a),
           [x, g, b], wrt=(0, 1, 2))


def test_rms_norm(rng):
    parity(lambda *a: jnorm.rms_norm(*a), lambda *a: tnorm.rms_norm(*a),
           [rng.randn(3, 5, 8).astype(np.float32),
            rng.rand(8).astype(np.float32) + 0.5], wrt=(0, 1))


@pytest.mark.parametrize("size", [5, 4])
def test_lrn(rng, size):
    x = rng.rand(1, 2, 2, 7).astype(np.float32)
    parity(lambda a: jnorm.lrn(a, size=size, alpha=0.3),
           lambda a: tnorm.lrn(a, size=size, alpha=0.3), [x], wrt=(0,))


class TestFusedBNBackward:
    """The closed-form BN backward against JAX's custom VJP and against
    torch's autograd through the plain formula."""

    def test_fused_vjp_matches_autodiff(self, rng):
        x, g, b = _bn_args(rng, (4, 6, 6, 8), 8)[:3]
        axes = (0, 1, 2)
        t, _ = parity(lambda *a: jnorm._bn_apply(*a, axes, 1e-5),
                      lambda *a: tnorm._BNApply.apply(*a, axes, 1e-5)[0],
                      [x, g, b], wrt=(0, 1, 2))
        # autograd through the statistics gives the same gradients
        xt, gt, bt = (to_t(a, True) for a in (x, g, b))
        dy = torch.from_numpy(rng.randn(4, 6, 6, 8).astype(np.float32))
        fused = torch.autograd.grad(
            (tnorm._BNApply.apply(xt, gt, bt, axes, 1e-5)[0] * dy).sum(),
            (xt, gt, bt))
        mean, var, inv = tnorm._bn_stats(xt, axes, 1e-5)
        plain = torch.autograd.grad(
            (tnorm.bn_affine(xt, gt, bt, mean, inv) * dy).sum(), (xt, gt, bt))
        for a, e in zip(fused, plain):
            torch.testing.assert_close(a, e, rtol=2e-4, atol=2e-5)

    def test_train_bn_end_to_end_grads(self, rng):
        x, g, b = _bn_args(rng, (8, 5), 5)[:3]
        rm, rv = np.zeros(5, np.float32), np.ones(5, np.float32)

        def jloss(x, g, b):
            y, _, _ = jnorm.batch_norm_train(x, g, b, to_j(rm), to_j(rv))
            return jnp.sum(jnp.square(y))

        def tloss(x, g, b):
            y, _, _ = tnorm.batch_norm_train(x, g, b, to_t(rm), to_t(rv))
            return y.square().sum()

        parity(jloss, tloss, [x, g, b], wrt=(0, 1, 2))


def _cb_args(rng, n=2, hw=8, cin=3, cout=4, k=3):
    return [rng.randn(n, hw, hw, cin).astype(np.float32),
            (rng.randn(k, k, cin, cout) * 0.3).astype(np.float32),
            (rng.rand(cout) + 0.5).astype(np.float32),
            rng.randn(cout).astype(np.float32),
            rng.randn(cout).astype(np.float32),
            (rng.rand(cout) + 0.5).astype(np.float32)]


def test_conv_bn_stats(rng):
    x, w = _cb_args(rng)[:2]
    parity(lambda a, b: jcb.conv_bn_stats(a, b, stride=2),
           lambda a, b: tcb.conv_bn_stats(a, b, stride=2), [x, w])


@pytest.mark.parametrize("save8", [False, True])
@pytest.mark.parametrize("stride,k,cout", [(1, 3, 4), (2, 3, 4), (2, 1, 6)])
def test_conv_bn_train(rng, save8, stride, k, cout):
    """Forward, new running statistics and the gradients of x, w, gamma,
    beta; with ``save8`` the gradients are the JAX package's save8 ones."""
    args = _cb_args(rng, cout=cout, k=k)
    # a channel whose mean dwarfs its spread: what the centered stash is for
    args[0] = args[0] + np.float32(3.0)
    kw = dict(stride=stride, save8=save8, momentum=0.8)
    parity(lambda *a: jcb.conv_bn_train(*a, **kw),
           lambda *a: tcb.conv_bn_train(*a, **kw), args, wrt=(0, 1, 2, 3))


@pytest.mark.parametrize("stride", [1, 2])
def test_conv_bn_save8_stash_bytes(rng, stride):
    """The int8 codes of x and of the centered conv output are the JAX
    package's, byte for byte; their scales agree within fp32 rounding."""
    x, w, g, b = _cb_args(rng)[:4]
    _, jres = jcb._conv_bn_fwd(to_j(x), to_j(w), to_j(g), to_j(b), stride,
                               "SAME", 1e-5, True)
    _, tres = tcb._conv_bn_fwd(to_t(x), to_t(w), to_t(g), to_t(b), stride,
                               "SAME", 1e-5, True)
    (jqx, jsx), _ = jres[2]
    (tqx, tsx), xdt = tres[2]
    assert tqx.dtype == torch.int8 and xdt == torch.float32
    np.testing.assert_array_equal(tqx.numpy(), np.asarray(jqx))
    np.testing.assert_array_equal(tsx.numpy(), np.asarray(jsx))
    jqz, jsz = jres[3]
    tqz, tsz = tres[3]
    np.testing.assert_array_equal(tqz.numpy(), np.asarray(jqz))
    np.testing.assert_allclose(tsz.numpy(), np.asarray(jsz), rtol=1e-6)
    assert jres[0] is None and jres[1] is None
    assert tres[0] is None and tres[1] is None


def test_quant8_codes_round_half_even():
    """Ties round to even, clip at ±127: the same codes as ``_quant8``."""
    t = np.asarray([[0.5], [1.5], [2.5], [-0.5], [-2.5], [127.0]],
                   np.float32)
    jq, js = jcb._quant8(to_j(t))
    tq, ts = tcb._quant8(to_t(t))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tq.numpy()[:, 0], [0, 2, 2, 0, -2, 127])


def test_conv_bn_infer(rng):
    args = _cb_args(rng)
    parity(lambda *a: jcb.conv_bn_infer(*a, stride=2),
           lambda *a: tcb.conv_bn_infer(*a, stride=2), args, wrt=(0, 1))


def test_conv_bn_matches_unfused_conv_then_bn(rng):
    """The fused op equals conv2d followed by batch_norm_train, forward
    and gradients (the closed forms share ``bn_input_grad``)."""
    from paddle_tpu_torch.ops import conv as tconv
    args = [to_t(a, True) for a in _cb_args(rng)[:4]]
    rm, rv = torch.zeros(4), torch.ones(4)
    fused = tcb.conv_bn_train(*args, rm, rv, stride=2)
    y = tconv.conv2d(args[0], args[1], stride=2)
    plain = tnorm.batch_norm_train(y, args[2], args[3], rm, rv)
    for a, e in zip(fused, plain):
        torch.testing.assert_close(a, e, rtol=1e-5, atol=1e-5)
    gf = torch.autograd.grad(fused[0].square().sum(), args)
    gp = torch.autograd.grad(plain[0].square().sum(), args)
    for a, e in zip(gf, gp):
        torch.testing.assert_close(a, e, rtol=1e-4, atol=1e-4)
