"""Fused conv + batch-norm training op (counterpart of
``paddle_tpu/ops/conv_bn.py``).

One op produces the conv output and consumes its batch statistics; the
backward is the closed-form two-pass BN VJP followed by the conv's own
backward (``aten.convolution_backward``: cuDNN's data and weight
gradients on the card), with no autograd through the statistics.
``save8`` stashes the backward's saved activations (x and the centered
conv output y - mean) as per-channel int8, the same bytes as the JAX
package's stash on the same inputs; the forward values are untouched.
"""

from typing import Tuple

import torch

from paddle_tpu_torch.core import dtypes
from paddle_tpu_torch.ops import conv as ops_conv
from paddle_tpu_torch.ops import norm as ops_norm


def conv_bn_stats(x, w, *, stride=1, padding="SAME"):
    """(conv(x, w), Σy, Σy²) — fp32 sums per output channel over N·H·W."""
    cdt = dtypes.compute_dtype()
    y = ops_conv.conv2d(x.to(cdt), w.to(cdt), stride=stride, padding=padding)
    yf = y.float()
    axes = tuple(range(y.dim() - 1))
    return y, yf.sum(dim=axes), (yf * yf).sum(dim=axes)


def _quant8(t):
    """Per-channel symmetric int8 codes (round half to even, clip ±127)
    and fp32 scales of a saved activation."""
    tf = t.float()
    amax = tf.abs().amax(dim=tuple(range(t.dim() - 1)))
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(tf / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant8(q, scale, dtype):
    return (q.float() * scale).to(dtype)


def _conv_bn_fwd(x, w, gamma, beta, stride, padding, eps, save8,
                 counts=None):
    """((out, mean, var), residuals) — ``paddle_tpu``'s ``_conv_bn_fwd``:
    the residuals are (x, y, None, None, ...) or, with ``save8``,
    (None, None, ((qx, sx), x dtype), (qz, sz), ...). ``counts`` (a
    list) gets the number of rows the statistics are over appended."""
    y, s1, s2 = conv_bn_stats(x, w, stride=stride, padding=padding)
    count = y.numel() // y.shape[-1]
    if ops_norm._SYNC:
        # the global batch's statistics (``norm.synced_statistics``)
        tot = ops_norm._SYNC[-1](torch.stack(
            [s1, s2, torch.full_like(s1, float(count))]))
        s1, s2, count = tot[0], tot[1], tot[2]
    if counts is not None:
        counts.append(count)
    mean = s1 / count
    var = torch.clamp_min(s2 / count - mean.square(), 0.0)
    inv = torch.rsqrt(var + eps)
    out = ops_norm.bn_affine(y, gamma, beta, mean, inv)
    if save8:
        stash_x = (_quant8(x), x.dtype)
        # the CENTERED output: the backward only reads ŷ = (y - mean)·inv,
        # so centering bounds the stash noise whatever the channel's mean
        stash_y = _quant8(y.float() - mean)
    else:
        stash_x = stash_y = None
    return ((out, mean, var),
            (None if save8 else x, None if save8 else y, stash_x, stash_y,
             w, mean, inv, gamma))


class _ConvBN(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, gamma, beta, stride, padding, eps, save8):
        counts = []
        (out, mean, var), res = _conv_bn_fwd(x, w, gamma, beta, stride,
                                             padding, eps, save8, counts)
        x_s, y_s, stash_x, stash_y, _, _, inv, _ = res
        if save8:
            (qx, sx), ctx.x_dtype = stash_x
            qz, sz = stash_y
            ctx.save_for_backward(qx, sx, qz, sz, w, mean, inv, gamma)
        else:
            ctx.save_for_backward(x_s, y_s, w, mean, inv, gamma)
        ctx.conf = (stride, padding, save8)
        # under ``norm.synced_statistics`` the backward's sums are the
        # global batch's too
        ctx.sync = (ops_norm._SYNC[-1], counts[0]) if ops_norm._SYNC \
            else None
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dout, _dmean, _dvar):
        stride, padding, save8 = ctx.conf
        if save8:
            qx, sx, qz, sz, w, mean, inv, gamma = ctx.saved_tensors
            centered = qz.float() * sz                 # = y - mean (stashed)
            x_full = _dequant8(qx, sx, ctx.x_dtype)
        else:
            x_full, y, w, mean, inv, gamma = ctx.saved_tensors
            centered = y.float() - mean
        axes = tuple(range(centered.dim() - 1))
        g, sum_dy_yhat, sum_dy = ops_norm.bn_input_grad(
            dout, centered, inv, gamma, axes,
            *(ctx.sync if ctx.sync else ()))
        dx, dw = _conv2d_backward(g.to(dout.dtype), x_full, w, stride=stride,
                                 padding=padding)
        return (dx, dw, sum_dy_yhat.to(gamma.dtype), sum_dy.to(gamma.dtype),
                None, None, None, None)


def _conv2d_backward(g, x, w, *, stride=1, padding="SAME"):
    """(dx, dw) of ``conv.conv2d(x, w, stride, padding)`` for the output
    cotangent ``g`` (NHWC): one ``aten.convolution_backward`` in the
    compute dtype, without the forward again; dx cropped where the conv
    padded asymmetrically, cast to x's dtype, dw to w's."""
    cdt = dtypes.compute_dtype()
    xc, wc, sym = ops_conv.nchw_operands(x.to(cdt), w.to(cdt), stride,
                                         padding, 1)
    dxc, dwc, _ = torch.ops.aten.convolution_backward(
        g.to(cdt).permute(0, 3, 1, 2), xc, wc, None,
        list(ops_conv._pair(stride)), list(sym), [1, 1], False, [0, 0], 1,
        [True, True, False])
    if tuple(xc.shape[2:]) != tuple(x.shape[1:3]):      # F.pad was applied
        (h0, _), (w0, _) = ops_conv.resolve_pads(
            x.shape[1:3], padding, w.shape[:2], ops_conv._pair(stride))
        dxc = dxc[:, :, h0:h0 + x.shape[1], w0:w0 + x.shape[2]]
    return (dxc.permute(0, 2, 3, 1).to(x.dtype),
            dwc.permute(2, 3, 1, 0).to(w.dtype))


def conv_bn_train(x, w, gamma, beta, running_mean, running_var, *,
                  stride=1, padding="SAME", momentum=0.9, eps=1e-5,
                  save8: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused conv→BN training step. Returns (out, new_running_mean,
    new_running_var); the running statistics are new tensors."""
    out, mean, var = _ConvBN.apply(x, w, gamma, beta, stride, padding, eps,
                                   save8)
    new_mean = momentum * running_mean + (1 - momentum) * mean
    new_var = momentum * running_var + (1 - momentum) * var
    return (out, new_mean.to(running_mean.dtype),
            new_var.to(running_var.dtype))


def conv_bn_infer(x, w, gamma, beta, running_mean, running_var, *,
                  stride=1, padding="SAME", eps=1e-5):
    """Inference path: plain conv + folded-affine BN (no stats needed)."""
    y = ops_conv.conv2d(x, w, stride=stride, padding=padding)
    return ops_norm.batch_norm_infer(y, gamma, beta, running_mean,
                                     running_var, eps=eps)
