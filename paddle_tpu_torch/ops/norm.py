"""Normalisation (counterpart of ``paddle_tpu/ops/norm.py``).

``batch_norm_train`` returns (y, new_running_mean, new_running_var): the
running statistics come back as new tensors, never updated in place, so
they thread through a train step as explicit state.
"""

from typing import Tuple

import torch


def _bn_stats(x, axes, eps):
    mean = x.mean(dim=axes, dtype=torch.float32)
    mean2 = x.float().square().mean(dim=axes)
    # fp32 cancellation can push E[x^2]-E[x]^2 slightly negative when the
    # mean dwarfs the spread; rsqrt would then emit NaN
    var = torch.clamp_min(mean2 - mean.square(), 0.0)
    return mean, var, torch.rsqrt(var + eps)


def bn_affine(x, gamma, beta, mean, inv):
    """x * scale + shift with the per-channel affine computed in fp32 and
    applied in x's dtype."""
    g32 = gamma.float()
    scale = (g32 * inv).to(x.dtype)
    shift = (beta.float() - mean * g32 * inv).to(x.dtype)
    return x * scale + shift


def bn_input_grad(dy, x_centered, inv, gamma, axes):
    """(dx in fp32, Σdy·x̂, Σdy) of y = γ·x̂ + β, x̂ = x_centered·inv: the
    two-pass closed form (one fused reduction pass, one elementwise pass)

        dx = s/N · (N·dy − Σdy − x̂·Σ(dy·x̂)),  s = γ·inv

    shared by ``batch_norm_train`` and ``conv_bn.conv_bn_train``."""
    n = 1
    for a in axes:
        n *= x_centered.shape[a]
    dyf = dy.float()
    sum_dy = dyf.sum(dim=axes)
    xhat = x_centered * inv
    sum_dy_xhat = (dyf * xhat).sum(dim=axes)
    s = gamma.float() * inv / n
    return s * (n * dyf - sum_dy - xhat * sum_dy_xhat), sum_dy_xhat, sum_dy


class _BNApply(torch.autograd.Function):
    """Normalise-and-affine with the closed-form backward of
    ``paddle_tpu.ops.norm._bn_apply``; autograd never differentiates
    through the statistics. Also returns the batch mean and variance
    (no gradient) for the running statistics."""

    @staticmethod
    def forward(ctx, x, gamma, beta, axes, eps):
        mean, var, inv = _bn_stats(x, axes, eps)
        ctx.save_for_backward(x, mean, inv, gamma, beta)
        ctx.axes = axes
        ctx.mark_non_differentiable(mean, var)
        return bn_affine(x, gamma, beta, mean, inv), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, mean, inv, gamma, beta = ctx.saved_tensors
        dx, sum_dy_xhat, sum_dy = bn_input_grad(dy, x.float() - mean, inv,
                                                gamma, ctx.axes)
        return (dx.to(x.dtype), sum_dy_xhat.to(gamma.dtype),
                sum_dy.to(beta.dtype), None, None)


def batch_norm_train(x, gamma, beta, running_mean, running_var, *,
                     momentum=0.9, eps=1e-5, axes=None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training-mode BN over all axes except the last (channel): stats
    reduced in fp32, the normalisation applied as a per-channel affine in
    x's dtype, the backward in closed form."""
    axes = tuple(axes) if axes is not None else tuple(range(x.dim() - 1))
    y, mean, var = _BNApply.apply(x, gamma, beta, axes, eps)
    new_mean = momentum * running_mean + (1 - momentum) * mean
    new_var = momentum * running_var + (1 - momentum) * var
    return y, new_mean.to(running_mean.dtype), new_var.to(running_var.dtype)


def batch_norm_infer(x, gamma, beta, running_mean, running_var, *, eps=1e-5):
    inv = torch.rsqrt(running_var.float() + eps)
    return bn_affine(x, gamma, beta, running_mean.float(), inv)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               *, eps: float = 1e-5) -> torch.Tensor:
    """Layer norm over the last axis, computed in fp32 (population
    variance, ``rsqrt(var + eps)``) and cast back to ``x``'s dtype — the
    op chain of ``paddle_tpu.ops.norm.layer_norm``."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps) * gamma + beta
    return y.to(x.dtype)


def rms_norm(x, gamma, *, eps=1e-6, axis=-1):
    xf = x.float()
    ms = (xf * xf).mean(dim=axis, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * gamma).to(x.dtype)


def lrn(x, *, size=5, alpha=1e-4, beta=0.75, k=1.0):
    """Cross-map (channel) local response normalisation, NHWC:
    y = x / (k + alpha * sum_local(x^2))^beta over a window of ``size``
    channels centred at each channel (a cumulative sum over channels)."""
    sq = x.float().square()
    half = size // 2
    padded = torch.nn.functional.pad(sq, (half, size - 1 - half))
    csum = torch.cumsum(padded, dim=-1)
    csum = torch.cat([torch.zeros_like(csum[..., :1]), csum], dim=-1)
    local = csum[..., size:] - csum[..., :-size]
    return (x.float() / torch.pow(k + alpha * local, beta)).to(x.dtype)
