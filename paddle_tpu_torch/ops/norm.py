"""Normalisation (counterpart of ``paddle_tpu/ops/norm.py``).

``batch_norm_train`` returns (y, new_running_mean, new_running_var): the
running statistics come back as new tensors, never updated in place, so
they thread through a train step as explicit state.

Inside ``synced_statistics(reduce, reduce_max)`` (a data-parallel step
over several ranks) the statistics are those of the global batch: each
rank's sums and counts are reduced over the ranks, and so are the
backward's two sums — the GSPMD step's batch norm over the global batch
(the q8 blocks of ``ops/q8.py`` read the same reducers).
"""

import contextlib
from typing import Tuple

import torch

# the active cross-rank reducers: ``reduce(t)`` sums ``t`` over the
# ranks (``_SYNC[-1]``), ``reduce_max(t)`` takes its maximum
_SYNC: list = []
_SYNC_MAX: list = []


@contextlib.contextmanager
def synced_statistics(reduce, reduce_max=None):
    """Batch statistics (and their backward's sums) over every rank
    inside the block: ``reduce(t)`` returns the sum of ``t`` over the
    ranks, ``reduce_max(t)`` the maximum (the q8 stashes' absmax).
    Every rank must run the same normalisations in the same order."""
    _SYNC.append(reduce)
    _SYNC_MAX.append(reduce_max)
    try:
        yield
    finally:
        _SYNC.pop()
        _SYNC_MAX.pop()


def _global_stats(x, axes, eps, reduce):
    """(mean, var, inv, n) over the ranks' rows: fp32 sums and counts of
    this rank's rows reduced in one collective."""
    n = 1
    for a in axes:
        n *= x.shape[a]
    xf = x.float()
    s1 = xf.sum(dim=axes)
    s2 = xf.square().sum(dim=axes)
    tot = reduce(torch.stack([s1, s2, torch.full_like(s1, float(n))]))
    mean, mean2 = tot[0] / tot[2], tot[1] / tot[2]
    var = torch.clamp_min(mean2 - mean.square(), 0.0)
    return mean, var, torch.rsqrt(var + eps), tot[2]


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


def bn_input_grad(dy, x_centered, inv, gamma, axes, reduce=None,
                  n_global=None):
    """(dx in fp32, Σdy·x̂, Σdy) of y = γ·x̂ + β, x̂ = x_centered·inv: the
    two-pass closed form (one fused reduction pass, one elementwise pass)

        dx = s/N · (N·dy − Σdy − x̂·Σ(dy·x̂)),  s = γ·inv

    shared by ``batch_norm_train`` and ``conv_bn.conv_bn_train``. With a
    cross-rank ``reduce`` (``synced_statistics``) the two sums in dx and
    N are the global batch's (``n_global`` rows); the returned sums (γ's
    and β's gradients) stay this rank's."""
    n = 1
    for a in axes:
        n *= x_centered.shape[a]
    dyf = dy.float()
    sum_dy = dyf.sum(dim=axes)
    xhat = x_centered * inv
    sum_dy_xhat = (dyf * xhat).sum(dim=axes)
    g_dy, g_dy_xhat = sum_dy, sum_dy_xhat
    if reduce is not None:
        g_dy, g_dy_xhat = reduce(torch.stack([sum_dy, sum_dy_xhat]))
        n = n_global
    s = gamma.float() * inv / n
    return s * (n * dyf - g_dy - xhat * g_dy_xhat), sum_dy_xhat, sum_dy


class _BNApply(torch.autograd.Function):
    """Normalise-and-affine with the closed-form backward of
    ``paddle_tpu.ops.norm._bn_apply``; autograd never differentiates
    through the statistics. Also returns the batch mean and variance
    (no gradient) for the running statistics."""

    @staticmethod
    def forward(ctx, x, gamma, beta, axes, eps):
        ctx.reduce = _SYNC[-1] if _SYNC else None
        if ctx.reduce is None:
            mean, var, inv = _bn_stats(x, axes, eps)
        else:
            mean, var, inv, ctx.n = _global_stats(x, axes, eps, ctx.reduce)
        ctx.save_for_backward(x, mean, inv, gamma, beta)
        ctx.axes = axes
        ctx.mark_non_differentiable(mean, var)
        return bn_affine(x, gamma, beta, mean, inv), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, mean, inv, gamma, beta = ctx.saved_tensors
        dx, sum_dy_xhat, sum_dy = bn_input_grad(
            dy, x.float() - mean, inv, gamma, ctx.axes, ctx.reduce,
            getattr(ctx, "n", None))
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
