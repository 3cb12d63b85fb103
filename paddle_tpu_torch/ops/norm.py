"""Normalisation (counterpart of ``paddle_tpu/ops/norm.py``)."""

import torch


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
