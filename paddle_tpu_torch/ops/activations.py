"""Activation functions (counterpart of ``paddle_tpu/ops/activations.py``):
elementwise torch functions and the name table ``get``."""

import torch
import torch.nn.functional as F


def linear(x):
    return x


relu = torch.relu
sigmoid = torch.sigmoid
tanh = torch.tanh
exponential = torch.exp
softrelu = F.softplus  # log(1+e^x)
abs_ = torch.abs
log = torch.log
silu = F.silu


def square(x):
    return x * x


def gelu(x):
    """The tanh approximation (``jax.nn.gelu``'s default)."""
    return F.gelu(x, approximate="tanh")


def brelu(x, t_min=0.0, t_max=24.0):
    """Bounded relu."""
    return torch.clamp(x, t_min, t_max)


def stanh(x, scale_a=2.0 / 3.0, scale_b=1.7159):
    """Scaled tanh."""
    return scale_b * torch.tanh(scale_a * x)


def softmax(x, axis=-1):
    return torch.softmax(x, dim=axis)


def log_softmax(x, axis=-1):
    return torch.log_softmax(x, dim=axis)


_REGISTRY = {
    "linear": linear, "relu": relu, "sigmoid": sigmoid, "tanh": tanh,
    "exponential": exponential, "softrelu": softrelu, "square": square,
    "abs": abs_, "log": log, "brelu": brelu, "stanh": stanh,
    "softmax": softmax, "gelu": gelu, "silu": silu,
}


def get(name: str):
    """The activation function called ``name``."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown activation {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]
