"""Initializer objects for the fluid-style API surface (reference:
python/paddle/v2/framework/initializer.py — Constant/Uniform/Normal/Xavier/
MSRA initializers). The layer API consumes these through ParamAttr."""

from paddle_tpu_torch.core.param import ParamAttr


def Constant(value=0.0):
    return ParamAttr(initializer="constant", initial_value=value)


def Normal(mean=0.0, std=1.0):
    return ParamAttr(initializer="normal", initial_mean=mean, initial_std=std)


def Uniform(limit=None):
    return ParamAttr(initializer="uniform", initial_std=limit)


def Xavier():
    return ParamAttr(initializer="xavier")


def MSRA():
    return ParamAttr(initializer="msra")
