"""Activation declarations (reference: python/paddle/trainer_config_helpers/
activations.py — BaseActivation subclasses with a .name consumed by the
config parser; runtime impls in paddle_tpu_torch.ops.activations)."""


class BaseActivation:
    name = "linear"

    def __init__(self):
        pass

    def __repr__(self):
        return f"{type(self).__name__}()"


class Linear(BaseActivation):
    name = "linear"


class Relu(BaseActivation):
    name = "relu"


class Sigmoid(BaseActivation):
    name = "sigmoid"


class Tanh(BaseActivation):
    name = "tanh"


class STanh(BaseActivation):
    name = "stanh"


class BRelu(BaseActivation):
    name = "brelu"


class SoftRelu(BaseActivation):
    name = "softrelu"


class Exp(BaseActivation):
    name = "exponential"


class Log(BaseActivation):
    name = "log"


class Abs(BaseActivation):
    name = "abs"


class Square(BaseActivation):
    name = "square"


class Softmax(BaseActivation):
    name = "softmax"


class SequenceSoftmax(BaseActivation):
    """Softmax over each sequence's timesteps (reference:
    SequenceSoftmaxActivation; runtime: ops.sequence.seq_softmax)."""
    name = "sequence_softmax"


class Gelu(BaseActivation):
    name = "gelu"


class Silu(BaseActivation):
    name = "silu"


def resolve(act) -> str:
    """Accept an activation object, its name, or None → canonical name."""
    if act is None:
        return "linear"
    if isinstance(act, str):
        return act
    return act.name
