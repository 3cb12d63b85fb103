"""Sequence-pooling type declarations (reference: python/paddle/
trainer_config_helpers/poolings.py — MaxPooling, AvgPooling, SumPooling,
SqrtAvgPooling; runtime impls in paddle_tpu_torch.ops.sequence)."""


class BasePoolingType:
    name = None


class Max(BasePoolingType):
    name = "max"


class Avg(BasePoolingType):
    name = "avg"


class Sum(BasePoolingType):
    name = "sum"


class SqrtN(BasePoolingType):
    name = "sqrt"


MaxPooling = Max
AvgPooling = Avg
SumPooling = Sum
SqrtAvgPooling = SqrtN


def resolve(p) -> str:
    if p is None:
        return "max"
    if isinstance(p, str):
        return p
    return p.name
