"""Projections and operators for mixed_layer (counterpart of
``paddle_tpu/projection.py``).

Reference: paddle/gserver/layers/Projection.h (Projection sub-units summed
into a MixedLayer), Operator.h; config DSL full_matrix_projection,
trans_full_matrix_projection, identity_projection, table_projection,
dotmul_projection, scaling_projection, slice_projection, context_projection,
dotmul_operator (trainer_config_helpers/layers.py).

A projection is (input, param specs, apply fn); mixed_layer sums the
applied tensors. Products here are plain ``torch.matmul`` in the input's
dtype, as ``jnp.matmul`` is in the JAX package (no compute-dtype cast).
"""

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from paddle_tpu_torch.core.param import ParamAttr, ParamSpec
from paddle_tpu_torch.ops import sequence as ops_seq
from paddle_tpu_torch.topology import auto_name
from paddle_tpu_torch.utils import enforce


@dataclasses.dataclass
class Projection:
    inputs: List                      # LayerOutput parents
    size: int                         # output width
    param_specs: List[ParamSpec]
    apply: Callable                   # (params, parent_values, ctx) -> tensor


def _attr(param_attr, default_name) -> ParamAttr:
    a = param_attr if isinstance(param_attr, ParamAttr) else ParamAttr()
    if a.name is None:
        a = type(a)(**{**a.__dict__, "name": default_name})
    return a


def full_matrix_projection(input, size: int, param_attr=None) -> Projection:
    """W·x (reference: FullMatrixProjection.cpp)."""
    a = _attr(param_attr, f"{auto_name('fm_proj')}.w")
    spec = ParamSpec(a.name, (input.size, size), attr=a, fan_in=input.size)

    def apply(params, parents, ctx):
        x = parents[0].array
        return torch.matmul(x, params[spec.name].to(x.dtype))

    return Projection([input], size, [spec], apply)


def trans_full_matrix_projection(input, size: int,
                                 param_attr=None) -> Projection:
    """Wᵀ·x — shares a (size, in) matrix transposed (reference:
    TransposedFullMatrixProjection.cpp; used for tied embeddings)."""
    a = _attr(param_attr, f"{auto_name('tfm_proj')}.w")
    spec = ParamSpec(a.name, (size, input.size), attr=a, fan_in=input.size)

    def apply(params, parents, ctx):
        x = parents[0].array
        return torch.matmul(x, params[spec.name].T.to(x.dtype))

    return Projection([input], size, [spec], apply)


def identity_projection(input, offset: Optional[int] = None,
                        size: Optional[int] = None) -> Projection:
    """x, or x[offset:offset+size] (reference: IdentityProjection /
    IdentityOffsetProjection)."""
    out_size = size or (input.size - (offset or 0) if offset is not None
                        else input.size)

    def apply(params, parents, ctx):
        x = parents[0].array
        if offset is not None:
            return x[..., offset:offset + out_size]
        return x

    return Projection([input], out_size, [], apply)


def slice_projection(input, slices: Sequence[Tuple[int, int]]) -> Projection:
    """Concat of [begin, end) column slices (reference: SliceProjection)."""
    out_size = sum(e - b for b, e in slices)

    def apply(params, parents, ctx):
        x = parents[0].array
        return torch.cat([x[..., b:e] for b, e in slices], dim=-1)

    return Projection([input], out_size, [], apply)


def table_projection(input, size: int, param_attr=None) -> Projection:
    """Embedding-table row lookup for integer inputs (reference:
    TableProjection.cpp)."""
    a = _attr(param_attr, f"{auto_name('table_proj')}.w")
    spec = ParamSpec(a.name, (input.size, size), attr=a, fan_in=size)

    def apply(params, parents, ctx):
        ids = parents[0].array
        if ids.dim() > 1 and ids.shape[-1] == 1:
            ids = ids[..., 0]
        return params[spec.name][ids.long()]

    return Projection([input], size, [spec], apply)


def dotmul_projection(input, param_attr=None) -> Projection:
    """x ⊙ w with a learnable vector (reference: DotMulProjection.cpp)."""
    a = _attr(param_attr, f"{auto_name('dotmul_proj')}.w")
    spec = ParamSpec(a.name, (input.size,), attr=a, fan_in=input.size)

    def apply(params, parents, ctx):
        x = parents[0].array
        return x * params[spec.name].to(x.dtype)

    return Projection([input], input.size, [spec], apply)


def scaling_projection(input, param_attr=None) -> Projection:
    """w·x with a learnable scalar (reference: ScalingProjection.cpp)."""
    a = _attr(param_attr, f"{auto_name('scaling_proj')}.w")
    spec = ParamSpec(a.name, (1,), attr=a)

    def apply(params, parents, ctx):
        x = parents[0].array
        return x * params[spec.name].to(x.dtype)

    return Projection([input], input.size, [spec], apply)


def context_projection(input, context_len: int, context_start=None,
                       padding_attr=False) -> Projection:
    """Sliding context-window concat over a sequence (reference:
    ContextProjection.cpp; paddle/function/ContextProjectionOp.cpp).
    Trainable padding is not supported — zero padding only."""
    enforce.enforce(padding_attr is False or padding_attr is None,
                    "trainable context padding is not supported")
    start = -(context_len // 2) if context_start is None else context_start
    out_size = input.size * context_len

    def apply(params, parents, ctx):
        pv = parents[0]
        enforce.enforce(pv.is_sequence, "context_projection needs sequences")
        return ops_seq.context_projection(pv.array, pv.lengths, context_len,
                                          start)

    return Projection([input], out_size, [], apply)


def dotmul_operator(a, b, scale: float = 1.0) -> Projection:
    """scale·(a ⊙ b) (reference: DotMulOperator — a mixed_layer Operator,
    no parameters)."""
    enforce.enforce(a.size == b.size, "dotmul operands must match")

    def apply(params, parents, ctx):
        return scale * parents[0].array * parents[1].array

    return Projection([a, b], a.size, [], apply)
