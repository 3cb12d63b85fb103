"""Parameter specs and the parameter dict (counterpart of
``paddle_tpu/core/param.py``).

Reference: paddle/parameter/Parameter.h:60 — a Parameter owns typed
buffers plus a ParameterConfig proto. Here parameters are entries of a
flat dict ``{name: torch.Tensor}``; metadata lives in ``ParamSpec``.
Initial values come from the JAX package's threefry stream for the same
seed and name (``ops/prng``): the keys and integer bits are equal, the
floating transforms agree to rounding (``uniform`` within an ulp,
``ops/prng.normal`` bitwise), constants exactly.
"""

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch

from paddle_tpu_torch.core import dtypes, place
from paddle_tpu_torch.ops import prng


@dataclasses.dataclass(frozen=True)
class ParamAttr:
    """Per-parameter attributes (reference: trainer_config_helpers/attrs.py
    ParameterAttribute — name, initial_std/mean, learning_rate, l1/l2 decay,
    sparse flags)."""
    name: Optional[str] = None
    initializer: Optional[str] = None      # normal | uniform | xavier | msra | constant
    initial_mean: float = 0.0
    initial_std: Optional[float] = None    # None => 1/sqrt(fan_in) like reference
    initial_value: Optional[float] = None  # for constant init
    learning_rate: float = 1.0             # per-param lr scale
    l1_rate: Optional[float] = None
    l2_rate: Optional[float] = None
    is_static: bool = False                # frozen parameter
    sparse_update: bool = False            # row-sparse gradient path


def _normal(key, shape, device) -> torch.Tensor:
    """``jax.random.normal`` (``ops/prng.normal``)."""
    return prng.normal(key, shape, device=device)


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Shape/dtype/init spec for one named parameter."""
    name: str
    shape: Tuple[int, ...]
    dtype: object = None
    attr: ParamAttr = dataclasses.field(default_factory=ParamAttr)
    # axis interpretation for default init: fan_in is prod(shape[:-1]) unless set
    fan_in: Optional[int] = None
    # mesh-axis sharding hint (kept for the spec's shape; the port runs
    # on one card)
    sharding: Optional[Tuple] = None

    def resolved_dtype(self) -> torch.dtype:
        return dtypes.resolve(self.dtype) if self.dtype else \
            dtypes.param_dtype()

    def initialize(self, key: torch.Tensor, device=None) -> torch.Tensor:
        """Materialise the initial value on ``device`` (default: the card)
        from ``key`` (reference: Parameter::randomize — default
        N(0, 1/sqrt(fan_in)))."""
        device = place.resolve_device(device)
        a = self.attr
        dtype = self.resolved_dtype()
        shape = tuple(self.shape)
        if a.initial_value is not None or a.initializer == "constant":
            return torch.full(shape, a.initial_value or 0.0, dtype=dtype,
                              device=device)
        fan_in = self.fan_in
        if fan_in is None:
            fan_in = int(math.prod(shape[:-1])) if len(shape) > 1 else int(shape[0])
        init = a.initializer or "normal"
        if init == "normal":
            std = a.initial_std if a.initial_std is not None else 1.0 / math.sqrt(max(1, fan_in))
            out = a.initial_mean + std * _normal(key, shape, device)
        elif init in ("uniform", "xavier"):
            if init == "uniform":
                lim = a.initial_std if a.initial_std is not None else 1.0 / math.sqrt(max(1, fan_in))
            else:
                fan_out = int(shape[-1]) if len(shape) > 1 else int(shape[0])
                lim = math.sqrt(6.0 / (fan_in + fan_out))
            out = prng.uniform(key, shape, -lim, lim, device=device)
        elif init == "msra":
            std = math.sqrt(2.0 / max(1, fan_in))
            out = std * _normal(key, shape, device)
        else:
            raise ValueError(f"unknown initializer {init!r}")
        return out.to(dtype)


def init_params(specs: Sequence[ParamSpec], key_source=None,
                device=None) -> dict:
    """Initialise a full parameter dict from specs, name-keyed subkeys,
    on ``device`` (default: the card)."""
    from paddle_tpu_torch.utils import rng
    device = place.resolve_device(device)
    ks = key_source or rng.global_key_source()
    return {s.name: s.initialize(ks.named(s.name), device) for s in specs}
