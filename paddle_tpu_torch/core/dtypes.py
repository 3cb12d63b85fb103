"""Dtype names <-> torch dtypes (counterpart of
``paddle_tpu/core/dtypes.py``)."""

import torch

_NAMES = {
    "float32": torch.float32, "fp32": torch.float32,
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
    "float16": torch.float16, "fp16": torch.float16,
    "int32": torch.int32, "int64": torch.int64,
    "bool": torch.bool,
}


def resolve(name_or_dtype) -> torch.dtype:
    """A dtype name (``"bf16"``, ``"float32"``, ...) or a torch dtype
    -> the torch dtype."""
    if isinstance(name_or_dtype, torch.dtype):
        return name_or_dtype
    if isinstance(name_or_dtype, str) and name_or_dtype in _NAMES:
        return _NAMES[name_or_dtype]
    raise ValueError(f"unknown dtype {name_or_dtype!r}: one of "
                     f"{sorted(_NAMES)} or a torch.dtype")


def name(dtype) -> str:
    """Canonical name of a dtype (``torch.bfloat16`` -> ``"bfloat16"``)."""
    return str(resolve(dtype)).replace("torch.", "")


def param_dtype() -> torch.dtype:
    """Parameter dtype: the ``default_dtype`` flag (``float32``)."""
    from paddle_tpu_torch.utils.flags import GLOBAL_FLAGS
    return resolve(GLOBAL_FLAGS.get("default_dtype", "float32"))


def compute_dtype() -> torch.dtype:
    """Dtype matmul and conv operands are rounded to: the
    ``compute_dtype`` flag (``bfloat16``; ``PADDLE_TPU_COMPUTE_DTYPE``)."""
    from paddle_tpu_torch.utils.flags import GLOBAL_FLAGS
    return resolve(GLOBAL_FLAGS.get("compute_dtype", "bfloat16"))
