"""Dense linear algebra with the dtype policy of ``paddle_tpu/ops/math.py``.

Floating operands are rounded to the compute dtype (flag
``compute_dtype``, default bf16), multiplied with fp32 accumulation and
an fp32 result, then cast to the output dtype: the JAX package's
``preferred_element_type=float32`` contract. The rounded operands are
multiplied as fp32 values (exact products, fp32 sums), so the result is
the same on the card (cuBLAS SGEMM, TF32 off) and on the CPU.
"""

import torch

from paddle_tpu_torch.core import dtypes


def _rounded(t: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """``t`` rounded to ``cdt``, as an fp32 (or wider) tensor."""
    return t.to(cdt) if cdt == torch.float32 else t.to(cdt).float()


def matmul(a: torch.Tensor, b: torch.Tensor, *, out_dtype=None
           ) -> torch.Tensor:
    """Compute-dtype-in / fp32-accumulate matmul. Integer operands skip the
    compute-dtype cast (bf16's 8-bit mantissa would round values > 256)."""
    if not (a.is_floating_point() and b.is_floating_point()):
        out = torch.matmul(a, b)
        return out if out_dtype is None else out.to(out_dtype)
    cdt = dtypes.compute_dtype()
    out_dtype = out_dtype or a.dtype
    return torch.matmul(_rounded(a, cdt), _rounded(b, cdt)).to(out_dtype)


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor = None
           ) -> torch.Tensor:
    """x @ w (+ b) — the fully connected layer's forward."""
    out = matmul(x, w)
    if b is not None:
        out = out + b.to(out.dtype)
    return out


def outer(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.einsum("i,j->ij", a, b)
