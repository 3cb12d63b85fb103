"""Top-k / argmax ops (counterpart of ``paddle_tpu/ops/topk.py``)."""

import torch


def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest along the last axis, ties
    to the lower index (``lax.top_k``'s order; ``torch.topk`` promises
    none): the head of a stable descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def max_id(x: torch.Tensor) -> torch.Tensor:
    """Argmax over the last axis (the first maximum; a NaN counts as the
    maximum), kept as [..., 1] int32."""
    return torch.argmax(x, dim=-1, keepdim=True).to(torch.int32)
