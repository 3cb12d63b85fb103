"""Loss functions (counterpart of ``paddle_tpu/ops/loss.py``)."""

import torch


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Integer labels [...] against logits [..., classes] -> per-example
    loss [...] in fp32: log-softmax in fp32, minus the label's entry."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[..., None])[..., 0]
