"""Device placement (counterpart of ``paddle_tpu/core/place.py``).

Entry points take an explicit ``device``; when it is omitted they run
on :func:`default_device`, the first CUDA card. There is no quiet CPU
fallback: a caller that wants the CPU (the tests do) says so.
"""

import os
from typing import Optional

import torch

# Declared peak dense FLOP/s per card, bf16 inputs with fp32
# accumulation on the tensor cores (NVIDIA data sheets, SXM parts,
# without sparsity), matched against ``torch.cuda.get_device_name``
# longest pattern first. The MFU accounting in ``observe.costs``
# divides by it; an unknown card (or the CPU) reports no MFU rather
# than an invented one.
PEAK_FLOPS_TABLE = (
    ("h100", 989e12),
)


def default_device() -> torch.device:
    """The first CUDA card. Raises where there is none: the port never
    decides on its own to run on the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' explicitly to run the "
            "plain PyTorch path on the CPU")
    return torch.device("cuda:0")


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the card. A
    bare ``"cuda"`` gets its index, so devices compare equal to the ones
    tensors report."""
    if device is None:
        return default_device()
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def peak_flops(device=None) -> Optional[float]:
    """Declared peak FLOP/s of a CUDA ``device`` (default: the first
    card), or None for the CPU and for cards the table does not know.
    ``PADDLE_TPU_PEAK_TFLOPS`` (in TFLOP/s) overrides the table for any
    device, as in the JAX package."""
    env = os.environ.get("PADDLE_TPU_PEAK_TFLOPS")
    if env:
        try:
            return float(env) * 1e12
        except ValueError:
            pass
    device = resolve_device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device).lower()
    best = None
    for pat, flops in PEAK_FLOPS_TABLE:
        if pat in name and (best is None or len(pat) > len(best[0])):
            best = (pat, flops)
    return best[1] if best else None
