"""Hand-written Hopper kernels (counterpart of ``paddle_tpu/ops/pallas/``).

CUDA C++ sources live in ``csrc/``; ``_build`` compiles them with nvcc
at first use and binds them with ctypes. ``KERNELS`` lists every kernel
wrapper of the serving and training paths, each with its ``launches``
counter: an int, or a dict with one count per branch for the wrappers
that launch more than one kernel instantiation — the three templated on
the KV pool's storage ({"none", "int8", "int4"}) and the two attention
wrappers ({"bf16": tensor-core kernels, "fp32": CUDA-core kernels}).
"""

from paddle_tpu_torch.ops.kernels.attention import (flash_attention_bwd,
                                                    flash_attention_fwd)
from paddle_tpu_torch.ops.kernels.decode import (flash_decode_attention,
                                                 fused_sample)
from paddle_tpu_torch.ops.kernels.prefill import (flash_chunk_prefill,
                                                  paged_span_write)

KERNELS = (flash_decode_attention, fused_sample, flash_chunk_prefill,
           paged_span_write, flash_attention_fwd, flash_attention_bwd)


def reset_launches():
    """Set every kernel wrapper's launch counts to 0."""
    for fn in KERNELS:
        if isinstance(fn.launches, dict):
            fn.launches = dict.fromkeys(fn.launches, 0)
        else:
            fn.launches = 0


def launch_counts() -> dict:
    """``{kernel name: launches}`` of every kernel and branch: a
    branching wrapper's first branch (the model-dtype pool, or bf16
    attention) under its own name, the others as ``<name>.<branch>``
    (``flash_decode_attention.int8``, ``flash_attention_fwd.fp32``)."""
    out = {}
    for fn in KERNELS:
        if isinstance(fn.launches, dict):
            first = next(iter(fn.launches))
            for branch, n in fn.launches.items():
                out[fn.__name__ if branch == first
                    else f"{fn.__name__}.{branch}"] = n
        else:
            out[fn.__name__] = fn.launches
    return out
