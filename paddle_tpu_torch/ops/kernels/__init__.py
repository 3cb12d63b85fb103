"""Hand-written Hopper kernels (counterpart of ``paddle_tpu/ops/pallas/``).

CUDA C++ sources live in ``csrc/``; ``_build`` compiles them with nvcc
at first use and binds them with ctypes. ``KERNELS`` lists every kernel
wrapper of the serving path, each with its ``launches`` counter.
"""

from paddle_tpu_torch.ops.kernels.decode import (flash_decode_attention,
                                                 fused_sample)
from paddle_tpu_torch.ops.kernels.prefill import (flash_chunk_prefill,
                                                  paged_span_write)

KERNELS = (flash_decode_attention, fused_sample, flash_chunk_prefill,
           paged_span_write)


def reset_launches():
    """Set every kernel wrapper's launch count to 0."""
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    """``{kernel name: launches}`` of every kernel wrapper."""
    return {fn.__name__: fn.launches for fn in KERNELS}
