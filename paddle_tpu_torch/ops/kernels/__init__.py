"""Hand-written Hopper kernels (counterpart of ``paddle_tpu/ops/pallas/``).

CUDA C++ sources live in ``csrc/``; ``_build`` compiles them with nvcc
at first use and binds them with ctypes. ``KERNELS`` lists every kernel
wrapper of the serving and training paths, each with its ``launches``
counter: an int, or a dict with one count per branch for the wrappers
that launch more than one kernel instantiation — the three templated on
the KV pool's storage ({"none", "int8", "int4"}), the sampler's two
uniform streams ({"hash", "threefry"}) and the two attention wrappers
({"bf16": tensor-core kernels, "fp32": CUDA-core kernels}).

The counters tick in Python, where a wrapper launches its kernel. A
CUDA graph replay runs no Python: ``core/graphs.py`` records what one
replay launches at capture (``launch_counts`` before and after) and adds
it with :func:`add_launches` at every replay.

``ENTRY_POINTS`` lists the callers that reach a kernel through another
wrapper and keep a tally of their own beside that kernel's count
(``fused_spec_verify``: kernel 2 at a verify window's rows);
:func:`entry_counts` reads them, :func:`reset_launches` and
:func:`add_launches` cover them too.
"""

from paddle_tpu_torch.ops.kernels.attention import (flash_attention_bwd,
                                                    flash_attention_fwd)
from paddle_tpu_torch.ops.kernels.decode import (flash_decode_attention,
                                                 fused_sample,
                                                 fused_spec_verify)
from paddle_tpu_torch.ops.kernels.prefill import (flash_chunk_prefill,
                                                  paged_span_write)

KERNELS = (flash_decode_attention, fused_sample, flash_chunk_prefill,
           paged_span_write, flash_attention_fwd, flash_attention_bwd)
ENTRY_POINTS = (fused_spec_verify,)


def reset_launches():
    """Set every kernel wrapper's launch counts, and every entry point's
    tally, to 0."""
    for fn in ENTRY_POINTS:
        fn.launches = 0
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


def entry_counts() -> dict:
    """``{entry point name: launches}`` of ``ENTRY_POINTS``."""
    return {fn.__name__: fn.launches for fn in ENTRY_POINTS}


def add_launches(delta: dict):
    """Add ``{kernel name: n}`` (the names of :func:`launch_counts` and
    :func:`entry_counts`) to the wrappers' counts."""
    for fn in ENTRY_POINTS:
        fn.launches += delta.get(fn.__name__, 0)
    for fn in KERNELS:
        if isinstance(fn.launches, dict):
            first = next(iter(fn.launches))
            for branch in fn.launches:
                name = (fn.__name__ if branch == first
                        else f"{fn.__name__}.{branch}")
                fn.launches[branch] += delta.get(name, 0)
        else:
            fn.launches += delta.get(fn.__name__, 0)
