"""Memory budgeting (counterpart of ``paddle_tpu/utils/memory.py``).

- ``device_memory_stats(device)`` — the caching allocator's figures for
  a CUDA device (empty on the CPU, as the JAX package's on its CPU
  backend);
- ``host_memory_stats()`` — the process's resident set;
- ``step_memory(fn, *args)`` — the peak bytes of one call of ``fn``.
  The JAX package reads a compiled program's memory analysis without
  running it; PyTorch has no such program, so the call runs once: on a
  card the allocator's peak over the call, on the CPU the peak of the
  tensors the call's operators allocate and still hold.

The JAX package's ``max_batch_size`` (a compile-only probe of batch
sizes) has no caller in the port and is not ported.
"""

import os
import weakref
from typing import Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode


def device_memory_stats(device=None) -> Dict[str, int]:
    """``bytes_in_use`` / ``peak_bytes_in_use`` / ``bytes_reserved`` /
    ``bytes_limit`` of a CUDA ``device`` (default: the first card when
    there is one); an empty dict for the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            return {}
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    return {"bytes_in_use": int(torch.cuda.memory_allocated(device)),
            "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(device)),
            "bytes_reserved": int(torch.cuda.memory_reserved(device)),
            "bytes_limit": int(torch.cuda.get_device_properties(
                device).total_memory)}


def host_memory_stats() -> Dict[str, int]:
    """Host-process memory: {rss_bytes, peak_rss_bytes} (best-effort;
    empty dict on platforms without /proc or resource). Feeds the
    trainer's host-memory gauge next to the device memory gauge."""
    out: Dict[str, int] = {}
    try:
        import resource
        import sys
        ru = resource.getrusage(resource.RUSAGE_SELF)
        # linux reports KiB, macOS bytes
        scale = 1 if sys.platform == "darwin" else 1024
        out["peak_rss_bytes"] = int(ru.ru_maxrss) * scale
    except (ImportError, ValueError):
        pass
    try:
        with open("/proc/self/statm") as f:
            rss_pages = int(f.read().split()[1])
        out["rss_bytes"] = rss_pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        pass
    return out


def _tensors(obj, out):
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, dict):
        for v in obj.values():
            _tensors(v, out)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _tensors(v, out)
    elif hasattr(obj, "__dataclass_fields__"):
        for k in obj.__dataclass_fields__:
            _tensors(getattr(obj, k), out)
    return out


def _nbytes(tensors) -> int:
    seen, total = set(), 0
    for t in tensors:
        st = t.untyped_storage()
        if st.data_ptr() not in seen:
            seen.add(st.data_ptr())
            total += st.nbytes()
    return total


class _LiveBytes(TorchDispatchMode):
    """Bytes of the tensors the operators under it have returned and that
    are still alive, and their peak (views of a counted tensor add
    nothing)."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0

    def _drop(self, n):
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _tensors(out, []):
            if t._base is not None or t.device.type == "meta":
                continue
            n = t.untyped_storage().nbytes()
            self.live += n
            weakref.finalize(t, self._drop, n)
        self.peak = max(self.peak, self.live)
        return out


def step_memory(fn: Callable, *args) -> Dict[str, int]:
    """Run ``fn(*args)`` once and report its memory: {peak, arguments,
    outputs, temps} in bytes, where ``peak`` counts the arguments plus
    the most the call held beyond them at once."""
    arg_t = _tensors(args, [])
    arguments = _nbytes(arg_t)
    dev = arg_t[0].device if arg_t else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out = fn(*args)
        torch.cuda.synchronize(dev)
        extra = torch.cuda.max_memory_allocated(dev) - base
    else:
        with _LiveBytes() as tracker:
            out = fn(*args)
        extra = tracker.peak
    outputs = _nbytes(_tensors(out, []))
    peak = arguments + max(int(extra), 0)
    return {"peak": int(peak), "arguments": int(arguments),
            "outputs": int(outputs),
            "temps": int(max(peak - arguments - outputs, 0))}
