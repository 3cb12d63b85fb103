"""Captured step programs: the port's counterpart of ``jax.jit`` for the
serving engine's two step functions.

A :class:`StepProgram` wraps a step function and keys it on the
abstract signature of each call (``observe/compile_tracker.arg_signature``):
the shape and dtype of every array argument, the value of every static
one. On a CUDA device the first call with a new key warms the function
up once and captures it into a CUDA graph on the capture stream of its
:class:`GraphContext`; every call with that key afterwards copies its
inputs into the graph's static buffers and replays it. Each capture is
recorded through the program's compile tracker, so the tracker's count
is the number of graphs captured, as it is the number of XLA
compilations in the JAX package. On the CPU the function runs as it is
and the tracker counts the signatures it sees: the device is the
caller's choice, not a fallback. On a CUDA device there is no eager
path: a capture that fails raises :class:`GraphCaptureError` from the
operation that broke it.

The arguments of a call, by type:

- a numpy array: a per-call input. The graph holds a device copy (its
  static buffer), filled through a pinned staging buffer before each
  replay;
- a numpy scalar (``np.int32(c)``): a per-call device scalar, the
  counterpart of a traced scalar in JAX. The graph holds a 0-d device
  tensor and fills it with ``fill_`` before each replay (a
  stream-ordered launch, no host sync);
- a tensor or a dict of tensors (parameters, the KV pool, a device
  table the caller keeps up to date): resident. The graph reads and
  writes it where it lies, so every replay must be given the same
  tensors (checked by address);
- anything else: static, part of the key by value.

All graphs of one context share one memory pool. A graph's outputs live
in it and are overwritten by the graph's next replay: the caller
consumes them first (the engine copies the sampled ids to the host
every step). The static inputs, the pinned staging buffers and the
resident tensors are allocated outside capture.

The wrappers of ``ops/kernels`` count their launches in Python, which a
replay does not run: a capture records each wrapper's launch-count
delta, and every replay adds it.
"""

import gc
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from paddle_tpu_torch.observe import compile_tracker as _ct

_TORCH_DTYPES = {np.dtype(np.int32): torch.int32,
                 np.dtype(np.int64): torch.int64,
                 np.dtype(np.float32): torch.float32,
                 np.dtype(np.bool_): torch.bool}


class GraphCaptureError(RuntimeError):
    """A step function could not be captured into a CUDA graph."""


def _torch_dtype(dt) -> torch.dtype:
    try:
        return _TORCH_DTYPES[np.dtype(dt)]
    except KeyError:
        raise TypeError(f"step program input of numpy dtype {dt}: one of "
                        f"{sorted(str(d) for d in _TORCH_DTYPES)}") from None


def _tensor_leaves(obj, out: List[torch.Tensor]):
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, dict):
        for k in sorted(obj, key=str):
            _tensor_leaves(obj[k], out)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _tensor_leaves(v, out)


def _addresses(obj) -> List[int]:
    leaves: List[torch.Tensor] = []
    _tensor_leaves(obj, leaves)
    return [t.data_ptr() for t in leaves]


def _device(args) -> torch.device:
    """The device of the first tensor among ``args``."""
    leaves: List[torch.Tensor] = []
    for a in args:
        _tensor_leaves(a, leaves)
        if leaves:
            return leaves[0].device
    raise ValueError("a step program call needs at least one tensor "
                     "argument to place it")


def _host_args(args) -> tuple:
    """``args`` as the step function takes them on the CPU: numpy arrays
    as tensors sharing their memory, numpy scalars as 0-d tensors (of
    the dtypes a captured program takes)."""
    out = []
    for a in args:
        if isinstance(a, np.ndarray):
            _torch_dtype(a.dtype)
            a = torch.from_numpy(a)
        elif isinstance(a, np.generic):
            a = torch.tensor(a.item(), dtype=_torch_dtype(a.dtype))
        out.append(a)
    return tuple(out)


class Staged:
    """A device tensor filled from numpy: on a CUDA device through a
    pinned buffer and a copy on the current stream that does not wait
    for the device (an upload waits only for the previous one to have
    left the pinned buffer); on the CPU by a plain copy."""

    def __init__(self, shape, dtype: torch.dtype, device: torch.device):
        self.tensor = torch.zeros(shape, dtype=dtype, device=device)
        self._cuda = self.tensor.device.type == "cuda"
        if self._cuda:
            self._pinned = torch.empty(shape, dtype=dtype, pin_memory=True)
            self._host = self._pinned.numpy()
        self._done: Optional[torch.cuda.Event] = None

    def upload(self, a: np.ndarray):
        if not self._cuda:
            self.tensor.copy_(torch.from_numpy(np.ascontiguousarray(a)))
            return
        if self._done is not None:
            self._done.synchronize()
        np.copyto(self._host, a, casting="no")
        self.tensor.copy_(self._pinned, non_blocking=True)
        self._done = torch.cuda.Event()
        self._done.record()


class GraphContext:
    """The capture stream and the graph memory pool shared by a set of
    step programs (one engine's), made at the first capture."""

    def __init__(self):
        self.stream: Optional[torch.cuda.Stream] = None
        self.pool = None

    def ready(self, device: torch.device):
        if self.stream is None:
            self.stream = torch.cuda.Stream(device)
            self.pool = torch.cuda.graph_pool_handle()
        elif self.stream.device != device:
            raise ValueError(f"a graph context captures on "
                             f"{self.stream.device}, not {device}")


def _launch_counts() -> dict:
    from paddle_tpu_torch.ops import kernels
    return {**kernels.launch_counts(), **kernels.entry_counts()}


def _add_launches(delta: dict):
    from paddle_tpu_torch.ops import kernels
    kernels.add_launches(delta)


class _Captured:
    """One captured graph: its static inputs, its outputs and the launch
    counts one replay stands for."""

    def __init__(self, prog: "StepProgram", args, device: torch.device):
        ctx = prog.context
        ctx.ready(device)
        self.kinds = []
        call = []
        for a in args:
            if isinstance(a, np.ndarray):
                staged = Staged(a.shape, _torch_dtype(a.dtype), device)
                self.kinds.append(("array", staged))
                call.append(staged.tensor)
            elif isinstance(a, np.generic):
                static = torch.empty((), dtype=_torch_dtype(a.dtype),
                                     device=device)
                self.kinds.append(("scalar", static))
                call.append(static)
            elif isinstance(a, (torch.Tensor, dict, list, tuple)):
                self.kinds.append(("resident", _addresses(a)))
                call.append(a)
            else:
                self.kinds.append(("static",))
                call.append(a)
        self.load(args)
        here = torch.cuda.current_stream(device)
        ctx.stream.wait_stream(here)
        with torch.cuda.stream(ctx.stream):
            # warm-up: first-use work (cuBLAS handles and workspaces, the
            # capture stream's arrival counters, kernel attributes) runs
            # here, outside capture. Its launches execute and count.
            prog.fn(*call)
            before = _launch_counts()
            graph = torch.cuda.CUDAGraph()
            # no garbage collection while capturing: a collection that
            # frees an unreachable graph (an earlier engine's) destroys it
            # mid-capture, which CUDA refuses and which voids this capture
            gc_was_on = gc.isenabled()
            gc.disable()
            try:
                graph.capture_begin(pool=ctx.pool)
                try:
                    out = prog.fn(*call)
                except BaseException as e:
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        pass            # the capture is already invalid
                    raise GraphCaptureError(
                        f"capturing {prog.name} failed: {e}") from e
                graph.capture_end()
            finally:
                if gc_was_on:
                    gc.enable()
            after = _launch_counts()
        here.wait_stream(ctx.stream)
        # what one replay launches; the capture itself launched nothing
        self.delta = {k: after[k] - before[k] for k in after
                      if after[k] != before[k]}
        _add_launches({k: -v for k, v in self.delta.items()})
        self.graph, self.out = graph, out

    def load(self, args):
        """Copy the call's per-call inputs into the static buffers, on
        the current stream."""
        for kind, a in zip(self.kinds, args):
            if kind[0] == "array":
                kind[1].upload(a)
            elif kind[0] == "scalar":
                kind[1].fill_(a.item())
            elif kind[0] == "resident" and _addresses(a) != kind[1]:
                raise ValueError("a step program's resident tensors "
                                 "(parameters, pool, device tables) must "
                                 "be the ones it captured")

    def replay(self, args):
        self.load(args)
        self.graph.replay()
        _add_launches(self.delta)
        return self.out


class StepProgram:
    """A step function under its compile tracker's ``name``: captured
    and replayed per signature on a CUDA device, run as it is on the
    CPU. ``raw`` is the function itself."""

    def __init__(self, fn: Callable, name: str,
                 tracker: Optional[_ct.CompileTracker] = None,
                 context: Optional[GraphContext] = None):
        self.raw = self.fn = fn
        self.name = name
        self.tracker = tracker if tracker is not None else \
            _ct.CompileTracker()
        self.context = context if context is not None else GraphContext()
        self._graphs = {}

    @property
    def graphs(self) -> int:
        """Graphs captured so far."""
        return len(self._graphs)

    def __call__(self, *args):
        sig = _ct.arg_signature(args)
        device = _device(args)
        if device.type != "cuda":
            t0 = time.perf_counter()
            out = self.fn(*_host_args(args))
            self.tracker.record(self.name, sig, time.perf_counter() - t0)
            return out
        g = self._graphs.get(sig)
        if g is None:
            t0 = time.perf_counter()
            g = _Captured(self, args, device)
            self._graphs[sig] = g
            self.tracker.record(self.name, sig, time.perf_counter() - t0)
        return g.replay(args)
