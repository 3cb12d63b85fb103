"""Compile tracker: count program builds and what caused them — the
port's own copy of ``paddle_tpu/observe/compile_tracker.py``.

A program cache keyed on the abstract signature of a call (the shape
and dtype of every array argument, the value of every static one) is
missed exactly when a call brings a signature not seen before, so
tracking the signatures seen per function gives an exact miss count
from pure Python. In the JAX package a miss is an XLA compilation; in
the port it is a CUDA graph capture (``core/graphs.py``), or on the CPU
a signature seen for the first time. The tracker records, per function:

- the miss count (``compile_cache_misses_total{fn=...}`` counter),
- the wall time of each miss-triggering call
  (``compile_wall_seconds_total{fn=...}`` counter),
- the argument signature that caused each miss (bounded list).

A *recompile storm* — one function missing ``storm_threshold``+ times —
logs a warning naming the latest offending signature.
"""

import functools
import logging
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from paddle_tpu_torch.observe import metrics as _metrics

log = logging.getLogger("paddle_tpu_torch.observe.compile")

_m_misses = _metrics.counter(
    "compile_cache_misses_total",
    "program cache misses observed per tracked function (each is one "
    "CUDA graph capture on the card)")
_m_compile_s = _metrics.counter(
    "compile_wall_seconds_total",
    "wall time of miss-triggering calls (capture-dominated)")


def _dtype_name(dtype) -> str:
    """A dtype as the JAX package prints it: ``int32``, ``bfloat16``."""
    return str(dtype).replace("torch.", "")


def _walk_leaves(obj, out):
    """The leaves of ``obj`` in ``jax.tree_util.tree_leaves`` order:
    dicts by sorted key, lists and tuples in order; None is an empty
    subtree and contributes no leaf."""
    if isinstance(obj, dict):
        for k in sorted(obj, key=str):
            _walk_leaves(obj[k], out)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _walk_leaves(v, out)
    elif obj is not None:
        out.append(obj)


def arg_signature(*args) -> Tuple:
    """Abstract signature of a call: ``(shape, dtype)`` of every tensor,
    numpy array and numpy scalar leaf (a scalar's shape is ``()``), the
    ``repr`` of every other leaf (a static value). Two calls with equal
    signatures run the same program; the signature of numpy arguments
    is the one the JAX package computes for them."""
    leaves: List = []
    _walk_leaves(args, leaves)
    sig = []
    for leaf in leaves:
        if isinstance(leaf, (torch.Tensor, np.ndarray, np.generic)):
            sig.append((tuple(leaf.shape), _dtype_name(leaf.dtype)))
        else:
            sig.append(repr(leaf))
    return tuple(sig)


class CompileTracker:
    """Per-function signature sets + miss records (thread-safe)."""

    def __init__(self, storm_threshold: int = 5, max_miss_records: int = 64):
        self.storm_threshold = max(1, int(storm_threshold))
        self.max_miss_records = max_miss_records
        self._lock = threading.Lock()
        self._seen: Dict[str, set] = {}
        self._misses: Dict[str, List[dict]] = {}
        self._compile_s: Dict[str, float] = {}

    def record(self, name: str, sig: Tuple,
               wall_s: Optional[float] = None) -> bool:
        """Record one call of ``name`` with signature ``sig`` (from
        ``arg_signature``); ``wall_s`` is the call's wall time. Returns
        True when the signature is new — i.e. this call built a
        program."""
        with self._lock:
            seen = self._seen.setdefault(name, set())
            if sig in seen:
                return False
            seen.add(sig)
            miss = {"signature": repr(sig)[:512],
                    "wall_s": round(wall_s, 6) if wall_s else None,
                    "ts": round(time.time(), 3),
                    "miss_index": len(seen)}
            records = self._misses.setdefault(name, [])
            if len(records) < self.max_miss_records:
                records.append(miss)
            if wall_s:
                self._compile_s[name] = (self._compile_s.get(name, 0.0)
                                         + wall_s)
            n = len(seen)
        _m_misses.inc(fn=name)
        if wall_s:
            _m_compile_s.inc(wall_s, fn=name)
        if n >= self.storm_threshold and \
                (n - self.storm_threshold) % self.storm_threshold == 0:
            log.warning(
                "recompile storm: %r has built %d programs — its program "
                "cache is being missed repeatedly (usually shape churn "
                "from the data pipeline). Last miss signature: %s",
                name, n, miss["signature"])
        return True

    def track_call(self, name: str, fn, *args, **kwargs):
        """Call ``fn(*args, **kwargs)``, timing it and recording the
        signature. kwargs participate in the signature."""
        sig = arg_signature(args, kwargs)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        self.record(name, sig, time.perf_counter() - t0)
        return out

    def count(self, name: Optional[str] = None) -> int:
        """Programs built (for one function, or all)."""
        with self._lock:
            if name is not None:
                return len(self._seen.get(name, ()))
            return sum(len(s) for s in self._seen.values())

    def compile_seconds(self, name: Optional[str] = None) -> float:
        with self._lock:
            if name is not None:
                return self._compile_s.get(name, 0.0)
            return sum(self._compile_s.values())

    def misses(self, name: str) -> List[dict]:
        with self._lock:
            return list(self._misses.get(name, ()))

    def snapshot(self) -> Dict[str, dict]:
        """Per-function {count, compile_seconds, misses}."""
        with self._lock:
            return {name: {"count": len(seen),
                           "compile_seconds": round(
                               self._compile_s.get(name, 0.0), 6),
                           "misses": list(self._misses.get(name, ()))}
                    for name, seen in self._seen.items()}

    def clear(self):
        with self._lock:
            self._seen.clear()
            self._misses.clear()
            self._compile_s.clear()


_default = CompileTracker()


def default_compile_tracker() -> CompileTracker:
    return _default


def track_compiles(fn, name: Optional[str] = None,
                   tracker: Optional[CompileTracker] = None):
    """Wrap a callable so every call is signature-tracked:
    ``step = track_compiles(step, "train_step")``."""
    tracker = tracker or _default
    label = name or getattr(fn, "__name__", repr(fn))

    @functools.wraps(fn, assigned=("__name__", "__doc__"), updated=())
    def wrapper(*args, **kwargs):
        return tracker.track_call(label, fn, *args, **kwargs)

    wrapper.tracker = tracker
    return wrapper
