"""Trace scopes: nested named timing regions — the port's own copy of
``paddle_tpu/observe/trace.py``.

Each scope accumulates its wall time into a ``utils/stat.py`` StatSet
and records a span into the chrome-trace ring (``observe/
chrome_trace.py``). With profiling on (``use_profiler=True`` or the
``profile`` flag, ``PADDLE_TPU_PROFILE``), it also opens
``torch.profiler.record_function``, so the region shows in a
``torch.profiler`` trace beside the card's kernels.

Scopes nest: a ``trace_scope("backward")`` inside
``trace_scope("step")`` accumulates under the qualified name
``step/backward`` (per thread).
"""

import contextlib
import functools
import threading
import time
from typing import Optional

from paddle_tpu_torch.observe import chrome_trace as _chrome
from paddle_tpu_torch.utils import stat as _stat

_tls = threading.local()


def _stack():
    if not hasattr(_tls, "stack"):
        _tls.stack = []
    return _tls.stack


def current_scope() -> str:
    """The '/'-joined active scope path of this thread ('' at top level)."""
    return "/".join(_stack())


def _profiler_ctx(name: str, args: Optional[str] = None):
    import torch.profiler
    return torch.profiler.record_function(name, args)


def _profiling_enabled(use_profiler: Optional[bool]) -> bool:
    if use_profiler is not None:
        return use_profiler
    from paddle_tpu_torch.utils.flags import GLOBAL_FLAGS
    return bool(GLOBAL_FLAGS.get("profile", False))


@contextlib.contextmanager
def trace_scope(name: str, stats: Optional[_stat.StatSet] = None,
                use_profiler: Optional[bool] = None):
    """Open a named timing scope: accumulates wall time into ``stats``
    (default: the global StatSet) under the nesting-qualified name,
    records a span, and opens a profiler annotation when profiling is
    on. Yields the qualified name."""
    stats = stats or _stat.global_stats
    stack = _stack()
    stack.append(name)
    qualified = "/".join(stack)
    ctx = (_profiler_ctx(name) if _profiling_enabled(use_profiler)
           else contextlib.nullcontext())
    wall0 = time.time()
    start = time.perf_counter()
    try:
        with ctx:
            yield qualified
    finally:
        dur = time.perf_counter() - start
        stats.get(qualified).add(dur)
        _chrome.record_span(qualified, wall0, dur)
        stack.pop()


@contextlib.contextmanager
def step_scope(step_num: int, name: str = "train",
               stats: Optional[_stat.StatSet] = None,
               use_profiler: Optional[bool] = None):
    """Mark one training step: accumulates into the ``name`` timer, its
    span carries ``{"step": step_num}``, and with profiling on the
    annotation carries the step number. Nests like ``trace_scope``."""
    stats = stats or _stat.global_stats
    stack = _stack()
    stack.append(name)
    qualified = "/".join(stack)
    ctx = (_profiler_ctx(name, str(step_num))
           if _profiling_enabled(use_profiler) else contextlib.nullcontext())
    wall0 = time.time()
    start = time.perf_counter()
    try:
        with ctx:
            yield
    finally:
        dur = time.perf_counter() - start
        stats.get(qualified).add(dur)
        _chrome.record_span(qualified, wall0, dur, args={"step": step_num})
        stack.pop()


def traced(name: Optional[str] = None, **scope_kw):
    """Decorator form: ``@traced("encode")`` wraps the call in a
    trace_scope named after the function by default."""

    def deco(fn):
        scope = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            with trace_scope(scope, **scope_kw):
                return fn(*a, **kw)

        return wrapper

    return deco
