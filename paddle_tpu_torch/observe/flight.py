"""Flight recorder: the last K step records + a config/env snapshot,
dumped as a JSON post-mortem when a run dies — the port's own copy of
``paddle_tpu/observe/flight.py``.

The recorder keeps a bounded ring of recent step records (a deque
append, no I/O) and ``dump()`` writes one self-contained artifact:

- ``last_steps``: the ring
- ``config``: the port's GLOBAL_FLAGS values
- ``env``: PADDLE_* / TORCH_* / CUDA_* / NCCL_* environment variables
- ``versions`` and ``devices``: Python, torch and CUDA, the visible cards
- ``metrics``: the default registry snapshot
- ``compile_tracker``: per-function graph counts + miss signatures
- ``exception``: type/message/traceback when dumping from a failure

Artifacts land in ``PADDLE_TPU_FLIGHT_DIR`` (flag ``flight_dir``;
default the working directory) as ``flight_<utc>_<pid>.json``.
``install_excepthook()`` opts into a dump on any unhandled exception.
"""

import collections
import json
import os
import sys
import threading
import time
import traceback
from typing import List, Optional

from paddle_tpu_torch.utils.logger import get_logger

log = get_logger("observe.flight")

_ENV_PREFIXES = ("PADDLE_", "TORCH_", "CUDA_", "NCCL_")


class FlightRecorder:
    """Bounded ring of step records + the dump machinery."""

    def __init__(self, capacity: int = 256):
        self._lock = threading.Lock()
        self._ring = collections.deque(maxlen=max(1, int(capacity)))
        self._dumped_paths: List[str] = []

    def record(self, rec: dict):
        """Append one step record (cheap: no copy beyond the dict the
        caller already built, no I/O)."""
        with self._lock:
            self._ring.append(rec)

    def records(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def clear(self):
        with self._lock:
            self._ring.clear()
            self._dumped_paths = []

    @property
    def dumped_paths(self) -> List[str]:
        with self._lock:
            return list(self._dumped_paths)

    def _snapshot(self, reason: str, exc: Optional[BaseException]) -> dict:
        from paddle_tpu_torch.observe import metrics as _metrics
        from paddle_tpu_torch.observe.chrome_trace import _process_index
        from paddle_tpu_torch.observe.compile_tracker import \
            default_compile_tracker
        from paddle_tpu_torch.utils.flags import GLOBAL_FLAGS

        snap = {
            "kind": "flight_recorder",
            "reason": reason,
            "ts": time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime()),
            "pid": os.getpid(),
            "argv": list(sys.argv),
            # shared guarded resolution (env -> torch.distributed -> 0)
            "process_index": _process_index(),
            "config": {k: v for k, (v, _) in
                       GLOBAL_FLAGS.describe().items()},
            "env": {k: v for k, v in sorted(os.environ.items())
                    if k.startswith(_ENV_PREFIXES)},
            "versions": {"python": sys.version.split()[0]},
            "metrics": _metrics.default_registry().snapshot(),
            "compile_tracker": default_compile_tracker().snapshot(),
            "last_steps": self.records(),
        }
        torch = sys.modules.get("torch")
        if torch is not None:
            try:
                snap["versions"]["torch"] = torch.__version__
                snap["versions"]["cuda"] = torch.version.cuda
                # names only: a dump never initialises a card
                if torch.cuda.is_initialized():
                    snap["devices"] = [torch.cuda.get_device_name(i)
                                       for i in range(
                                           torch.cuda.device_count())]
            except Exception:  # noqa: BLE001 — the card may be wedged
                pass
        if exc is not None:
            snap["exception"] = {
                "type": type(exc).__name__,
                "message": str(exc),
                "traceback": "".join(traceback.format_exception(
                    type(exc), exc, exc.__traceback__))[-8192:],
            }
        return snap

    def dump(self, path: Optional[str] = None, reason: str = "",
             exc: Optional[BaseException] = None) -> Optional[str]:
        """Write the post-mortem artifact; returns its path (None when
        the write failed — dumping must never mask the original error)."""
        from paddle_tpu_torch.observe.metrics import JsonlSink

        if path is None:
            path = os.path.join(
                flight_dir(),
                time.strftime("flight_%Y%m%d_%H%M%S", time.gmtime())
                + f"_{os.getpid()}.json")
        try:
            snap = JsonlSink._clean(self._snapshot(reason, exc))
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(snap, f, indent=1, default=repr)
            os.replace(tmp, path)
        except Exception as e:  # noqa: BLE001 — a snapshot/serialization
            # failure must not bury the crash being post-mortemed
            log.warning("flight recorder dump to %s failed: %s: %s",
                        path, type(e).__name__, e)
            return None
        with self._lock:
            self._dumped_paths.append(path)
        log.warning("flight recorder: post-mortem written to %s (%s)",
                    path, reason or "no reason given")
        return path


def flight_dir() -> str:
    """Artifact directory: flight_dir flag → PADDLE_TPU_FLIGHT_DIR env
    (the flag already reads the env) → the working directory."""
    try:
        from paddle_tpu_torch.utils.flags import GLOBAL_FLAGS
        d = GLOBAL_FLAGS.get("flight_dir")
    except Exception:  # noqa: BLE001
        d = None
    return d or os.environ.get("PADDLE_TPU_FLIGHT_DIR") or "."


def configured() -> bool:
    """True when an explicit flight directory is set (flag or env) —
    the trainer's generic crash dump is gated on it so default runs
    never litter artifacts; the NaN tripwire dumps regardless. An
    explicit ``.`` counts as configured (opting INTO cwd dumps)."""
    try:
        from paddle_tpu_torch.utils.flags import GLOBAL_FLAGS
        if GLOBAL_FLAGS.get("flight_dir"):
            return True
    except Exception:  # noqa: BLE001
        pass
    return bool(os.environ.get("PADDLE_TPU_FLIGHT_DIR"))


_default = FlightRecorder()


def default_flight_recorder() -> FlightRecorder:
    return _default


_hook_installed = False


def install_excepthook():
    """Chain a sys.excepthook that dumps the default recorder on any
    unhandled exception, then defers to the previous hook. Idempotent;
    opt-in (library code must not hijack the hook by default)."""
    global _hook_installed
    if _hook_installed:
        return
    prev = sys.excepthook

    def hook(exc_type, exc, tb):
        try:
            e = exc if isinstance(exc, BaseException) else exc_type(exc)
            if e.__traceback__ is None:
                e = e.with_traceback(tb)
            _default.dump(reason="unhandled exception", exc=e)
        except Exception:  # noqa: BLE001 — never mask the real crash
            pass
        prev(exc_type, exc, tb)

    sys.excepthook = hook
    _hook_installed = True
