"""Observability (counterpart of ``paddle_tpu/observe/__init__.py``):
the metrics registry and its JSONL sink (``metrics``), MFU accounting
(``costs``), the compile tracker, rolling SLO windows (``window``), the
request log (``requests``), chrome-trace spans and lifecycle events
(``chrome_trace``, ``trace``), the health server (``health``), the
flight recorder (``flight``), the fleet's metrics aggregation
(``fleet``) and alert rules (``alerts``), the goodput ledger
(``goodput``), the gang's straggler attribution (``straggler``) and the
step bottleneck attribution (``bottleneck``).

``report()`` is the one funnel the trainer (and anything else) pushes
per-step records through: every record goes to the configured JSONL
sink and to any registered handlers, while the event-handler path keeps
working untouched::

    from paddle_tpu_torch import observe
    observe.configure(jsonl_path="metrics.jsonl")   # or
    # PADDLE_TPU_METRICS_PATH=metrics.jsonl in the environment
    ...train...
"""

import os
import threading
from typing import Callable, List, Optional

from paddle_tpu_torch.observe.alerts import (  # noqa: F401
    AlertEvaluator, AlertRule, default_fleet_rules,
    default_training_rules)
from paddle_tpu_torch.observe.chrome_trace import (  # noqa: F401
    SpanBuffer, alignments, clear_alignments, default_buffer,
    merge_traces, note_alignment, record_event, record_span,
    set_trace_capacity, trace_enabled, trace_export)
from paddle_tpu_torch.observe.fleet import (  # noqa: F401
    FleetAggregator, death_postmortem)
from paddle_tpu_torch.observe.goodput import (  # noqa: F401
    GoodputLedger, StepAccountant)
from paddle_tpu_torch.observe.straggler import (  # noqa: F401
    StragglerDetector, judge_gang)
from paddle_tpu_torch.observe import bottleneck  # noqa: F401
from paddle_tpu_torch.observe.bottleneck import attribute_step  # noqa: F401
from paddle_tpu_torch.observe import costs  # noqa: F401 — observe.costs.*
from paddle_tpu_torch.observe.compile_tracker import (  # noqa: F401
    CompileTracker, arg_signature, default_compile_tracker,
    track_compiles)
from paddle_tpu_torch.observe.flight import (  # noqa: F401
    FlightRecorder, default_flight_recorder, flight_dir,
    install_excepthook)
from paddle_tpu_torch.observe.health import HealthServer  # noqa: F401
from paddle_tpu_torch.observe.metrics import (  # noqa: F401
    Counter, Gauge, Histogram, JsonlSink, Registry, counter,
    default_registry, gauge, histogram, parse_prometheus, read_jsonl)
from paddle_tpu_torch.observe import requests  # noqa: F401
from paddle_tpu_torch.observe.requests import (  # noqa: F401
    RequestLog, default_request_log)
from paddle_tpu_torch.observe.trace import (  # noqa: F401
    current_scope, step_scope, trace_scope, traced)
from paddle_tpu_torch.observe.window import (  # noqa: F401
    SloConfig, WindowedQuantiles)

_lock = threading.Lock()
_sink: Optional[JsonlSink] = None
_sink_source = None        # "configure" | "flag" | "env" — see sink_source()
_explicit_off = False      # configure(None) from user code: defaults (env
                           # var, metrics_path flag) must not resurrect one
_env_checked = False       # PADDLE_TPU_METRICS_PATH probed once
_handlers: List[Callable[[dict], None]] = []


def configure(jsonl_path: Optional[str] = None,
              flush_every: int = 32,
              _source: str = "configure") -> Optional[JsonlSink]:
    """Install (or with ``jsonl_path=None`` remove) the process-wide JSONL
    metrics sink that ``report()`` feeds. Returns the sink. ``_source``
    tags where the sink came from ("configure" | "flag" | "env") so
    precedence between them stays decidable — callers other than the
    framework itself should leave it alone."""
    global _sink, _sink_source, _env_checked, _explicit_off
    with _lock:
        if _sink is not None:
            _sink.close()
            _sink = None
        _sink_source = None
        # explicit configuration settles the question — configure(None)
        # from user code means "no sink", and neither the env var nor
        # the metrics_path flag may resurrect one
        _env_checked = True
        _explicit_off = jsonl_path is None and _source == "configure"
        if jsonl_path:
            _sink = JsonlSink(jsonl_path, flush_every=flush_every)
            _sink_source = _source
        return _sink


def _env_autoconfigure():
    """PADDLE_TPU_METRICS_PATH wires the sink without code changes (the
    env contract every other knob in utils/flags.py follows). Probed once
    per process (and again after reset()) — not on every hot-loop call."""
    global _sink, _sink_source, _env_checked
    if _env_checked:
        return
    path = os.environ.get("PADDLE_TPU_METRICS_PATH")
    with _lock:
        _env_checked = True
        if path and _sink is None:
            try:
                _sink = JsonlSink(path)
                _sink_source = "env"
            except OSError as e:
                # a bad env path must not kill the training loop — the
                # explicit configure() API still raises for real callers
                from paddle_tpu_torch.utils.logger import get_logger
                get_logger("observe").warning(
                    "PADDLE_TPU_METRICS_PATH=%s unusable (%s); "
                    "metrics sink disabled", path, e)


def sink() -> Optional[JsonlSink]:
    if not _env_checked:
        _env_autoconfigure()
    return _sink


def sink_source() -> Optional[str]:
    """Where the active sink came from: "configure" (explicit code),
    "flag" (metrics_path flag via the trainer), or "env"
    (PADDLE_TPU_METRICS_PATH autoconfiguration); None without a sink.
    Lets callers honor explicit configuration over the defaults."""
    sink()                     # settle the env probe first
    return _sink_source


def explicitly_disabled() -> bool:
    """True after a user-code ``configure(None)``: the trainer's flag
    path must not resurrect the sink the user just turned off."""
    return _explicit_off


def has_consumers() -> bool:
    """True when report() would reach a sink or handler — hot loops use
    this to skip building record dicts nobody will read."""
    return sink() is not None or bool(_handlers)


def add_report_handler(fn: Callable[[dict], None]) -> None:
    """Register a callback invoked with every report() record — the
    programmatic tap (dashboards, tests) next to the JSONL file."""
    with _lock:
        _handlers.append(fn)


def remove_report_handler(fn: Callable[[dict], None]) -> None:
    with _lock:
        if fn in _handlers:
            _handlers.remove(fn)


def report(record: Optional[dict] = None, **scalars) -> dict:
    """Emit one observability record (a flat dict of scalars). Fans out
    to the JSONL sink (when configured) and all registered handlers.
    Never raises — a broken handler must not kill the training loop."""
    rec = dict(record or {})
    rec.update(scalars)
    s = sink()
    if s is not None:
        try:
            s.write(rec)
        except (OSError, ValueError, TypeError):
            pass       # incl. json.dumps on non-serializable values
    with _lock:
        handlers = list(_handlers)
    for fn in handlers:
        try:
            fn(rec)
        except Exception:  # noqa: BLE001 — observability is best-effort
            pass
    return rec


def reset():
    """Drop the sink and handlers, zero every default-registry series,
    and clear the span buffer / flight ring / compile tracker (test
    isolation). Registrations survive — module-level metric objects
    (trainer, master, distributed) must stay wired to the registry."""
    global _sink, _sink_source, _env_checked, _explicit_off
    with _lock:
        if _sink is not None:
            _sink.close()
        _sink = None
        _sink_source = None
        _env_checked = False
        _explicit_off = False
        _handlers.clear()
    default_registry().clear_series()
    default_buffer().clear()
    clear_alignments()
    default_flight_recorder().clear()
    default_compile_tracker().clear()
    default_request_log().clear()
