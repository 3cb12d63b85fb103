"""Metrics registry: Counter / Gauge / Histogram with labelled series —
the port's own copy of ``paddle_tpu/observe/metrics.py`` (stdlib only).

Two sinks:

- ``JsonlSink`` — one JSON record per step (TensorBoard-style scalar
  log), tailed by a shell or read back with ``read_jsonl``; the fleet
  aggregator writes one record per scrape through it;
- ``render_prometheus()`` — Prometheus text exposition format, so a
  scrape endpoint (or a test) can read a snapshot of any registry;
  ``parse_prometheus`` reads it back into the ``Registry.snapshot``
  shape (the fleet's TCP replica scrape).
"""

import json
import math
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

# Prometheus' default buckets, in seconds — right-sized for request/step
# latencies from 1 ms to 10 s.
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0)


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape_label(v: str) -> str:
    """Prometheus text-format label escaping (backslash, quote, newline)
    — one raw quote in a label value would invalidate the whole scrape
    response, not just the one series."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(key: Tuple[Tuple[str, str], ...]) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in key)
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    return repr(int(f)) if f.is_integer() else repr(f)


class Metric:
    """Base: one named metric holding one series per label combination."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 registry: Optional["Registry"] = None):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._series: Dict[Tuple[Tuple[str, str], ...], object] = {}
        if registry is not None:
            registry.register(self)

    def _zero(self):
        raise NotImplementedError

    def _get(self, labels: Dict[str, str]):
        key = _label_key(labels)
        with self._lock:
            if key not in self._series:
                self._series[key] = self._zero()
            return self._series[key]

    def _peek(self, labels: Dict[str, str]):
        """Read-only lookup: never creates a series — value() and
        snapshot() must not grow label cardinality from probe paths."""
        with self._lock:
            return self._series.get(_label_key(labels))

    def series(self) -> Dict[Tuple[Tuple[str, str], ...], object]:
        with self._lock:
            return dict(self._series)

    def remove(self, **labels):
        """Drop one labelled series (no-op when absent) — the
        bounded-cardinality hygiene hook for per-entity samples whose
        entity set changes at runtime (e.g. a tenant whose budget is
        removed: its gauge must not freeze at the last written value
        forever)."""
        with self._lock:
            self._series.pop(_label_key(labels), None)

    def clear(self):
        with self._lock:
            self._series.clear()


class Counter(Metric):
    """Monotonically increasing count (requests, tokens, errors)."""

    kind = "counter"

    class _Cell:
        __slots__ = ("value",)

        def __init__(self):
            self.value = 0.0

    def _zero(self):
        return Counter._Cell()

    def inc(self, amount: float = 1.0, **labels):
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative increment "
                             f"{amount}")
        cell = self._get(labels)
        with self._lock:
            cell.value += amount

    def value(self, **labels) -> float:
        cell = self._peek(labels)
        return cell.value if cell is not None else 0.0


class Gauge(Metric):
    """Point-in-time value (queue depth, memory bytes, temperature)."""

    kind = "gauge"

    class _Cell:
        __slots__ = ("value",)

        def __init__(self):
            self.value = 0.0

    def _zero(self):
        return Gauge._Cell()

    def set(self, value: float, **labels):
        cell = self._get(labels)
        with self._lock:
            cell.value = float(value)

    def inc(self, amount: float = 1.0, **labels):
        cell = self._get(labels)
        with self._lock:
            cell.value += amount

    def dec(self, amount: float = 1.0, **labels):
        self.inc(-amount, **labels)

    def value(self, **labels) -> float:
        cell = self._peek(labels)
        return cell.value if cell is not None else 0.0


class Histogram(Metric):
    """Cumulative-bucket histogram (Prometheus semantics): each bucket
    counts observations <= its upper bound; +Inf is implicit."""

    kind = "histogram"

    class _Cell:
        __slots__ = ("counts", "sum", "count", "min", "max")

        def __init__(self, n_buckets):
            self.counts = [0] * n_buckets
            self.sum = 0.0
            self.count = 0
            self.min = math.inf
            self.max = -math.inf

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_BUCKETS,
                 registry: Optional["Registry"] = None):
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError(f"histogram {name}: needs at least one bucket")
        super().__init__(name, help, registry)

    def _zero(self):
        return Histogram._Cell(len(self.buckets))

    def observe(self, value: float, **labels):
        cell = self._get(labels)
        with self._lock:
            for i, b in enumerate(self.buckets):
                if value <= b:
                    cell.counts[i] += 1
                    break
            cell.sum += value
            cell.count += 1
            cell.min = min(cell.min, value)
            cell.max = max(cell.max, value)

    def _read_cell(self, cell) -> Dict[str, object]:
        """A consistent copy of one cell under the lock — renderers must
        not read counts/sum/count piecewise while observe() is mid-update
        in another thread (a torn read emits a non-monotonic histogram
        that Prometheus clients reject)."""
        with self._lock:
            return {"counts": list(cell.counts), "sum": cell.sum,
                    "count": cell.count, "min": cell.min, "max": cell.max}

    def snapshot(self, **labels) -> Dict[str, float]:
        cell = self._peek(labels)
        if cell is None:
            return {"count": 0, "sum": 0.0, "avg": 0.0,
                    "min": 0.0, "max": 0.0}
        c = self._read_cell(cell)
        return {"count": c["count"], "sum": c["sum"],
                "avg": c["sum"] / c["count"] if c["count"] else 0.0,
                "min": c["min"] if c["count"] else 0.0,
                "max": c["max"] if c["count"] else 0.0}

    def quantile(self, q: float, **labels) -> float:
        """Bucket-resolution quantile estimate from the cumulative
        counts: the upper bound of the first bucket whose cumulative
        count covers rank ``q*count`` (the Prometheus convention,
        without interpolation — the answer is exact to one bucket
        width). Observations above the last bucket report the tracked
        max; empty series report 0. The sliding-window estimator
        (``observe/window.py``) must agree with this on a stationary
        stream — pinned by tests."""
        cell = self._peek(labels)
        if cell is None:
            return 0.0
        c = self._read_cell(cell)
        if not c["count"]:
            return 0.0
        rank = q * c["count"]
        cum = 0
        for ub, n in zip(self.buckets, c["counts"]):
            cum += n
            if cum >= rank and cum > 0:
                return ub
        return c["max"]          # the +Inf bucket: report the real max

    def time(self, **labels):
        """Context manager observing the elapsed wall time in seconds."""
        return _HistTimer(self, labels)


class _HistTimer:
    def __init__(self, hist, labels):
        self._hist = hist
        self._labels = labels

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._hist.observe(time.perf_counter() - self._t0, **self._labels)
        return False


class Registry:
    """Thread-safe collection of metrics; the unit of export."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Metric] = {}

    def register(self, metric: Metric) -> Metric:
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None:
                if type(existing) is not type(metric):
                    raise ValueError(
                        f"metric {metric.name!r} already registered as "
                        f"{existing.kind}, cannot re-register as "
                        f"{metric.kind}")
                if (isinstance(metric, Histogram)
                        and metric.buckets != existing.buckets):
                    # silently returning the old buckets would drop the
                    # caller's chosen resolution with no signal
                    raise ValueError(
                        f"histogram {metric.name!r} already registered "
                        f"with buckets {existing.buckets}, requested "
                        f"{metric.buckets}")
                return existing
            self._metrics[metric.name] = metric
            return metric

    def counter(self, name: str, help: str = "") -> Counter:
        return self.register(Counter(name, help))

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self.register(Gauge(name, help))

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self.register(Histogram(name, help, buckets))

    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    def metrics(self) -> List[Metric]:
        with self._lock:
            return sorted(self._metrics.values(), key=lambda m: m.name)

    def clear(self):
        with self._lock:
            self._metrics.clear()

    def clear_series(self):
        """Zero every metric's series without dropping registrations —
        module-level metrics (master.py, distributed.py) stay wired."""
        for m in self.metrics():
            m.clear()

    # -- export ------------------------------------------------------------
    def snapshot(self) -> Dict[str, dict]:
        """Nested plain-python snapshot: {name: {kind, help, series:
        [{labels, ...values}]}} — the CLI pretty-printer's input."""
        out = {}
        for m in self.metrics():
            series = []
            for key, cell in sorted(m.series().items()):
                rec = {"labels": dict(key)}
                if m.kind == "histogram":
                    rec.update(m.snapshot(**dict(key)))
                else:
                    rec["value"] = cell.value
                series.append(rec)
            out[m.name] = {"kind": m.kind, "help": m.help, "series": series}
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        lines = []
        for m in self.metrics():
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for key, cell in sorted(m.series().items()):
                if m.kind == "histogram":
                    c = m._read_cell(cell)     # consistent under the lock
                    cum = 0
                    for ub, n in zip(m.buckets, c["counts"]):
                        cum += n
                        bkey = key + (("le", _fmt_value(ub)),)
                        lines.append(f"{m.name}_bucket"
                                     f"{_fmt_labels(bkey)} {cum}")
                    bkey = key + (("le", "+Inf"),)
                    lines.append(f"{m.name}_bucket{_fmt_labels(bkey)} "
                                 f"{c['count']}")
                    lines.append(f"{m.name}_sum{_fmt_labels(key)} "
                                 f"{_fmt_value(c['sum'])}")
                    lines.append(f"{m.name}_count{_fmt_labels(key)} "
                                 f"{c['count']}")
                else:
                    lines.append(f"{m.name}{_fmt_labels(key)} "
                                 f"{_fmt_value(cell.value)}")
        return "\n".join(lines) + ("\n" if lines else "")


def _parse_labels(s: str) -> Dict[str, str]:
    """Parse one ``{k="v",...}`` label block (inverse of _fmt_labels,
    including the escaping)."""
    out: Dict[str, str] = {}
    i = 0
    while i < len(s):
        eq = s.index("=", i)
        name = s[i:eq].strip().lstrip(",").strip()
        assert s[eq + 1] == '"', f"malformed label block {s!r}"
        j = eq + 2
        buf = []
        while s[j] != '"':
            if s[j] == "\\":
                j += 1
                buf.append({"n": "\n"}.get(s[j], s[j]))
            else:
                buf.append(s[j])
            j += 1
        out[name] = "".join(buf)
        i = j + 1
    return out


def parse_prometheus(text: str) -> Dict[str, dict]:
    """Parse Prometheus text exposition back into the
    :meth:`Registry.snapshot` shape: ``{name: {kind, series: [{labels,
    value}]}}`` — the inverse the fleet aggregator uses to scrape a
    replica's ``/metrics`` over HTTP into its own labeled registry.

    Histogram exposition (``_bucket``/``_sum``/``_count`` lines) folds
    back under the base name as ``{labels, sum, count}`` records (the
    per-bucket counts are not reconstructed — fleet aggregation pools
    raw window samples for quantiles, never merges bucket estimates).
    Unknown/malformed lines are skipped, not fatal: a scrape is
    best-effort observability, not a parser contract.
    """
    kinds: Dict[str, str] = {}
    out: Dict[str, dict] = {}

    def _series(name: str, labels: Dict[str, str]) -> dict:
        doc = out.setdefault(name, {"kind": kinds.get(name, "untyped"),
                                    "series": []})
        key = _label_key(labels)
        for rec in doc["series"]:
            if _label_key(rec["labels"]) == key:
                return rec
        rec = {"labels": labels}
        doc["series"].append(rec)
        return rec

    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                kinds[parts[2]] = parts[3]
            continue
        try:
            lhs, val_s = line.rsplit(None, 1)
            value = float(val_s)
            if "{" in lhs:
                name, rest = lhs.split("{", 1)
                rest = rest.rstrip()
                if not rest.endswith("}"):
                    raise ValueError(f"unterminated label block: "
                                     f"{line!r}")
                labels = _parse_labels(rest[:-1])
            else:
                name, labels = lhs, {}
            base = None
            for suffix, field in (("_bucket", None), ("_sum", "sum"),
                                  ("_count", "count")):
                cand = name[:-len(suffix)] if name.endswith(suffix) else None
                if cand and kinds.get(cand) == "histogram":
                    base, comp = cand, field
                    break
            if base is not None:
                if comp is None:
                    continue             # bucket lines: not reconstructed
                _series(base, labels)[comp] = value
            else:
                _series(name, labels)["value"] = value
        except (ValueError, AssertionError, IndexError):
            continue
    for name, doc in out.items():
        doc["kind"] = kinds.get(name, doc["kind"])
    return out


# -- the global default registry -------------------------------------------

_default = Registry()


def default_registry() -> Registry:
    return _default


def counter(name: str, help: str = "") -> Counter:
    return _default.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return _default.gauge(name, help)


def histogram(name: str, help: str = "",
              buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
    return _default.histogram(name, help, buckets)


# -- JSONL scalar sink ------------------------------------------------------

class JsonlSink:
    """One JSON record per step, appended to a file — the TensorBoard-
    scalars equivalent a shell can grep and ``read_jsonl`` reads back.

    Records carry ``ts`` (epoch seconds) plus whatever scalars the caller
    passes; non-finite floats serialize as strings so the file stays
    valid JSON line-by-line.

    Writes are block-buffered and flushed every ``flush_every`` records
    or at least once a second — a per-line flush costs a ~100 µs syscall
    that would dominate sub-ms train steps (the <5% overhead budget).
    """

    def __init__(self, path: str, flush_every: int = 32):
        self.path = path
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self._f = open(path, "a")
        self._lock = threading.Lock()
        self._n = 0
        self._last_flush = time.monotonic()
        self.flush_every = max(1, flush_every)

    @staticmethod
    def _clean(v):
        """Stringify non-finite floats at ANY depth (a diverged run's
        metrics dict carries NaN) — bare NaN/Infinity is not valid JSON
        and would break strict parsers line-by-line."""
        if isinstance(v, float) and not math.isfinite(v):
            return repr(v)
        if isinstance(v, dict):
            return {k: JsonlSink._clean(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [JsonlSink._clean(x) for x in v]
        return v

    def write(self, record: Optional[dict] = None, **scalars):
        rec = {"ts": round(time.time(), 3)}
        if record:
            rec.update(record)
        rec.update(scalars)
        line = json.dumps(self._clean(rec))
        with self._lock:
            if self._f.closed:
                return
            self._f.write(line + "\n")
            self._n += 1
            now = time.monotonic()
            if (self._n % self.flush_every == 0
                    or now - self._last_flush >= 1.0):
                self._f.flush()
                self._last_flush = now

    def flush(self):
        with self._lock:
            if not self._f.closed:
                self._f.flush()

    def close(self):
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def read_jsonl(path: str, last: Optional[int] = None) -> List[dict]:
    """Parse a JSONL metrics file; malformed lines (a crash mid-write)
    are skipped, not fatal. ``last`` keeps only the trailing N records."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                continue
    return out[-last:] if last else out
