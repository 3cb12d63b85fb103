"""Metrics registry: Counter / Gauge / Histogram with labelled series —
the port's own copy of the parts of ``paddle_tpu/observe/metrics.py``
that the engine, the compile tracker, the health server and the flight
recorder use (stdlib only), with the process-wide default registry and
the JSON cleaning of ``JsonlSink`` (the file sink itself is not
ported)."""

import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

# Prometheus' default buckets, in seconds
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0)


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(key: Tuple[Tuple[str, str], ...]) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{_escape_label(v)}"' for k, v in key) + "}"


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

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._series: Dict[Tuple[Tuple[str, str], ...], object] = {}

    def _zero(self):
        raise NotImplementedError

    def _get(self, labels: Dict[str, str]):
        key = _label_key(labels)
        with self._lock:
            if key not in self._series:
                self._series[key] = self._zero()
            return self._series[key]

    def _peek(self, labels: Dict[str, str]):
        """Read-only lookup: never creates a series."""
        with self._lock:
            return self._series.get(_label_key(labels))

    def series(self) -> Dict[Tuple[Tuple[str, str], ...], object]:
        with self._lock:
            return dict(self._series)

    def remove(self, **labels):
        """Drop one labelled series (no-op when absent): a per-entity
        sample whose entity went away (a tenant whose budget was
        removed) must not freeze at its last value."""
        with self._lock:
            self._series.pop(_label_key(labels), None)


class _Cell:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0


class Counter(Metric):
    """Monotonically increasing count (requests, tokens)."""

    kind = "counter"

    def _zero(self):
        return _Cell()

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
    """Point-in-time value (queue depth, blocks in use)."""

    kind = "gauge"

    def _zero(self):
        return _Cell()

    def set(self, value: float, **labels):
        cell = self._get(labels)
        with self._lock:
            cell.value = float(value)

    def value(self, **labels) -> float:
        cell = self._peek(labels)
        return cell.value if cell is not None else 0.0


class Histogram(Metric):
    """Cumulative-bucket histogram (Prometheus semantics)."""

    kind = "histogram"

    class _HCell:
        __slots__ = ("counts", "sum", "count", "min", "max")

        def __init__(self, n_buckets):
            self.counts = [0] * n_buckets
            self.sum = 0.0
            self.count = 0
            self.min = math.inf
            self.max = -math.inf

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError(f"histogram {name}: needs at least one bucket")
        super().__init__(name, help)

    def _zero(self):
        return Histogram._HCell(len(self.buckets))

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

    def snapshot(self) -> Dict[str, dict]:
        """Nested plain-python snapshot: {name: {kind, help, series:
        [{labels, ...values}]}} (the flight recorder's ``metrics``)."""
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
                    c = m._read_cell(cell)
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


# -- the process-wide default registry ---------------------------------------

_default = Registry()


def default_registry() -> Registry:
    return _default


def counter(name: str, help: str = "") -> Counter:
    return _default.counter(name, help)


class JsonlSink:
    """The JSON cleaning of ``paddle_tpu``'s per-step JSONL sink, which
    the health server and the flight recorder apply to their documents."""

    @staticmethod
    def _clean(v):
        """Stringify non-finite floats at ANY depth: bare NaN/Infinity
        is not valid JSON and would break strict parsers."""
        if isinstance(v, float) and not math.isfinite(v):
            return repr(v)
        if isinstance(v, dict):
            return {k: JsonlSink._clean(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [JsonlSink._clean(x) for x in v]
        return v
