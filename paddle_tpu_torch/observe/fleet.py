"""Fleet metrics aggregation: N replica registries merged into one — the
port's own copy of ``paddle_tpu/observe/fleet.py`` (stdlib only).

:class:`FleetAggregator` is the router-side half: on the router's
health-poll cadence it ingests every replica's metrics view (the
in-process handle passes the engine registry's ``snapshot()`` dict; the
TCP handle scrapes HTTP ``/metrics`` and parses it back with
``metrics.parse_prometheus`` — same shape either way) and merges it
into one labelled fleet registry:

- **counters** are summed across replicas under ``fleet_<name>``
  (per-replica DELTAS summed, clamped at zero, so a replica restart —
  its counters reset — never subtracts from the fleet total);
- **gauges** are kept per-replica under ``fleet_<name>{replica=...}``
  (a fleet-summed queue depth would hide exactly the placement skew a
  gauge exists to show);
- **histograms** are not merged (bucket estimates don't pool) — fleet
  quantiles come from the raw windowed TTFT samples every replica
  exports in its ``/healthz`` ``window.ttft_samples`` (clock-free
  ``[age_s, value]`` pairs), pooled through
  ``WindowedQuantiles.absorb`` into ``fleet_ttft_window_seconds{q}``.
  Averaging per-replica p99s instead would weight a 3-request replica
  like a 3000-request one and lose the fleet tail entirely.

Each scrape can append one record to a JSONL time-series (``kind:
"fleet"``) for post-hoc analysis, and :func:`death_postmortem` bundles
a dead replica's last-known state with the router's view into one
flight-recorder artifact.

``prefix``/``entity_label``/``window_keys`` generalize the member
handle past serving replicas (a training gang's ranks, say), with the
same never-average-per-member-p99s semantics.
"""


import os
import time
from typing import Dict, List, Optional

from paddle_tpu_torch.observe import metrics as _metrics
from paddle_tpu_torch.observe.window import WindowedQuantiles

_QS = (("p50", 0.5), ("p95", 0.95), ("p99", 0.99))


class FleetAggregator:
    """Scrape-and-merge of N replica metric views into one registry.

    ``registry`` is where the fleet series land — the router passes its
    OWN registry so one ``/metrics`` scrape answers for the whole
    fleet; defaults to a fresh one. ``jsonl_path`` appends one record
    per scrape for post-hoc time-series analysis.

    ``prefix``/``entity_label``/``window_keys`` generalize the member
    handle: the serving router keeps the defaults
    (``fleet_*{replica=...}`` with the pooled ``ttft`` window); the
    training-gang supervisor passes ``prefix="gang"``,
    ``entity_label="rank"``, ``window_keys=("step_time",
    "barrier_wait")`` so the same delta-summed-counter /
    labeled-gauge / pooled-raw-samples semantics serve the gang. Each
    window key ``k`` is fed from the member doc's ``window.
    <k>_samples`` export and lands as ``<prefix>_<k>_window_seconds{q}``
    plus a sample-count gauge (suffix ``count_suffix`` — "_requests"
    for serving, "_samples" reads better for step times).
    """

    def __init__(self, *, registry: Optional[_metrics.Registry] = None,
                 window_s: float = 60.0,
                 jsonl_path: Optional[str] = None,
                 clock=time.monotonic,
                 prefix: str = "fleet",
                 entity_label: str = "replica",
                 window_keys=("ttft",),
                 count_suffix: str = "_requests"):
        self.registry = (registry if registry is not None
                         else _metrics.Registry())
        self.window_s = float(window_s)
        self._clock = clock
        self.prefix = str(prefix)
        self.entity_label = str(entity_label)
        self.window_keys = tuple(window_keys)
        self._sink = (_metrics.JsonlSink(jsonl_path)
                      if jsonl_path else None)
        # (member, metric, label_key) -> last seen cumulative value:
        # the delta base that makes counter summing reset-safe
        self._last_counts: Dict[tuple, float] = {}
        # member -> (scrape_t, {window_key: [[age_s, value], ...]}) —
        # the LATEST window export per member, pooled on demand
        # (re-absorbing every scrape would duplicate samples)
        self._samples: Dict[str, tuple] = {}
        self._states: Dict[str, str] = {}
        reg = self.registry
        self._m_scrapes = reg.counter(
            f"{self.prefix}_scrapes_total",
            "aggregator scrape rounds completed")
        # the serving census gauge predates the generalization and its
        # name is pinned by dashboards/alert rules; other prefixes get
        # the neutral "<prefix>_members"
        census = ("fleet_replicas" if self.prefix == "fleet"
                  else f"{self.prefix}_members")
        self._m_members = reg.gauge(
            census, "members per admission state (label state) — the "
            "dead-member alert rule's input")
        self._m_windows = {}
        for key in self.window_keys:
            self._m_windows[key] = (
                reg.gauge(
                    f"{self.prefix}_{key}_window_seconds",
                    f"rolling {key} quantile over the window (label "
                    "q), POOLED from every member's raw windowed "
                    "samples — never an average of per-member "
                    "quantiles"),
                reg.gauge(
                    f"{self.prefix}_{key}_window{count_suffix}",
                    f"samples behind the pooled {key} window "
                    "quantiles"))

    # -- ingestion ---------------------------------------------------------
    def observe_replica(self, name: str, *, state: str = "ok",
                        health: Optional[dict] = None,
                        snapshot: Optional[dict] = None,
                        now: Optional[float] = None):
        """Ingest one member's view: its admission state, its
        ``/healthz``-shaped document (source of the raw window samples
        under ``window.<key>_samples``) and its registry snapshot
        (counters + gauges). Either doc may be None (endpoint
        unreachable) — the aggregator keeps the last window view and
        simply skips the counter round."""
        now = self._clock() if now is None else float(now)
        name = str(name)
        self._states[name] = str(state)
        if snapshot:
            self._merge_snapshot(name, snapshot)
        win = (health or {}).get("window") or {}
        found = {key: list(win[f"{key}_samples"])
                 for key in self.window_keys
                 if f"{key}_samples" in win}
        if found:
            # a partial export keeps the other keys' last view
            prev = self._samples.get(name)
            merged = dict(prev[1]) if prev else {}
            merged.update(found)
            self._samples[name] = (now, merged)

    def members(self):
        """The members currently in the state census (census order is
        insertion order — callers sort)."""
        return list(self._states)

    def _merge_snapshot(self, name: str, snapshot: Dict[str, dict]):
        for mname, doc in snapshot.items():
            kind = doc.get("kind")
            series = doc.get("series") or []
            if kind == "counter":
                m = self.registry.counter(f"{self.prefix}_{mname}")
                for rec in series:
                    labels = dict(rec.get("labels") or {})
                    try:
                        value = float(rec.get("value", 0.0))
                    except (TypeError, ValueError):
                        continue
                    key = (name, mname,
                           tuple(sorted(labels.items())))
                    delta = value - self._last_counts.get(key, 0.0)
                    self._last_counts[key] = value
                    if delta > 0:
                        m.inc(delta, **labels)
            elif kind == "gauge":
                m = self.registry.gauge(f"{self.prefix}_{mname}")
                for rec in series:
                    labels = dict(rec.get("labels") or {})
                    try:
                        value = float(rec.get("value", 0.0))
                    except (TypeError, ValueError):
                        continue
                    labels[self.entity_label] = name  # ours wins
                    m.set(value, **labels)
            # histograms: deliberately skipped (see module docstring)

    def drop_replica(self, name: str):
        """Forget a member's window samples and counter bases (it
        died; its gauges stay at their last value under its label —
        the post-mortem view — until the next scrape overwrites or a
        restart re-registers it)."""
        name = str(name)
        self._samples.pop(name, None)
        for key in [k for k in self._last_counts if k[0] == name]:
            self._last_counts.pop(key, None)

    def forget_state(self, name: str):
        """Drop a member from the state census entirely (admin
        removal — as opposed to ``drop_replica``, which keeps the
        ``dead`` entry so the dead-member alert can fire), and remove
        every aggregated gauge series carrying its entity label (the
        stale-sample hygiene a gang shrink relies on). The next
        ``finish_scrape`` stops counting it, which is what RESOLVES
        that alert."""
        self._states.pop(str(name), None)
        for mname, doc in list(self.registry.snapshot().items()):
            if (not mname.startswith(f"{self.prefix}_")
                    or doc["kind"] != "gauge"):
                continue
            m = self.registry.get(mname)
            for rec in doc.get("series") or []:
                labels = dict(rec.get("labels") or {})
                if labels.get(self.entity_label) == name:
                    m.remove(**labels)

    # -- derived fleet series ----------------------------------------------
    def pooled(self, key: str,
               now: Optional[float] = None) -> WindowedQuantiles:
        """The pooled window for one key: every member's latest
        raw-sample export pooled (ages shifted by time-since-scrape)
        into one WindowedQuantiles. Built fresh per call — the
        per-member exports are the state; re-pooling is how expiry
        stays exact."""
        now = self._clock() if now is None else float(now)
        pool = WindowedQuantiles(window_s=self.window_s,
                                 max_samples=65536, clock=self._clock)
        for scrape_t, by_key in self._samples.values():
            drift = now - scrape_t
            pool.absorb([[age + drift, v]
                         for age, v in by_key.get(key, ())], now=now)
        return pool

    def pooled_ttft(self, now: Optional[float] = None
                    ) -> WindowedQuantiles:
        """The serving-era name for ``pooled("ttft")``."""
        return self.pooled("ttft", now)

    def finish_scrape(self, now: Optional[float] = None) -> dict:
        """Close one scrape round: refresh the derived gauges (state
        counts, pooled window quantiles per key), append the JSONL
        record, return a summary dict (what the record carried)."""
        now = self._clock() if now is None else float(now)
        self._m_scrapes.inc()
        by_state: Dict[str, int] = {}
        for s in self._states.values():
            by_state[s] = by_state.get(s, 0) + 1
        for s in ("ok", "degraded", "unhealthy", "dead", "done"):
            if s == "done" and self.prefix == "fleet":
                continue       # serving has no clean-exit state
            self._m_members.set(by_state.get(s, 0), state=s)
        summary = {"kind": self.prefix,
                   "replicas": dict(self._states)}
        for key in self.window_keys:
            pool = self.pooled(key, now)
            qs = pool.quantiles([q for _, q in _QS], now=now)
            m_win, m_n = self._m_windows[key]
            for lbl, q in _QS:
                m_win.set(qs[q], q=lbl)
            m_n.set(pool.count(now))
            summary[f"{key}_p50_s"] = round(qs[0.5], 6)
            summary[f"{key}_p99_s"] = round(qs[0.99], 6)
            summary.setdefault("window_requests", pool.count(now))
        if self._sink is not None:
            self._sink.write(dict(summary))
        return summary

    def ttft_quantile(self, q: float,
                      now: Optional[float] = None) -> float:
        return self.pooled("ttft", now).quantile(q, now=now)

    def close(self):
        if self._sink is not None:
            self._sink.close()


def death_postmortem(name: str, *, router_view: Optional[dict] = None,
                     last_health: Optional[dict] = None,
                     outstanding: Optional[List[dict]] = None,
                     alerts: Optional[List[dict]] = None,
                     path: Optional[str] = None) -> Optional[str]:
    """Bundle a dead replica's post-mortem with the router's view into
    ONE flight artifact: the member's last-known ``/healthz`` document,
    the work it held when the transport died, the router's fleet
    health document and firing alerts — plus the standard flight
    snapshot (metrics registry, env, compile tracker). Written as
    ``fleet_death_<replica>_<utc>.json`` in the flight dir; returns
    the path (None when the write failed — post-mortems never raise
    into the requeue path)."""
    from paddle_tpu_torch.observe import flight as _flight
    rec = _flight.default_flight_recorder()
    rec.record({"kind": "replica_death", "replica": str(name),
                "last_health": last_health or {},
                "outstanding": outstanding or [],
                "router": router_view or {},
                "alerts": alerts or []})
    if path is None:
        path = os.path.join(
            _flight.flight_dir(),
            time.strftime(f"fleet_death_{name}_%Y%m%d_%H%M%S",
                          time.gmtime()) + f"_{os.getpid()}.json")
    return rec.dump(path, reason=f"replica {name} died")
