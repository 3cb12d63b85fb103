"""Declarative alert rules over a metrics registry — the port's own
copy of ``paddle_tpu/observe/alerts.py`` (stdlib only).

The fleet aggregator (``observe/fleet.py``) answers "what is the
fleet's state"; this module answers "is that state WRONG" — the
machine-readable signal surface an autoscaler keys off.

An :class:`AlertRule` is one threshold over one registry series::

    AlertRule("fleet_dead_replicas", metric="fleet_replicas",
              labels={"state": "dead"}, op=">=", threshold=1,
              for_s=0.0, description="a replica transport died")

``for_s`` is the for-duration debounce (Prometheus semantics): the
condition must hold CONTINUOUSLY that long before the rule fires —
``pending`` in between — so a one-poll queue spike never pages.
Four states per rule: ``inactive`` → ``pending`` (condition true,
clock running) → ``firing`` (held for ``for_s``) → back to
``inactive`` (emitting ``resolved``). Transitions emit:

- a nestable-async trace slice (cat ``alert``, id ``alert.<rule>``):
  ``b`` at firing, ``e`` at resolved — the alert's lifetime renders as
  one span NEXT TO the request timelines that caused it;
- the ``alerts_transitions_total{rule, event}`` counter and the
  ``alert_firing{rule}`` 0/1 gauge;
- a record into the evaluator's bounded event log, served by the
  router's ``/alerts`` endpoint.

A rule whose metric (or labelled series) does not exist yet evaluates
as NOT breached — absence of traffic is not an incident.
"""


import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

from paddle_tpu_torch.observe import chrome_trace as _chrome
from paddle_tpu_torch.observe import metrics as _metrics

_OPS = {
    ">": lambda v, t: v > t,
    ">=": lambda v, t: v >= t,
    "<": lambda v, t: v < t,
    "<=": lambda v, t: v <= t,
}


@dataclasses.dataclass(frozen=True)
class AlertRule:
    """One declarative threshold: ``<metric>{labels} <op> <threshold>``
    held for ``for_s`` seconds fires the alert named ``name``.

    ``min_samples`` guards ratio/quantile rules against cold starts: a
    second gated metric (``samples_metric``, same label semantics) must
    be at least ``min_samples`` for the rule to evaluate at all — a
    prefix-hit-rate of 0.0 over zero placements is not a breach.
    """

    name: str
    metric: str
    op: str
    threshold: float
    labels: Dict[str, str] = dataclasses.field(default_factory=dict)
    for_s: float = 0.0
    description: str = ""
    samples_metric: Optional[str] = None
    min_samples: float = 1.0

    def __post_init__(self):
        if self.op not in _OPS:
            raise ValueError(f"alert rule {self.name!r}: op must be one "
                             f"of {sorted(_OPS)}, got {self.op!r}")
        if self.for_s < 0:
            raise ValueError(f"alert rule {self.name!r}: for_s must be "
                             f">= 0, got {self.for_s}")


class _RuleState:
    __slots__ = ("state", "pending_t", "fired_t", "value")

    def __init__(self):
        self.state = "inactive"     # inactive | pending | firing
        self.pending_t: Optional[float] = None
        self.fired_t: Optional[float] = None
        self.value = 0.0


class AlertEvaluator:
    """Evaluate a rule set against one registry on the caller's
    cadence (the router does it per health-poll round). ``buffer``
    receives the firing/resolved trace events (default: the process
    span buffer, so ``stats --trace`` shows alert spans next to the
    requests that caused them)."""

    def __init__(self, registry: _metrics.Registry,
                 rules: Sequence[AlertRule], *,
                 counter_registry: Optional[_metrics.Registry] = None,
                 clock=time.monotonic, max_events: int = 256):
        self.registry = registry
        self.rules = list(rules)
        names = [r.name for r in self.rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate alert rule names: {names}")
        self._clock = clock
        self._states = {r.name: _RuleState() for r in self.rules}
        self.events: deque = deque(maxlen=max(1, int(max_events)))
        # alert spans carry wall-clock timestamps like every other
        # trace event (monotonic clocks don't merge across processes)
        self._wall_anchor = time.time() - time.perf_counter()
        reg = counter_registry if counter_registry is not None \
            else registry
        self._m_transitions = reg.counter(
            "alerts_transitions_total", "alert state transitions, by "
            "rule and event (firing | resolved)")
        self._m_firing = reg.gauge(
            "alert_firing", "1 while the rule is firing, else 0")
        for r in self.rules:
            self._m_firing.set(0, rule=r.name)

    # -- evaluation --------------------------------------------------------
    def _value(self, rule: AlertRule) -> Optional[float]:
        m = self.registry.get(rule.metric)
        if m is None or m.kind == "histogram":
            return None
        cell = m._peek(rule.labels)
        if cell is None:
            return None
        return float(cell.value)

    def _enough_samples(self, rule: AlertRule) -> bool:
        if rule.samples_metric is None:
            return True
        m = self.registry.get(rule.samples_metric)
        if m is None or m.kind == "histogram":
            return False
        total = sum(c.value for c in m.series().values())
        return total >= rule.min_samples

    def evaluate(self, now: Optional[float] = None) -> List[dict]:
        """One evaluation round; returns the transition events it
        emitted (firing/resolved records, also kept in ``events``)."""
        now = self._clock() if now is None else float(now)
        out: List[dict] = []
        for rule in self.rules:
            st = self._states[rule.name]
            value = self._value(rule)
            breached = (value is not None
                        and self._enough_samples(rule)
                        and _OPS[rule.op](value, rule.threshold))
            st.value = value if value is not None else 0.0
            if breached:
                if st.state == "inactive":
                    st.state, st.pending_t = "pending", now
                if (st.state == "pending"
                        and now - st.pending_t >= rule.for_s):
                    st.state, st.fired_t = "firing", now
                    out.append(self._transition(rule, st, "firing", now))
            else:
                if st.state == "firing":
                    out.append(self._transition(rule, st, "resolved",
                                                now))
                st.state, st.pending_t, st.fired_t = \
                    "inactive", None, None
        return out

    def _transition(self, rule: AlertRule, st: _RuleState,
                    event: str, now: float) -> dict:
        self._m_transitions.inc(rule=rule.name, event=event)
        self._m_firing.set(1 if event == "firing" else 0,
                           rule=rule.name)
        wall = self._wall_anchor + time.perf_counter()
        _chrome.record_event(
            f"alert:{rule.name}", wall,
            "b" if event == "firing" else "e",
            f"alert.{rule.name}", cat="alert",
            args={"event": event, "value": round(st.value, 6),
                  "threshold": rule.threshold, "op": rule.op})
        rec = {"rule": rule.name, "event": event,
               "value": round(st.value, 6),
               "metric": rule.metric, "labels": dict(rule.labels),
               "op": rule.op, "threshold": rule.threshold,
               "for_s": rule.for_s,
               "description": rule.description,
               "ts": round(time.time(), 3)}
        self.events.append(rec)
        return rec

    # -- read side ---------------------------------------------------------
    def firing(self) -> List[dict]:
        """The rules currently firing, with their live values."""
        out = []
        for rule in self.rules:
            st = self._states[rule.name]
            if st.state == "firing":
                out.append({"rule": rule.name,
                            "value": round(st.value, 6),
                            "op": rule.op,
                            "threshold": rule.threshold,
                            "description": rule.description})
        return out

    def doc(self) -> dict:
        """The ``/alerts`` endpoint document: per-rule state + the
        recent transition log."""
        return {
            "rules": [{
                "rule": r.name, "metric": r.metric,
                "labels": dict(r.labels), "op": r.op,
                "threshold": r.threshold, "for_s": r.for_s,
                "state": self._states[r.name].state,
                "value": round(self._states[r.name].value, 6),
                "description": r.description,
            } for r in self.rules],
            "firing": self.firing(),
            "events": list(self.events),
        }


def default_fleet_rules(*, burn_threshold: float = 1.0,
                        queue_depth: float = 32,
                        dead_replicas: float = 1,
                        prefix_hit_rate: float = 0.2,
                        min_placements: float = 20,
                        for_s: float = 0.0) -> List[AlertRule]:
    """The stock rule set over the router + fleet registry — the four
    signals an admission controller or autoscaler steers on.
    Thresholds are constructor knobs; ``for_s`` applies to the rate
    rules (the dead-replica rule always fires immediately: a lost
    transport is not noise)."""
    return [
        AlertRule("fleet_ttft_burn_rate",
                  metric="router_slo_burn_rate", op=">",
                  threshold=burn_threshold, for_s=for_s,
                  description="fleet TTFT SLO error budget burning "
                  "faster than it accrues"),
        AlertRule("fleet_queue_depth",
                  metric="router_queue_depth", op=">",
                  threshold=queue_depth, for_s=for_s,
                  description="requests backing up unplaced — the "
                  "scale-up signal"),
        AlertRule("fleet_dead_replicas",
                  metric="fleet_replicas", labels={"state": "dead"},
                  op=">=", threshold=dead_replicas, for_s=0.0,
                  description="a replica transport died (its work was "
                  "requeued onto survivors)"),
        AlertRule("fleet_prefix_hit_rate",
                  metric="router_placement_hit_rate", op="<",
                  threshold=prefix_hit_rate, for_s=for_s,
                  samples_metric="router_placements_total",
                  min_samples=min_placements,
                  description="placements mostly landing cold — "
                  "placement keying drifted or the hot set churned"),
    ]


def default_training_rules(*, skew_s: float = 1.0,
                           wedge_s: float = 30.0,
                           restarts_10m: float = 3,
                           input_fraction: float = 0.25,
                           min_scrapes: float = 3,
                           for_s: float = 0.0) -> List[AlertRule]:
    """The stock rule set over the gang supervisor's registry — the
    training-side mirror of :func:`default_fleet_rules`, keyed off the
    series the supervisor's scrape loop maintains (reference
    ``runtime/supervisor.py``): straggler skew, per-rank step recency, the
    restart-rate window, and the goodput ledger's input-stall split.

    ``wedge_s`` should sit WELL UNDER the supervisor's hard
    ``wedge_window`` — this alert is the early warning that pages a
    human before the supervisor's judge kills the gang."""
    return [
        AlertRule("gang_step_skew",
                  metric="gang_step_skew_seconds", labels={"q": "p50"},
                  op=">", threshold=skew_s, for_s=for_s,
                  description="median step wall diverging across ranks "
                  "— one host is consistently slower (see "
                  "gang_straggler_rank for the attribution)"),
        AlertRule("gang_wedge_suspect",
                  metric="gang_max_seconds_since_step", op=">",
                  threshold=wedge_s, for_s=for_s,
                  description="a rank is heartbeating but has not "
                  "advanced its step — wedged collective or stuck "
                  "input, ahead of the supervisor's hard wedge kill"),
        AlertRule("training_restart_storm",
                  metric="training_restarts_last_10m", op=">=",
                  threshold=restarts_10m, for_s=0.0,
                  description="gang restarting repeatedly — crash "
                  "looping instead of recovering (a storm is never "
                  "noise: no for_s debounce)"),
        AlertRule("training_input_bound",
                  metric="training_input_stall_fraction", op=">",
                  threshold=input_fraction, for_s=for_s,
                  samples_metric="gang_scrapes_total",
                  min_samples=min_scrapes,
                  description="the input pipeline, not the accelerator, "
                  "is pacing training (goodput ledger input_stall "
                  "share of accounted wall-clock)"),
    ]
