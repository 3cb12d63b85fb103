"""Straggler attribution: joining per-rank step and barrier windows
(counterpart of ``paddle_tpu/observe/straggler.py``; the arithmetic is
the JAX package's, line for line, so reports on the same windows are
equal).

The reference built ``BarrierStat`` (paddle/utils/Stat.h) for exactly
this judgment, and ``distributed.barrier`` already records the per-rank
wait histogram it implies. The rule, stated there and implemented
here: in a synchronous gang every rank waits at the barrier for the
SLOWEST rank — so the rank whose barrier wait is consistently
near-zero while its peers wait IS the straggler (it arrives last; it
never waits). A big MEAN barrier wait across the gang is load
imbalance; a big SPREAD with one near-zero rank is one sick host.

:class:`StragglerDetector` consumes the per-rank raw windows the gang
supervisor scrapes out of worker heartbeats (``runtime/supervisor.py``
telemetry contract) and publishes two series the training alert rules
(``observe/alerts.py`` ``default_training_rules``) key off:

- ``gang_step_skew_seconds{q}`` — max-over-ranks minus min-over-ranks
  of the per-rank step-time quantile, per q. Computed per rank FIRST
  and spread SECOND: the skew of pooled quantiles would be zero by
  construction.
- ``gang_straggler_rank`` — the attributed rank, -1 while the gang is
  balanced. Attribution prefers the barrier rule; when no barrier
  data exists (a gang that never calls ``distributed.barrier``) it falls
  back to step-time dominance: the rank whose median step is
  ``margin``x the fastest rank's median.

Stdlib-only.
"""

import time
from typing import Dict, List, Optional, Sequence

from paddle_tpu_torch.observe import metrics as _metrics

_QS = (("p50", 0.5), ("p95", 0.95), ("p99", 0.99))


def _quantile(vals: List[float], q: float) -> float:
    """The repo-wide nearest-rank convention (observe/window.py)."""
    if not vals:
        return 0.0
    s = sorted(vals)
    i = min(len(s) - 1, int(q * (len(s) - 1) + 0.5))
    return s[i]


def judge_gang(per_rank: Dict[str, Dict[str, Sequence[float]]], *,
               min_samples: int = 4, wait_floor_s: float = 0.02,
               margin: float = 2.0) -> dict:
    """One skew report from per-rank raw windows.

    ``per_rank`` maps rank -> {"step": [wall_s...], "barrier":
    [wait_s...]} (raw values, newest window). Returns::

        {"straggler_rank": int | None, "rule": "barrier" |
         "step_time" | None, "skew": {"p50": s, "p95": s, "p99": s},
         "per_rank": {rank: {"step_p50_s", "barrier_p50_s", "n_step",
                             "n_barrier"}}}

    Barrier rule: among ranks with >= ``min_samples`` barrier waits,
    the candidate is the rank with the smallest median wait; it is THE
    straggler when its median is under ``wait_floor_s`` while every
    peer's median is both over the floor and ``margin``x the
    candidate's (one rank always arriving last while the rest wait).
    Step fallback (no barrier data): the slowest rank's median step
    must be ``margin``x the fastest rank's — a gang that is merely
    noisy names nobody.
    """
    stats = {}
    for rank, wins in per_rank.items():
        step = [float(v) for v in (wins.get("step") or ())]
        barrier = [float(v) for v in (wins.get("barrier") or ())]
        stats[str(rank)] = {
            "step_p50_s": round(_quantile(step, 0.5), 6),
            "barrier_p50_s": round(_quantile(barrier, 0.5), 6),
            "n_step": len(step), "n_barrier": len(barrier),
            "_step": step, "_barrier": barrier}

    skew = {}
    ranked = [s for s in stats.values() if s["n_step"] >= min_samples]
    for lbl, q in _QS:
        if len(ranked) >= 2:
            qs = [_quantile(s["_step"], q) for s in ranked]
            skew[lbl] = round(max(qs) - min(qs), 6)
        else:
            skew[lbl] = 0.0

    straggler, rule = None, None
    with_barrier = {r: s for r, s in stats.items()
                    if s["n_barrier"] >= min_samples}
    if len(with_barrier) >= 2:
        cand = min(with_barrier, key=lambda r:
                   with_barrier[r]["barrier_p50_s"])
        cand_med = with_barrier[cand]["barrier_p50_s"]
        peers = [s["barrier_p50_s"] for r, s in with_barrier.items()
                 if r != cand]
        if (cand_med <= wait_floor_s
                and min(peers) >= wait_floor_s
                and min(peers) >= margin * max(cand_med, 1e-6)):
            straggler, rule = cand, "barrier"
    if straggler is None:
        with_step = {r: s for r, s in stats.items()
                     if s["n_step"] >= min_samples}
        if len(with_step) >= 2:
            cand = max(with_step, key=lambda r:
                       with_step[r]["step_p50_s"])
            meds = [s["step_p50_s"] for s in with_step.values()]
            if (min(meds) > 0
                    and with_step[cand]["step_p50_s"]
                    >= margin * min(meds)):
                straggler, rule = cand, "step_time"
    for s in stats.values():
        s.pop("_step"), s.pop("_barrier")
    return {"straggler_rank": (int(straggler)
                               if straggler is not None else None),
            "rule": rule, "skew": skew, "per_rank": stats}


class StragglerDetector:
    """Stateful wrapper publishing :func:`judge_gang` into a registry
    on the supervisor's scrape cadence. Keeps only the latest report —
    windows are the workers' state; the detector just joins them."""

    def __init__(self, registry: Optional[_metrics.Registry] = None, *,
                 min_samples: int = 4, wait_floor_s: float = 0.02,
                 margin: float = 2.0, clock=time.monotonic):
        reg = (registry if registry is not None
               else _metrics.default_registry())
        self.registry = reg
        self.min_samples = int(min_samples)
        self.wait_floor_s = float(wait_floor_s)
        self.margin = float(margin)
        self._clock = clock
        self.report: dict = {"straggler_rank": None, "rule": None,
                             "skew": {}, "per_rank": {}}
        self._m_skew = reg.gauge(
            "gang_step_skew_seconds",
            "per-rank step-time quantile spread: max over ranks minus "
            "min over ranks at quantile q (label q) — the step-skew "
            "alert's input")
        self._m_straggler = reg.gauge(
            "gang_straggler_rank",
            "rank attributed as the gang straggler by the BarrierStat "
            "rule (near-zero barrier wait while peers wait) or the "
            "step-time-dominance fallback; -1 while balanced")

    def update(self, per_rank: Dict[str, Dict[str, Sequence[float]]]
               ) -> dict:
        """Join one scrape's per-rank windows, refresh the gauges,
        return (and retain) the report."""
        rep = judge_gang(per_rank, min_samples=self.min_samples,
                         wait_floor_s=self.wait_floor_s,
                         margin=self.margin)
        for lbl, _ in _QS:
            self._m_skew.set(rep["skew"].get(lbl, 0.0), q=lbl)
        self._m_straggler.set(
            rep["straggler_rank"] if rep["straggler_rank"] is not None
            else -1)
        self.report = rep
        return rep
