"""Goodput ledger: where did this elastic run's wall-clock go
(counterpart of ``paddle_tpu/observe/goodput.py``, the same buckets,
file format and series).

The Ascend field study (PAPERS.md) diagnoses accelerator deployments
through utilization/latency ATTRIBUTION, and the reference's Go master
kept per-task accounting — raw counters don't answer "what fraction of
this run trained". This module decomposes a supervised training run's
wall-clock, across coordination epochs, into buckets:

- ``useful_step``      — step execution at the run's steady median
  (dispatch + host sync, compile excess removed);
- ``input_stall``      — the feed wait (pipeline get / convert+H2D);
- ``recompile``        — step wall beyond the steady median on steps
  the compile tracker attributes to a jit cache miss;
- ``checkpoint_save``  — the synchronous part of async checkpoint
  saves (device->host snapshot + enqueue);
- ``restore``          — checkpoint load + reshard on (re)entry;
- ``startup``          — gang launch to the worker's accountant birth
  (process spawn, imports, backend init), supervisor-attributed;
- ``restart_gap``      — failure detection to the NEXT gang's launch
  (teardown, post-mortem, backoff), supervisor-attributed;
- ``other``            — in-worker wall the loop didn't classify
  (event handlers, logging, pass turnaround) so worker buckets sum to
  the worker's elapsed wall exactly.

Two halves:

:class:`StepAccountant` is the worker side — O(1) float adds in the
training loop, published to the supervisor inside the heartbeat
telemetry (``runtime/supervisor.py``). Its buckets are CUMULATIVE for
the incarnation, so the supervisor folds them idempotently (last write
per epoch wins).

:class:`GoodputLedger` is the supervisor side — per-epoch buckets
persisted to a CHECKSUMMED JSON file in ``state_dir`` next to the
flight posts, so the accounting survives both worker and supervisor
restarts (a torn or tampered file is detected and the ledger starts
fresh rather than reporting garbage). Exported as
``training_goodput_fraction`` + ``training_overhead_seconds_total
{bucket}`` and stamped into every restart post-mortem.

Stdlib-only (the supervisor and CLI import observe without torch
work).
"""

import hashlib
import json
import os
import threading
import time
from typing import Dict, Optional

from paddle_tpu_torch.observe import metrics as _metrics

#: every bucket the ledger accounts; useful_step is the goodput
BUCKETS = ("useful_step", "input_stall", "recompile", "checkpoint_save",
           "restore", "startup", "restart_gap", "other")

#: the subset a worker accounts in-process (supervisor owns the rest)
WORKER_BUCKETS = ("useful_step", "input_stall", "recompile",
                  "checkpoint_save", "restore")


class StepAccountant:
    """In-trainer wall-clock bucketing for one worker incarnation.

    ``snapshot()`` closes the books up to now: ``other`` is elapsed
    wall minus every classified bucket (clamped at zero), so the
    worker's buckets always sum to its elapsed wall — the property the
    ledger's >=95%-accounted contract rides on.
    """

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self._t0 = clock()
        self.t_start_wall = time.time()
        self._lock = threading.Lock()
        self._b = {b: 0.0 for b in WORKER_BUCKETS}

    def add(self, bucket: str, seconds: float):
        if bucket not in self._b:
            raise ValueError(f"unknown worker bucket {bucket!r} "
                             f"(one of {WORKER_BUCKETS})")
        with self._lock:
            self._b[bucket] += max(0.0, float(seconds))

    def step(self, dt: float, *, feed_s: float = 0.0,
             compile_miss: bool = False,
             median_s: Optional[float] = None):
        """Account one trained batch: ``dt`` is the step wall
        (dispatch + sync), ``feed_s`` the feed wait. On a jit cache
        miss the steady median (when known) stays useful and the
        excess is recompile — the first-ever step has no median yet,
        so its whole wall is compile, which is what it is."""
        with self._lock:
            self._b["input_stall"] += max(0.0, float(feed_s))
            dt = max(0.0, float(dt))
            if compile_miss:
                useful = min(dt, median_s) if median_s else 0.0
                self._b["useful_step"] += useful
                self._b["recompile"] += dt - useful
            else:
                self._b["useful_step"] += dt

    def elapsed(self) -> float:
        return max(0.0, self._clock() - self._t0)

    def snapshot(self) -> dict:
        """Cumulative buckets including the derived ``other``."""
        el = self.elapsed()
        with self._lock:
            b = dict(self._b)
        b["other"] = max(0.0, el - sum(b.values()))
        return {"buckets": {k: round(v, 6) for k, v in b.items()},
                "elapsed_s": round(el, 6),
                "t_start_wall": self.t_start_wall}


def _checksum(doc: dict) -> str:
    body = json.dumps(doc, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(body.encode()).hexdigest()


class GoodputLedger:
    """Run-lifetime per-epoch bucket accounting, crash-persistent.

    File format (atomic-replace, like every state file here)::

        {"v": 1, "epochs": {"1": {bucket: seconds}},
         "meta": {...}, "checksum": sha256-of-the-rest}

    A load failure (missing/torn/bad checksum) starts a fresh ledger
    and remembers why in ``load_error`` — accounting is observability,
    never a reason to refuse a restart.
    """

    def __init__(self, path: Optional[str] = None, clock=time.time):
        self.path = path
        self._clock = clock
        self._lock = threading.Lock()
        self.epochs: Dict[int, Dict[str, float]] = {}
        self.meta: dict = {"run_started": clock()}
        self.load_error: Optional[str] = None
        # last exported totals per bucket: the delta base that keeps
        # the overhead counter monotone across export rounds
        self._exported: Dict[str, float] = {}
        if path and os.path.exists(path):
            self._load(path)

    def _load(self, path: str):
        try:
            with open(path) as f:
                doc = json.load(f)
            want = doc.pop("checksum", None)
            if want != _checksum(doc):
                raise ValueError("checksum mismatch")
            self.epochs = {int(e): {str(k): float(v)
                                    for k, v in b.items()}
                           for e, b in doc.get("epochs", {}).items()}
            self.meta = dict(doc.get("meta") or {})
            self.meta.setdefault("run_started", self._clock())
        except (OSError, ValueError, KeyError, TypeError) as e:
            self.load_error = f"{type(e).__name__}: {e}"
            self.epochs, self.meta = {}, {"run_started": self._clock()}

    # -- writes ------------------------------------------------------------
    def set_bucket(self, epoch: int, bucket: str, seconds: float):
        """Absolute (idempotent) write — the fold for cumulative
        worker buckets and for supervisor-owned one-shot spans."""
        if bucket not in BUCKETS:
            raise ValueError(f"unknown bucket {bucket!r}")
        with self._lock:
            self.epochs.setdefault(int(epoch), {})[bucket] = \
                max(0.0, float(seconds))

    def add(self, epoch: int, bucket: str, seconds: float):
        if bucket not in BUCKETS:
            raise ValueError(f"unknown bucket {bucket!r}")
        with self._lock:
            b = self.epochs.setdefault(int(epoch), {})
            b[bucket] = b.get(bucket, 0.0) + max(0.0, float(seconds))

    def fold_worker(self, epoch: int, buckets: Dict[str, float]):
        """Fold one worker's cumulative bucket snapshot into the
        epoch (absolute overwrite: the snapshot is cumulative for the
        incarnation, so the latest one supersedes every earlier one).
        Unknown keys are dropped — telemetry is a loose contract."""
        for k, v in (buckets or {}).items():
            if k in BUCKETS:
                try:
                    self.set_bucket(epoch, k, float(v))
                except (TypeError, ValueError):
                    continue

    # -- reads -------------------------------------------------------------
    def totals(self) -> Dict[str, float]:
        with self._lock:
            out = {b: 0.0 for b in BUCKETS}
            for buckets in self.epochs.values():
                for k, v in buckets.items():
                    out[k] = out.get(k, 0.0) + v
        return out

    def wall_accounted(self) -> float:
        return sum(self.totals().values())

    def goodput_fraction(self) -> float:
        """useful_step over everything accounted (0.0 on an empty
        ledger — no accounting is not perfect goodput)."""
        t = self.totals()
        wall = sum(t.values())
        return t["useful_step"] / wall if wall > 0 else 0.0

    def summary(self) -> dict:
        t = self.totals()
        return {"goodput_fraction": round(self.goodput_fraction(), 6),
                "wall_accounted_s": round(sum(t.values()), 3),
                "totals": {k: round(v, 3) for k, v in t.items()},
                "epochs": {str(e): {k: round(v, 3)
                                    for k, v in b.items()}
                           for e, b in sorted(self.epochs.items())},
                "load_error": self.load_error}

    # -- persistence -------------------------------------------------------
    def save(self, path: Optional[str] = None) -> Optional[str]:
        """Atomic checksummed write; never raises into the supervision
        loop (a full disk must not kill the run it measures)."""
        path = path or self.path
        if not path:
            return None
        with self._lock:
            doc = {"v": 1,
                   "epochs": {str(e): {k: round(v, 6)
                                       for k, v in b.items()}
                              for e, b in self.epochs.items()},
                   "meta": dict(self.meta)}
        doc["checksum"] = _checksum(doc)
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, path)
        except OSError:
            return None
        return path

    # -- registry export ---------------------------------------------------
    def export(self, registry: Optional[_metrics.Registry] = None):
        """Refresh the ledger's registry series: the goodput-fraction
        gauge, the per-bucket overhead counter (delta-inc'd so scrape
        deltas stay meaningful), and the input-stall fraction the
        input-bound alert rule keys off."""
        reg = (registry if registry is not None
               else _metrics.default_registry())
        g = reg.gauge("training_goodput_fraction",
                      "useful-step seconds over all accounted "
                      "wall-clock, run lifetime (goodput ledger)")
        c = reg.counter("training_overhead_seconds_total",
                        "non-useful wall-clock by bucket (label "
                        "bucket; goodput ledger)")
        stall = reg.gauge("training_input_stall_fraction",
                          "input_stall seconds over all accounted "
                          "wall-clock — the input-bound alert's input")
        acc = reg.gauge("training_wall_seconds_accounted",
                        "total wall-clock the goodput ledger has "
                        "attributed to a bucket")
        t = self.totals()
        wall = sum(t.values())
        g.set(round(t["useful_step"] / wall, 6) if wall > 0 else 0.0)
        stall.set(round(t["input_stall"] / wall, 6) if wall > 0
                  else 0.0)
        acc.set(round(wall, 3))
        for b in BUCKETS:
            if b == "useful_step":
                continue
            delta = t[b] - self._exported.get(b, 0.0)
            if delta > 0:
                c.inc(delta, bucket=b)
                self._exported[b] = t[b]
