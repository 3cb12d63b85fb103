"""Per-request records: bounded ring + tail-latency attribution — the
port's own copy of ``paddle_tpu/observe/requests.py`` (stdlib only).

Each finished (or rejected) serving-engine request leaves one flat
record — timestamps, token counts, prefix-cache hit fraction, and its
latency split into the four places a request can spend time:

- ``queue_wait_s``     submitted -> admitted to a slot
- ``prefill_own_s``    time of the request's OWN prefill chunk(s)
- ``prefill_stall_s``  admitted -> first token, minus own prefill:
                       time parked behind OTHER requests' chunks and
                       interleaved decode steps
- ``decode_s``         first token -> finish

``attribute()`` turns a record into component fractions and names the
dominant component — the "top-k slowest, attributed" view `/requests`
serves.

The ring is bounded (default 512 records, ``PADDLE_TPU_REQUEST_LOG``
overrides; 0 disables). Engines write both their own log and the
process default.
"""

import os
import threading
from collections import deque
from typing import Dict, List

# the latency components of one request, in lifecycle order
COMPONENTS = ("queue_wait_s", "prefill_own_s", "prefill_stall_s",
              "decode_s")


def _env_capacity(default: int = 512) -> int:
    try:
        return int(os.environ.get("PADDLE_TPU_REQUEST_LOG", default))
    except ValueError:
        return default


DEFAULT_CAPACITY = _env_capacity()


def attribute(rec: Dict) -> Dict:
    """Attribution of one request record: per-component seconds and
    fractions (of the components' sum — the submit->finish span minus
    unaccounted scheduler slack) plus TWO dominance answers:

    - ``dominant``       over all four components — where the request's
                         LIFETIME went;
    - ``ttft_dominant``  over the three pre-first-token components
                         (queue wait, own prefill, prefill stall) —
                         where its TTFT went. Decode time is not part
                         of TTFT, so a long generation must not mask a
                         scheduling artifact.

    Both are ``none`` for a record with no measured time (a rejection).
    """
    comps = {c: max(float(rec.get(c) or 0.0), 0.0) for c in COMPONENTS}
    total = sum(comps.values())
    if total <= 0:
        return {"components": comps,
                "fractions": {c: 0.0 for c in comps},
                "dominant": "none", "ttft_dominant": "none"}
    dominant = max(COMPONENTS, key=lambda c: comps[c])
    ttft_comps = COMPONENTS[:3]              # queue, own, stall
    ttft_total = sum(comps[c] for c in ttft_comps)
    ttft_dominant = (max(ttft_comps, key=lambda c: comps[c])[:-2]
                     if ttft_total > 0 else "none")
    return {"components": comps,
            "fractions": {c: comps[c] / total for c in comps},
            "dominant": dominant[:-2],       # strip the trailing "_s"
            "ttft_dominant": ttft_dominant}


class RequestLog:
    """Thread-safe bounded ring of request records (oldest evicted)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._lock = threading.Lock()
        self._capacity = max(0, int(capacity))
        self._dq: deque = deque(maxlen=self._capacity or 1)
        self._evicted = 0

    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def enabled(self) -> bool:
        return self._capacity > 0

    def add(self, rec: Dict):
        if not self._capacity:
            return
        with self._lock:
            if len(self._dq) == self._capacity:
                self._evicted += 1
            self._dq.append(dict(rec))

    def records(self) -> List[Dict]:
        with self._lock:
            return [dict(r) for r in self._dq]

    def evicted(self) -> int:
        with self._lock:
            return self._evicted

    def __len__(self):
        with self._lock:
            return len(self._dq)

    def clear(self):
        with self._lock:
            self._dq.clear()
            self._evicted = 0

    def slowest(self, k: int = 10, by: str = "ttft_s") -> List[Dict]:
        """Top-``k`` completed requests by ``by`` (descending), each
        with its ``attribution`` attached — the tail-latency evidence.
        Records without the key (rejections when sorting by latency)
        sort last."""
        recs = [r for r in self.records() if r.get(by) is not None]
        recs.sort(key=lambda r: float(r[by]), reverse=True)
        out = []
        for r in recs[:max(0, int(k))]:
            r = dict(r)
            r["attribution"] = attribute(r)
            out.append(r)
        return out

    def summary(self) -> Dict:
        """Aggregate view for `/requests`: counts by finish reason and
        by dominant component."""
        reasons: Dict[str, int] = {}
        dominant: Dict[str, int] = {}
        for r in self.records():
            reasons[str(r.get("finish_reason"))] = (
                reasons.get(str(r.get("finish_reason")), 0) + 1)
            d = attribute(r)["dominant"]
            dominant[d] = dominant.get(d, 0) + 1
        return {"count": len(self), "evicted": self.evicted(),
                "capacity": self.capacity, "by_reason": reasons,
                "by_dominant_component": dominant}


_default = RequestLog()


def default_request_log() -> RequestLog:
    return _default
