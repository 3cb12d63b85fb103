"""Serving-fleet router: prefix-aware placement over N engine replicas —
the port's own copy of ``paddle_tpu/serving/router.py`` (host code: the
replicas' engines run the kernels).

One engine serves one host's worth of traffic; the fleet tier is this
router fronting N replicas over the JSONL serve wire (in-process
:class:`~paddle_tpu_torch.serving.replica.EngineReplica` handles, or
:class:`~paddle_tpu_torch.serving.replica.SocketReplica` handles to
:class:`~paddle_tpu_torch.serving.replica.ReplicaServer` endpoints).
Three responsibilities:

**Placement.** Admission is prefix-cache-aware: the prompt's
content-chain block hashes (``serving/blocks.prompt_block_hashes`` —
the same digests the replicas' prefix caches key on) are the routing
key. The router remembers which digests it placed on which replica (a
bounded per-replica hot set); a new request scores each replica by its
hot leading-digest run and lands where its prefix is hot, so
shared-prefix tenants converge onto warm pools and the fleet
cold-prefills a shared system prompt once, not N times. Fallback is
least-loaded among healthy replicas, under a per-replica in-flight cap.

**Health-driven drain.** Each replica's three-state ``/healthz``
(ok | degraded | unhealthy, plus SLO burn gauges behind it) drives
admission: ``degraded`` replicas are DEPRIORITIZED (placed only when
no ok replica has room), ``unhealthy`` replicas stop admitting while
their in-flight work finishes (drain), and a DEAD replica (transport
gone) has its in-flight requests re-queued onto survivors — every
accepted request completes; a re-queued request simply re-runs its
full prompt (deterministic decoding makes the output identical).

**P/D disaggregation.** With a prefill tier configured, a request
whose transferable prefix is not hot on any decode replica first runs
chunked prefill on a PREFILL replica (``export_prefix``); the finished
KV blocks come back serialized (the PTKV wire, ``serving/transfer``)
and are shipped to the chosen decode replica (``import_prefix``, the
prefix-cache publish path) ahead of the generate op on the same
ordered connection. The decode replica admits the request as a
prefix-cache hit and recomputes only the final chunk — generation is
bitwise the colocated run. If the prefill tier is busy or dies, the
router falls back to a plain colocated placement: disaggregation is a
throughput optimization, never a correctness dependency.

The router is steppable like the engines (``submit`` / ``step`` /
``run_until_idle`` / ``idle``) and single-threaded: one ``step()``
pumps in-process replicas, collects results, polls health, and places
queued work. Observability mirrors the engine surface: a router
registry (placement/requeue/drain counters, per-replica state and
in-flight gauges, fleet TTFT windows + SLO burn, the fleet aggregator's
series and the alert rules' gauges), a request log, and ``serve()``
exposing ``/metrics`` + ``/healthz`` + ``/requests`` + ``/alerts``.
"""


import dataclasses
import itertools
import logging
import os
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from paddle_tpu_torch.observe import alerts as _alerts
from paddle_tpu_torch.observe import chrome_trace as _chrome
from paddle_tpu_torch.observe import fleet as _fleet
from paddle_tpu_torch.observe import metrics as _metrics
from paddle_tpu_torch.observe import requests as _requests
from paddle_tpu_torch.observe.window import SloConfig, WindowedQuantiles
from paddle_tpu_torch.serving import blocks as _blocks

logger = logging.getLogger(__name__)

# routers minted per process: the trace-id prefix bakes in pid +
# instance so every fleet request id is unique across the whole
# multi-process trace merge (two routers can NEVER collide)
_ROUTER_IDS = itertools.count()

_LATENCY_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                    0.1, 0.25, 0.5, 1.0, 2.5, 5.0)

# load-shed reasons the door can refuse with (each a counted
# rejection, never a timeout):
#   queue_full    — the router backlog crossed shed_queue_max (the
#                   latency tier gets 2x headroom before it sheds)
#   burn_rate     — the fleet TTFT SLO burn rate crossed shed_burn_max;
#                   batch-tier arrivals shed first, latency keeps
#                   flowing (the SLO the burn measures IS latency-tier
#                   experience)
#   tenant_budget — the request's own reserved-token charge exceeds
#                   the tenant's FLEET budget: it could never place
SHED_REASONS = ("queue_full", "burn_rate", "tenant_budget")


class AdmissionError(RuntimeError):
    """The router refused a request at the door (load shed). Carries
    the machine-readable ``reason`` (one of :data:`SHED_REASONS`) so
    callers can distinguish back-off-and-retry (``queue_full``,
    ``burn_rate``) from never-admissible (``tenant_budget``)."""

    def __init__(self, reason: str, msg: str):
        super().__init__(msg)
        self.reason = reason


def fleet_keying(handles, default_block_size: int = 16,
                 default_chunk_tokens: int = 64) -> Tuple[int, int]:
    """Placement keying (block size / chunk grid) read off the first
    replica ``/healthz`` that reports it — the one way the router's
    digest notion is derived from the engines' own prefix caches
    (every fleet front end keys through here, so they can never drift
    apart)."""
    bs, chunk = int(default_block_size), int(default_chunk_tokens)
    for h in handles:
        doc = h.health()
        if doc and doc.get("block_size"):
            return int(doc["block_size"]), int(
                doc.get("chunk_tokens", chunk))
    logger.warning(
        "fleet_keying: no replica /healthz reported block_size — "
        "falling back to block_size=%d chunk_tokens=%d; if the engines "
        "use a different grid, placement digests will never match and "
        "the prefix-aware path is dead (pass health ports, or "
        "block_size=/chunk_tokens= explicitly)", bs, chunk)
    return bs, chunk

# replica states, best-first; the gauge encodes the rank so dashboards
# can alert on `router_replica_state < 3`
REPLICA_STATES = ("ok", "degraded", "unhealthy", "dead")
_STATE_RANK = {"ok": 3, "degraded": 2, "unhealthy": 1, "dead": 0}

# cache tiers, fastest first — directory entries prefer the fastest
# replica holding a digest; a fetch is priced off the SLOWEST tier in
# the source's leading run
_TIER_RANK = {"hbm": 0, "dram": 1, "disk": 2}


@dataclasses.dataclass
class RouterRequest:
    """One fleet request and its routing lifecycle."""
    xid: int
    prompt: np.ndarray
    max_new: int
    temperature: float = 0.0
    top_k: int = 0
    eos_id: Optional[int] = None
    tenant: str = "default"
    tier: str = "batch"
    # -- routing lifecycle (filled by the router) ------------------------
    status: str = "queued"      # queued | prefill | placed | done | failed
    replica: Optional[str] = None           # decode placement
    prefill_replica: Optional[str] = None   # P/D export source
    digests: List[bytes] = dataclasses.field(
        default_factory=list, repr=False)   # full-block chain hashes
    usable: int = 0             # leading digests admission can hit
    #                             (chunk-aligned — the placement key)
    payload: Optional[str] = None           # b64 KV payload awaiting a
    payload_blocks: int = 0                 # decode slot (P/D flow)
    prefix_score: int = 0       # hot digests at the chosen replica
    tokens: List[int] = dataclasses.field(default_factory=list)
    finish_reason: Optional[str] = None
    error: Optional[str] = None
    requeues: int = 0           # dead-replica recoveries
    placements: int = 0
    trace_id: str = ""          # fleet-unique; replicas adopt it
    submit_t: float = 0.0
    placed_t: Optional[float] = None
    finish_t: Optional[float] = None
    replica_ttft_ms: Optional[float] = None
    replica_latency_ms: Optional[float] = None

    @property
    def output(self) -> np.ndarray:
        return np.concatenate([self.prompt,
                               np.asarray(self.tokens, np.int32)])

    @property
    def latency_s(self) -> Optional[float]:
        if self.finish_t is None:
            return None
        return self.finish_t - self.submit_t

    @property
    def ttft_s(self) -> Optional[float]:
        """Fleet TTFT: router queueing + the replica-reported TTFT."""
        if self.replica_ttft_ms is None or self.placed_t is None:
            return None
        return (self.placed_t - self.submit_t
                + self.replica_ttft_ms / 1000.0)


@dataclasses.dataclass
class _RewarmTicket:
    """Outstanding-table entry for a rewarm export/import relay — NOT
    a request (never requeued, never finished; its loss is a cache
    miss for the replacement replica, nothing more)."""
    rid: str
    target: str                 # replica name the payload ships to
    digests: List[bytes]


class _Replica:
    """Router-side state for one replica handle."""

    def __init__(self, handle, cap: int, hot_cap: int):
        self.handle = handle
        self.name = handle.name
        self.state = "ok"
        self.last_health: dict = {}
        self.health_t = -1e9
        # xid -> (req, kind); kind: generate | export | import | rewarm
        self.outstanding: "OrderedDict" = OrderedDict()
        self.cap = int(cap)
        self.hot: "OrderedDict" = OrderedDict()
        self.hot_cap = int(hot_cap)
        # administrative drain hold (scale-down): while set, the health
        # poll must NOT re-promote this replica to ok — it stays
        # unhealthy (no new admissions) until removed or released
        self.draining = False
        # the replica's tier eviction epoch as last seen (health doc or
        # any op result): a bump between health scrapes means the warm
        # advertisement is stale NOW — see _note_epoch
        self.tier_epoch = -1
        # most recent placement prompts with a usable prefix, keyed by
        # their leading digest chain — the rewarm seed list a
        # replacement replica's prefixes are re-imported from
        self.recent: "OrderedDict" = OrderedDict()
        # digest -> tier ("hbm" | "dram" | "disk"): the replica's OWN
        # advertisement of what it holds warm at any cache tier, rebuilt
        # from each /healthz scrape's `tiers.digests` listing. `hot` is
        # the router's placement-side guess; `warm` is ground truth on
        # the scrape cadence — prefix scoring unions both.
        self.warm: Dict[bytes, str] = {}

    @property
    def in_flight(self) -> int:
        """Work that occupies the replica (import acks don't)."""
        return sum(1 for _, kind in self.outstanding.values()
                   if kind != "import")

    def note_recent(self, digests: tuple, prompt, cap: int = 16):
        if digests in self.recent:
            self.recent.move_to_end(digests)
        self.recent[digests] = prompt
        while len(self.recent) > cap:
            self.recent.popitem(last=False)

    def mark_hot(self, digests):
        for d in digests:
            if d in self.hot:
                self.hot.move_to_end(d)
            else:
                self.hot[d] = None
        while len(self.hot) > self.hot_cap:
            self.hot.popitem(last=False)

    def warm_tier(self, digest) -> Optional[str]:
        """The fastest tier this replica holds ``digest`` at, or None.
        A placement-marked hot digest counts as HBM (the engine will
        promote from its own DRAM/disk on admission anyway, so any
        local tier serves hits without router help)."""
        if digest in self.hot:
            return "hbm"
        return self.warm.get(digest)

    def prefix_run(self, digests) -> Tuple[int, Optional[str]]:
        """(length, deepest tier) of the LEADING digest run warm at
        ANY local tier — the same stop-at-first-miss walk engine
        admission does. The deepest tier prices a remote fetch."""
        n, deepest = 0, None
        for d in digests:
            t = self.warm_tier(d)
            if t is None:
                break
            n += 1
            if deepest is None or _TIER_RANK[t] > _TIER_RANK[deepest]:
                deepest = t
        return n, deepest

    def prefix_score(self, digests) -> int:
        return self.prefix_run(digests)[0]


class Router:
    """Prefix-aware fleet router over replica handles (see module
    docstring). ``replicas`` are handles implementing the protocol in
    ``serving/replica.py``; ``prefill`` names the subset serving as
    the disaggregated prefill tier (those receive only
    ``export_prefix`` work — P/D mode is off when empty).
    ``block_size``/``chunk_tokens`` must match the replicas' engines:
    they derive the placement digests and the transferable-prefix cap
    exactly as engine admission does."""

    def __init__(self, replicas: Sequence, *, block_size: int = 16,
                 chunk_tokens: int = 64, prefill: Sequence[str] = (),
                 max_in_flight: int = 8, health_poll_s: float = 0.25,
                 hot_digests: int = 4096,
                 registry: Optional[_metrics.Registry] = None,
                 slo: Optional[SloConfig] = None,
                 trace: bool = True, aggregate: bool = True,
                 fleet_jsonl: Optional[str] = None,
                 alert_rules: Optional[Sequence] = None,
                 fetch_flops_per_byte: float = 8.0,
                 shed_queue_max: int = 0,
                 shed_burn_max: float = 0.0,
                 tenant_budgets: Optional[Dict[str, int]] = None):
        if not replicas:
            raise ValueError("router needs at least one replica")
        bs, chunk = int(block_size), int(chunk_tokens)
        if bs < 1 or chunk < 1 or chunk % bs:
            raise ValueError(f"chunk_tokens {chunk} must be a positive "
                             f"multiple of block_size {bs}")
        self.block_size, self.chunk_tokens = bs, chunk
        self._replica_cap = int(max_in_flight)
        self._hot_cap = int(hot_digests)
        self._all: List[_Replica] = [
            _Replica(h, max_in_flight, hot_digests) for h in replicas]
        names = [st.name for st in self._all]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate replica names: {names}")
        prefill = set(prefill)
        unknown = prefill - set(names)
        if unknown:
            raise ValueError(f"prefill names {sorted(unknown)} not in "
                             f"replicas {names}")
        self._prefill = [st for st in self._all if st.name in prefill]
        self._decode = [st for st in self._all
                        if st.name not in prefill]
        if not self._decode:
            raise ValueError("every replica is prefill-tier: nothing "
                             "left to decode")
        self._health_poll_s = float(health_poll_s)
        # -- admission control (the door) ---------------------------------
        # 0 disables each shed axis; see SHED_REASONS for semantics
        self.shed_queue_max = int(shed_queue_max)
        self.shed_burn_max = float(shed_burn_max)
        # fleet-wide tenant budgets: tenant -> reserved-token cap
        # (prompt + max_new summed over the tenant's PLACED work across
        # every replica). Over-budget tenants QUEUE (skipped by
        # placement, no head-of-line blocking) — the one rejection is a
        # single request whose own charge exceeds the budget, mirroring
        # the engine-level contract.
        self._tenant_budgets: Dict[str, int] = dict(tenant_budgets or {})
        self._tenant_used: Dict[str, int] = {}
        self._charged: set = set()
        # rewarm state: dead replica name -> its recent prefix prompts
        self._rewarm_stash: Dict[str, list] = {}
        self._rewarm_ids = itertools.count()
        # a FleetController registers its summary callable here so one
        # router /healthz answers for the control plane too
        self._controller_summary = None
        self._queue: deque = deque()
        self._requests: Dict[int, RouterRequest] = {}
        self._ids = itertools.count()
        self.request_log = _requests.RequestLog()
        self._n_completed = 0
        self.slo = slo
        win = slo.window_s if slo is not None else 60.0
        self._win_ttft = WindowedQuantiles(window_s=win)
        self._win_tps = WindowedQuantiles(window_s=win)
        # -- metrics ------------------------------------------------------
        reg = self.metrics = registry or _metrics.Registry()
        self._m_requests = reg.counter(
            "router_requests_total", "requests submitted to the fleet")
        self._m_completed = reg.counter(
            "router_requests_completed_total",
            "fleet requests finished, by finish reason (error = the "
            "replica rejected the request — malformed, too long)")
        self._m_tokens = reg.counter(
            "router_tokens_total", "tokens emitted across the fleet")
        self._m_placements = reg.counter(
            "router_placements_total", "generate placements onto "
            "replicas (a requeued request places again)")
        self._m_place_hits = reg.counter(
            "router_placement_prefix_hits_total",
            "placements that landed where a leading run of the "
            "prompt's block digests was already hot — the prefix-aware "
            "hit rate's numerator")
        self._m_requeued = reg.counter(
            "router_requeued_total", "in-flight requests re-queued off "
            "a dead replica onto survivors")
        self._m_drains = reg.counter(
            "router_drains_total", "replica drains begun, by reason "
            "(unhealthy = stop admitting, in-flight finishes; dead = "
            "transport lost, in-flight re-queued)")
        self._m_queue = reg.gauge(
            "router_queue_depth", "requests waiting for a placement")
        self._m_in_flight = reg.gauge(
            "router_replica_in_flight", "outstanding work per replica "
            "(router view: generate + export ops awaiting results)")
        self._m_replica_queue = reg.gauge(
            "router_replica_queue_depth", "queue depth each replica "
            "last reported on /healthz")
        self._m_state = reg.gauge(
            "router_replica_state", "replica admission state: 3=ok "
            "2=degraded 1=unhealthy 0=dead")
        self._m_ttft = reg.histogram(
            "router_ttft_seconds", "fleet TTFT: submit -> first token "
            "(router queueing + replica-reported TTFT)",
            buckets=_LATENCY_BUCKETS)
        self._m_win_ttft = reg.gauge(
            "router_ttft_window_seconds", "rolling fleet TTFT quantile "
            "over the SLO window (label q)")
        self._m_win_tps = reg.gauge(
            "router_tokens_per_sec_window", "rolling per-request "
            "decode tokens/sec quantile over the SLO window (label q)")
        self._m_burn = reg.gauge(
            "router_slo_burn_rate", "fleet TTFT SLO burn rate (0 "
            "without a configured SLO)")
        self._m_pd_exports = reg.counter(
            "router_pd_exports_total", "prefill-tier export_prefix "
            "ops completed (P/D disaggregation)")
        self._m_pd_blocks = reg.counter(
            "router_pd_blocks_shipped_total", "KV blocks shipped over "
            "the P/D transfer path and adopted by decode replicas")
        self._m_pd_errors = reg.counter(
            "router_pd_errors_total", "P/D transfer ops a replica "
            "refused, by op (export = colocated fallback; import = "
            "cold prefill on the decode replica — same bits, slower)")
        self._m_hit_rate = reg.gauge(
            "router_placement_hit_rate", "fraction of generate "
            "placements that landed on a replica with a hot "
            "leading-digest run — the prefix-hit-rate alert's input")
        self._m_kv_fetches = reg.counter(
            "router_kv_fetches_total", "remote prefix fetches placed "
            "through the fleet cache directory, labeled by the "
            "DEEPEST tier in the source's leading run (the tier that "
            "priced the fetch)")
        self._m_dir_size = reg.gauge(
            "router_directory_size", "distinct digests the fleet "
            "cache directory currently maps to a live replica+tier")
        self._m_shed = reg.counter(
            "router_shed_total", "requests refused at the door, by "
            "reason (queue_full | burn_rate | tenant_budget) — counted "
            "rejections, never timeouts")
        self._m_tenant_flight = reg.gauge(
            "router_tenant_tokens_in_flight", "reserved tokens "
            "(prompt + max_new) each tenant has placed fleet-wide — "
            "the charge the fleet tenant budget caps")
        self._m_rewarm = reg.counter(
            "router_rewarm_total", "prefix re-imports attempted for a "
            "replacement replica, by result (shipped = KV relayed "
            "from a warm survivor; miss = no warm source / payload "
            "gone — the replacement cold-prefills that prefix)")
        self._m_dir_invalidations = reg.counter(
            "router_directory_invalidations_total", "warm-set "
            "invalidations forced by a tier eviction-epoch bump seen "
            "on an op result between health scrapes (the stale-fetch "
            "prevention path)")
        # fetch-vs-recompute crossover: ship the prefix's KV bytes when
        # recomputing a token costs more than `fetch_flops_per_byte`
        # device FLOPs per wire byte shipped (both sides linear in
        # prefix tokens, so the tokens cancel). 0 fetches whenever a
        # source exists; float("inf") disables fetching entirely.
        self.fetch_flops_per_byte = float(fetch_flops_per_byte)
        for st in self._all:
            self._m_state.set(_STATE_RANK[st.state], replica=st.name)
        # -- fleet observability plane ------------------------------------
        # trace propagation: every accepted request gets a FLEET-unique
        # trace id (pid + router instance + xid) stamped onto the serve
        # wire; replicas adopt it, so their engine lifecycle events join
        # under the router's route/queue/place spans when the per-
        # process exports merge on pid (observe.trace_export)
        self.trace_requests = bool(trace)
        self._trace_prefix = f"fleet{os.getpid()}.{next(_ROUTER_IDS)}"
        self._wall_anchor = time.time() - time.perf_counter()
        # metrics aggregation + alerts: the aggregator writes into THIS
        # registry, so one /metrics scrape answers for the whole fleet;
        # the evaluator runs over the same registry per scrape round
        self.aggregate = bool(aggregate)
        self.fleet = _fleet.FleetAggregator(
            registry=reg, window_s=win, jsonl_path=fleet_jsonl)
        self.alerts = _alerts.AlertEvaluator(
            reg, alert_rules if alert_rules is not None
            else _alerts.default_fleet_rules())
        self._scrape_t = -1e9

    # -- trace propagation -------------------------------------------------
    def _rev(self, req: RouterRequest, name: str, ph: str,
             perf_t: float, **args):
        """One router-side lifecycle event on the request's FLEET
        trace track (same cat/id as the replica engine's events, so
        the merged export renders one connected tree)."""
        if req.trace_id:
            _chrome.record_event(name, self._wall_anchor + perf_t, ph,
                                 req.trace_id, args=args or None)

    # -- request API -------------------------------------------------------
    def submit(self, prompt, max_new: int, *, temperature: float = 0.0,
               top_k: int = 0, eos_id: Optional[int] = None,
               tenant: str = "default", tier: str = "batch"
               ) -> RouterRequest:
        """Queue one fleet request; placement happens in ``step()``.
        The request is stamped with a fleet-unique trace id; its
        ``route`` slice (the router-side root of the whole cross-
        process request tree) opens here and closes at completion.
        Raises :class:`AdmissionError` when the door sheds (see
        :data:`SHED_REASONS`) — shed BEFORE replicas saturate, never a
        timeout after they did."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        tier, tenant = str(tier), str(tenant)
        if self.shed_queue_max:
            # latency-tier traffic gets 2x headroom: the backlog that
            # sheds bulk work early is exactly what keeps the latency
            # tier's TTFT in band
            limit = (2 * self.shed_queue_max if tier == "latency"
                     else self.shed_queue_max)
            if len(self._queue) >= limit:
                self._m_shed.inc(reason="queue_full")
                raise AdmissionError(
                    "queue_full", f"router queue at {len(self._queue)} "
                    f">= {limit} for tier {tier!r}")
        if (self.shed_burn_max and tier != "latency"
                and self._slo_burn_rate() > self.shed_burn_max):
            self._m_shed.inc(reason="burn_rate")
            raise AdmissionError(
                "burn_rate", f"TTFT SLO burn rate "
                f"{self._slo_burn_rate():.2f} > {self.shed_burn_max} "
                f"— batch-tier arrivals shed until it recovers")
        budget = self._tenant_budgets.get(tenant)
        own = int(prompt.size) + int(max_new)
        if budget is not None and own > budget:
            self._m_shed.inc(reason="tenant_budget")
            raise AdmissionError(
                "tenant_budget", f"request reserves {own} tokens > "
                f"tenant {tenant!r} fleet budget {budget} — it could "
                f"never place")
        req = RouterRequest(
            xid=next(self._ids), prompt=prompt, max_new=int(max_new),
            temperature=float(temperature), top_k=int(top_k),
            eos_id=eos_id, tenant=str(tenant), tier=str(tier),
            submit_t=time.perf_counter())
        if self.trace_requests:
            req.trace_id = f"{self._trace_prefix}.r{req.xid}"
        req.digests = _blocks.prompt_block_hashes(prompt,
                                                  self.block_size)
        per = self.chunk_tokens // self.block_size
        req.usable = min(
            len(req.digests),
            ((int(prompt.size) - 1) // self.chunk_tokens) * per)
        self._queue.append(req)
        self._requests[req.xid] = req
        self._m_requests.inc()
        self._m_queue.set(len(self._queue))
        self._rev(req, "route", "b", req.submit_t, xid=req.xid,
                  prompt_tokens=int(prompt.size), max_new=req.max_new,
                  tenant=req.tenant, tier=req.tier)
        self._rev(req, "queue", "b", req.submit_t)
        return req

    # -- fleet-wide tenant accounting -------------------------------------
    def set_tenant_budget(self, tenant: str, tokens: Optional[int]):
        """Set (or with ``None`` clear) a tenant's fleet-wide
        reserved-token budget. Takes effect at the next placement
        round — work already placed is never clawed back."""
        if tokens is None:
            self._tenant_budgets.pop(str(tenant), None)
        else:
            self._tenant_budgets[str(tenant)] = int(tokens)

    @staticmethod
    def _tenant_charge(req: RouterRequest) -> int:
        return int(req.prompt.size) + int(req.max_new)

    def _charge(self, req: RouterRequest):
        if req.xid in self._charged:
            return
        self._charged.add(req.xid)
        used = self._tenant_used.get(req.tenant, 0)
        self._tenant_used[req.tenant] = used + self._tenant_charge(req)
        self._m_tenant_flight.set(self._tenant_used[req.tenant],
                                  tenant=req.tenant)

    def _release(self, req: RouterRequest):
        if req.xid not in self._charged:
            return
        self._charged.discard(req.xid)
        used = self._tenant_used.get(req.tenant, 0)
        self._tenant_used[req.tenant] = max(
            0, used - self._tenant_charge(req))
        self._m_tenant_flight.set(self._tenant_used[req.tenant],
                                  tenant=req.tenant)

    def _tenant_blocked(self, req: RouterRequest) -> bool:
        budget = self._tenant_budgets.get(req.tenant)
        if budget is None:
            return False
        return (self._tenant_used.get(req.tenant, 0)
                + self._tenant_charge(req) > budget)

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def outstanding(self) -> int:
        return sum(len(st.outstanding) for st in self._all)

    @property
    def idle(self) -> bool:
        return not self._queue and not any(
            kind != "import"
            for st in self._all
            for _, kind in st.outstanding.values())

    def replica_states(self) -> Dict[str, str]:
        return {st.name: st.state for st in self._all}

    def placement_hit_rate(self) -> float:
        """Fraction of generate placements that landed on a replica
        with a hot leading-digest run."""
        total = self._m_placements.value()
        if not total:
            return 0.0
        return self._m_place_hits.value() / total

    # -- scheduler ---------------------------------------------------------
    def step(self) -> List[RouterRequest]:
        """One router iteration: pump in-process replicas, collect
        results, poll health (requeueing off dead replicas), place
        queued work. Returns the requests that finished this step."""
        for st in self._all:
            if st.state != "dead":
                st.handle.pump()
        finished = self._collect()
        now = time.perf_counter()
        self._poll_health(now)
        if self.aggregate and now - self._scrape_t >= self._health_poll_s:
            self._scrape_t = now
            self._scrape()
        self._place()
        self._update_gauges()
        return finished

    def run_until_idle(self, max_steps: int = 200_000
                       ) -> List[RouterRequest]:
        done: List[RouterRequest] = []
        for _ in range(max_steps):
            if self.idle:
                return done
            done.extend(self.step())
        raise RuntimeError(
            f"router did not drain in {max_steps} steps "
            f"({self.queue_depth} queued, {self.outstanding} "
            f"outstanding, states {self.replica_states()})")

    # -- results -----------------------------------------------------------
    def _collect(self) -> List[RouterRequest]:
        finished: List[RouterRequest] = []
        for st in self._all:
            for doc in st.handle.poll():
                self._note_epoch(st, doc)
                ent = st.outstanding.pop(doc.get("id"), None)
                if ent is None:
                    # ack for an untracked op, or a late result for a
                    # request already requeued off this replica —
                    # first completion wins
                    continue
                req, kind = ent
                if kind == "rewarm":
                    self._on_rewarm(st, req, doc)
                    continue
                if kind == "import":
                    if "error" in doc:
                        # a refused adoption (stamp mismatch, spec
                        # engine) degrades that request to a cold
                        # prefill — same bits, slower; count + log so
                        # a misconfigured fleet is visible, never
                        # silent
                        self._m_pd_errors.inc(op="import")
                        logger.warning("import_prefix refused by %s: %s",
                                       st.name, doc["error"])
                    else:
                        self._m_pd_blocks.inc(
                            int(doc.get("imported") or 0))
                    continue
                if kind == "export":
                    self._on_export(st, req, doc)
                elif "error" in doc:
                    err = str(doc["error"])
                    if err.startswith("draining"):
                        # the replica sealed for graceful drain after
                        # placement won the race: not a request
                        # failure — place it on a survivor
                        self._requeue(st, req)
                    else:
                        self._finish(req, None, error=err)
                        finished.append(req)
                else:
                    self._finish(req, doc)
                    finished.append(req)
        return finished

    def _note_epoch(self, st, doc: dict):
        """Tier-directory invalidation fence: every replica op result
        carries the spill tiers' eviction epoch. A bump relative to
        what the last health scrape advertised means digests retired
        BETWEEN scrapes — the warm set is stale NOW. Drop it (fetches
        stop routing at ghosts immediately) and force a re-scrape at
        the next poll instead of waiting out the cadence."""
        ep = doc.get("tier_epoch")
        if ep is None:
            return
        ep = int(ep)
        if st.tier_epoch >= 0 and ep > st.tier_epoch:
            if st.warm:
                st.warm = {}
                self._m_dir_invalidations.inc()
            st.health_t = -1e9      # re-scrape on the very next poll
        st.tier_epoch = max(st.tier_epoch, ep)

    def _requeue(self, st, req: RouterRequest):
        """Send ``req`` back to the queue front after ``st`` refused or
        lost it (drain refusal, dead transport)."""
        req.requeues += 1
        req.status = "queued"
        req.replica = None
        req.payload, req.payload_blocks = None, 0
        self._release(req)
        self._m_requeued.inc()
        self._set_state(st, "unhealthy")    # stop placing here; the
        #                                     health poll re-promotes a
        #                                     replica that recovers
        now = time.perf_counter()
        self._rev(req, "requeue", "n", now, reason="drain",
                  replica=st.name, requeues=req.requeues)
        self._rev(req, "queue", "b", now)   # waiting again: the queue
        #                                     slice re-opens on the SAME
        #                                     trace — one connected tree
        self._queue.appendleft(req)

    def _on_export(self, st, req: RouterRequest, doc: dict):
        req.prefill_replica = st.name
        if "error" in doc:
            # a prefill replica that REFUSES the export (non-paged
            # engine, budget rejection, drain) must not fail the
            # request — disaggregation is never a correctness
            # dependency; fall back colocated (prefill_replica is set,
            # so placement won't retry the prefill tier)
            self._m_pd_errors.inc(op="export")
            logger.warning("export_prefix refused by %s (colocated "
                           "fallback): %s", st.name, doc["error"])
            req.status = "queued"
            self._queue.appendleft(req)
            return
        self._m_pd_exports.inc()
        payload = doc.get("payload")
        if payload:
            req.payload = payload
            req.payload_blocks = int(doc.get("blocks", 0))
            st.mark_hot(req.digests[:req.payload_blocks])
        # back to the queue FRONT (it already waited through the
        # prefill stage) awaiting a decode placement; an empty payload
        # (no transferable prefix / evicted) decodes colocated-style
        req.status = "queued"
        self._queue.appendleft(req)

    def _finish(self, req: RouterRequest, doc: Optional[dict],
                error: Optional[str] = None):
        now = time.perf_counter()
        req.finish_t = now
        self._release(req)
        self._n_completed += 1
        if error is not None:
            req.status, req.error = "failed", error
            req.finish_reason = "error"
            self._m_completed.inc(reason="error")
        else:
            req.status = "done"
            req.tokens = [int(t) for t in doc.get("tokens", ())]
            req.finish_reason = doc.get("finish_reason")
            req.replica_ttft_ms = doc.get("ttft_ms")
            req.replica_latency_ms = doc.get("latency_ms")
            self._m_completed.inc(reason=req.finish_reason or "unknown")
            self._m_tokens.inc(len(req.tokens))
            ttft = req.ttft_s
            if ttft is not None:
                self._m_ttft.observe(ttft)
                self._win_ttft.observe(ttft)
            if req.latency_s and req.tokens:
                self._win_tps.observe(len(req.tokens) / req.latency_s)
        self._rev(req, "route", "e", now,
                  reason=req.finish_reason or "error",
                  tokens=len(req.tokens), requeues=req.requeues,
                  replica=req.replica)
        self._record_request(req)

    def _record_request(self, req: RouterRequest):
        def r6(v):
            return round(v, 6) if v is not None else None

        self.request_log.add({
            "rid": req.xid, "engine": "router",
            "trace_id": req.trace_id or f"router.r{req.xid}",
            "finish_reason": req.finish_reason if req.error is None
            else f"rejected:{req.error[:80]}",
            "tenant": req.tenant, "tier": req.tier,
            "replica": req.replica,
            "prefill_replica": req.prefill_replica,
            "requeues": req.requeues,
            "prefix_score": req.prefix_score,
            "prompt_tokens": int(req.prompt.size),
            "tokens": len(req.tokens),
            "queue_wait_s": r6((req.placed_t or req.finish_t)
                               - req.submit_t),
            "prefill_own_s": None, "prefill_stall_s": None,
            "decode_s": None,
            "ttft_s": r6(req.ttft_s),
            "latency_s": r6(req.latency_s),
            "cache_hit_frac": round(
                req.prefix_score / max(len(req.digests), 1), 4)})

    # -- health / drain ----------------------------------------------------
    def _poll_health(self, now: float):
        for st in self._all:
            if st.state == "dead":
                continue
            if not st.handle.alive():
                self._mark_dead(st)
                continue
            if now - st.health_t < self._health_poll_s:
                # throttle applies even while the endpoint is
                # unreachable — health() can block (HTTP timeout) and
                # this loop runs on the single scheduler thread
                continue
            st.health_t = now
            try:
                doc = st.handle.health()
            except Exception:
                doc = None
            if doc is None:
                continue    # endpoint unreachable: state unknown,
            #                 liveness stays the transport's verdict
            st.last_health = doc
            # fleet cache directory feed: the replica's /healthz tiers
            # section lists its warm digests per tier (hbm listing
            # capped at the engine); rebuild — not merge — so entries
            # the replica evicted are pruned on this same cadence
            tiers_doc = (doc.get("tiers") or {})
            tiers = tiers_doc.get("digests") or {}
            ep = tiers_doc.get("eviction_epoch")
            if tiers and not (ep is not None
                              and int(ep) < st.tier_epoch):
                # refuse a warm rebuild whose epoch is OLDER than what
                # op results already proved — its digest list may still
                # name retired entries; wait for a fresh view
                warm: Dict[bytes, str] = {}
                for tname in ("disk", "dram", "hbm"):   # fastest wins
                    for hexd in tiers.get(tname, ()):
                        try:
                            warm[bytes.fromhex(hexd)] = tname
                        except ValueError:
                            pass
                st.warm = warm
            if ep is not None:
                # the scrape and its warm rebuild are one atomic view:
                # record the epoch it was taken at so only LATER bumps
                # (seen on op results) invalidate it
                st.tier_epoch = max(st.tier_epoch, int(ep))
            status = doc.get("status", "ok")
            if not doc.get("healthy", True):
                status = "unhealthy"
            if st.draining:
                # administrative drain hold: never re-promote a
                # replica the controller is scaling down
                status = "unhealthy"
            self._set_state(
                st, status if status in REPLICA_STATES else "ok")

    def _set_state(self, st, new: str):
        if new == st.state:
            return
        if new == "unhealthy":
            self._m_drains.inc(reason="unhealthy")
        st.state = new
        self._m_state.set(_STATE_RANK[new], replica=st.name)

    def _mark_dead(self, st):
        if st.state == "dead":
            return
        st.state = "dead"
        # rewarm seed: remember what was recently placed here (most
        # recent last) BEFORE pruning, so a replacement replica can
        # re-import those prefixes from warm survivors
        if st.recent:
            self._rewarm_stash[st.name] = list(st.recent.values())
            st.recent.clear()
        # prune the dead member's directory entries immediately: a
        # fetch routed at a corpse would just bounce through the
        # requeue path, and `directory()` must never advertise one
        st.warm = {}
        st.hot.clear()
        self._m_state.set(0, replica=st.name)
        self._m_drains.inc(reason="dead")
        now = time.perf_counter()
        requeue: List[RouterRequest] = []
        for xid, (req, kind) in list(st.outstanding.items()):
            st.outstanding.pop(xid)
            if kind == "import":
                continue
            if kind == "rewarm":
                # a rewarm export lost with its source is just a cache
                # miss for the replacement — never requeued work
                self._m_rewarm.inc(result="miss")
                continue
            self._release(req)
            req.requeues += 1
            req.status = "queued"
            req.replica = None
            # a payload produced by (or destined for) the dead replica
            # restarts the whole flow — survivors may have the prefix
            # hot anyway
            req.payload, req.payload_blocks = None, 0
            self._rev(req, "requeue", "n", now, reason="dead",
                      replica=st.name, requeues=req.requeues)
            self._rev(req, "queue", "b", now)
            requeue.append(req)
        if requeue:
            self._m_requeued.inc(len(requeue))
            for req in reversed(requeue):
                self._queue.appendleft(req)
        # the fleet flight hook: bundle the dead member's last-known
        # state with the router's view into one post-mortem artifact
        # (only when a flight dir is configured — tests and notebooks
        # must not litter; same gate as the trainer's crash dumps)
        self.fleet.drop_replica(st.name)
        from paddle_tpu_torch.observe import flight as _flight
        if _flight.configured():
            _fleet.death_postmortem(
                st.name, router_view=self.health(),
                last_health=st.last_health,
                outstanding=[{"xid": r.xid, "requeues": r.requeues,
                              "trace": r.trace_id} for r in requeue],
                alerts=self.alerts.firing())

    # -- fleet aggregation -------------------------------------------------
    def _scrape(self):
        """One aggregation round on the health-poll cadence: ingest
        every live replica's registry snapshot + last health doc into
        the fleet aggregator (it writes into THIS registry), refresh
        the derived fleet gauges, then run the alert rules over the
        result. Dead replicas still report their router-side state so
        ``fleet_replicas{state="dead"}`` counts them."""
        for st in self._all:
            snapshot = None
            if st.state != "dead":
                fn = getattr(st.handle, "metrics_snapshot", None)
                if fn is not None:
                    try:
                        snapshot = fn()
                    except Exception:
                        snapshot = None
            self.fleet.observe_replica(
                st.name, state=st.state,
                health=st.last_health or None, snapshot=snapshot)
        self.fleet.finish_scrape()
        self._m_dir_size.set(len(self.directory()))
        self._update_gauges()
        self._update_window_gauges()    # burn gauge feeds the TTFT rule
        self.alerts.evaluate()

    def remove_replica(self, name: str):
        """Administratively retire a replica: forget its per-replica
        gauge series and aggregator state so fleet counts (and the
        dead-replica alert) reflect the intended fleet, not history.
        The admin surface a future autoscaler's scale-down uses; any
        in-flight work is requeued first via the dead path."""
        st = next((s for s in self._all if s.name == name), None)
        if st is None:
            raise KeyError(f"no replica named {name!r}")
        self._mark_dead(st)
        self._all.remove(st)
        if st in self._decode:
            self._decode.remove(st)
        if st in self._prefill:
            self._prefill.remove(st)
        if not self._decode:
            raise RuntimeError("removed the last decode replica: the "
                               "router can no longer place work")
        self.fleet.drop_replica(name)
        self.fleet.forget_state(name)
        for g in (self._m_state, self._m_in_flight,
                  self._m_replica_queue):
            g.remove(replica=name)
        try:
            st.handle.close()
        except Exception:
            pass

    # -- fleet lifecycle (the controller's command surface) ----------------
    def add_replica(self, handle, *, prefill: bool = False):
        """Register a NEW replica handle (scale-up, or a replacement
        spawned under a fresh name). It admits immediately as ``ok``;
        the next health poll corrects that if the replica disagrees."""
        if any(st.name == handle.name for st in self._all):
            raise ValueError(f"replica name {handle.name!r} already "
                             f"registered")
        st = _Replica(handle, self._replica_cap, self._hot_cap)
        self._all.append(st)
        (self._prefill if prefill else self._decode).append(st)
        self._m_state.set(_STATE_RANK[st.state], replica=st.name)
        return st

    def replace_replica(self, name: str, handle):
        """Swap a DEAD replica's handle for its replacement under the
        SAME name (the healed process inherits the spill dir keyed on
        it). Role and list position carry over; the warm set starts
        empty and refills from the replacement's first health scrape
        (its disk tier re-adopts the spill dir) plus the rewarm path."""
        st = next((s for s in self._all if s.name == name), None)
        if st is None:
            raise KeyError(f"no replica named {name!r}")
        if st.state != "dead":
            raise ValueError(f"replica {name!r} is {st.state}, not "
                             f"dead — drain and remove it instead")
        if handle.name != name:
            raise ValueError(f"replacement handle is named "
                             f"{handle.name!r}, expected {name!r}")
        try:
            st.handle.close()
        except Exception:
            pass
        st.handle = handle
        st.last_health = {}
        st.health_t = -1e9
        st.tier_epoch = -1
        st.draining = False
        st.outstanding.clear()
        st.state = "ok"
        self._m_state.set(_STATE_RANK["ok"], replica=name)
        return st

    def begin_drain(self, name: str):
        """Administrative drain (scale-down): stop admitting onto
        ``name`` and HOLD it unhealthy against health-poll
        re-promotion. In-flight work finishes normally; the caller
        watches ``in_flight`` reach 0 and then removes the replica."""
        st = next((s for s in self._all if s.name == name), None)
        if st is None:
            raise KeyError(f"no replica named {name!r}")
        st.draining = True
        self._set_state(st, "unhealthy")

    def rewarm_replica(self, name: str, limit: int = 8) -> int:
        """Re-warm a replacement replica: for each prefix recently
        placed on the dead incarnation (the stash `_mark_dead` kept),
        ship its KV from the warmest live survivor over the transfer
        wire — a ``warm_only`` export relayed as an import, exactly
        the cache-directory fetch path. Prefixes the replacement
        already holds warm (its disk tier re-adopted the spill dir)
        are skipped. Returns the number of rewarm exports issued."""
        target = next((s for s in self._all if s.name == name), None)
        if target is None:
            raise KeyError(f"no replica named {name!r}")
        stash = self._rewarm_stash.pop(name, [])
        issued = 0
        for prompt in reversed(stash):      # most recent first
            if issued >= int(limit):
                break
            digests = _blocks.prompt_block_hashes(
                np.asarray(prompt, np.int32), self.block_size)
            if not digests:
                continue
            if target.prefix_score(digests) >= len(digests):
                continue    # already warm (spill-dir re-adoption)
            src, run, tier = None, 0, None
            for st in self._all:
                if st is target or st.state not in ("ok", "degraded"):
                    continue
                n, deepest = st.prefix_run(digests)
                if n > run or (n == run and n > 0 and src is not None
                               and st.in_flight < src.in_flight):
                    src, run, tier = st, n, deepest
            if src is None or run <= 0:
                self._m_rewarm.inc(result="miss")
                continue
            rid = f"rw{next(self._rewarm_ids)}"
            spec = {"id": rid, "op": "export_prefix", "warm_only": True,
                    "prompt": [int(t) for t in prompt]}
            src.handle.submit(spec)
            # the ticket rides the ordinary outstanding plumbing (the
            # handle is polled ONLY by _collect); _on_rewarm relays
            # the payload to the target when the export lands
            src.outstanding[rid] = (
                _RewarmTicket(rid, name, list(digests)), "rewarm")
            self._m_kv_fetches.inc(tier=tier or "dram")
            issued += 1
        return issued

    def _on_rewarm(self, src, ticket, doc: dict):
        """A rewarm export landed: relay the payload to the ticket's
        target replica as an ordinary import (the prefix-cache publish
        path), or count the miss if the source had nothing left."""
        target = next((s for s in self._all
                       if s.name == ticket.target), None)
        payload = doc.get("payload") if "error" not in doc else None
        if (target is None or target.state == "dead" or not payload):
            self._m_rewarm.inc(result="miss")
            return
        blocks = int(doc.get("blocks") or 0)
        imp = {"id": f"{ticket.rid}.imp", "op": "import_prefix",
               "payload": payload}
        target.handle.submit(imp)
        target.outstanding[f"{ticket.rid}.imp"] = (ticket, "import")
        target.mark_hot(ticket.digests[:blocks] if blocks
                        else ticket.digests)
        self._m_rewarm.inc(result="shipped")

    # -- placement ---------------------------------------------------------
    def _place(self):
        remaining: deque = deque()
        while self._queue:
            req = self._queue.popleft()
            if not self._place_one(req):
                remaining.append(req)
        self._queue = remaining
        self._m_queue.set(len(self._queue))

    def _place_one(self, req: RouterRequest) -> bool:
        if self._tenant_blocked(req):
            # over its fleet budget: the request WAITS (placement
            # skips it without blocking the tenants behind it) until
            # enough of the tenant's placed work finishes
            return False
        if req.payload is not None:
            return self._place_decode(req)
        if (req.usable and req.prefill_replica is None
                and not self._warm_on_placeable_decode(req)):
            # fleet cache directory: the prefix is cold on every decode
            # replica that could take this request, but may be warm
            # SOMEWHERE — another replica's HBM, DRAM or disk. Fetch it
            # over the transfer wire when shipping bytes beats
            # recomputing FLOPs (the crossover knob); the payload comes
            # back through the ordinary export relay and ships ahead of
            # the generate op like a P/D prefill would.
            src, run, tier = self._pick_fetch_source(req)
            if src is not None and self._fetch_pays(src):
                spec = {"id": req.xid, "op": "export_prefix",
                        "warm_only": True,
                        "prompt": [int(t) for t in req.prompt]}
                if req.trace_id:
                    spec["trace"] = req.trace_id
                src.handle.submit(spec)
                src.outstanding[req.xid] = (req, "export")
                req.status = "prefill"
                req.prefill_replica = src.name
                self._m_kv_fetches.inc(tier=tier)
                self._rev(req, "place", "n", time.perf_counter(),
                          kind="fetch", replica=src.name,
                          blocks=run, tier=tier)
                return True
        if (self._prefill and req.usable
                and req.prefill_replica is None
                and not self._hot_anywhere(req)):
            st = self._pick_prefill()
            if st is not None:
                spec = {"id": req.xid, "op": "export_prefix",
                        "prompt": [int(t) for t in req.prompt]}
                if req.trace_id:
                    # the P/D hop joins the same fleet trace: the
                    # prefill replica's engine spans land on this id
                    spec["trace"] = req.trace_id
                st.handle.submit(spec)
                st.outstanding[req.xid] = (req, "export")
                req.status = "prefill"
                req.prefill_replica = st.name
                self._rev(req, "place", "n", time.perf_counter(),
                          kind="export", replica=st.name)
                return True
            # no prefill capacity: colocated fallback — correctness
            # (and latency) must not wait on the prefill tier
        return self._place_decode(req)

    def _warm_on_placeable_decode(self, req: RouterRequest) -> bool:
        """True when a decode replica that could take this request NOW
        (live, under its cap) holds a leading run warm at any local
        tier — placement lands there and local hits/promotion serve
        it, so a remote fetch would only burn wire bytes."""
        usable = req.digests[:req.usable]
        return any(st.prefix_score(usable) > 0
                   for st in self._decode
                   if st.state in ("ok", "degraded")
                   and st.in_flight < st.cap)

    def _pick_fetch_source(self, req: RouterRequest):
        """Best remote source for ``req``'s prefix: the live replica
        (any role — a capped decode replica or the prefill tier both
        qualify) with the longest leading warm run; ties prefer the
        least loaded. Returns (replica, run_blocks, deepest_tier) or
        (None, 0, None)."""
        usable = req.digests[:req.usable]
        best, best_key, best_run = None, None, (0, None)
        for st in self._all:
            if st.state not in ("ok", "degraded"):
                continue
            n, deepest = st.prefix_run(usable)
            if n <= 0:
                continue
            key = (n, -st.in_flight)
            if best_key is None or key > best_key:
                best, best_key, best_run = st, key, (n, deepest)
        return best, best_run[0], best_run[1]

    def _fetch_pays(self, src) -> bool:
        """The bytes-shipped-vs-FLOPs-recomputed crossover. Both sides
        are linear in prefix tokens (`kv_bytes_per_token` wire bytes
        vs `flops_per_token` recompute), so the prefix length cancels
        and the decision is a per-token rate comparison against the
        ``fetch_flops_per_byte`` knob. Missing health figures (row
        engine, no scrape yet) fail toward recompute — the behavior
        the fleet had before the directory existed."""
        if self.fetch_flops_per_byte == 0:
            return True
        doc = src.last_health or {}
        flops = doc.get("flops_per_token")
        kvb = doc.get("kv_bytes_per_token")
        if not flops or not kvb:
            return False
        return float(flops) >= self.fetch_flops_per_byte * float(kvb)

    def directory(self) -> Dict[str, dict]:
        """The fleet-global cache directory: digest hex -> {replica,
        tier} over every LIVE replica's advertised warm set (hot-set
        entries count as hbm), preferring the fastest tier when a
        digest is warm in several places. Dead replicas never appear —
        their entries are pruned the moment death is detected."""
        out: Dict[str, dict] = {}
        for st in self._all:
            if st.state == "dead":
                continue
            for d in st.hot:
                cur = out.get(d.hex())
                if cur is None or _TIER_RANK[cur["tier"]] > 0:
                    out[d.hex()] = {"replica": st.name, "tier": "hbm"}
            for d, t in st.warm.items():
                cur = out.get(d.hex())
                if cur is None or _TIER_RANK[t] < _TIER_RANK[cur["tier"]]:
                    out[d.hex()] = {"replica": st.name, "tier": t}
        return out

    def _hot_anywhere(self, req: RouterRequest) -> bool:
        """True when some decode replica already holds the whole
        transferable prefix hot — the placement-hit fast path that
        skips the prefill tier entirely."""
        usable = req.digests[:req.usable]
        return any(st.prefix_score(usable) >= req.usable
                   for st in self._decode
                   if st.state in ("ok", "degraded"))

    def _pick_prefill(self):
        best, best_key = None, None
        for st in self._prefill:
            if st.state in ("unhealthy", "dead"):
                continue
            if st.in_flight >= st.cap:
                continue
            key = (1 if st.state == "ok" else 0, -st.in_flight)
            if best_key is None or key > best_key:
                best, best_key = st, key
        return best

    def _pick_decode(self, req: RouterRequest):
        usable = req.digests[:req.usable]
        best, best_key = None, None
        for st in self._decode:
            if st.state in ("unhealthy", "dead"):
                continue
            if st.in_flight >= st.cap:
                continue
            # state dominates (degraded replicas only when no ok one
            # has room), then the hot-prefix run, then load
            key = (1 if st.state == "ok" else 0,
                   st.prefix_score(usable), -st.in_flight)
            if best_key is None or key > best_key:
                best, best_key = st, key
        return best

    def _place_decode(self, req: RouterRequest) -> bool:
        st = self._pick_decode(req)
        if st is None:
            return False
        usable = req.digests[:req.usable]
        score = st.prefix_score(usable)
        if req.payload is not None:
            # ship the KV ahead of the generate op on the same ordered
            # connection: the import lands before admission runs
            iid = f"imp{req.xid}.{req.placements}"
            imp = {"id": iid, "op": "import_prefix",
                   "payload": req.payload}
            if req.trace_id:
                imp["trace"] = req.trace_id
            st.handle.submit(imp)
            st.outstanding[iid] = (req, "import")
            st.mark_hot(req.digests[:req.payload_blocks])
            score = max(score, req.payload_blocks)
            req.payload = None
        spec = {
            "id": req.xid, "prompt": [int(t) for t in req.prompt],
            "max_new": req.max_new, "temperature": req.temperature,
            "top_k": req.top_k, "eos_id": req.eos_id,
            "tenant": req.tenant, "tier": req.tier}
        if req.trace_id:
            # the replica engine ADOPTS this id (its _enqueue only
            # mints one when the wire didn't carry one), so its
            # queued/prefill/decode spans join this very track
            spec["trace"] = req.trace_id
        st.handle.submit(spec)
        st.outstanding[req.xid] = (req, "generate")
        req.status, req.replica = "placed", st.name
        req.placed_t = time.perf_counter()
        req.placements += 1
        req.prefix_score = score
        self._charge(req)
        self._m_placements.inc()
        if score > 0:
            self._m_place_hits.inc()
        st.mark_hot(usable)
        if req.usable:
            # rewarm seed: this prompt's leading chunk-aligned prefix
            # is (about to be) warm here — what a replacement would
            # want re-imported if this replica dies. One token past the
            # prefix: an engine counts a prompt's last chunk as computed
            # there (it makes the logits), so the bare prefix would
            # export one chunk short (nothing at all for one chunk);
            # the extra token completes no block, the digests stay
            st.note_recent(
                tuple(usable),
                req.prompt[:req.usable * self.block_size + 1].copy())
        self._rev(req, "queue", "e", req.placed_t)
        self._rev(req, "place", "n", req.placed_t, kind="generate",
                  replica=st.name, prefix_score=score,
                  placements=req.placements)
        return True

    # -- observability -----------------------------------------------------
    def _slo_burn_rate(self) -> float:
        if self.slo is None:
            return 0.0
        return self.slo.burn_rate(
            self._win_ttft.fraction_over(self.slo.ttft_s))

    def _update_gauges(self):
        """Cheap per-step scalar gauges (the scheduler calls this every
        iteration — window quantiles live in _update_window_gauges,
        computed only at scrape time like the engines')."""
        for st in self._all:
            self._m_in_flight.set(st.in_flight, replica=st.name)
            qd = (st.last_health or {}).get("queue_depth")
            if qd is not None:
                self._m_replica_queue.set(qd, replica=st.name)
        self._m_hit_rate.set(self.placement_hit_rate())

    def _update_window_gauges(self):
        ttft = self._win_ttft.quantiles((0.5, 0.95, 0.99))
        tps = self._win_tps.quantiles((0.5, 0.95, 0.99))
        for lbl, q in (("p50", 0.5), ("p95", 0.95), ("p99", 0.99)):
            self._m_win_ttft.set(ttft[q], q=lbl)
            self._m_win_tps.set(tps[q], q=lbl)
        self._m_burn.set(self._slo_burn_rate())

    def health(self) -> dict:
        self._update_gauges()
        self._update_window_gauges()
        ttft = self._win_ttft.quantiles((0.5, 0.95, 0.99))
        doc = {
            "replicas": {
                st.name: {
                    "state": st.state,
                    "role": "prefill" if st in self._prefill
                    else "decode",
                    "in_flight": st.in_flight,
                    "queue_depth": (st.last_health or {}).get(
                        "queue_depth"),
                    "slots_active": (st.last_health or {}).get(
                        "slots_active"),
                    "blocks_in_use": (st.last_health or {}).get(
                        "blocks_in_use"),
                    "blocks_total": (st.last_health or {}).get(
                        "blocks_total"),
                    "ttft_p99_s": ((st.last_health or {}).get("window")
                                   or {}).get("ttft_p99_s"),
                    "slo_burn": ((st.last_health or {}).get("slo")
                                 or {}).get("ttft_burn_rate"),
                    "tiers": {
                        t: ((st.last_health or {}).get("tiers") or {})
                        .get(t, {}).get("entries")
                        for t in ("dram", "disk")}}
                for st in self._all},
            "directory_size": len(self.directory()),
            "queue_depth": len(self._queue),
            "requests": int(self._m_requests.value()),
            "completed": self._n_completed,
            "requeued": int(self._m_requeued.value()),
            "shed": int(sum(c.value for c
                            in self._m_shed.series().values())),
            "placement_hit_rate": round(self.placement_hit_rate(), 4),
            "alerts_firing": self.alerts.firing(),
            "window": {"ttft_p50_s": round(ttft[0.5], 6),
                       "ttft_p99_s": round(ttft[0.99], 6),
                       "requests": self._win_ttft.count(),
                       "fleet_ttft_p99_s": round(
                           self.fleet.ttft_quantile(0.99), 6)}}
        decode_live = [st for st in self._decode
                       if st.state in ("ok", "degraded")]
        if not decode_live:
            doc["healthy"] = False      # nothing can admit: 503
        elif any(st.state != "ok" for st in self._all):
            doc["status"] = "degraded"
            doc["degraded_reason"] = ", ".join(
                f"{st.name}={st.state}" for st in self._all
                if st.state != "ok")
        if self.slo is not None:
            doc["slo"] = {"ttft_s": self.slo.ttft_s,
                          "target": self.slo.target,
                          "burn_rate": round(self._slo_burn_rate(), 4)}
        if self._tenant_budgets:
            doc["tenants"] = {
                t: {"budget": b, "in_flight": self._tenant_used.get(t, 0)}
                for t, b in sorted(self._tenant_budgets.items())}
        if self._controller_summary is not None:
            try:
                doc["controller"] = self._controller_summary()
            except Exception:
                pass
        return doc

    def requests_doc(self, k: int = 10) -> dict:
        doc = self.request_log.summary()
        doc["slowest_by_ttft"] = self.request_log.slowest(k, by="ttft_s")
        return doc

    def metrics_text(self) -> str:
        self._update_gauges()
        self._update_window_gauges()
        return self.metrics.render_prometheus()

    def serve(self, host: str = "127.0.0.1", port: int = 0):
        """/metrics + /healthz + /requests + /alerts over the router
        registry (the aggregator writes fleet series into it, so this
        one scrape answers for the whole fleet); caller owns
        ``close()``."""
        from paddle_tpu_torch.observe.health import HealthServer
        return HealthServer(registry=self.metrics, health_fn=self.health,
                            host=host, port=port,
                            requests_fn=self.requests_doc,
                            metrics_fn=self.metrics_text,
                            alerts_fn=self.alerts.doc)

    def close(self):
        for st in self._all:
            try:
                st.handle.close()
            except Exception:
                pass
        self.fleet.close()
