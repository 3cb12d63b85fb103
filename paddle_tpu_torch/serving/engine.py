"""Continuous-batching LM decode engines (counterpart of
``paddle_tpu/serving/engine.py``).

:class:`DecodeEngine` is the row-arena slot engine (the one a format-v3
artifact loads into): the KV cache is a ``[L, B, cache_len, Hkv, Dh]``
arena whose B rows are leased to requests. A request queues (FIFO)
until a row frees, is prefilled into it in one program per prompt
bucket (``transformer.prefill_into_slot``, the prompt right-padded to
the smallest bucket that holds it), then decodes one token per step at
its own position (``transformer.decode_step_slots``) beside whatever
else is in flight, until EOS or ``max_new`` frees the row for the next.

:class:`PagedDecodeEngine` leases ``batch`` slots to requests. A request
queues until a slot frees and its worst-case block count can be
reserved, is chunk-prefilled into pool pages (one chunk per step while
others decode), then decodes one token per step with the sampler on the
device, until EOS or ``max_new``. Full prompt blocks are published in
the prefix cache as their chunk lands, and a later prompt with the same
prefix maps them into its page table instead of prefilling them.

The two step functions run as step programs (``core/graphs.py``), the
counterpart of the JAX engine's jitted programs: on the card one CUDA
graph per prompt bucket (slot engine) or per (chunk bucket, page-vector
length) (paged engine) for prefill and one for decode, captured at the
first call with that key and replayed after; ``compile_counts()``
counts them through the compile tracker, as the JAX engine counts its
compilations. There is no eager path on the card.
Only ``[B]`` int32 ids (or one id after a prefill) cross to the host per
step, and that copy is the step's one sync; scheduling state lives in
numpy and is copied into the programs' static buffers, the page table
into one device table when it changes. The per-step sampling seeds come
from ``np.random.RandomState(seed)`` in the same order as the JAX
engine's, so one ``seed`` gives both engines the same seed stream.

The multi-tenant scheduler is the JAX engine's: latency/batch tiers with
strict-priority admission, per-tenant token budgets (exhaustion queues,
never rejects) and preempt-to-blocks — a batch-tier victim's pages are
published into the prefix cache, and it resumes either by re-mapping
them (``remap``) or, when some were evicted, by a cache-hit chunked
prefill and a forced replay of its emitted tokens through decode steps
(``replay``).

Observability follows the JAX engine's: each request leaves
chrome-trace lifecycle events on its own async track (``eng<N>.r<rid>``:
request, queued, admitted, prefill, prefill_chunk, first_token, decode,
preempted, resumed, finished; ``observe/chrome_trace.py``) and one
record in the request log (``observe/requests.py``); TTFT and goodput
feed rolling windows (``observe/window.py``) whose quantiles and SLO
burn rate ``health()`` reports; ``serve()`` puts ``/metrics``,
``/healthz`` and ``/requests`` on an HTTP port (``observe/health.py``);
``abort_requests`` closes every open slice.

Prefix mobility: ``export_prefix`` serializes a prompt's cached prefix
blocks onto the PTKV wire (``serving/transfer.py``) and
``import_prefix`` adopts such a payload into the pool, written in place
so the captured graphs keep reading the same tensors. With ``tiers=``
an evicted cached block is demoted to host DRAM or disk
(``serving/tiers.py``) and promoted back at admission.

:class:`SpecDecodeEngine` is the paged engine with speculative
decoding: a small draft model proposes ``spec_k`` tokens per step, the
target verifies every slot's window in one pass, and the accept/reject
tail emits the accepted drafts plus one token of the target's own.
"""

import dataclasses
import itertools
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.core import graphs, place, ragged
from paddle_tpu_torch.models import transformer
from paddle_tpu_torch.observe import chrome_trace as _chrome
from paddle_tpu_torch.observe import compile_tracker as _ct
from paddle_tpu_torch.observe import costs as _costs
from paddle_tpu_torch.observe import metrics as _metrics
from paddle_tpu_torch.observe import requests as _requests
from paddle_tpu_torch.observe.window import SloConfig, WindowedQuantiles
from paddle_tpu_torch.serving import blocks as _blocks
from paddle_tpu_torch.serving import tiers as _tiers
from paddle_tpu_torch.serving import transfer as _transfer
from paddle_tpu_torch.utils.logger import get_logger

log = get_logger("serving.engine")

# per-process engine counter: bakes into request trace ids
# (``eng<N>.r<rid>``) so several engines' events never collide in one
# exported timeline
_ENGINE_IDS = itertools.count()

# decode steps run single-digit ms; prefill tens-to-hundreds
_LATENCY_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                    0.1, 0.25, 0.5, 1.0, 2.5, 5.0)
_GOODPUT_BUCKETS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                    500.0, 1000.0, 2500.0, 5000.0, 10000.0)

# the two scheduling tiers: "latency" admits ahead of "batch" and may
# preempt a batch-tier victim's blocks; "batch" fills whatever capacity
# latency traffic leaves (and is the only tier preemption may evict)
VALID_TIERS = ("latency", "batch")

# the slot engine's prompt buckets: one prefill program each, at most ~2x
# padded prefill work on a mixed workload
DEFAULT_PREFILL_BUCKETS = (16, 32, 64, 128, 256, 512)

PREFILL = "serving_engine.prefill"
DECODE = "serving_engine.decode"


@dataclasses.dataclass
class EngineRequest:
    """One generation request and its lifecycle record."""
    rid: int
    prompt: np.ndarray                  # [Tp] int32
    max_new: int
    temperature: float = 0.0
    top_k: int = 0
    eos_id: Optional[int] = None
    tenant: str = "default"             # token-budget accounting key
    tier: str = "batch"                 # latency | batch (VALID_TIERS)
    # -- lifecycle (filled by the engine) --------------------------------
    bucket: int = 0                     # slot engine: padded prompt length
    slot: int = -1
    prefix_hit_tokens: int = 0          # prompt tokens served from cache
    block_hashes: Optional[List[bytes]] = None
    tier_promote_done: bool = False     # spill-tier promotion attempted
    #                                     (once per request)
    tier_promoted_blocks: int = 0       # blocks promotion just adopted
    #                                     for it: dram/disk hits, not hbm
    tokens: List[int] = dataclasses.field(default_factory=list)
    status: str = "queued"              # queued | prefilling | running
    #                                     | preempted | done | aborted
    finish_reason: Optional[str] = None  # eos | max_tokens | abort reason
    submit_t: float = 0.0
    prefill_t: Optional[float] = None   # last admission
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    prefill_own_s: float = 0.0          # this request's own chunk time
    trace_id: str = ""                  # eng<N>.r<rid>: joins its events
    decode_open: bool = False           # a "decode" trace slice is open
    preemptions: int = 0                # times preempted to blocks
    # preempt-to-blocks resume state: the host snapshot taken at
    # preemption (block-chain digests + decode cursor), and, on the
    # eviction fallback, the emitted tokens the replay force-feeds
    # through decode steps without emitting them again
    snapshot: Optional[dict] = dataclasses.field(default=None, repr=False)
    replay: Optional[List[int]] = dataclasses.field(default=None,
                                                    repr=False)

    @property
    def output(self) -> np.ndarray:
        """prompt + generated ids."""
        return np.concatenate([self.prompt,
                               np.asarray(self.tokens, np.int32)])

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_t is None:
            return None
        return self.first_token_t - self.submit_t

    @property
    def latency_s(self) -> Optional[float]:
        if self.finish_t is None:
            return None
        return self.finish_t - self.submit_t

    @property
    def queue_wait_s(self) -> Optional[float]:
        if self.prefill_t is None:
            return None
        return self.prefill_t - self.submit_t

    @property
    def prefill_stall_s(self) -> Optional[float]:
        """Admitted -> first token, minus own prefill time: time parked
        behind other requests' chunks and the decode steps between
        them."""
        if self.first_token_t is None or self.prefill_t is None:
            return None
        return max(self.first_token_t - self.prefill_t
                   - self.prefill_own_s, 0.0)

    @property
    def decode_s(self) -> Optional[float]:
        if self.finish_t is None or self.first_token_t is None:
            return None
        return self.finish_t - self.first_token_t

    @property
    def cache_hit_frac(self) -> float:
        """Fraction of the prompt served from the prefix cache."""
        return self.prefix_hit_tokens / max(int(self.prompt.size), 1)


class DecodeEngine:
    """The row-arena slot engine, and the slot-scheduler core the paged
    engine builds on: request records, host-side slot state, the batched
    decode step, token emission and metrics. The paged engine
    specializes submission, admission and prefill.

    ``prefill``/``decode`` are step programs (``core/graphs.py``, as
    ``serving/sampling.engine_step_fns`` makes them) or plain step
    functions with their signatures, which the engine wraps into
    programs under its tracker. Build one with :meth:`from_params`, or
    from a format-v3 artifact with ``io/lm_serving.LMServer.engine()``.
    One prefill program per bucket and one decode program
    (``compile_counts()``)."""

    def __init__(self, prefill: Callable, decode: Callable, params, cache,
                 *, batch: int, cache_len: int,
                 buckets: Sequence[int] = DEFAULT_PREFILL_BUCKETS,
                 device, cfg, seed: Optional[int] = None,
                 tracker: Optional[_ct.CompileTracker] = None,
                 slo: Optional[SloConfig] = None,
                 registry: Optional[_metrics.Registry] = None,
                 decode_flops: Optional[float] = None):
        if tracker is None:
            tracker = getattr(decode, "tracker", None) or \
                _ct.CompileTracker()
        self._tracker = tracker
        context = getattr(decode, "context", None) or graphs.GraphContext()
        self._prefill_fn = self._program(prefill, PREFILL, context)
        self._decode_fn = self._program(decode, DECODE, context)
        self.params = params
        self.cache = cache
        self.cfg = cfg
        self.device = torch.device(device)
        self.batch = int(batch)
        self.cache_len = int(cache_len)
        self.buckets = tuple(sorted({int(b) for b in buckets
                                     if int(b) <= cache_len}))
        if not self.buckets:
            raise ValueError(f"no prefill bucket fits cache_len="
                             f"{cache_len} (buckets={tuple(buckets)})")
        # None draws fresh OS entropy; a seed gives the JAX engine's
        # per-call seed stream
        self._rng = np.random.RandomState(seed)
        self._peak_flops = (place.peak_flops(self.device)
                            if self.device.type == "cuda" else None)
        self._flops_total = 0.0
        self._step_s_total = 0.0
        # a fixed model-FLOPs numerator per step (an artifact's stamped
        # cost); None counts each step's FLOPs from its shapes
        self.decode_flops = decode_flops
        B = self.batch
        self._pos = np.zeros(B, np.int32)
        self._active = np.zeros(B, bool)
        self._last = np.zeros(B, np.int32)
        self._temp = np.zeros(B, np.float32)
        self._topk = np.zeros(B, np.int32)
        self._slot_req: List[Optional[EngineRequest]] = [None] * B
        self._free = deque(range(B))
        self._queue: deque = deque()
        self._ids = itertools.count()
        # -- request-scoped observability --------------------------------
        self._engine_id = next(_ENGINE_IDS)
        # perf_counter -> wall-clock anchor: lifecycle events land on the
        # epoch timeline of the trace spans, while the engine's own
        # timestamps stay monotonic
        self._wall_anchor = time.time() - time.perf_counter()
        self.request_log = _requests.RequestLog()
        self.slo: Optional[SloConfig] = None
        self.configure_slo(slo)
        reg = self.metrics = (registry if registry is not None
                              else _metrics.Registry())
        self._m_requests = reg.counter(
            "engine_requests_total", "requests submitted")
        self._m_rejected = reg.counter(
            "engine_requests_rejected_total",
            "submissions rejected at validation, by reason")
        self._m_completed = reg.counter(
            "engine_requests_completed_total",
            "requests finished, by termination reason")
        self._m_tokens = reg.counter(
            "engine_tokens_total", "tokens emitted across all requests")
        self._m_steps = reg.counter(
            "engine_decode_steps_total", "batched decode steps executed")
        self._m_prefills = reg.counter(
            "engine_prefill_calls_total", "prompts fully prefilled")
        self._m_queue = reg.gauge(
            "engine_queue_depth", "requests waiting for a slot")
        self._m_occupancy = reg.gauge(
            "engine_slots_active", "slots currently decoding")
        self._m_wait_s = reg.histogram(
            "engine_queue_wait_seconds", "submit -> prefill-start wait",
            buckets=_LATENCY_BUCKETS)
        self._m_ttft_s = reg.histogram(
            "engine_ttft_seconds", "submit -> first token",
            buckets=_LATENCY_BUCKETS)
        self._m_prefill_s = reg.histogram(
            "engine_prefill_seconds", "a prompt's own prefill time, "
            "summed over its chunks", buckets=_LATENCY_BUCKETS)
        self._m_step_s = reg.histogram(
            "engine_decode_step_seconds", "batched decode-step latency "
            "(device work + [B]-ids host sync)", buckets=_LATENCY_BUCKETS)
        self._m_decode_mfu = reg.gauge(
            "engine_decode_mfu", "model-FLOPs utilisation of the last "
            "decode step (FLOPs from the shapes, observe/costs.py; 0 "
            "until a step ran on a card with a declared peak)")
        self._m_goodput = reg.histogram(
            "engine_request_tokens_per_sec", "per-request goodput: "
            "tokens emitted / (finish - submit)", buckets=_GOODPUT_BUCKETS)
        self._m_win_ttft = reg.gauge(
            "engine_ttft_window_seconds", "rolling TTFT quantile over "
            "the SLO window (label q = p50|p95|p99, and per tier)")
        self._m_win_tps = reg.gauge(
            "engine_tokens_per_sec_window", "rolling per-request "
            "goodput quantile over the SLO window (label q)")
        self._m_burn = reg.gauge(
            "engine_slo_burn_rate", "TTFT SLO burn rate: windowed "
            "violation fraction / error budget (0 without a "
            "configured SLO)")

    @classmethod
    def from_params(cls, params, cfg, *, batch: int, cache_len: int,
                    buckets: Sequence[int] = DEFAULT_PREFILL_BUCKETS,
                    seed: Optional[int] = None, device=None,
                    tracker: Optional[_ct.CompileTracker] = None,
                    registry: Optional[_metrics.Registry] = None,
                    slo: Optional[SloConfig] = None,
                    decode_flops: Optional[float] = None):
        """The slot engine over live ``params`` (``transformer.
        init_params``, ``params_from_numpy`` or the int8-weight
        ``io/lm_serving.quantize_lm_params``) with a zeroed arena of
        ``batch`` rows of ``cache_len`` positions and the step programs
        of ``sampling.engine_step_fns`` under ``tracker`` (default: a
        fresh one per engine), the TTFT ``slo``, the metrics
        ``registry`` and the fixed per-step ``decode_flops`` (default:
        counted from the shapes). Runs on the card unless
        ``device="cpu"``; ``params`` must already live there."""
        from paddle_tpu_torch.serving import sampling
        device = place.resolve_device(device)
        where = _params_device(params)
        if where != device:
            raise ValueError(f"params live on {where}, the engine runs on "
                             f"{device}")
        if cache_len > cfg.max_len:
            raise ValueError(f"cache_len {cache_len} exceeds cfg.max_len "
                             f"{cfg.max_len}")
        if tracker is None:
            tracker = _ct.CompileTracker(storm_threshold=len(buckets) + 2)
        prefill_fn, decode_fn = sampling.engine_step_fns(cfg,
                                                         tracker=tracker)
        cache = transformer.init_cache(cfg, batch, cache_len, device=device)
        return cls(prefill_fn, decode_fn, params, cache, batch=batch,
                   cache_len=cache_len, buckets=buckets, device=device,
                   cfg=cfg, seed=seed, tracker=tracker, slo=slo,
                   registry=registry, decode_flops=decode_flops)

    def _program(self, fn, name: str, context) -> graphs.StepProgram:
        """``fn`` as a step program under this engine's tracker."""
        if isinstance(fn, graphs.StepProgram):
            if fn.tracker is not self._tracker or fn.name != name:
                raise ValueError(f"step program {fn.name!r} is tracked "
                                 f"elsewhere: the engine counts {name!r} "
                                 f"in its own tracker")
            return fn
        return graphs.StepProgram(fn, name, self._tracker, context)

    # -- request-scoped observability --------------------------------------
    def configure_slo(self, slo: Optional[SloConfig]):
        """Install (or with ``None`` clear) the TTFT SLO ``health()``
        evaluates over its rolling window; resets the windows to the new
        length."""
        self.slo = slo
        win = slo.window_s if slo is not None else 60.0
        self._win_ttft = WindowedQuantiles(window_s=win)
        self._win_tps = WindowedQuantiles(window_s=win)
        # per-tier TTFT windows, made as tiers appear: the scheduler's
        # point is the per-tier p99 separation the aggregate hides
        self._win_ttft_tier: Dict[str, WindowedQuantiles] = {}
        self._tier_window_s = win

    def _tier_window(self, tier: str) -> WindowedQuantiles:
        win = self._win_ttft_tier.get(tier)
        if win is None:
            win = self._win_ttft_tier[tier] = WindowedQuantiles(
                window_s=self._tier_window_s)
        return win

    def _wall(self, perf_t: float) -> float:
        return self._wall_anchor + perf_t

    def _ev(self, req: EngineRequest, name: str, ph: str, perf_t: float,
            **args):
        """One lifecycle event on this request's async trace track."""
        _chrome.record_event(name, self._wall(perf_t), ph, req.trace_id,
                             args=args or None)

    def _reject(self, rid: int, reason: str, msg: str) -> ValueError:
        """Count, trace and log a rejected submission; returns (does not
        raise) the ValueError, so call sites read ``raise
        self._reject(...)``."""
        now = time.perf_counter()
        self._m_rejected.inc(reason=reason)
        _chrome.record_event(
            "request_rejected", self._wall(now), "n",
            f"eng{self._engine_id}.r{rid}",
            args={"rid": rid, "reason": reason})
        # a rejection leaves a record too, with no measured components
        rec = {"rid": rid, "engine": self._engine_id,
               "trace_id": f"eng{self._engine_id}.r{rid}",
               "submit_ts": round(self._wall(now), 6),
               "finish_reason": f"rejected:{reason}",
               "prompt_tokens": None, "tokens": 0,
               "queue_wait_s": None, "prefill_own_s": None,
               "prefill_stall_s": None, "decode_s": None,
               "ttft_s": None, "latency_s": None, "cache_hit_frac": 0.0}
        self.request_log.add(rec)
        _requests.default_request_log().add(rec)
        return ValueError(msg)

    def _enqueue(self, req: EngineRequest) -> EngineRequest:
        """Queue the request and open its trace track (an async
        ``request`` slice and a nested ``queued`` one). A caller's trace
        id (``submit(trace=...)``) is adopted as it is."""
        if not req.trace_id:
            req.trace_id = f"eng{self._engine_id}.r{req.rid}"
        self._queue.append(req)
        self._m_requests.inc()
        self._m_queue.set(len(self._queue))
        self._ev(req, "request", "b", req.submit_t, rid=req.rid,
                 prompt_tokens=int(req.prompt.size), max_new=req.max_new,
                 tenant=req.tenant, tier=req.tier)
        self._ev(req, "queued", "b", req.submit_t)
        return req

    def _record_request(self, req: EngineRequest):
        """One flat record into the engine's request log and the process
        default (``observe.requests.default_request_log()``)."""
        def r6(v):
            return round(v, 6) if v is not None else None

        rec = {"rid": req.rid, "engine": self._engine_id,
               "trace_id": req.trace_id,
               "submit_ts": round(self._wall(req.submit_t), 6),
               "finish_reason": req.finish_reason,
               "tenant": req.tenant, "tier": req.tier,
               "preemptions": req.preemptions,
               "prompt_tokens": int(req.prompt.size),
               "tokens": len(req.tokens),
               "queue_wait_s": r6(req.queue_wait_s),
               "prefill_own_s": r6(req.prefill_own_s),
               "prefill_stall_s": r6(req.prefill_stall_s),
               "decode_s": r6(req.decode_s),
               "ttft_s": r6(req.ttft_s),
               "latency_s": r6(req.latency_s),
               "cache_hit_frac": round(req.cache_hit_frac, 4)}
        self.request_log.add(rec)
        _requests.default_request_log().add(rec)

    def _slo_burn_rate(self) -> float:
        if self.slo is None:
            return 0.0
        return self.slo.burn_rate(
            self._win_ttft.fraction_over(self.slo.ttft_s))

    def _update_window_gauges(self):
        """Refresh the rolling-quantile gauges and the burn rate: when a
        request finishes (request grain, off the per-token path) and on
        every read (``health()``, ``metrics_text()``), since samples
        expire with time."""
        ttft = self._win_ttft.quantiles((0.5, 0.95, 0.99))
        tps = self._win_tps.quantiles((0.5, 0.95, 0.99))
        for lbl, q in (("p50", 0.5), ("p95", 0.95), ("p99", 0.99)):
            self._m_win_ttft.set(ttft[q], q=lbl)
            self._m_win_tps.set(tps[q], q=lbl)
        for tier, win in self._win_ttft_tier.items():
            tq = win.quantiles((0.5, 0.95, 0.99))
            for lbl, q in (("p50", 0.5), ("p95", 0.95), ("p99", 0.99)):
                self._m_win_ttft.set(tq[q], q=lbl, tier=tier)
        self._m_burn.set(self._slo_burn_rate())

    # -- request API -------------------------------------------------------
    def _validate_submit(self, rid: int, prompt: np.ndarray, max_new: int,
                         tier: str, largest_bucket: Optional[int] = None):
        """Counted rejections for the malformed requests a wire can
        deliver; ``largest_bucket`` adds the slot engine's
        ``prompt_too_long`` (no prefill program past it) before the
        cache check, in the JAX engine's order."""
        if prompt.size < 1:
            raise self._reject(rid, "empty_prompt", "submit: empty prompt")
        if max_new < 1:
            raise self._reject(rid, "bad_max_new", f"submit: max_new must "
                               f"be >= 1, got {max_new}")
        if tier not in VALID_TIERS:
            raise self._reject(rid, "bad_tier", f"submit: tier must be one "
                               f"of {VALID_TIERS}, got {tier!r}")
        if largest_bucket is not None and prompt.size > largest_bucket:
            raise self._reject(
                rid, "prompt_too_long", f"submit: prompt length "
                f"{prompt.size} exceeds the largest prefill bucket "
                f"{largest_bucket}")
        if prompt.size + max_new > self.cache_len:
            raise self._reject(
                rid, "exceeds_cache", f"submit: {prompt.size} prompt + "
                f"{max_new} new tokens exceed cache_len {self.cache_len}")

    def submit(self, prompt, max_new: int, *, temperature: float = 0.0,
               top_k: int = 0, eos_id: Optional[int] = None,
               tenant: str = "default", tier: str = "batch",
               trace: Optional[str] = None) -> EngineRequest:
        """Queue one request; returns its live record. The prompt must
        fit the largest bucket and, with ``max_new``, the cache length
        (``prompt_too_long`` / ``exceeds_cache`` rejections, counted).
        ``tenant`` and ``tier`` ride into the request log and trace
        events; the slot engine admits FIFO regardless. ``trace`` adopts
        a caller's trace id instead of minting ``eng<N>.r<rid>``."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        rid = next(self._ids)
        self._validate_submit(rid, prompt, max_new, tier,
                              largest_bucket=self.buckets[-1])
        req = EngineRequest(
            rid=rid, prompt=prompt, max_new=int(max_new),
            temperature=float(temperature), top_k=int(top_k),
            eos_id=eos_id, tenant=str(tenant), tier=str(tier),
            bucket=ragged.bucket_length(prompt.size, self.buckets),
            submit_t=time.perf_counter(),
            trace_id=str(trace) if trace else "")
        return self._enqueue(req)

    def abort_requests(self, reason: str = "replica_killed") -> int:
        """Close every live request's open trace slices (``queued`` /
        ``prefill`` / ``decode`` / ``request``) with an ``aborted``
        marker and drop the work: the in-process counterpart of the
        serving process dying. Trace-level only: block and slot
        accounting is abandoned, not released, as in a dead process; do
        not reuse the engine afterwards. Returns the requests aborted."""
        now = time.perf_counter()
        aborted: List[EngineRequest] = []
        # a preempted request closed its prefill/decode slices at
        # preemption and waits in a "queued" slice opened there, which
        # closes here too (the JAX engine leaves that one open)
        for req in list(self._queue) + list(getattr(self, "_preempted", ())):
            self._ev(req, "queued", "e", now)
            aborted.append(req)
        for slot, req in enumerate(self._slot_req):
            if req is None:
                continue
            if req.first_token_t is None:
                self._ev(req, "prefill", "e", now)
            if req.decode_open:
                self._ev(req, "decode", "e", now)
                req.decode_open = False
            self._active[slot] = False
            self._slot_req[slot] = None
            aborted.append(req)
        for req in aborted:
            req.status, req.finish_reason = "aborted", reason
            self._ev(req, "aborted", "n", now, reason=reason)
            self._ev(req, "request", "e", now)
        self._queue.clear()
        if hasattr(self, "_preempted"):
            self._preempted.clear()
        self._m_queue.set(0)
        return len(aborted)

    @property
    def active_count(self) -> int:
        return int(self._active.sum())

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def idle(self) -> bool:
        return not self._queue and not self._active.any()

    # -- scheduler ---------------------------------------------------------
    def _seed(self) -> np.int32:
        return np.int32(self._rng.randint(0, 2 ** 31 - 1))

    def _finish(self, req: EngineRequest, reason: str, now: float):
        req.status, req.finish_reason, req.finish_t = "done", reason, now
        self._m_completed.inc(reason=reason)
        if req.latency_s and req.latency_s > 0:
            goodput = len(req.tokens) / req.latency_s
            self._m_goodput.observe(goodput)
            self._win_tps.observe(goodput)
        if req.slot >= 0:
            self._active[req.slot] = False
            self._slot_req[req.slot] = None
            self._free.append(req.slot)
        if req.decode_open:
            self._ev(req, "decode", "e", now)
            req.decode_open = False
        self._ev(req, "finished", "n", now, reason=reason,
                 tokens=len(req.tokens))
        self._ev(req, "request", "e", now)
        self._record_request(req)
        self._update_window_gauges()

    def _emit(self, req: EngineRequest, tok: int, now: float) -> bool:
        """Record one emitted token; True when the request finished."""
        req.tokens.append(int(tok))
        self._m_tokens.inc()
        finishing = ((req.eos_id is not None and tok == req.eos_id)
                     or len(req.tokens) >= req.max_new)
        if req.first_token_t is None:
            req.first_token_t = now
            ttft = now - req.submit_t
            self._m_ttft_s.observe(ttft)
            self._win_ttft.observe(ttft)
            self._tier_window(req.tier).observe(ttft)
            self._ev(req, "prefill", "e", now)
            self._ev(req, "first_token", "n", now,
                     ttft_ms=round(1000 * ttft, 3))
            if not finishing:
                self._ev(req, "decode", "b", now)
                req.decode_open = True
        if req.eos_id is not None and tok == req.eos_id:
            self._finish(req, "eos", now)
            return True
        if len(req.tokens) >= req.max_new:
            self._finish(req, "max_tokens", now)
            return True
        return False

    def _admit_slots(self, finished: List[EngineRequest]):
        """Prefill queued requests into free rows, FIFO, one prefill
        program call each (its bucket's graph; ``length``, ``slot`` and
        the seed are device scalars), and emit each one's first token."""
        while self._queue and self._free:
            req = self._queue.popleft()
            slot = self._free.popleft()
            now = time.perf_counter()
            req.prefill_t = now
            self._m_wait_s.observe(now - req.submit_t)
            self._ev(req, "queued", "e", now)
            self._ev(req, "admitted", "n", now, slot=slot,
                     queue_wait_ms=round(1000 * (now - req.submit_t), 3))
            self._ev(req, "prefill", "b", now)
            padded = np.zeros((1, req.bucket), np.int32)
            padded[0, :req.prompt.size] = req.prompt
            t0 = time.perf_counter()
            tok, self.cache = self._prefill_fn(
                self.params, self.cache, padded, np.int32(req.prompt.size),
                np.int32(slot), np.asarray([req.temperature], np.float32),
                np.asarray([req.top_k], np.int32), self._seed())
            tok = int(tok.cpu()[0])
            now = time.perf_counter()
            req.prefill_own_s = now - t0
            self._m_prefill_s.observe(now - t0)
            self._m_prefills.inc()
            self._ev(req, "prefill_chunk", "n", now,
                     tokens=int(req.prompt.size), bucket=req.bucket)
            req.slot, req.status = slot, "running"
            self._slot_req[slot] = req
            if self._emit(req, tok, now):
                finished.append(req)    # a one-token request: its row is
                continue                # already free again
            self._active[slot] = True
            self._pos[slot] = req.prompt.size
            self._last[slot] = tok
            self._temp[slot] = req.temperature
            self._topk[slot] = req.top_k
        self._m_queue.set(len(self._queue))

    def _schedule(self, finished: List[EngineRequest]):
        """Admission and prefill work that runs before the decode step."""
        self._admit_slots(finished)

    def _pre_decode(self):
        """Host bookkeeping before a decode step."""

    def _decode_extra(self):
        """Extra decode-program args inserted after ``active``."""
        return ()

    def _consume_forced(self, slot: int) -> bool:
        """True when the slot replays already-emitted tokens after a
        preempt-to-blocks resume: the step's sampled id is dropped, the
        known token advances the cursor, nothing is emitted again."""
        return False

    def _update_gauges(self):
        self._m_occupancy.set(self.active_count)

    def step(self) -> List[EngineRequest]:
        """One scheduler iteration: admission and prefill, then one
        batched decode step for every active slot. Returns the requests
        that finished during this step."""
        finished: List[EngineRequest] = []
        self._schedule(finished)
        if self._active.any():
            self._pre_decode()
            positions = self._pos[self._active].tolist()
            t0 = time.perf_counter()
            nxt, self.cache = self._decode_fn(
                self.params, self.cache, self._last, self._pos,
                self._active, *self._decode_extra(), self._temp,
                self._topk, self._seed())
            # the only device->host transfer; it also ends the program's
            # use of its staging buffers and outputs before the next call
            nxt = nxt.cpu().numpy()
            now = time.perf_counter()
            self._account_step(now - t0, _costs.decode_step_flops(
                self.cfg, positions))
            for slot in np.flatnonzero(self._active):
                if self._consume_forced(slot):
                    continue
                req = self._slot_req[slot]
                tok = int(nxt[slot])
                self._pos[slot] += 1
                self._last[slot] = tok
                if self._emit(req, tok, now):
                    finished.append(req)
        self._update_gauges()
        return finished

    def _account_step(self, dt: float, flops: float):
        """One batched step's seconds and model FLOPs (the fixed
        ``decode_flops`` numerator instead, when set) into the step
        histogram and counter, the lifetime MFU totals and the MFU
        gauge."""
        flops = self.decode_flops or flops
        self._m_step_s.observe(dt)
        self._m_steps.inc()
        self._flops_total += flops
        self._step_s_total += dt
        mfu = _costs.mfu(flops, dt, self._peak_flops)
        if mfu is not None:
            self._m_decode_mfu.set(mfu)

    def run_until_idle(self, max_steps: int = 100_000
                       ) -> List[EngineRequest]:
        """Drive ``step()`` until queue and slots drain; returns every
        request finished along the way."""
        done: List[EngineRequest] = []
        for _ in range(max_steps):
            if self.idle:
                return done
            done.extend(self.step())
        raise RuntimeError(f"engine did not drain in {max_steps} steps "
                           f"({self.queue_depth} queued, "
                           f"{self.active_count} active)")

    # -- observability -----------------------------------------------------
    def decode_mfu(self) -> Optional[float]:
        """Lifetime decode MFU: all decode steps' model FLOPs over their
        summed seconds times the card's declared peak. None on the CPU
        or before a step ran."""
        return _costs.mfu(self._flops_total, self._step_s_total,
                          self._peak_flops)

    def compile_counts(self) -> Dict[str, int]:
        """Programs the tracker charged to this engine's two step
        functions: CUDA graphs captured on the card, signatures seen on
        the CPU — the "one per (bucket, span) + one for decode"
        invariant of the JAX engine."""
        return {"prefill": self._tracker.count(PREFILL),
                "decode": self._tracker.count(DECODE)}

    def health(self) -> dict:
        doc = {"requests": int(self._m_requests.value()),
               "completed": sum(int(self._m_completed.value(reason=r))
                                for r in ("eos", "max_tokens")),
               "tokens": int(self._m_tokens.value()),
               "decode_steps": int(self._m_steps.value()),
               "queue_depth": self.queue_depth,
               "slots_active": self.active_count,
               "slots_total": self.batch,
               "cache_len": self.cache_len,
               "device": str(self.device),
               "prefill_buckets": list(self.buckets),
               "compile_counts": self.compile_counts(),
               "compile_seconds": {
                   "prefill": self._tracker.compile_seconds(PREFILL),
                   "decode": self._tracker.compile_seconds(DECODE)}}
        mfu = self.decode_mfu()
        if mfu is not None:
            doc["decode_mfu"] = mfu
        self._update_window_gauges()
        ttft = self._win_ttft.quantiles((0.5, 0.95, 0.99))
        doc["window"] = {
            "window_s": self._win_ttft.window_s,
            "requests": self._win_ttft.count(),
            "ttft_p50_s": round(ttft[0.5], 6),
            "ttft_p95_s": round(ttft[0.95], 6),
            "ttft_p99_s": round(ttft[0.99], 6),
            "tokens_per_sec_p50": round(self._win_tps.quantile(0.5), 3),
            # raw windowed TTFT samples, clock-free [age_s, value] (the
            # newest 512): quantiles of several engines pool from these
            "ttft_samples": [[round(a, 4), round(v, 6)] for a, v in
                             self._win_ttft.export_samples()[-512:]]}
        if self._win_ttft_tier:
            doc["window"]["tiers"] = {
                tier: {"requests": win.count(),
                       "ttft_p50_s": round(win.quantile(0.5), 6),
                       "ttft_p99_s": round(win.quantile(0.99), 6)}
                for tier, win in sorted(self._win_ttft_tier.items())}
        if self.slo is not None:
            burn = self._slo_burn_rate()
            doc["slo"] = {"ttft_s": self.slo.ttft_s,
                          "target": self.slo.target,
                          "window_s": self.slo.window_s,
                          "burn_threshold": self.slo.burn_threshold,
                          "ttft_burn_rate": round(burn, 4)}
            if burn > self.slo.burn_threshold:
                # degraded, not unhealthy: /healthz stays 200 while the
                # reason is machine-readable
                doc["status"] = "degraded"
                doc["degraded_reason"] = (
                    f"ttft_slo_burn_rate {burn:.2f} > "
                    f"{self.slo.burn_threshold} (p99 "
                    f"{ttft[0.99]:.4f}s vs slo {self.slo.ttft_s}s over "
                    f"{self._win_ttft.count()} requests)")
        return doc

    def requests_doc(self, k: int = 10) -> dict:
        """The ``/requests`` document: the request log's summary and the
        ``k`` slowest by TTFT with their attributed components."""
        doc = self.request_log.summary()
        doc["slowest_by_ttft"] = self.request_log.slowest(k, by="ttft_s")
        return doc

    def metrics_text(self) -> str:
        self._update_window_gauges()   # samples expire: refresh on read
        return self.metrics.render_prometheus()

    def serve(self, host: str = "127.0.0.1", port: int = 0):
        """``/metrics``, ``/healthz`` and ``/requests`` over this engine
        (``observe/health.HealthServer``); the caller owns ``close()``.
        The documents are host state: a scrape never reads the card."""
        from paddle_tpu_torch.observe.health import HealthServer
        return HealthServer(registry=self.metrics, health_fn=self.health,
                            host=host, port=port,
                            requests_fn=self.requests_doc,
                            metrics_fn=self.metrics_text)


def _params_device(params) -> torch.device:
    """The device of a parameter tree, read from its first tensor leaf
    (a quantized weight is a {"q8", "scale"} dict)."""
    node = params["embed"]
    while isinstance(node, dict):
        node = next(iter(node.values()))
    return node.device


def default_chunk_buckets(chunk_tokens: int) -> tuple:
    """Power-of-two chunk buckets up to ``chunk_tokens`` (always
    included): a prompt's tail chunk pads to the smallest covering
    bucket instead of the full chunk size."""
    out, b = {int(chunk_tokens)}, 8
    while b < chunk_tokens:
        out.add(b)
        b *= 2
    return tuple(sorted(out))


def paged_tracker(cache_len: int, chunk_tokens: int,
                  buckets: Sequence[int]) -> _ct.CompileTracker:
    """A compile tracker whose storm threshold clears the paged engine's
    legitimate ceiling: one prefill program per reachable (chunk bucket,
    context span) pair."""
    spans = max(1, int(cache_len) // int(chunk_tokens))
    return _ct.CompileTracker(storm_threshold=spans * len(tuple(buckets))
                              + 2)


class PagedDecodeEngine(DecodeEngine):
    """Block-table continuous batching: paged KV, chunked prefill,
    prefix cache, tiers, tenant budgets and preempt-to-blocks.

    - **chunked prefill** — prompts are prefilled in ``chunk_tokens``
      chunks, ONE chunk per ``step()`` while any slot decodes, so a long
      prompt never stalls in-flight decoders for its whole length;
    - **prefix cache** — full prompt blocks are published under
      content-chain hashes (``serving/blocks``) as their chunk lands; a
      later prompt sharing the prefix maps the cached blocks into its
      page table (refcount bump) and skips their prefill. Hits are
      capped to whole chunks, so a hit replays the cold prefill's exact
      chunk grid;
    - **reservation** — admission reserves a request's worst-case block
      count up front and pages are allocated lazily, so decode never
      stalls mid-flight on an empty pool;
    - **tiers** — ``tier="latency"`` admits ahead of ``"batch"`` and,
      when its reservation does not fit, preempts batch-tier victims to
      blocks (``_preempt``); preempted requests resume ahead of fresh
      batch admissions;
    - **tenant budgets** — a tenant's reserved tokens in flight are
      capped (``set_tenant_budget``); an exhausted tenant's requests
      wait and are skipped, never block the others, never reject;
    - **prefix mobility** — ``export_prefix`` / ``import_prefix`` move
      a prompt's cached prefix blocks between pools over the PTKV wire;
      with ``tiers`` (a ``serving.tiers.TieredStore`` or its kwargs) an
      evicted cached block is demoted to host DRAM / disk and promoted
      back when a request that needs it is admitted.

    Program discipline: one prefill program per (chunk bucket, context
    span) pair and one decode program (``compile_counts()``).
    """

    def __init__(self, prefill: Callable, decode: Callable, params,
                 cache, *, batch: int, cache_len: int, block_size: int,
                 device, cfg, num_blocks: Optional[int] = None,
                 chunk_tokens: int = 64, seed: Optional[int] = None,
                 tracker: Optional[_ct.CompileTracker] = None,
                 tenant_budgets: Optional[Dict[str, int]] = None,
                 slo: Optional[SloConfig] = None, tiers=None,
                 chunk_buckets: Optional[Sequence[int]] = None,
                 registry: Optional[_metrics.Registry] = None,
                 decode_flops: Optional[float] = None):
        bs = int(block_size)
        if bs < 1 or cache_len % bs:
            raise ValueError(f"cache_len {cache_len} must be a positive "
                             f"multiple of block_size {bs}")
        chunk_tokens = min(int(chunk_tokens), int(cache_len))
        if chunk_tokens < 1 or chunk_tokens % bs:
            raise ValueError(f"chunk_tokens {chunk_tokens} must be a "
                             f"positive multiple of block_size {bs}")
        if cache_len % chunk_tokens:
            raise ValueError(f"cache_len {cache_len} must be a multiple "
                             f"of chunk_tokens {chunk_tokens}")
        buckets = (tuple(chunk_buckets) if chunk_buckets is not None
                   else default_chunk_buckets(chunk_tokens))
        if tracker is None and not isinstance(decode, graphs.StepProgram):
            tracker = paged_tracker(cache_len, chunk_tokens, buckets)
        super().__init__(prefill, decode, params, cache, batch=batch,
                         cache_len=cache_len, buckets=buckets,
                         device=device, cfg=cfg, seed=seed, tracker=tracker,
                         slo=slo, registry=registry,
                         decode_flops=decode_flops)
        self.block_size = bs
        self.pages_per_slot = cache_len // bs
        self.num_blocks = int(num_blocks if num_blocks is not None
                              else batch * self.pages_per_slot)
        self.chunk_tokens = chunk_tokens
        self.pool = _blocks.BlockPool(self.num_blocks, bs)
        # the pool's storage ("none" = model dtype; "int8"/"int4" carry
        # fp32 scale tables beside the codes), read from its arrays
        self.kv_dtype = transformer.pool_kv_dtype(cache, cfg)
        self.kv_bytes_per_token = transformer.kv_pool_bytes_per_token(
            cfg, self.kv_dtype)
        self.pool_bytes = self.kv_bytes_per_token * self.num_blocks * bs
        B = self.batch
        # the page table: host copy, and the device table the decode
        # program reads where it lies, uploaded when the host copy
        # changed. Unallocated entries stay 0 and are only read under
        # the attention mask or as padded rows
        self._pages = np.zeros((B, self.pages_per_slot), np.int32)
        self._pages_dev = graphs.Staged(self._pages.shape, torch.int32,
                                        self.device)
        self._pages_dirty = True
        self._nalloc = [0] * B              # pages allocated per slot
        self._slot_blocks: List[List[int]] = [[] for _ in range(B)]
        self._slot_hashes: List[List[bytes]] = [[] for _ in range(B)]
        self._slot_off = [0] * B            # next prompt token to prefill
        self._slot_reserved = [0] * B       # unallocated reservation left
        self._slot_prefill_s = [0.0] * B    # seconds across chunks
        self._prefilling: deque = deque()   # slots mid-prompt, round-robin
        self._evictions_seen = 0
        # -- multi-tenant scheduling state -------------------------------
        # budgets cap a tenant's RESERVED tokens in flight (admitted,
        # unfinished requests' prompt + max_new); exhaustion queues the
        # tenant's requests and other tenants admit past them
        self.tenant_budgets: Dict[str, int] = dict(tenant_budgets or {})
        self._tenant_used: Dict[str, int] = {}
        self._preempted: deque = deque()    # preempted, awaiting resume
        self._slot_forced: List[deque] = [deque() for _ in range(B)]
        reg = self.metrics
        self._m_preempts = reg.counter(
            "engine_preemptions_total", "batch-tier victims preempted "
            "to blocks (pages published to the prefix cache) so a "
            "latency-tier request could reserve")
        self._m_resumes = reg.counter(
            "engine_resumes_total", "preempted requests resumed, by "
            "mode: remap = every snapshot block still cached (host "
            "re-mapping only), replay = eviction fallback (cache-hit "
            "chunked prefill + forced decode replay)")
        self._m_tenant_tokens = reg.gauge(
            "engine_tenant_tokens_in_flight", "reserved tokens (prompt + "
            "max_new of live requests) per budgeted tenant — what the "
            "token budget caps")
        self._m_blocks_in_use = reg.gauge(
            "engine_blocks_in_use", "pool blocks referenced by live "
            "requests")
        self._m_blocks_free = reg.gauge(
            "engine_blocks_free", "pool blocks holding nothing")
        self._m_blocks_cached = reg.gauge(
            "engine_blocks_cached", "refcount-0 prefix-cache blocks "
            "parked in the LRU (evictable)")
        self._m_prefix_hits = reg.counter(
            "engine_prefix_cache_hit_blocks_total",
            "prompt blocks served from the prefix cache")
        self._m_prefix_miss = reg.counter(
            "engine_prefix_cache_miss_blocks_total",
            "full prompt blocks that had to be prefilled")
        self._m_evictions = reg.counter(
            "engine_prefix_cache_evictions_total",
            "cached blocks evicted LRU-oldest-first")
        self._m_chunks = reg.counter(
            "engine_prefill_chunks_total", "prefill chunks executed")
        self._m_stall = reg.histogram(
            "engine_prefill_stall_seconds", "time in-flight decoders "
            "waited on one prefill chunk", buckets=_LATENCY_BUCKETS)
        self._m_kv_bytes = reg.gauge(
            "engine_kv_bytes_per_token", "pool bytes one resident token "
            "costs across all layers (k + v, and their scales in a "
            "quantized pool)")
        self._m_kv_bytes.set(self.kv_bytes_per_token)
        self._m_kv_exported = reg.counter(
            "engine_kv_blocks_exported_total", "prefix-cache blocks "
            "serialized out over the transfer wire (export_prefix)")
        self._m_kv_imported = reg.counter(
            "engine_kv_blocks_imported_total", "transferred or promoted "
            "blocks adopted into the pool through the prefix-cache "
            "publish path (import_prefix, tier promotion)")
        self._m_tier_hits = reg.counter(
            "engine_prefix_tier_hit_blocks_total", "prompt blocks "
            "served per tier (label tier): hbm = ordinary prefix-cache "
            "hit, dram/disk = spilled block adopted again at admission")
        self._m_tier_miss = reg.counter(
            "engine_prefix_tier_miss_blocks_total", "prefix lookups "
            "that missed a tier (label tier), once per request's "
            "promotion walk: a cold block misses hbm, dram and disk")
        # -- spill store (the card's pool -> host DRAM -> disk) ----------
        # a serving.tiers.TieredStore, or the kwargs of one
        # ({"dram_bytes": ..., "disk_bytes": ..., "disk_dir": ...});
        # None disables spill: eviction drops the block
        self.tiers = None
        if tiers is not None:
            self.tiers = (tiers if isinstance(tiers, _tiers.TieredStore)
                          else _tiers.TieredStore(registry=reg,
                                                  **dict(tiers)))
            self.pool.on_evict = self._demote_block

    # -- construction ------------------------------------------------------
    @classmethod
    def from_params(cls, params, cfg, *, batch: int, cache_len: int,
                    block_size: int = 16,
                    num_blocks: Optional[int] = None,
                    chunk_tokens: int = 64,
                    chunk_buckets: Optional[Sequence[int]] = None,
                    seed: Optional[int] = None,
                    kv_dtype: Optional[str] = None, device=None,
                    tracker: Optional[_ct.CompileTracker] = None,
                    tenant_budgets: Optional[Dict[str, int]] = None,
                    slo: Optional[SloConfig] = None, tiers=None,
                    registry: Optional[_metrics.Registry] = None,
                    decode_flops: Optional[float] = None):
        """Engine over live ``params`` (from ``transformer.init_params``,
        ``params_from_numpy`` or the int8-weight
        ``io/lm_serving.quantize_lm_params``) with a fresh pool of
        ``num_blocks`` blocks (default: ``batch`` full-length slots) in
        the storage ``kv_dtype`` names (None: the model dtype; "int8" or
        "int4": quantized, see ``transformer.init_block_pool``), and the
        step programs of ``sampling.paged_step_fns`` under ``tracker``
        (default: a fresh one per engine), with the TTFT ``slo``, the
        spill ``tiers``, the chunk buckets (default: the powers of two
        up to ``chunk_tokens``, and it), the metrics ``registry`` and the
        fixed per-step ``decode_flops`` of the constructor. Runs on the
        card unless ``device="cpu"``; ``params`` must already live
        there."""
        from paddle_tpu_torch.serving import sampling
        device = place.resolve_device(device)
        where = _params_device(params)
        if where != device:
            raise ValueError(f"params live on {where}, the engine runs on "
                             f"{device}")
        if cache_len > cfg.max_len:
            raise ValueError(f"cache_len {cache_len} exceeds cfg.max_len "
                             f"{cfg.max_len}")
        if block_size < 1 or cache_len % block_size:
            raise ValueError(f"cache_len {cache_len} must be a positive "
                             f"multiple of block_size {block_size}")
        nb = int(num_blocks if num_blocks is not None
                 else batch * (cache_len // block_size))
        pool = transformer.init_block_pool(cfg, nb, block_size,
                                           kv_dtype=kv_dtype, device=device)
        if tracker is None:
            chunk = min(int(chunk_tokens), int(cache_len))
            tracker = paged_tracker(cache_len, chunk, chunk_buckets
                                    or default_chunk_buckets(chunk))
        prefill_fn, decode_fn = sampling.paged_step_fns(
            cfg, block_size, tracker=tracker)
        return cls(prefill_fn, decode_fn, params, pool, batch=batch,
                   cache_len=cache_len, block_size=block_size,
                   num_blocks=nb, chunk_tokens=chunk_tokens, device=device,
                   cfg=cfg, seed=seed, tracker=tracker,
                   tenant_budgets=tenant_budgets, slo=slo, tiers=tiers,
                   chunk_buckets=chunk_buckets, registry=registry,
                   decode_flops=decode_flops)

    # -- request API -------------------------------------------------------
    def set_tenant_budget(self, tenant: str, tokens: Optional[int]):
        """Cap (or with ``None`` uncap) ``tenant``'s reserved tokens in
        flight. Takes effect at the next admission: live requests are
        never evicted by a budget change. Later submissions whose own
        prompt + max_new exceeds the cap are rejected
        (``exceeds_budget``); a request already queued above a lowered
        cap waits until it is raised."""
        if tokens is None:
            self.tenant_budgets.pop(tenant, None)
            self._m_tenant_tokens.remove(tenant=tenant)
        else:
            self.tenant_budgets[str(tenant)] = int(tokens)

    def submit(self, prompt, max_new: int, *, temperature: float = 0.0,
               top_k: int = 0, eos_id: Optional[int] = None,
               tenant: str = "default", tier: str = "batch",
               trace: Optional[str] = None) -> EngineRequest:
        """Queue one request. Any prompt with ``len(prompt) + max_new <=
        cache_len`` is accepted and prefilled in chunks.
        ``tier="latency"`` admits ahead of batch-tier work and may
        preempt a batch victim's blocks under pool pressure; ``tenant``
        charges the request's worst-case tokens against that tenant's
        budget (exhaustion queues, never rejects); ``trace`` adopts a
        caller's trace id instead of minting ``eng<N>.r<rid>``."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        rid = next(self._ids)
        self._validate_submit(rid, prompt, max_new, tier)
        need = -(-(prompt.size + max_new) // self.block_size)
        if need > self.num_blocks:
            # a request needing more blocks than the pool has could
            # never reserve and would block the FIFO head forever
            raise self._reject(
                rid, "exceeds_pool", f"submit: {prompt.size} prompt + "
                f"{max_new} new tokens need {need} blocks, exceeding the "
                f"pool's {self.num_blocks}")
        budget = self.tenant_budgets.get(str(tenant))
        if budget is not None and prompt.size + max_new > budget:
            # a request whose own charge exceeds its tenant's cap could
            # never admit: impossibility rejects, exhaustion queues
            raise self._reject(
                rid, "exceeds_budget", f"submit: {prompt.size} prompt + "
                f"{max_new} new tokens exceed tenant {tenant!r}'s budget "
                f"of {budget}")
        req = EngineRequest(
            rid=rid, prompt=prompt, max_new=int(max_new),
            temperature=float(temperature), top_k=int(top_k),
            eos_id=eos_id, tenant=str(tenant), tier=str(tier),
            submit_t=time.perf_counter(),
            trace_id=str(trace) if trace else "")
        return self._enqueue(req)

    # -- prefix transfer (the PTKV wire) -----------------------------------
    def prefix_digests(self, prompt) -> List[bytes]:
        """Content-chain digests of ``prompt``'s transferable prefix: the
        chunk-aligned full blocks admission can serve as hits (the final
        chunk is always computed here: it produces the logits)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        per = self.chunk_tokens // self.block_size
        usable = ((int(prompt.size) - 1) // self.chunk_tokens) * per
        if usable <= 0:
            return []
        return _blocks.prompt_block_hashes(prompt,
                                           self.block_size)[:usable]

    def _checked_slabs(self, digest: bytes, payload: bytes):
        """The slabs of a spill tier's single-block ``payload`` for
        ``digest``, stamp-checked against this pool; a corrupt or
        mismatched payload is quarantined and gives None (a miss)."""
        try:
            meta, items = _transfer.deserialize_blocks(payload)
            _transfer.check_pool_match(meta, self.cache, self.block_size,
                                       self.kv_dtype)
            if len(items) != 1 or items[0][0] != digest:
                raise ValueError("spill payload digest mismatch")
        except (ValueError, KeyError):
            self.tiers.quarantine(digest)
            return None
        return items[0][1]

    def export_prefix(self, prompt, trace: Optional[str] = None,
                      partial: bool = False) -> Optional[bytes]:
        """Serialize ``prompt``'s transferable prefix out of this pool.
        Every prefix block must be published (serve the prompt first,
        e.g. ``submit(prompt, max_new=1)`` and drain). None when the
        prompt has no transferable prefix or a block was evicted: the
        receiver then prefills cold, slower but identical.

        ``partial=True`` serves the LEADING run from wherever it lives —
        pool rows and spilled DRAM/disk payloads in one chain — and
        stops at the first miss; None only when that run is empty."""
        digests = self.prefix_digests(prompt)
        if not digests:
            return None
        chain = []              # (digest, pool block or None, tier slabs)
        for h in digests:
            b = self.pool.lookup(h)
            if b is not None:
                chain.append((h, b, None))
                continue
            if not partial:
                return None
            got = self.tiers.get(h) if self.tiers is not None else None
            slabs = (self._checked_slabs(h, got[1]) if got is not None
                     else None)
            if slabs is None:
                break
            chain.append((h, None, slabs))
        if not chain:
            return None
        read = iter(_transfer.read_blocks(
            self.cache, [b for _, b, _ in chain if b is not None],
            self.block_size))
        items = [(h, next(read) if b is not None else slabs)
                 for h, b, slabs in chain]
        payload = _transfer.serialize_raw_blocks(
            _transfer.pool_meta(self.cache, self.block_size,
                                self.kv_dtype), items, trace=trace)
        self._m_kv_exported.inc(len(items))
        return payload

    def _adopt(self, digest: bytes, chain_blocks: set) -> Optional[int]:
        """Allocate a block for ``digest`` and publish it (refcount 0,
        parked in the LRU, served as a hit from here on); None when the
        pool cannot take one more block without evicting a block of
        this chain (a chain whose head is evicted serves no hits)."""
        if not self.pool.can_reserve(1):
            return None
        if (self.pool.free_count == 0
                and self.pool.lru_oldest() in chain_blocks):
            return None
        self.pool.reserve(1)
        b = self.pool.alloc()
        self.pool.publish(digest, b)
        self.pool.release(b)
        chain_blocks.add(b)
        return b

    def import_prefix(self, payload: bytes) -> int:
        """Adopt serialized prefix blocks into this pool through the
        prefix-cache publish path. Stamp-checked: a payload whose layout,
        kv_dtype or slab shapes differ from this pool's raises. Walks
        the chain in order, skipping digests already cached, and stops
        when the pool cannot take another block. The slabs are written
        in place (one ``index_copy_`` per pool leaf): every pool tensor
        keeps its address, so the captured graphs read the adopted rows.
        Returns the blocks adopted; they park refcount-0 in the LRU.
        Generation over them equals the cold run token for token."""
        meta, blocks = _transfer.deserialize_blocks(payload)
        _transfer.check_pool_match(meta, self.cache, self.block_size,
                                   self.kv_dtype)
        chain_blocks = set()    # pool blocks of this chain's digests
        pending = []
        for digest, arrays in blocks:
            existing = self.pool.lookup(digest)
            if existing is not None:
                chain_blocks.add(existing)
                continue
            b = self._adopt(digest, chain_blocks)
            if b is None:
                break
            pending.append((b, arrays))
        # one write per pool leaf for the whole chain: nothing reads the
        # pool between the publishes and here (one engine thread)
        _transfer.write_blocks(self.cache, pending, self.block_size)
        if pending:
            self._m_kv_imported.inc(len(pending))
        if meta.get("trace"):
            # the payload carried the sender's trace context: mark the
            # adoption on that track
            _chrome.record_event(
                "prefix_import", self._wall(time.perf_counter()), "n",
                str(meta["trace"]),
                args={"blocks": len(pending), "chain": len(blocks)})
        return len(pending)

    # -- tiered spill (the card's pool -> host DRAM -> disk) ---------------
    def _demote_block(self, block: int, digest: bytes):
        """``pool.on_evict``: serialize the evicted cached block onto the
        wire (the spill format) and park it in the tiers. Fires inside
        ``alloc()`` before the new holder's rows are written (by a later
        step on the current stream); the copy to the host is blocking on
        that stream, so the bytes still match the digest. A failed spill
        is a lost cache entry, as eviction was before tiers, never an
        error on the allocation path."""
        try:
            payload = _transfer.serialize_blocks(
                self.cache, [block], [digest], self.block_size,
                self.kv_dtype)
            self.tiers.put(digest, payload)
        except Exception as e:  # noqa: BLE001 — a lost entry, no more
            log.warning("demoting block %d (%s) failed, the entry is "
                        "lost: %s: %s", block, digest.hex(),
                        type(e).__name__, e)

    def _promote_for(self, req: EngineRequest):
        """Adopt ``req``'s spilled prefix from the DRAM/disk tiers into
        the pool once its admission is certain, so the plan sees the
        promoted blocks as ordinary prefix-cache hits. Walks the chain
        to the chunk-aligned hit cap and stops at the first miss. Runs
        once per request; a corrupt or mismatched payload is quarantined
        and is a miss."""
        req.tier_promote_done = True
        bs = self.block_size
        if req.block_hashes is None:
            req.block_hashes = _blocks.prompt_block_hashes(req.prompt, bs)
        per = self.chunk_tokens // bs
        usable = ((int(req.prompt.size) - 1) // self.chunk_tokens) * per
        chain_blocks = set()
        pending = []
        for h in req.block_hashes[:usable]:
            existing = self.pool.lookup(h)
            if existing is not None:
                chain_blocks.add(existing)
                continue
            self._m_tier_miss.inc(tier="hbm")
            got = self.tiers.get(h)
            if got is None:
                self._m_tier_miss.inc(tier="dram")
                self._m_tier_miss.inc(tier="disk")
                break
            tier = got[0]
            if tier == "disk":
                self._m_tier_miss.inc(tier="dram")
            slabs = self._checked_slabs(h, got[1])
            if slabs is None:
                break
            b = self._adopt(h, chain_blocks)
            if b is None:
                break
            pending.append((b, slabs))
            self._m_tier_hits.inc(tier=tier)
        _transfer.write_blocks(self.cache, pending, bs)
        req.tier_promoted_blocks = len(pending)
        if pending:
            self._m_kv_imported.inc(len(pending))
            self._ev(req, "tier_promote", "n", time.perf_counter(),
                     blocks=len(pending))

    @property
    def preempted_count(self) -> int:
        """Preempted requests parked awaiting resume."""
        return len(self._preempted)

    @property
    def idle(self) -> bool:
        return (not self._queue and not self._preempted
                and not self._prefilling and not self._active.any())

    # -- scheduler ---------------------------------------------------------
    def _alloc_page(self, slot: int):
        b = self.pool.alloc()
        self._pages[slot, self._nalloc[slot]] = b
        self._pages_dirty = True
        self._nalloc[slot] += 1
        self._slot_blocks[slot].append(b)
        self._slot_reserved[slot] -= 1

    def _map_slot(self, slot: int, blocks: List[int]):
        """A fresh page table for ``slot`` holding ``blocks``."""
        self._pages[slot, :] = 0
        self._pages[slot, :len(blocks)] = blocks
        self._pages_dirty = True
        self._nalloc[slot] = len(blocks)
        self._slot_blocks[slot] = list(blocks)

    def _release_slot(self, slot: int):
        """Drop every block and the unallocated reservation of
        ``slot``."""
        for b in self._slot_blocks[slot]:
            self.pool.release(b)
        self.pool.unreserve(self._slot_reserved[slot])
        self._slot_blocks[slot] = []
        self._slot_hashes[slot] = []
        self._slot_reserved[slot] = 0
        self._nalloc[slot] = 0
        self._slot_forced[slot] = deque()
        self._pages[slot, :] = 0
        self._pages_dirty = True

    # -- multi-tenant admission / preemption -------------------------------
    def _charge(self, req: EngineRequest) -> int:
        """Worst-case tokens a live request holds against its tenant's
        budget: the prompt + max_new its block reservation backs."""
        return int(req.prompt.size) + int(req.max_new)

    def _budget_ok(self, req: EngineRequest) -> bool:
        budget = self.tenant_budgets.get(req.tenant)
        if budget is None:
            return True
        return self._tenant_used.get(req.tenant, 0) \
            + self._charge(req) <= budget

    def _track_tenant(self, req: EngineRequest, delta: int):
        used = max(self._tenant_used.get(req.tenant, 0) + delta, 0)
        if used:
            self._tenant_used[req.tenant] = used
        else:
            # prune at zero: tenant names arrive unvalidated, so dead
            # entries would grow host state one row per name ever seen
            self._tenant_used.pop(req.tenant, None)
        if req.tenant in self.tenant_budgets:
            # gauge samples only for configured budgets (bounded)
            self._m_tenant_tokens.set(used, tenant=req.tenant)

    def _admission_plan(self, req: EngineRequest):
        """(hashes, hits, need, revive) for admitting ``req`` now."""
        bs = self.block_size
        Tp = req.prompt.size
        if req.block_hashes is None:     # a pure function of the prompt
            req.block_hashes = _blocks.prompt_block_hashes(req.prompt, bs)
        hashes = req.block_hashes
        # hits are capped CHUNK-aligned, and the last prompt token is
        # always recomputed (the final chunk must produce logits)
        per = self.chunk_tokens // bs
        usable = ((Tp - 1) // self.chunk_tokens) * per
        hits: List[int] = []
        for h in hashes[:usable]:
            b = self.pool.lookup(h)
            if b is None:
                break
            hits.append(b)
        hits = hits[:len(hits) // per * per]
        need = -(-(Tp + req.max_new) // bs) - len(hits)
        # refcount-0 hits leave the allocatable set when shared: the
        # reservation must cover them too
        revive = sum(1 for b in hits if self.pool.refcount(b) == 0)
        return hashes, hits, need, revive

    def _try_admit(self, req: EngineRequest) -> bool:
        """Admit ``req`` if a slot is free and its reservation fits."""
        if not self._free:
            return False
        hashes, hits, need, revive = self._admission_plan(req)
        if not self.pool.can_reserve(need + revive):
            return False
        # promote only once admission is certain (a promoted block parks
        # refcount-0 in the LRU, where a long wait would see it evicted
        # again). Each promoted block moves free -> LRU and its digest
        # need -> revive, so the verdict above stands; only the hits
        # change
        if self.tiers is not None and not req.tier_promote_done:
            self._promote_for(req)
            if req.tier_promoted_blocks:
                hashes, hits, need, revive = self._admission_plan(req)
        slot = self._free.popleft()
        self.pool.reserve(need)
        for b in hits:
            self.pool.share(b)
        self._map_slot(slot, hits)
        self._slot_hashes[slot] = hashes
        self._slot_off[slot] = len(hits) * self.block_size
        self._slot_reserved[slot] = need
        self._slot_prefill_s[slot] = 0.0
        req.prefix_hit_tokens = len(hits) * self.block_size
        self._m_prefix_hits.inc(len(hits))
        # the blocks promotion just adopted were dram/disk hits (counted
        # there); the rest were in the pool all along
        hbm_hits = len(hits) - req.tier_promoted_blocks
        req.tier_promoted_blocks = 0
        if hbm_hits > 0:
            self._m_tier_hits.inc(hbm_hits, tier="hbm")
        now = time.perf_counter()
        req.prefill_t = now
        if req.preemptions == 0:
            # a re-admission would observe the whole submit -> now span
            # again: the histogram keeps each request's first wait
            self._m_wait_s.observe(now - req.submit_t)
        self._ev(req, "queued", "e", now)
        self._ev(req, "admitted", "n", now, slot=slot,
                 queue_wait_ms=round(1000 * (now - req.submit_t), 3),
                 hit_blocks=len(hits), reserved_blocks=need)
        self._ev(req, "prefill", "b", now)
        req.slot, req.status = slot, "prefilling"
        self._slot_req[slot] = req
        self._track_tenant(req, self._charge(req))
        if req.replay is not None:
            # preempt-resume eviction fallback: the prompt prefills
            # again on its cold chunk grid (surviving chunks are cache
            # hits), then the emitted tokens replay through decode steps
            self._slot_forced[slot] = deque(req.replay)
            req.replay = None
        self._prefilling.append(slot)
        return True

    def _admit(self):
        """Tiered, budget-aware admission, in priority classes:

        1. the latency-tier queue (FIFO): a head that cannot reserve may
           preempt batch-tier victims; while it stays blocked nothing
           below it admits;
        2. preempted requests (oldest first), ahead of fresh batch
           admissions, so preemption is a delay, not a demotion;
        3. the batch-tier queue (FIFO), head-of-line on its reservation.

        In every class a request whose tenant's budget is exhausted is
        skipped, not waited on: one tenant's burst does not block the
        others."""
        blocked = False
        for req in [r for r in self._queue if r.tier == "latency"]:
            if not self._budget_ok(req):
                continue
            admitted = self._try_admit(req)
            if not admitted and self._preemption_feasible(req):
                while not admitted and self._preempt_victim():
                    admitted = self._try_admit(req)
            if not admitted:
                blocked = True
                break
            self._queue.remove(req)
        if not blocked:
            for req in list(self._preempted):
                if not self._budget_ok(req):
                    continue
                if self._try_resume(req) is None:
                    blocked = True
                    break
                self._preempted.remove(req)
            if not blocked:
                for req in [r for r in self._queue if r.tier == "batch"]:
                    if not self._budget_ok(req):
                        continue
                    if not self._try_admit(req):
                        break
                    self._queue.remove(req)
        self._m_queue.set(len(self._queue) + len(self._preempted))

    def _preemption_feasible(self, req: EngineRequest) -> bool:
        """Could preempting batch-tier work ever free enough for
        ``req``? Its worst case against every block not held by
        latency-tier requests."""
        held = sum(self._nalloc[s] + self._slot_reserved[s]
                   for s, r in enumerate(self._slot_req)
                   if r is not None and r.tier != "batch")
        need = -(-(req.prompt.size + req.max_new) // self.block_size)
        return need <= self.num_blocks - held

    def _preempt_victim(self) -> bool:
        """Preempt ONE batch-tier request: the one holding the most
        blocks (allocated + reserved: what preemption frees), ties to
        the most recently admitted. False when there is none."""
        best, best_key = -1, None
        for slot, req in enumerate(self._slot_req):
            if req is None or req.tier != "batch":
                continue
            if req.status not in ("prefilling", "running"):
                continue
            key = (self._nalloc[slot] + self._slot_reserved[slot],
                   req.prefill_t or 0.0)
            if best_key is None or key > best_key:
                best, best_key = slot, key
        if best < 0:
            return False
        self._preempt(best)
        return True

    def _preempt(self, slot: int):
        """Preempt-to-blocks: snapshot the slot's decode cursor, publish
        every written block into the prefix cache (the prompt's chain
        continued over the generated tokens, the partial tail block
        under its own digest), release the pages and the reservation.
        No device memory moves. A victim still prefilling re-queues at
        the head: its published chunks are cache hits when it comes
        back."""
        req = self._slot_req[slot]
        now = time.perf_counter()
        bs = self.block_size
        blocks = list(self._slot_blocks[slot])
        if req.status == "running":
            if req.decode_open:
                self._ev(req, "decode", "e", now)
                req.decode_open = False
            pos = int(self._pos[slot])
            seq = np.concatenate([req.prompt,
                                  np.asarray(req.tokens, np.int32)])
            nfull = pos // bs
            hashes = _blocks.prompt_block_hashes(seq[:nfull * bs], bs)
            tail_len = pos % bs
            tail_hash = None
            if tail_len:
                parent = hashes[-1] if hashes else _blocks.ROOT_HASH
                tail_hash = _blocks.chain_hash(parent, seq[nfull * bs:pos])
            for j, h in enumerate(hashes):
                self.pool.publish(h, blocks[j])
            if tail_hash is not None:
                self.pool.publish(tail_hash, blocks[nfull])
            req.snapshot = {"hashes": hashes, "tail_hash": tail_hash,
                            "pos": pos, "last": int(self._last[slot]),
                            "forced": list(self._slot_forced[slot])}
            published = nfull + (1 if tail_len else 0)
            self._active[slot] = False
        else:                       # mid-prefill: the published chunk
            published = 0           # blocks already carry their digests
            self._prefilling.remove(slot)
            self._ev(req, "prefill", "e", now)
            if self._slot_forced[slot]:
                # a replay-resuming victim preempted again mid-prefill:
                # its history must survive the re-queue, or the next
                # admission would emit delivered tokens again
                req.replay = list(req.tokens)
        self._release_slot(slot)
        self._slot_off[slot] = 0
        self._slot_req[slot] = None
        self._free.append(slot)
        self._track_tenant(req, -self._charge(req))
        req.slot = -1
        req.preemptions += 1
        self._m_preempts.inc()
        self._ev(req, "preempted", "n", now, tokens=len(req.tokens),
                 blocks_published=published, was=req.status)
        # queued again (resume line or arrival queue): a fresh "queued"
        # slice keeps the next admission's "queued e" balanced
        self._ev(req, "queued", "b", now)
        if req.status == "running":
            req.status = "preempted"
            self._preempted.append(req)
        else:
            req.status = "queued"
            self._queue.appendleft(req)

    def _try_resume(self, req: EngineRequest) -> Optional[str]:
        """Resume one preempted request. ``"remap"``: every snapshot
        digest still resolves in the prefix cache — share the blocks
        back into a fresh page table, un-publish the partial tail
        (decode writes into it again), restore the cursor; no device
        work. ``"replay"``: some block was evicted — admit again through
        the chunked prefill (the prompt's surviving chunks are hits) and
        force the emitted tokens through decode steps; the programs are
        the same as the first run's, so the continuation is the same.
        ``None``: blocked on a slot or a reservation."""
        if not self._free:
            return None
        snap = req.snapshot
        bs = self.block_size
        blocks: List[int] = []
        ok = True
        for h in snap["hashes"]:
            b = self.pool.lookup(h)
            if b is None:
                ok = False
                break
            blocks.append(b)
        tail_b = None
        if ok and snap["tail_hash"] is not None:
            tail_b = self.pool.lookup(snap["tail_hash"])
            # the tail block is written again: it must be ours alone
            # (refcount 0, parked in the LRU), else fall back to replay
            if tail_b is None or self.pool.refcount(tail_b) != 0:
                ok = False
            else:
                blocks.append(tail_b)
        if ok:
            need = -(-(req.prompt.size + req.max_new) // bs) - len(blocks)
            revive = sum(1 for b in blocks if self.pool.refcount(b) == 0)
            if not self.pool.can_reserve(need + revive):
                return None
            now = time.perf_counter()
            slot = self._free.popleft()
            self.pool.reserve(need)
            for b in blocks:
                self.pool.share(b)
            if tail_b is not None:
                self.pool.unpublish(tail_b)
            self._map_slot(slot, blocks)
            self._slot_hashes[slot] = req.block_hashes or \
                _blocks.prompt_block_hashes(req.prompt, bs)
            self._slot_off[slot] = req.prompt.size
            self._slot_reserved[slot] = need
            self._slot_forced[slot] = deque(snap["forced"])
            req.slot, req.status = slot, "running"
            self._slot_req[slot] = req
            self._active[slot] = True
            self._pos[slot] = snap["pos"]
            self._last[slot] = snap["last"]
            self._temp[slot] = req.temperature
            self._topk[slot] = req.top_k
            self._track_tenant(req, self._charge(req))
            req.snapshot = None
            self._ev(req, "queued", "e", now)
            if not req.decode_open:
                self._ev(req, "decode", "b", now)
                req.decode_open = True
            self._m_resumes.inc(mode="remap")
            self._ev(req, "resumed", "n", now, mode="remap",
                     blocks=len(blocks))
            return "remap"
        # eviction fallback: forced replay through normal admission
        req.replay = list(req.tokens)
        if not self._try_admit(req):
            req.replay = None           # still parked: keep the snapshot
            return None
        req.snapshot = None
        self._m_resumes.inc(mode="replay")
        self._ev(req, "resumed", "n", time.perf_counter(), mode="replay",
                 replay_tokens=len(req.tokens))
        return "replay"

    def _draft_chunk_hook(self, slot: int, padded: np.ndarray, c: int,
                          npages: int):
        """No-op on the paged engine; the spec engine mirrors the chunk
        into the draft pool here."""

    def _try_adopt(self, slot: int) -> bool:
        """Map the slot's NEXT chunk straight onto cached blocks when
        every block of it is already published (a concurrent request
        with the same prefix prefilled it after this one was admitted).
        Only whole chunks below the hit cap qualify, so the chunk grid
        stays the cold prefill's."""
        req = self._slot_req[slot]
        off = self._slot_off[slot]
        bs, K = self.block_size, self.chunk_tokens
        cap = ((req.prompt.size - 1) // K) * K
        if off % K or off >= cap:
            return False
        hashes = self._slot_hashes[slot]
        blocks = []
        for j in range(off // bs, (off + K) // bs):
            b = self.pool.lookup(hashes[j])
            if b is None:
                return False
            blocks.append(b)
        for b in blocks:
            self.pool.share(b)
            self._pages[slot, self._nalloc[slot]] = b
            self._nalloc[slot] += 1
            self._slot_blocks[slot].append(b)
        self._pages_dirty = True
        self.pool.unreserve(len(blocks))
        self._slot_reserved[slot] -= len(blocks)
        self._slot_off[slot] = off + K
        req.prefix_hit_tokens += K
        self._m_prefix_hits.inc(len(blocks))
        self._m_tier_hits.inc(len(blocks), tier="hbm")
        self._ev(req, "prefix_adopt", "n", time.perf_counter(),
                 hit_blocks=len(blocks), tokens=K)
        return True

    def _prefill_chunk(self, finished: List[EngineRequest]):
        slot = self._prefilling.popleft()
        req = self._slot_req[slot]
        while self._try_adopt(slot):
            pass
        bs = self.block_size
        off = self._slot_off[slot]
        c = min(req.prompt.size - off, self.chunk_tokens)
        bucket = ragged.bucket_length(c, self.buckets)
        end_page = -(-(off + c) // bs)
        while self._nalloc[slot] < end_page:
            self._alloc_page(slot)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :c] = req.prompt[off:off + c]
        # the page-vector prefix covering context + chunk: its length is
        # the program's key beside the bucket; entries past the
        # allocated count back only padded rows, which never write
        npages = off // bs + -(-bucket // bs)
        stalled = bool(self._active.any())
        t0 = time.perf_counter()
        tok, self.cache = self._prefill_fn(
            self.params, self.cache, padded, np.int32(c),
            self._pages[slot, :npages],
            np.asarray([req.temperature], np.float32),
            np.asarray([req.top_k], np.int32), self._seed())
        tok = int(tok.cpu()[0])
        # the spec engine's draft prefills the same chunk into its own
        # pool here, through the same page vector
        self._draft_chunk_hook(slot, padded, c, npages)
        now = time.perf_counter()
        self._slot_prefill_s[slot] += now - t0
        self._m_chunks.inc()
        if stalled:
            self._m_stall.observe(now - t0)
        # publish the chunk's full prompt blocks now: a concurrent
        # same-prefix request adopts them instead of prefilling again
        cold = 0
        for j in range(off // bs, (off + c) // bs):
            self.pool.publish(self._slot_hashes[slot][j],
                              int(self._pages[slot, j]))
            self._m_prefix_miss.inc()
            cold += 1
        self._ev(req, "prefill_chunk", "n", now, tokens=int(c),
                 cold_blocks=cold, hit_blocks=req.prefix_hit_tokens // bs,
                 stalled_decoders=int(self._active.sum()) if stalled
                 else 0)
        self._slot_off[slot] = off + c
        if off + c < req.prompt.size:
            self._prefilling.append(slot)   # round-robin: one chunk per
            return                          # step, decode in between
        req.prefill_own_s = self._slot_prefill_s[slot]
        self._m_prefill_s.observe(req.prefill_own_s)
        self._m_prefills.inc()
        req.status = "running"
        self._active[slot] = True
        self._pos[slot] = req.prompt.size
        self._temp[slot] = req.temperature
        self._topk[slot] = req.top_k
        if self._slot_forced[slot]:
            # preempt-resume replay: the prompt's first token was
            # emitted before the preemption; the chunk grid just derived
            # it again. Restore the cursor on the known token, emit
            # nothing; the slices still move on (prefill closes, decode
            # opens), so the trace stays balanced through a replay
            self._ev(req, "prefill", "e", now)
            if not req.decode_open:
                self._ev(req, "decode", "b", now)
                req.decode_open = True
            self._last[slot] = self._slot_forced[slot].popleft()
            return
        self._last[slot] = tok
        if self._emit(req, tok, now):
            finished.append(req)            # blocks released by _finish

    def _consume_forced(self, slot: int) -> bool:
        forced = self._slot_forced[slot]
        if not forced:
            return False
        # replay: the decode step ran at the right (pos, last) and wrote
        # the pool; the known next token advances the cursor
        self._pos[slot] += 1
        self._last[slot] = forced.popleft()
        return True

    def _finish(self, req: EngineRequest, reason: str, now: float):
        if req.slot >= 0:
            self._release_slot(req.slot)
            self._track_tenant(req, -self._charge(req))
        super()._finish(req, reason, now)

    def _schedule(self, finished: List[EngineRequest]):
        self._admit()
        # with decoders in flight, at most ONE chunk runs per step; with
        # nothing decoding, chunks drain back to back until a finished
        # prompt activates a decoder
        while self._prefilling:
            self._prefill_chunk(finished)
            if finished:
                self._admit()           # a one-token request freed a slot
            if self._active.any():
                break

    def _pre_decode(self):
        # allocate the page each active row is about to write
        # (the reservation at admission guarantees this never fails)
        for slot in np.flatnonzero(self._active):
            if self._pos[slot] // self.block_size >= self._nalloc[slot]:
                self._alloc_page(slot)

    def _decode_extra(self):
        if self._pages_dirty:
            # a remap, an allocation or a release changed the table: the
            # decode program must read the new one at its next replay
            self._pages_dev.upload(self._pages)
            self._pages_dirty = False
        return (self._pages_dev.tensor,)

    def _update_gauges(self):
        super()._update_gauges()
        pool = self.pool
        self._m_blocks_in_use.set(pool.in_use)
        self._m_blocks_free.set(pool.free_count)
        self._m_blocks_cached.set(pool.cached_free_count)
        if pool.evictions > self._evictions_seen:
            self._m_evictions.inc(pool.evictions - self._evictions_seen)
            self._evictions_seen = pool.evictions

    # -- observability -----------------------------------------------------
    def health(self) -> dict:
        doc = super().health()
        doc.update({"block_size": self.block_size,
                    "blocks_total": self.num_blocks,
                    "blocks_in_use": self.pool.in_use,
                    "blocks_cached": self.pool.cached_free_count,
                    "prefix_cache_entries": self.pool.cached_count,
                    "chunk_tokens": self.chunk_tokens,
                    "kv_dtype": self.kv_dtype,
                    "kv_bytes_per_token": self.kv_bytes_per_token,
                    "pool_bytes": self.pool_bytes,
                    "preempted_queued": len(self._preempted),
                    "preemptions": int(self._m_preempts.value())})
        # per-token decode FLOPs: the recompute cost a router weighs
        # against fetching kv_bytes_per_token — the stamped step's share
        # per slot, as the JAX engine reports it, else one token at the
        # full context from the shapes
        doc["flops_per_token"] = (
            float(self.decode_flops) / max(self.batch, 1)
            if self.decode_flops else _costs.decode_step_flops(
                self.cfg, [self.cache_len - 1]))
        # occupancy and a capped newest-first digest listing per tier,
        # hbm (this pool's prefix cache) included; present without a
        # spill store too
        tiers_doc = (self.tiers.health() if self.tiers is not None
                     else {"digests": {}})
        tiers_doc["digests"]["hbm"] = [
            d.hex() for d in self.pool.cached_digests(512)]
        doc["tiers"] = tiers_doc
        tenants = sorted(set(self._tenant_used) | set(self.tenant_budgets))
        if tenants:
            doc["tenants"] = {
                t: {"tokens_in_flight": self._tenant_used.get(t, 0),
                    "budget": self.tenant_budgets.get(t)}
                for t in tenants}
        return doc


PROPOSE = "serving_engine.propose"
VERIFY = "serving_engine.verify"
DRAFT_VERIFY = "serving_engine.draft_verify"
DRAFT_PREFILL = "serving_engine.draft_prefill"


def spec_tracker(cache_len: int, chunk_tokens: int,
                 buckets: Sequence[int]) -> _ct.CompileTracker:
    """A compile tracker for the spec engine: it captures about twice
    the paged engine's prefill set (target and draft) plus propose,
    verify and draft_verify, so the storm threshold is
    ``2 * spans * buckets + 8``."""
    spans = max(1, int(cache_len) // int(chunk_tokens))
    return _ct.CompileTracker(
        storm_threshold=2 * spans * len(tuple(buckets)) + 8)


class SpecDecodeEngine(PagedDecodeEngine):
    """Speculative decoding over the paged pool: a small draft model
    proposes ``spec_k`` tokens per step, the target verifies every
    slot's ``W = spec_k + 1`` window in one pass
    (``transformer.verify_step_paged``), and the accept/reject tail
    (``fused_spec_verify``) emits the accepted drafts plus one token of
    the target's own: up to ``spec_k + 1`` tokens per step.

    **Shared pool.** The draft keeps its own pool (its depth and widths
    differ, its storage is the model dtype) on the same block grid,
    behind the same page table and ``BlockPool``: every writer (chunk
    prefill, propose, verify) writes both pools at the same physical
    rows, so a content hash that certifies a target block certifies the
    draft rows beside it, and prefix hits, preemption and resume need no
    draft-side bookkeeping.

    **The step.** ``propose`` runs the k greedy draft decode steps as
    one program, its proposals are copied to the host and make the
    window, ``verify`` runs the window and the tail, and (X, n) come
    back: two host round trips per step. Greedy rows emit the target's
    argmax at every position, so acceptance changes how fast tokens
    come, not which: each window row is the decode step it stands for
    up to the GEMM's rounding at another row count (``verify_step_paged``).

    Rejected rows' k/v stay in the pool above the rewound cursor, where
    nothing reads them; the next window overwrites them. The scheduler
    (tiers, budgets, preempt-to-blocks) is the paged engine's; on a
    replay resume the forced history runs through verify windows, with
    ``draft_verify`` writing the same windows into the draft pool.
    Refused: ``tiers=`` and ``import_prefix`` (a payload carries target
    rows only)."""

    def __init__(self, prefill: Callable, decode: Callable, params, cache,
                 *, draft_params, draft_cache, draft_prefill: Callable,
                 propose: Callable, verify: Callable,
                 draft_verify: Callable, spec_k: int,
                 tracker: Optional[_ct.CompileTracker] = None, **kw):
        if kw.get("tiers") is not None:
            # a spilled payload carries only target pool rows; adopting
            # one would leave the draft rows beside it stale
            raise ValueError("SpecDecodeEngine does not support tiered "
                             "spill (draft pool rows cannot ride the "
                             "single-pool payload)")
        if tracker is None and not isinstance(decode, graphs.StepProgram):
            chunk = min(int(kw.get("chunk_tokens", 64)), int(kw["cache_len"]))
            tracker = spec_tracker(kw["cache_len"], chunk,
                                   kw.get("chunk_buckets")
                                   or default_chunk_buckets(chunk))
        super().__init__(prefill, decode, params, cache, tracker=tracker,
                         **kw)
        self.spec_k = int(spec_k)
        if self.spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        context = self._decode_fn.context
        self._draft_prefill_fn = self._program(draft_prefill, DRAFT_PREFILL,
                                               context)
        self._propose_fn = self._program(propose, PROPOSE, context)
        self._verify_fn = self._program(verify, VERIFY, context)
        self._draft_verify_fn = self._program(draft_verify, DRAFT_VERIFY,
                                              context)
        self.draft_params = draft_params
        self.draft_cache = draft_cache
        self._valid = np.ones(self.batch, np.int32)
        reg = self.metrics
        self._m_spec_rounds = reg.counter(
            "engine_spec_rounds_total", "propose+verify rounds executed")
        self._m_spec_proposed = reg.counter(
            "engine_spec_proposed_tokens_total",
            "draft tokens proposed for verification")
        self._m_spec_accepted = reg.counter(
            "engine_spec_accepted_tokens_total",
            "proposed draft tokens the target accepted (the emitted "
            "correction/bonus token is not counted: acceptance measures "
            "the draft's hit rate, not throughput)")

    # -- construction ------------------------------------------------------
    @classmethod
    def from_params(cls, params, cfg, draft_params, draft_cfg, *,
                    spec_k: int = 4, batch: int, cache_len: int,
                    block_size: int = 16, num_blocks: Optional[int] = None,
                    chunk_tokens: int = 64,
                    chunk_buckets: Optional[Sequence[int]] = None,
                    seed: Optional[int] = None,
                    kv_dtype: Optional[str] = None, device=None,
                    tracker: Optional[_ct.CompileTracker] = None,
                    tenant_budgets: Optional[Dict[str, int]] = None,
                    slo: Optional[SloConfig] = None, tiers=None,
                    registry: Optional[_metrics.Registry] = None,
                    decode_flops: Optional[float] = None):
        """Spec engine over live target ``params`` and ``draft_params``
        (both already on the engine's device): the target's pool in the
        storage ``kv_dtype`` names, the draft's in its model dtype, both
        of ``num_blocks`` blocks; the programs of
        ``sampling.paged_step_fns`` and ``sampling.paged_spec_fns`` under
        one tracker (default: :func:`spec_tracker`) and one graph
        context. The draft must share the target's vocab (its proposals
        are target ids) and cover ``cache_len`` positions. Runs on the
        card unless ``device="cpu"``."""
        from paddle_tpu_torch.serving import sampling
        device = place.resolve_device(device)
        for name, tree in (("params", params), ("draft_params",
                                                draft_params)):
            where = _params_device(tree)
            if where != device:
                raise ValueError(f"{name} live on {where}, the engine runs "
                                 f"on {device}")
        if draft_cfg.vocab != cfg.vocab:
            raise ValueError(f"draft vocab {draft_cfg.vocab} != target vocab "
                             f"{cfg.vocab}: proposals must be target token "
                             f"ids")
        if cache_len > cfg.max_len or cache_len > draft_cfg.max_len:
            raise ValueError(f"cache_len {cache_len} exceeds max_len (target "
                             f"{cfg.max_len}, draft {draft_cfg.max_len})")
        if block_size < 1 or cache_len % block_size:
            raise ValueError(f"cache_len {cache_len} must be a positive "
                             f"multiple of block_size {block_size}")
        nb = int(num_blocks if num_blocks is not None
                 else batch * (cache_len // block_size))
        if tracker is None:
            chunk = min(int(chunk_tokens), int(cache_len))
            tracker = spec_tracker(cache_len, chunk, chunk_buckets
                                   or default_chunk_buckets(chunk))
        prefill_fn, decode_fn = sampling.paged_step_fns(
            cfg, block_size, tracker=tracker)
        spec = sampling.paged_spec_fns(cfg, draft_cfg, block_size, spec_k,
                                       tracker=tracker,
                                       context=decode_fn.context)
        pool = transformer.init_block_pool(cfg, nb, block_size,
                                           kv_dtype=kv_dtype, device=device)
        draft_pool = transformer.init_block_pool(draft_cfg, nb, block_size,
                                                 device=device)
        return cls(prefill_fn, decode_fn, params, pool,
                   draft_params=draft_params, draft_cache=draft_pool,
                   draft_prefill=spec["draft_prefill"],
                   propose=spec["propose"], verify=spec["verify"],
                   draft_verify=spec["draft_verify"], spec_k=spec_k,
                   batch=batch, cache_len=cache_len, block_size=block_size,
                   num_blocks=nb, chunk_tokens=chunk_tokens,
                   chunk_buckets=chunk_buckets, device=device, cfg=cfg,
                   seed=seed, tracker=tracker,
                   tenant_budgets=tenant_budgets, slo=slo, tiers=tiers,
                   registry=registry, decode_flops=decode_flops)

    # -- scheduler ---------------------------------------------------------
    def _draft_chunk_hook(self, slot: int, padded: np.ndarray, c: int,
                          npages: int):
        self.draft_cache = self._draft_prefill_fn(
            self.draft_params, self.draft_cache, padded, np.int32(c),
            self._pages[slot, :npages])

    def _pre_decode(self):
        # a verify round writes up to `valid` rows per slot: allocate
        # every page the window touches (the admission reservation
        # covers them: pos + valid - 1 <= prompt + max_new - 1)
        for slot in np.flatnonzero(self._active):
            end = int(self._pos[slot]) + int(self._valid[slot]) - 1
            while end // self.block_size >= self._nalloc[slot]:
                self._alloc_page(slot)

    def step(self) -> List[EngineRequest]:
        """One scheduler iteration: admission and chunk prefill as the
        paged engine, then one propose + verify round for every active
        slot (instead of one decode step)."""
        finished: List[EngineRequest] = []
        self._schedule(finished)
        if self._active.any():
            B, W = self.batch, self.spec_k + 1
            valid = np.ones(B, np.int32)
            forced = np.zeros(B, bool)
            for slot in np.flatnonzero(self._active):
                req = self._slot_req[slot]
                if self._slot_forced[slot]:
                    forced[slot] = True
                    valid[slot] = min(W, 1 + len(self._slot_forced[slot]))
                else:
                    cap = (req.prompt.size + req.max_new
                           - int(self._pos[slot]) - 1)
                    valid[slot] = max(min(W, cap), 1)
            self._valid = valid
            self._pre_decode()
            positions = self._pos.tolist()
            t0 = time.perf_counter()
            pages = self._decode_extra()[0]
            window = np.zeros((B, W), np.int32)
            window[:, 0] = self._last
            act_prop = self._active & ~forced
            if act_prop.any():
                props, self.draft_cache = self._propose_fn(
                    self.draft_params, self.draft_cache, self._last,
                    self._pos, act_prop, valid, pages)
                # the first host round trip: the window is built here
                window[:, 1:] = props.cpu().numpy()
            for slot in np.flatnonzero(forced):
                # replay window: the known history is the proposal set
                f = list(self._slot_forced[slot])[:W - 1]
                window[slot, 1:1 + len(f)] = f
            if forced.any():
                # keep the draft pool position-faithful on replay rows
                # (propose's writes were masked off for these slots)
                self.draft_cache = self._draft_verify_fn(
                    self.draft_params, self.draft_cache, window, self._pos,
                    valid, forced & self._active, pages)
            X, n, self.cache = self._verify_fn(
                self.params, self.cache, window, self._pos, valid,
                self._active, pages, self._temp, self._topk, self._seed())
            X, n = X.cpu().numpy(), n.cpu().numpy()
            now = time.perf_counter()
            self._account_step(now - t0, _costs.verify_step_flops(
                self.cfg, positions, W))
            self._m_spec_rounds.inc()
            for slot in np.flatnonzero(self._active):
                req = self._slot_req[slot]
                if forced[slot]:
                    f = self._slot_forced[slot]
                    m = min(int(valid[slot]), len(f))
                    for _ in range(m):
                        tok = f.popleft()
                    self._pos[slot] += m
                    self._last[slot] = tok
                    continue
                nprop = max(int(valid[slot]) - 1, 0)
                m = int(n[slot])
                self._m_spec_proposed.inc(nprop)
                self._m_spec_accepted.inc(max(m - 1, 0))
                fin, used = False, 0
                for j in range(m):
                    used += 1
                    if self._emit(req, int(X[slot, j]), now):
                        fin = True
                        break
                if fin:
                    finished.append(req)
                else:
                    self._pos[slot] += used
                    self._last[slot] = int(X[slot, used - 1])
        self._update_gauges()
        return finished

    def import_prefix(self, payload: bytes) -> int:
        """Refused on the spec engine: the wire carries target pool rows
        only, and adopting them would leave the draft rows beside them
        unwritten (propose would read garbage). A spec engine still
        exports."""
        raise ValueError("import_prefix: a SpecDecodeEngine cannot adopt "
                         "transferred blocks (no draft-pool rows travel on "
                         "the wire); use a target-only decode engine for "
                         "P/D disaggregation")

    # -- observability -----------------------------------------------------
    def acceptance_rate(self) -> Optional[float]:
        """Lifetime draft acceptance: accepted / proposed (None before
        the first proposal). 1.0: every draft token survived, as with a
        draft equal to the target under greedy sampling."""
        prop = self._m_spec_proposed.value()
        if not prop:
            return None
        return self._m_spec_accepted.value() / prop

    def compile_counts(self) -> Dict[str, int]:
        c = super().compile_counts()
        c.update({"draft_prefill": self._tracker.count(DRAFT_PREFILL),
                  "propose": self._tracker.count(PROPOSE),
                  "verify": self._tracker.count(VERIFY),
                  "draft_verify": self._tracker.count(DRAFT_VERIFY)})
        return c

    def health(self) -> dict:
        doc = super().health()
        acc = self.acceptance_rate()
        doc["spec"] = {
            "k": self.spec_k,
            "rounds": int(self._m_spec_rounds.value()),
            "proposed": int(self._m_spec_proposed.value()),
            "accepted": int(self._m_spec_accepted.value()),
            "acceptance_rate": round(acc, 4) if acc is not None else None}
        return doc
