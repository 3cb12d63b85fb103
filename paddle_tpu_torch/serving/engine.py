"""Continuous-batching LM decode engine over the paged KV pool
(counterpart of ``paddle_tpu/serving/engine.py``).

:class:`PagedDecodeEngine` leases ``batch`` slots to requests. A request
queues until a slot frees and its worst-case block count can be
reserved, is chunk-prefilled into pool pages (one chunk per step while
others decode), then decodes one token per step with the sampler on the
device, until EOS or ``max_new``. Full prompt blocks are published in
the prefix cache as their chunk lands, and a later prompt with the same
prefix maps them into its page table instead of prefilling them.

The two step functions run as step programs (``core/graphs.py``), the
counterpart of the JAX engine's jitted programs: on the card one CUDA
graph per (chunk bucket, page-vector length) for prefill and one for
decode, captured at the first call with that key and replayed after;
``compile_counts()`` counts them through the compile tracker, as the JAX
engine counts its compilations. There is no eager path on the card.
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

Not ported yet (queued in ROADMAP.md): SLO windows, the request log,
chrome-trace events (``_ev`` is the hook they attach to), the health
server, ``abort_requests``, the spill tiers,
``export_prefix``/``import_prefix``, ``SpecDecodeEngine`` and the
row-arena ``DecodeEngine`` path.
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
from paddle_tpu_torch.observe import compile_tracker as _ct
from paddle_tpu_torch.observe import costs as _costs
from paddle_tpu_torch.observe import metrics as _metrics
from paddle_tpu_torch.serving import blocks as _blocks

# decode steps run single-digit ms; prefill tens-to-hundreds
_LATENCY_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                    0.1, 0.25, 0.5, 1.0, 2.5, 5.0)

# the two scheduling tiers: "latency" admits ahead of "batch" and may
# preempt a batch-tier victim's blocks; "batch" fills whatever capacity
# latency traffic leaves (and is the only tier preemption may evict)
VALID_TIERS = ("latency", "batch")

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
    slot: int = -1
    prefix_hit_tokens: int = 0          # prompt tokens served from cache
    block_hashes: Optional[List[bytes]] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    status: str = "queued"              # queued | prefilling | running
    #                                     | preempted | done
    finish_reason: Optional[str] = None  # eos | max_tokens
    submit_t: float = 0.0
    prefill_t: Optional[float] = None   # last admission
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    prefill_own_s: float = 0.0          # this request's own chunk time
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


class DecodeEngine:
    """Slot-scheduler core: request records, host-side slot state, the
    batched decode step, token emission and metrics. The paged engine
    specializes admission and prefill; ``paddle_tpu``'s row-arena path
    of this class is not ported.

    ``prefill``/``decode`` are step programs (``core/graphs.py``, as
    ``serving/sampling.paged_step_fns`` makes them) or plain step
    functions, which the engine wraps into programs under its tracker."""

    def __init__(self, prefill: Callable, decode: Callable, params, cache,
                 *, batch: int, cache_len: int, buckets: Sequence[int],
                 device, cfg, seed: Optional[int] = None,
                 tracker: Optional[_ct.CompileTracker] = None):
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
        reg = self.metrics = _metrics.Registry()
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

    def _program(self, fn, name: str, context) -> graphs.StepProgram:
        """``fn`` as a step program under this engine's tracker."""
        if isinstance(fn, graphs.StepProgram):
            if fn.tracker is not self._tracker or fn.name != name:
                raise ValueError(f"step program {fn.name!r} is tracked "
                                 f"elsewhere: the engine counts {name!r} "
                                 f"in its own tracker")
            return fn
        return graphs.StepProgram(fn, name, self._tracker, context)

    # -- request API -------------------------------------------------------
    def _reject(self, reason: str, msg: str) -> ValueError:
        self._m_rejected.inc(reason=reason)
        return ValueError(msg)

    def _validate_submit(self, prompt: np.ndarray, max_new: int, tier: str):
        if prompt.size < 1:
            raise self._reject("empty_prompt", "submit: empty prompt")
        if max_new < 1:
            raise self._reject("bad_max_new", f"submit: max_new must be "
                               f">= 1, got {max_new}")
        if tier not in VALID_TIERS:
            raise self._reject("bad_tier", f"submit: tier must be one of "
                               f"{VALID_TIERS}, got {tier!r}")
        if prompt.size + max_new > self.cache_len:
            raise self._reject(
                "exceeds_cache", f"submit: {prompt.size} prompt + "
                f"{max_new} new tokens exceed cache_len {self.cache_len}")

    def _enqueue(self, req: EngineRequest) -> EngineRequest:
        self._queue.append(req)
        self._m_requests.inc()
        self._m_queue.set(len(self._queue))
        return req

    @property
    def active_count(self) -> int:
        return int(self._active.sum())

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def idle(self) -> bool:
        return not self._queue and not self._active.any()

    # -- scheduler ---------------------------------------------------------
    def _seed(self) -> np.int32:
        return np.int32(self._rng.randint(0, 2 ** 31 - 1))

    def _ev(self, req: EngineRequest, name: str, now: float, **args):
        """A request's lifecycle event (admitted, preempted, resumed,
        finished). No-op here: the chrome-trace events of the JAX engine
        attach to this hook (ROADMAP A)."""

    def _finish(self, req: EngineRequest, reason: str, now: float):
        req.status, req.finish_reason, req.finish_t = "done", reason, now
        self._m_completed.inc(reason=reason)
        if req.slot >= 0:
            self._active[req.slot] = False
            self._slot_req[req.slot] = None
            self._free.append(req.slot)
        self._ev(req, "finished", now, reason=reason)

    def _emit(self, req: EngineRequest, tok: int, now: float) -> bool:
        """Record one emitted token; True when the request finished."""
        req.tokens.append(int(tok))
        self._m_tokens.inc()
        if req.first_token_t is None:
            req.first_token_t = now
            self._m_ttft_s.observe(now - req.submit_t)
        if req.eos_id is not None and tok == req.eos_id:
            self._finish(req, "eos", now)
            return True
        if len(req.tokens) >= req.max_new:
            self._finish(req, "max_tokens", now)
            return True
        return False

    def _schedule(self, finished: List[EngineRequest]):
        """Admission and prefill work that runs before the decode step."""
        raise NotImplementedError

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
            dt = now - t0
            self._m_step_s.observe(dt)
            self._m_steps.inc()
            flops = _costs.decode_step_flops(self.cfg, positions)
            self._flops_total += flops
            self._step_s_total += dt
            mfu = _costs.mfu(flops, dt, self._peak_flops)
            if mfu is not None:
                self._m_decode_mfu.set(mfu)
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
        return doc

    def metrics_text(self) -> str:
        return self.metrics.render_prometheus()


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
      wait and are skipped, never block the others, never reject.

    Program discipline: one prefill program per (chunk bucket, context
    span) pair and one decode program (``compile_counts()``).
    """

    def __init__(self, prefill: Callable, decode: Callable, params,
                 cache, *, batch: int, cache_len: int, block_size: int,
                 device, cfg, num_blocks: Optional[int] = None,
                 chunk_tokens: int = 64, seed: Optional[int] = None,
                 tracker: Optional[_ct.CompileTracker] = None,
                 tenant_budgets: Optional[Dict[str, int]] = None):
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
        buckets = default_chunk_buckets(chunk_tokens)
        if tracker is None and not isinstance(decode, graphs.StepProgram):
            tracker = paged_tracker(cache_len, chunk_tokens, buckets)
        super().__init__(prefill, decode, params, cache, batch=batch,
                         cache_len=cache_len, buckets=buckets,
                         device=device, cfg=cfg, seed=seed, tracker=tracker)
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

    # -- construction ------------------------------------------------------
    @classmethod
    def from_params(cls, params, cfg, *, batch: int, cache_len: int,
                    block_size: int = 16,
                    num_blocks: Optional[int] = None,
                    chunk_tokens: int = 64, seed: Optional[int] = None,
                    kv_dtype: Optional[str] = None, device=None,
                    tracker: Optional[_ct.CompileTracker] = None,
                    tenant_budgets: Optional[Dict[str, int]] = None):
        """Engine over live ``params`` (from ``transformer.init_params``,
        ``params_from_numpy`` or the int8-weight
        ``io/lm_serving.quantize_lm_params``) with a fresh pool of
        ``num_blocks`` blocks (default: ``batch`` full-length slots) in
        the storage ``kv_dtype`` names (None: the model dtype; "int8" or
        "int4": quantized, see ``transformer.init_block_pool``), and the
        step programs of ``sampling.paged_step_fns`` under ``tracker``
        (default: a fresh one per engine). Runs on the card unless
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
        if block_size < 1 or cache_len % block_size:
            raise ValueError(f"cache_len {cache_len} must be a positive "
                             f"multiple of block_size {block_size}")
        nb = int(num_blocks if num_blocks is not None
                 else batch * (cache_len // block_size))
        pool = transformer.init_block_pool(cfg, nb, block_size,
                                           kv_dtype=kv_dtype, device=device)
        if tracker is None:
            chunk = min(int(chunk_tokens), int(cache_len))
            tracker = paged_tracker(cache_len, chunk,
                                    default_chunk_buckets(chunk))
        prefill_fn, decode_fn = sampling.paged_step_fns(
            cfg, block_size, tracker=tracker)
        return cls(prefill_fn, decode_fn, params, pool, batch=batch,
                   cache_len=cache_len, block_size=block_size,
                   num_blocks=nb, chunk_tokens=chunk_tokens, device=device,
                   cfg=cfg, seed=seed, tracker=tracker,
                   tenant_budgets=tenant_budgets)

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
               tenant: str = "default", tier: str = "batch"
               ) -> EngineRequest:
        """Queue one request. Any prompt with ``len(prompt) + max_new <=
        cache_len`` is accepted and prefilled in chunks.
        ``tier="latency"`` admits ahead of batch-tier work and may
        preempt a batch victim's blocks under pool pressure; ``tenant``
        charges the request's worst-case tokens against that tenant's
        budget (exhaustion queues, never rejects)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        rid = next(self._ids)
        self._validate_submit(prompt, max_new, tier)
        need = -(-(prompt.size + max_new) // self.block_size)
        if need > self.num_blocks:
            # a request needing more blocks than the pool has could
            # never reserve and would block the FIFO head forever
            raise self._reject(
                "exceeds_pool", f"submit: {prompt.size} prompt + "
                f"{max_new} new tokens need {need} blocks, exceeding the "
                f"pool's {self.num_blocks}")
        budget = self.tenant_budgets.get(str(tenant))
        if budget is not None and prompt.size + max_new > budget:
            # a request whose own charge exceeds its tenant's cap could
            # never admit: impossibility rejects, exhaustion queues
            raise self._reject(
                "exceeds_budget", f"submit: {prompt.size} prompt + "
                f"{max_new} new tokens exceed tenant {tenant!r}'s budget "
                f"of {budget}")
        req = EngineRequest(
            rid=rid, prompt=prompt, max_new=int(max_new),
            temperature=float(temperature), top_k=int(top_k),
            eos_id=eos_id, tenant=str(tenant), tier=str(tier),
            submit_t=time.perf_counter())
        return self._enqueue(req)

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
        now = time.perf_counter()
        req.prefill_t = now
        if req.preemptions == 0:
            # a re-admission would observe the whole submit -> now span
            # again: the histogram keeps each request's first wait
            self._m_wait_s.observe(now - req.submit_t)
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
        self._ev(req, "admitted", now, slot=slot, hit_blocks=len(hits))
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
            self._active[slot] = False
        else:
            self._prefilling.remove(slot)
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
        self._ev(req, "preempted", now, tokens=len(req.tokens),
                 was=req.status)
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
            self._m_resumes.inc(mode="remap")
            self._ev(req, "resumed", now, mode="remap")
            return "remap"
        # eviction fallback: forced replay through normal admission
        req.replay = list(req.tokens)
        if not self._try_admit(req):
            req.replay = None           # still parked: keep the snapshot
            return None
        req.snapshot = None
        self._m_resumes.inc(mode="replay")
        self._ev(req, "resumed", time.perf_counter(), mode="replay")
        return "replay"

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
        now = time.perf_counter()
        self._slot_prefill_s[slot] += now - t0
        self._m_chunks.inc()
        if stalled:
            self._m_stall.observe(now - t0)
        # publish the chunk's full prompt blocks now: a concurrent
        # same-prefix request adopts them instead of prefilling again
        for j in range(off // bs, (off + c) // bs):
            self.pool.publish(self._slot_hashes[slot][j],
                              int(self._pages[slot, j]))
            self._m_prefix_miss.inc()
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
            # nothing
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
        tenants = sorted(set(self._tenant_used) | set(self.tenant_budgets))
        if tenants:
            doc["tenants"] = {
                t: {"tokens_in_flight": self._tenant_used.get(t, 0),
                    "budget": self.tenant_budgets.get(t)}
                for t in tenants}
        return doc
