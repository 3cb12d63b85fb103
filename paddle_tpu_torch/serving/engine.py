"""Continuous-batching LM decode engine over the paged KV pool
(counterpart of ``paddle_tpu/serving/engine.py``, core only).

:class:`PagedDecodeEngine` leases ``batch`` slots to requests. A request
queues until a slot frees and its worst-case block count can be
reserved, is chunk-prefilled into pool pages (one chunk per step while
others decode), then decodes one token per step with the sampler on the
device, until EOS or ``max_new``. Full prompt blocks are published in
the prefix cache as their chunk lands, and a later prompt with the same
prefix maps them into its page table instead of prefilling them.

Only ``[B]`` int32 ids (or one id after a prefill) cross to the host per
step; scheduling state lives in numpy and is uploaded as small vectors.
The per-step sampling seeds come from ``np.random.RandomState(seed)``
in the same order as the JAX engine's, so one ``seed`` gives both
engines the same seed stream.

Not ported yet (queued in ROADMAP.md): tenant budgets and preemption,
latency/batch tiers, the spill tiers, ``export_prefix``/
``import_prefix``, SLO windows, the request log, chrome-trace events,
the health server, the compile tracker, ``SpecDecodeEngine`` and the
row-arena ``DecodeEngine`` path.
"""

import dataclasses
import itertools
import time
from collections import deque
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.core import place, ragged
from paddle_tpu_torch.models import transformer
from paddle_tpu_torch.observe import costs as _costs
from paddle_tpu_torch.observe import metrics as _metrics
from paddle_tpu_torch.serving import blocks as _blocks

# decode steps run single-digit ms; prefill tens-to-hundreds
_LATENCY_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                    0.1, 0.25, 0.5, 1.0, 2.5, 5.0)


@dataclasses.dataclass
class EngineRequest:
    """One generation request and its lifecycle record."""
    rid: int
    prompt: np.ndarray                  # [Tp] int32
    max_new: int
    temperature: float = 0.0
    top_k: int = 0
    eos_id: Optional[int] = None
    # -- lifecycle (filled by the engine) --------------------------------
    slot: int = -1
    prefix_hit_tokens: int = 0          # prompt tokens served from cache
    block_hashes: Optional[List[bytes]] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    status: str = "queued"              # queued | prefilling | running
    #                                     | done
    finish_reason: Optional[str] = None  # eos | max_tokens
    submit_t: float = 0.0
    first_token_t: Optional[float] = None
    prefill_own_s: float = 0.0          # this request's own chunk time

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
    of this class is not ported."""

    def __init__(self, prefill: Callable, decode: Callable, params, cache,
                 *, batch: int, cache_len: int, buckets: Sequence[int],
                 device, cfg, seed: Optional[int] = None):
        self._prefill_fn = prefill
        self._decode_fn = decode
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

    # -- request API -------------------------------------------------------
    def _reject(self, reason: str, msg: str) -> ValueError:
        self._m_rejected.inc(reason=reason)
        return ValueError(msg)

    def _validate_submit(self, prompt: np.ndarray, max_new: int):
        if prompt.size < 1:
            raise self._reject("empty_prompt", "submit: empty prompt")
        if max_new < 1:
            raise self._reject("bad_max_new", f"submit: max_new must be "
                               f">= 1, got {max_new}")
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

    def _vec(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _finish(self, req: EngineRequest, reason: str):
        req.status, req.finish_reason = "done", reason
        self._m_completed.inc(reason=reason)
        if req.slot >= 0:
            self._active[req.slot] = False
            self._slot_req[req.slot] = None
            self._free.append(req.slot)

    def _emit(self, req: EngineRequest, tok: int, now: float) -> bool:
        """Record one emitted token; True when the request finished."""
        req.tokens.append(int(tok))
        self._m_tokens.inc()
        if req.first_token_t is None:
            req.first_token_t = now
            self._m_ttft_s.observe(now - req.submit_t)
        if req.eos_id is not None and tok == req.eos_id:
            self._finish(req, "eos")
            return True
        if len(req.tokens) >= req.max_new:
            self._finish(req, "max_tokens")
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
                self.params, self.cache, self._vec(self._last),
                self._vec(self._pos), self._vec(self._active),
                *self._decode_extra(), self._vec(self._temp),
                self._vec(self._topk), int(self._seed()))
            nxt = nxt.cpu().numpy()     # the only device->host transfer
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
               "prefill_buckets": list(self.buckets)}
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


class PagedDecodeEngine(DecodeEngine):
    """Block-table continuous batching: paged KV, chunked prefill,
    prefix cache.

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
      stalls mid-flight on an empty pool; a request that cannot reserve
      waits FIFO at the queue head.
    """

    def __init__(self, prefill: Callable, decode: Callable, params,
                 cache, *, batch: int, cache_len: int, block_size: int,
                 device, cfg, num_blocks: Optional[int] = None,
                 chunk_tokens: int = 64, seed: Optional[int] = None):
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
        super().__init__(prefill, decode, params, cache, batch=batch,
                         cache_len=cache_len,
                         buckets=default_chunk_buckets(chunk_tokens),
                         device=device, cfg=cfg, seed=seed)
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
        # page table uploaded on change; unallocated entries stay 0 and
        # are only read under the attention mask or as padded rows
        self._pages = np.zeros((B, self.pages_per_slot), np.int32)
        self._pages_dev = None
        self._nalloc = [0] * B              # pages allocated per slot
        self._slot_blocks: List[List[int]] = [[] for _ in range(B)]
        self._slot_hashes: List[List[bytes]] = [[] for _ in range(B)]
        self._slot_off = [0] * B            # next prompt token to prefill
        self._slot_reserved = [0] * B       # unallocated reservation left
        self._slot_prefill_s = [0.0] * B    # seconds across chunks
        self._prefilling: deque = deque()   # slots mid-prompt, round-robin
        self._evictions_seen = 0
        reg = self.metrics
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
                    kv_dtype: Optional[str] = None, device=None):
        """Engine over live ``params`` (from ``transformer.init_params``,
        ``params_from_numpy`` or the int8-weight
        ``io/lm_serving.quantize_lm_params``) with a fresh pool of
        ``num_blocks`` blocks (default: ``batch`` full-length slots) in
        the storage ``kv_dtype`` names (None: the model dtype; "int8" or
        "int4": quantized, see ``transformer.init_block_pool``). Runs on
        the card unless ``device="cpu"``; ``params`` must already live
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
        prefill_fn, decode_fn = sampling.paged_step_fns(cfg, block_size)
        return cls(prefill_fn, decode_fn, params, pool, batch=batch,
                   cache_len=cache_len, block_size=block_size,
                   num_blocks=nb, chunk_tokens=chunk_tokens, device=device,
                   cfg=cfg, seed=seed)

    # -- request API -------------------------------------------------------
    def submit(self, prompt, max_new: int, *, temperature: float = 0.0,
               top_k: int = 0, eos_id: Optional[int] = None
               ) -> EngineRequest:
        """Queue one request. Any prompt with ``len(prompt) + max_new <=
        cache_len`` is accepted and prefilled in chunks."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        self._validate_submit(prompt, max_new)
        need = -(-(prompt.size + max_new) // self.block_size)
        if need > self.num_blocks:
            # a request needing more blocks than the pool has could
            # never reserve and would block the FIFO head forever
            raise self._reject(
                "exceeds_pool", f"submit: {prompt.size} prompt + "
                f"{max_new} new tokens need {need} blocks, exceeding the "
                f"pool's {self.num_blocks}")
        req = EngineRequest(
            rid=next(self._ids), prompt=prompt, max_new=int(max_new),
            temperature=float(temperature), top_k=int(top_k),
            eos_id=eos_id, submit_t=time.perf_counter())
        return self._enqueue(req)

    @property
    def idle(self) -> bool:
        return (not self._queue and not self._prefilling
                and not self._active.any())

    # -- scheduler ---------------------------------------------------------
    def _alloc_page(self, slot: int):
        b = self.pool.alloc()
        self._pages[slot, self._nalloc[slot]] = b
        self._pages_dev = None
        self._nalloc[slot] += 1
        self._slot_blocks[slot].append(b)
        self._slot_reserved[slot] -= 1

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
        if not self._free:
            return False
        hashes, hits, need, revive = self._admission_plan(req)
        if not self.pool.can_reserve(need + revive):
            return False
        slot = self._free.popleft()
        self.pool.reserve(need)
        for b in hits:
            self.pool.share(b)
        self._pages[slot, :] = 0
        self._pages[slot, :len(hits)] = hits
        self._pages_dev = None
        self._nalloc[slot] = len(hits)
        self._slot_blocks[slot] = list(hits)
        self._slot_hashes[slot] = hashes
        self._slot_off[slot] = len(hits) * self.block_size
        self._slot_reserved[slot] = need
        self._slot_prefill_s[slot] = 0.0
        req.prefix_hit_tokens = len(hits) * self.block_size
        self._m_prefix_hits.inc(len(hits))
        self._m_wait_s.observe(time.perf_counter() - req.submit_t)
        req.slot, req.status = slot, "prefilling"
        self._slot_req[slot] = req
        self._prefilling.append(slot)
        return True

    def _admit(self):
        """FIFO admission: the queue head waits for a slot and for its
        reservation; nothing admits past it."""
        while self._queue and self._try_admit(self._queue[0]):
            self._queue.popleft()
        self._m_queue.set(len(self._queue))

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
        self._pages_dev = None
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
        # the page-vector prefix covering context + chunk; entries past
        # the allocated count back only padded rows, which never write
        npages = off // bs + -(-bucket // bs)
        stalled = bool(self._active.any())
        t0 = time.perf_counter()
        tok, self.cache = self._prefill_fn(
            self.params, self.cache, self._vec(padded), c,
            self._vec(self._pages[slot, :npages].copy()),
            self._vec(np.asarray([req.temperature], np.float32)),
            self._vec(np.asarray([req.top_k], np.int32)),
            int(self._seed()))
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
        # final chunk: emit the sampled first token
        req.prefill_own_s = self._slot_prefill_s[slot]
        self._m_prefill_s.observe(req.prefill_own_s)
        self._m_prefills.inc()
        req.status = "running"
        if self._emit(req, tok, now):
            finished.append(req)
            return
        self._active[slot] = True
        self._pos[slot] = req.prompt.size
        self._last[slot] = tok
        self._temp[slot] = req.temperature
        self._topk[slot] = req.top_k

    def _finish(self, req: EngineRequest, reason: str):
        slot = req.slot
        if slot >= 0:
            for b in self._slot_blocks[slot]:
                self.pool.release(b)
            self.pool.unreserve(self._slot_reserved[slot])
            self._slot_blocks[slot] = []
            self._slot_hashes[slot] = []
            self._slot_reserved[slot] = 0
            self._nalloc[slot] = 0
            self._pages[slot, :] = 0
            self._pages_dev = None
        super()._finish(req, reason)

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
        if self._pages_dev is None:
            self._pages_dev = self._vec(self._pages.copy())
        return (self._pages_dev,)

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
                    "pool_bytes": self.pool_bytes})
        return doc
