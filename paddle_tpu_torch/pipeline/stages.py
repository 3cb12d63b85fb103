"""Snapshotable pipeline stages: parallel transform, streaming shuffle,
batcher (counterpart of ``paddle_tpu/pipeline/stages.py``; stdlib-only,
the same snapshots).

All three run lazily in the Pipeline's single producer thread (the
parallelism of the transform stage lives in its worker pool, not in the
stage driver), so when the downstream batcher yields a batch the whole
stage chain is suspended — the moment the Pipeline captures a
consistent snapshot:

- ``TransformStage``  — ordered parallel map over a bounded window of
  futures. Snapshot = the raw (pre-transform) samples still in flight;
  restore re-submits them, so outputs are exact as long as the map fn
  is deterministic per sample.
- ``ShuffleStage``    — reservoir-style streaming shuffle (fill a
  buffer, then swap a random slot per incoming sample). Snapshot = the
  RNG state plus the buffer contents; restore continues the identical
  random sequence.
- ``BatchStage``      — group into fixed-size lists (``size=None``
  passes items through, for sources that already yield batches).
  Snapshot = the partial batch plus the emitted-batch counter.
"""

import itertools
import random
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, List, Optional


class TransformStage:
    """Ordered parallel map: up to ``workers`` samples transform
    concurrently inside a sliding window of ``window`` futures; outputs
    come back in input order regardless of worker scheduling. Worker
    exceptions surface in the driver thread at the corresponding
    position in the stream (never a silent drop)."""

    def __init__(self, fn: Callable, workers: int = 2,
                 window: Optional[int] = None):
        if workers < 1:
            raise ValueError(f"transform workers must be >= 1, "
                             f"got {workers}")
        self.fn = fn
        self.workers = workers
        self.window = window or workers * 2
        self._pool: Optional[ThreadPoolExecutor] = None
        self._inflight = deque()           # (future, raw_sample)
        # True once this epoch's input is exhausted and only in-window
        # work remains. A snapshot taken then pairs pending raws with a
        # source cursor that has ALREADY rolled to the next epoch — the
        # restore must finish the epoch from those raws alone
        # (preload_only), never splice next-epoch source samples in
        self.draining = False

    def _ensure_pool(self) -> ThreadPoolExecutor:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=self.workers,
                thread_name_prefix="pipeline-xform")
        return self._pool

    def pending(self) -> List:
        """Raw samples submitted but not yet yielded downstream — the
        snapshot the Pipeline persists (restore re-submits them)."""
        return [raw for _, raw in self._inflight]

    def take_inflight(self) -> List:
        """Cancel the leftover futures of an abandoned epoch and return
        their raw samples. The raws are un-yielded work: a continued
        iteration re-submits them (fresh futures) ahead of new source
        samples; a state restore replaces them wholesale."""
        raws = [raw for _, raw in self._inflight]
        for fut, _ in self._inflight:
            fut.cancel()
        self._inflight.clear()
        return raws

    def feed(self, samples: Iterable, preload: Iterable = (),
             preload_only: bool = False) -> Iterator:
        """Transformed stream over ``preload`` (restored in-flight
        raws), stale in-flight raws (an abandoned prior epoch's
        drawn-but-undelivered work), then ``samples``; input order
        preserved. Stale futures from the abandoned epoch are cancelled
        and their raws re-submitted — draining them directly would
        raise CancelledError (or replay results out of band).

        ``preload_only=True`` is the restored tail drain: the snapshot
        was taken after the source exhausted this epoch (cursor already
        on the next epoch), so the epoch must finish from ``preload``
        alone — ``samples`` stays untouched for the next feed call."""
        stale = self.take_inflight()
        if self.draining:
            # abandoned mid-tail-drain: that epoch is over; its window
            # raws die with it (same fate as ring-staged batches)
            stale = []
            self.draining = False
        pool = self._ensure_pool()
        inflight = self._inflight
        try:
            if preload_only:
                self.draining = True       # snapshots must stay tail-only
                stream = itertools.chain(preload, stale)
            else:
                stream = itertools.chain(preload, stale, samples)
            for raw in stream:
                inflight.append((pool.submit(self.fn, raw), raw))
                if len(inflight) >= self.window:
                    fut, _ = inflight[0]
                    out = fut.result()     # raises the worker's exception
                    inflight.popleft()
                    yield out
            self.draining = True
            while inflight:
                fut, _ = inflight[0]
                out = fut.result()
                inflight.popleft()
                yield out
            self.draining = False
        finally:
            # abandoned mid-iteration (close/error): the un-yielded raws
            # stay in _inflight for a final snapshot; cancel what hasn't
            # started so close() doesn't wait on queued work
            for fut, _ in inflight:
                fut.cancel()

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        self._inflight.clear()


class ShuffleStage:
    """Streaming pool shuffle: maintain ``size`` samples; each incoming
    sample evicts (yields) a uniformly random resident. Unlike the
    chunked ``reader.shuffle`` decorator this emits continuously (no
    buf-size latency cliffs) and its full state — RNG + buffer — is
    capturable, which is what makes mid-epoch resume exact."""

    def __init__(self, size: int, seed: int = 0):
        if size < 1:
            raise ValueError(f"shuffle size must be >= 1, got {size}")
        self.size = size
        self.rng = random.Random(seed)
        self.buf: List = []
        # True while the end-of-epoch drain is in flight: a checkpoint
        # taken mid-drain must resume by draining the REST of the buffer
        # (already shuffled), not by mixing next-epoch samples into it
        self.draining = False

    def state(self) -> dict:
        return {"rng": self.rng.getstate(), "buf": list(self.buf),
                "draining": self.draining}

    def load_state(self, state: dict) -> None:
        self.rng.setstate(state["rng"])
        self.buf = list(state["buf"])
        self.draining = bool(state.get("draining", False))

    def feed(self, samples: Iterable) -> Iterator:
        buf, rng = self.buf, self.rng
        if not self.draining:
            for s in samples:
                if len(buf) < self.size:
                    buf.append(s)
                    continue
                j = rng.randrange(self.size)
                out, buf[j] = buf[j], s
                yield out
            # epoch end: drain in random order (shuffle once, then pop —
            # a mid-drain snapshot carries the already-shuffled tail)
            self.draining = True
            rng.shuffle(buf)
        while buf:
            yield buf.pop()
        self.draining = False


class BatchStage:
    """Fixed-size batching with an emitted-batch counter. ``size=None``
    is the passthrough mode for sources that already yield whole
    batches (the trainer wrapping a ``paddle.batch`` reader)."""

    def __init__(self, size: Optional[int] = None, drop_last: bool = True):
        if size is not None and size < 1:
            raise ValueError(f"batch size must be >= 1, got {size}")
        self.size = size
        self.drop_last = drop_last
        self.partial: List = []
        self.batches = 0                   # emitted since construction

    def state(self) -> dict:
        return {"partial": list(self.partial), "batches": self.batches}

    def load_state(self, state: dict) -> None:
        self.partial = list(state["partial"])
        self.batches = int(state["batches"])

    def feed(self, samples: Iterable) -> Iterator:
        if self.size is None:
            for b in samples:
                self.batches += 1
                yield b
            return
        for s in samples:
            self.partial.append(s)
            if len(self.partial) == self.size:
                out, self.partial = self.partial, []
                self.batches += 1
                yield out
        if self.partial:
            if self.drop_last:
                # the ragged tail dies WITH the epoch — carrying it into
                # the next epoch's first batch would mix epochs (and a
                # resumed run replays the same drop, keeping snapshots
                # consistent: both runs discard at the same boundary)
                self.partial = []
            else:
                out, self.partial = self.partial, []
                self.batches += 1
                yield out
