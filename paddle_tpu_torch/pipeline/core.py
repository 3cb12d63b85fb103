"""The asynchronous, checkpointable input pipeline (counterpart of
``paddle_tpu/pipeline/core.py``; the same threads, snapshots and
``STATE_VERSION``, so a state taken in either package resumes in the
other).

Reference slot: the v1 data-provider layer's async double-buffer
(paddle/gserver/dataproviders/PyDataProvider2.cpp:195 pool) grown into
a staged subsystem: a resumable Source feeds parallel transform workers
and a streaming shuffle into a batcher, batches land in a bounded host
staging ring, and a device stage converts and copies to the card ahead
of the consumer so step N+1's feeds are already on the device while
step N executes (the same hide-the-host-latency-behind-device-compute overlap
PAPERS.md's weight-update sharding paper makes for update cost).

Threads (all named ``pipeline-*`` — the test suite's thread-leak guard
keys on the prefix):

- ``pipeline-produce`` — drives source → transform → shuffle → batch,
  pushing ``(batch, state)`` into the staging ring (maxsize =
  ``prefetch``; a full ring backpressures the producer).
- ``pipeline-feed``    — pops batches, runs the convert fn (the
  trainer's ``DataFeeder.feed``, on the host) and the transfer fn
  (``trainer.DeviceTransfer`` on the card: pinned staging and an
  asynchronous copy on this thread's own CUDA stream), pushes
  device-bound feeds into the double-buffer queue (maxsize =
  ``device_depth``).
- transform workers    — ``pipeline-xform_*`` inside TransformStage.

Robustness contract: worker exceptions re-raise at ``next()`` (never a
silent hang or truncation), ``close()`` joins every thread, queues are
bounded end to end.

Checkpointing: every batch travels with the snapshot of the stage chain
taken at the moment the batcher emitted it (source cursor, in-flight
transform raws, shuffle RNG + buffer, batch counter). ``state_dict()``
returns the snapshot of the last batch the CONSUMER received — exactly
the resume point for batch k+1 after training on batch k —
and ``io/checkpoint.py`` carries it next to params/opt state, so a
preempted job restarts mid-epoch on the exact next batch.
"""

import queue
import threading
import time
from typing import Callable, Optional

from paddle_tpu_torch import observe
from paddle_tpu_torch.observe import metrics as _metrics
from paddle_tpu_torch.pipeline.source import Source, as_source
from paddle_tpu_torch.pipeline.stages import (BatchStage, ShuffleStage,
                                        TransformStage)
from paddle_tpu_torch.utils import enforce
from paddle_tpu_torch.utils.threadq import drain_join, put_stoppable as _put

_m_depth = _metrics.gauge(
    "pipeline_queue_depth",
    "staged batches per queue (labels: pipeline, stage=ring|device)")
_m_stage = _metrics.histogram(
    "pipeline_stage_seconds",
    "per-batch stage time (labels: pipeline, "
    "stage=produce|convert|transfer)")
_m_wait = _metrics.counter(
    "feed_wait_seconds_total",
    "consumer time blocked waiting for a feed (input-starvation; 0 "
    "means the pipeline fully hides host input behind device compute)")
_m_hits = _metrics.counter(
    "pipeline_prefetch_hits_total",
    "next() calls served without blocking (a feed was staged)")
_m_miss = _metrics.counter(
    "pipeline_prefetch_misses_total",
    "next() calls that had to wait on the pipeline")
_m_batches = _metrics.counter(
    "pipeline_batches_total", "batches delivered to the consumer")

_END = object()
STATE_VERSION = 1


class PipelineClosed(RuntimeError):
    """Raised when iterating a pipeline after close()."""


class _Err:
    """Error envelope: carries a stage thread's exception to next()."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


class Pipeline:
    """Composable staged input pipeline; see the module docstring.

    ``source``: a ``pipeline.Source`` or a zero-arg v2 reader callable.
    ``transform``: optional per-sample fn run by ``transform_workers``
    ordered parallel workers. ``shuffle_size``>0 inserts the streaming
    shuffle (seeded; its RNG + buffer checkpoint with the pipeline).
    ``batch_size=None`` passes source items through as ready batches.
    ``convert``/``transfer`` form the device stage — the trainer wires
    ``DataFeeder.feed`` and, on the card, ``trainer.DeviceTransfer`` via
    ``attach()``; both default to identity for host-only pipelines.

    ``track_state=False`` skips the per-batch stage-chain snapshot (a
    copy of the shuffle buffer's references + RNG state per emitted
    batch) for pipelines that will never checkpoint — ``state_dict()``
    then raises instead of returning a stale position.
    """

    def __init__(self, source, *, transform: Optional[Callable] = None,
                 transform_workers: int = 2, shuffle_size: int = 0,
                 seed: int = 0, batch_size: Optional[int] = None,
                 drop_last: bool = True, prefetch: int = 2,
                 device_depth: int = 2, convert: Optional[Callable] = None,
                 transfer: Optional[Callable] = None,
                 name: str = "pipeline", track_state: bool = True):
        self.source: Source = as_source(source)
        self._xform = (TransformStage(transform, transform_workers)
                       if transform is not None else None)
        self._shuffle = (ShuffleStage(shuffle_size, seed)
                         if shuffle_size else None)
        self._batch = BatchStage(batch_size, drop_last)
        self.prefetch = max(1, int(prefetch))
        self.device_depth = max(1, int(device_depth))
        self._convert = convert
        self._transfer = transfer
        self.name = name
        self.track_state = bool(track_state)
        self._restore_pending = []
        self._restore_draining = False
        self._stop = threading.Event()
        self._threads = []
        self._ring: Optional[queue.Queue] = None
        self._out: Optional[queue.Queue] = None
        self._active = False
        self._closed = False
        # identity of the CURRENT iteration: an abandoned epoch
        # generator whose GC-driven finally runs late must not tear
        # down a newer iteration's threads (close() already cleaned
        # the stale one when it invalidated the token)
        self._iter_token = None
        self._state = self._snapshot() if self.track_state else None

    # -- device-stage wiring (trainer) ------------------------------------
    def attach(self, convert: Optional[Callable] = None,
               transfer: Optional[Callable] = None) -> "Pipeline":
        """Install the convert/transfer fns of the device stage (the
        trainer calls this with its DataFeeder and device transfer).
        Must happen before iteration starts."""
        enforce.enforce(not self._active,
                        "pipeline.attach() while iterating")
        if convert is not None:
            self._convert = convert
        if transfer is not None:
            self._transfer = transfer
        return self

    # -- checkpoint state --------------------------------------------------
    def _snapshot(self) -> dict:
        """Consistent stage-chain snapshot; only called while the stage
        generators are suspended (producer thread at a batch boundary,
        or with no iteration active)."""
        return {
            "version": STATE_VERSION,
            "source": self.source.state_dict(),
            # in-flight transform raws + whether they are an epoch TAIL
            # (source already rolled): a tail restore must finish the
            # epoch from the raws alone, not splice next-epoch samples
            "pending": {
                "raws": (self._xform.pending() if self._xform
                         else []) + list(self._restore_pending),
                "draining": bool(
                    (self._xform.draining if self._xform else False)
                    or self._restore_draining),
            },
            "shuffle": self._shuffle.state() if self._shuffle else None,
            "batch": self._batch.state(),
        }

    def state_dict(self) -> dict:
        """The resume point: pipeline state as of the last batch the
        consumer received. Persist it next to the model checkpoint
        (``save_checkpoint(..., pipeline_state=...)``); restoring it
        continues the stream on the exact next batch."""
        enforce.enforce(
            self.track_state,
            "pipeline was built with track_state=False — no stream "
            "position is being captured to checkpoint")
        return self._state

    def load_state_dict(self, state: dict) -> None:
        enforce.enforce(not self._active,
                        "pipeline.load_state_dict() while iterating")
        enforce.enforce(
            self.track_state,
            "pipeline.load_state_dict() on a track_state=False pipeline")
        enforce.enforce(
            state.get("version") == STATE_VERSION,
            f"pipeline state version {state.get('version')} != "
            f"{STATE_VERSION}")
        self.source.load_state_dict(state["source"])
        pend = state.get("pending") or {}
        pending = list(pend.get("raws", ()))
        enforce.enforce(
            not pending or self._xform is not None,
            "pipeline state carries in-flight transform samples but "
            "this pipeline has no transform stage")
        if self._xform is not None:
            # the restored state REPLACES any abandoned epoch's leftover
            # in-flight work — keeping both would replay samples twice
            self._xform.take_inflight()
            self._xform.draining = False
        self._restore_pending = pending
        self._restore_draining = bool(pend.get("draining", False))
        if state.get("shuffle") is not None:
            enforce.enforce(
                self._shuffle is not None,
                "pipeline state carries shuffle state but this pipeline "
                "has no shuffle stage")
            self._shuffle.load_state(state["shuffle"])
        self._batch.load_state(state["batch"])
        self._state = self._snapshot()

    @property
    def batches_delivered(self) -> int:
        return self._batch.batches

    # -- stage threads -----------------------------------------------------
    def _produce(self, ring: queue.Queue, stop: threading.Event) -> None:
        try:
            stream = iter(self.source)
            if self._xform is not None:
                preload, self._restore_pending = self._restore_pending, []
                tail, self._restore_draining = self._restore_draining, False
                stream = self._xform.feed(stream, preload,
                                          preload_only=tail)
            if self._shuffle is not None:
                stream = self._shuffle.feed(stream)
            stream = self._batch.feed(stream)
            t0 = time.perf_counter()
            for batch in stream:
                _m_stage.observe(time.perf_counter() - t0,
                                 pipeline=self.name, stage="produce")
                state = self._snapshot() if self.track_state else None
                if not _put(ring, (batch, state), stop):
                    stream.close()     # run stage finalizers now
                    return
                _m_depth.set(ring.qsize(), pipeline=self.name,
                             stage="ring")
                t0 = time.perf_counter()
            _put(ring, _END, stop)
        except BaseException as e:  # noqa: BLE001 — re-raised at next()
            _put(ring, _Err(e), stop)

    def _feed(self, ring: queue.Queue, out: queue.Queue,
              stop: threading.Event) -> None:
        try:
            while True:
                try:
                    item = ring.get(timeout=0.1)
                except queue.Empty:
                    if stop.is_set():
                        return
                    continue
                _m_depth.set(ring.qsize(), pipeline=self.name,
                             stage="ring")
                if item is _END or isinstance(item, _Err):
                    _put(out, item, stop)
                    return
                batch, state = item
                with observe.trace_scope("feed"):
                    t0 = time.perf_counter()
                    if self._convert is not None:
                        with observe.trace_scope("convert"):
                            batch = self._convert(batch)
                    t1 = time.perf_counter()
                    _m_stage.observe(t1 - t0, pipeline=self.name,
                                     stage="convert")
                    if self._transfer is not None:
                        with observe.trace_scope("transfer"):
                            batch = self._transfer(batch)
                    _m_stage.observe(time.perf_counter() - t1,
                                     pipeline=self.name, stage="transfer")
                if not _put(out, (batch, state), stop):
                    return
                _m_depth.set(out.qsize(), pipeline=self.name,
                             stage="device")
        except BaseException as e:  # noqa: BLE001 — re-raised at next()
            _put(out, _Err(e), stop)

    # -- consumption -------------------------------------------------------
    def __iter__(self):
        """Yield device-ready feeds for ONE epoch (resuming mid-epoch
        when state was loaded); iterate again for the next epoch. Only
        one active iteration at a time. Abandoning an iteration
        mid-epoch discards the batches staged in the ring/device queues
        (in-flight TRANSFORM work is preserved and re-submitted) — for
        an exact continuation, restore via ``load_state_dict`` instead
        of abandoning."""
        if self._closed:
            raise PipelineClosed(f"pipeline {self.name!r} is closed")
        enforce.enforce(not self._active,
                        "pipeline already has an active iteration")
        self._active = True
        stop = self._stop = threading.Event()
        token = self._iter_token = object()
        ring = self._ring = queue.Queue(maxsize=self.prefetch)
        out = self._out = queue.Queue(maxsize=self.device_depth)
        threads = [
            threading.Thread(target=self._produce, args=(ring, stop),
                             name="pipeline-produce", daemon=True),
            threading.Thread(target=self._feed, args=(ring, out, stop),
                             name="pipeline-feed", daemon=True),
        ]
        self._threads = threads
        for t in threads:
            t.start()
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    item = out.get_nowait()
                    _m_hits.inc(pipeline=self.name)
                except queue.Empty:
                    _m_miss.inc(pipeline=self.name)
                    with observe.trace_scope("feed"), \
                            observe.trace_scope("wait"):
                        while True:
                            try:
                                item = out.get(timeout=0.1)
                                break
                            except queue.Empty:
                                if stop.is_set():
                                    raise PipelineClosed(
                                        f"pipeline {self.name!r} closed "
                                        f"while iterating") from None
                    _m_wait.inc(time.perf_counter() - t0,
                                pipeline=self.name)
                _m_depth.set(out.qsize(), pipeline=self.name,
                             stage="device")
                if item is _END:
                    return
                if isinstance(item, _Err):
                    raise item.exc
                feeds, state = item
                self._state = state
                _m_batches.inc(pipeline=self.name)
                yield feeds
        finally:
            # a stale generator (abandoned, finalized late by GC after a
            # newer iter() started) was already cleaned up by close();
            # only the iteration that still owns the token tears down
            if self._iter_token is token:
                self._end_iteration()

    def _end_iteration(self) -> None:
        """Stop + join this iteration's threads (normal epoch end, an
        abandoned generator, or an error — all paths come through
        here, so no thread outlives its epoch)."""
        queues = [q for q in (self._ring, self._out) if q is not None]
        alive = drain_join(queues, self._threads, self._stop)
        if alive:
            # a producer stuck >10s inside user reader/transform code
            # cannot be joined; abandon it as a daemon and WARN — this
            # runs from finally blocks during exception propagation and
            # from trainer.train's cleanup, where a raise would mask
            # the original training error and leave close() half-done
            from paddle_tpu_torch.utils.logger import get_logger
            get_logger("pipeline").warning(
                "pipeline %r: thread(s) %s still blocked in user code "
                "after 10s — abandoning them as daemons",
                self.name, [t.name for t in alive])
        self._threads = []
        self._ring = self._out = None
        self._active = False
        self._iter_token = None

    def __next__(self):
        raise TypeError("iterate the pipeline with iter()/for — each "
                        "iteration is one epoch")

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        """Stop all stage threads and release the transform pool.
        Idempotent; the pipeline cannot be iterated afterwards (its
        state_dict stays readable)."""
        if self._closed:
            return
        self._stop.set()
        if self._active:
            self._end_iteration()
        if self._xform is not None:
            self._xform.close()
        self._closed = True

    def __enter__(self) -> "Pipeline":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # best-effort: tests must close() explicitly
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass
