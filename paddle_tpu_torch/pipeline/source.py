"""Checkpointable sample sources for the input pipeline (counterpart of
``paddle_tpu/pipeline/source.py``; the same cursors, so a state taken
in either package resumes in the other).

Reference slot: the v1 data-provider layer (PyDataProvider2 readers) and
the Go master's chunk-task dispatch (go/master/service.go) — the three
ways training data enters the system:

- ``ReaderSource``   — any v2 reader callable (zero-arg, returns an
  iterator of samples). Cursor = sample offset; resume replays and
  skips, so exactness requires the callable to be deterministic
  (seeded shuffle decorators qualify).
- ``ShardSource``    — ``runtime/recordio`` shard files. Cursor =
  (epoch, chunk position, record position) against a per-epoch chunk
  permutation derived from (seed, epoch) — O(one chunk re-read) exact
  resume, no replay.
- ``MasterSource``   — a ``runtime.master.MasterClient`` task stream.
  Position lives in the MASTER's lease queues (a restore re-leases
  unfinished tasks, service.go recover semantics); local state is a
  best-effort record counter.

The Source contract the Pipeline builds on: iterating yields samples of
the CURRENT epoch from the current cursor, advancing the cursor per
sample; exhausting an epoch rolls the cursor to the next epoch's start.
``state_dict()`` is cheap (a few scalars) and must be captured only
while iteration is suspended — the Pipeline's producer does exactly
that, at batch boundaries.
"""

import random
from typing import Callable, Iterator, List, Optional, Sequence

from paddle_tpu_torch.utils import enforce


class Source:
    """Base: a resumable, epoch-aware sample stream."""

    kind = "source"

    def state_dict(self) -> dict:
        raise NotImplementedError

    def load_state_dict(self, state: dict) -> None:
        raise NotImplementedError

    def _check_kind(self, state: dict) -> None:
        got = state.get("kind")
        enforce.enforce(
            got == self.kind,
            f"pipeline source state mismatch: checkpoint carries "
            f"{got!r} state, this pipeline is built on {self.kind!r}")

    def __iter__(self) -> Iterator:
        raise NotImplementedError


def as_source(obj) -> Source:
    """Coerce a pipeline input into a Source: Source instances pass
    through, zero-arg reader callables wrap in ReaderSource."""
    if isinstance(obj, Source):
        return obj
    if callable(obj):
        return ReaderSource(obj)
    raise TypeError(
        f"pipeline source must be a Source or a reader callable, "
        f"got {type(obj).__name__}")


class ReaderSource(Source):
    """Wrap a v2 reader callable. Resume = re-invoke the callable and
    skip ``offset`` samples, so mid-epoch exactness requires the reader
    to be deterministic across invocations (seeded shuffle etc.); the
    skip cost is O(offset) — the shard/master sources avoid it."""

    kind = "reader"

    def __init__(self, reader_fn: Callable):
        self._fn = reader_fn
        self.epoch = 0
        self.offset = 0

    def state_dict(self) -> dict:
        return {"kind": self.kind, "epoch": self.epoch,
                "offset": self.offset}

    def load_state_dict(self, state: dict) -> None:
        self._check_kind(state)
        self.epoch = int(state["epoch"])
        self.offset = int(state["offset"])

    def __iter__(self) -> Iterator:
        it = iter(self._fn())
        for _ in range(self.offset):
            try:
                next(it)
            except StopIteration:
                # the reader shrank under the checkpoint: surface it —
                # silently restarting would replay seen data
                raise RuntimeError(
                    f"ReaderSource resume: reader exhausted before the "
                    f"checkpointed offset {self.offset} (epoch "
                    f"{self.epoch}) — the underlying data changed")
        for sample in it:
            self.offset += 1
            yield sample
        self.epoch += 1
        self.offset = 0


class ShardSource(Source):
    """Recordio shard files with an exact chunk-level cursor.

    Per epoch the chunk list (across all paths) is permuted by an RNG
    derived from ``(seed, epoch)`` — no RNG *state* needs persisting,
    the permutation is recomputed on resume. Resume cost: re-reading
    one chunk and skipping ``record_pos`` records inside it."""

    kind = "shards"

    def __init__(self, paths: Sequence[str], shuffle_chunks: bool = True,
                 seed: int = 0):
        if isinstance(paths, str):
            paths = [paths]
        self.paths = list(paths)
        enforce.enforce(self.paths, "ShardSource needs at least one path")
        self.shuffle_chunks = shuffle_chunks
        self.seed = int(seed)
        self.epoch = 0
        self.chunk_pos = 0
        self.record_pos = 0
        self._index: Optional[List] = None     # [(path, offset, nrecords)]

    def _build_index(self) -> List:
        if self._index is None:
            from paddle_tpu_torch.runtime import recordio
            idx = []
            for p in self.paths:
                for offset, n in recordio.chunk_offsets(p):
                    idx.append((p, offset, n))
            self._index = idx
        return self._index

    def _order(self, epoch: int) -> List[int]:
        order = list(range(len(self._build_index())))
        if self.shuffle_chunks:
            random.Random(self.seed * 1000003 + epoch).shuffle(order)
        return order

    def num_records(self) -> int:
        return sum(n for _, _, n in self._build_index())

    def state_dict(self) -> dict:
        return {"kind": self.kind, "epoch": self.epoch,
                "chunk_pos": self.chunk_pos,
                "record_pos": self.record_pos}

    def load_state_dict(self, state: dict) -> None:
        self._check_kind(state)
        self.epoch = int(state["epoch"])
        self.chunk_pos = int(state["chunk_pos"])
        self.record_pos = int(state["record_pos"])

    def __iter__(self) -> Iterator:
        from paddle_tpu_torch.runtime import recordio
        order = self._order(self.epoch)
        while self.chunk_pos < len(order):
            path, offset, _ = self._build_index()[order[self.chunk_pos]]
            records = list(recordio.read_chunk(path, offset))
            for i in range(self.record_pos, len(records)):
                self.record_pos = i + 1
                yield records[i]
            self.chunk_pos += 1
            self.record_pos = 0
        self.epoch += 1
        self.chunk_pos = 0


class MasterSource(Source):
    """Stream records from the elastic master service. The dispatch
    position is MASTER-side state (lease queues + snapshot file): on a
    trainer restart unfinished leases time out and requeue, so no data
    is lost — but the master's chunk granularity, not this counter,
    decides what replays. ``state_dict`` is therefore informational
    (records consumed), not a replay cursor."""

    kind = "master"

    def __init__(self, client, poll_interval: float = 0.05):
        self.client = client
        self.poll_interval = poll_interval
        self.records = 0
        self.epoch = 0

    def state_dict(self) -> dict:
        return {"kind": self.kind, "records": self.records,
                "epoch": self.epoch}

    def load_state_dict(self, state: dict) -> None:
        self._check_kind(state)
        self.records = int(state.get("records", 0))
        self.epoch = int(state.get("epoch", 0))

    def __iter__(self) -> Iterator:
        # one master pass per iteration — the Pipeline's epoch contract
        gen = self.client.reader(poll_interval=self.poll_interval,
                                 max_epochs=1)()
        for rec in gen:
            self.records += 1
            yield rec
        self.epoch += 1
