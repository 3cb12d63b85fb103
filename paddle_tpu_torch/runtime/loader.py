"""Background-thread prefetch loader over recordio files (counterpart
of ``paddle_tpu/runtime/loader.py``).

The DataProvider double-buffer equivalent (reference:
gserver/dataproviders/DataProvider.h:292 DoubleBuffer — a background thread
fills batch buffers while the trainer consumes; PyDataProvider2.cpp:195 runs
the Python provider on a worker thread). Here the hot path — disk reads,
chunk CRC, record framing — runs on native C++ threads
(the port's own ``runtime/native/recordio.cc`` Loader); Python only
unpickles records as they pop. Falls back to a Python thread when the
native lib is unavailable (no g++). Each loader records the path its
last iteration took in ``path_taken`` ("native" or "python").
"""

import ctypes
import pickle
import queue
import random
import threading
from typing import Iterator, Optional

from paddle_tpu_torch.runtime import native, recordio


class PrefetchLoader:
    """Iterate records of a recordio file with prefetching.

    shuffle=True shuffles chunk order per epoch (record-level shuffling is
    the reader decorator's job — matching the master's chunk-task dispatch
    granularity, go/master/service.go partition). With num_threads > 1,
    record order is nondeterministic across chunk boundaries (concurrent
    chunk decoding feeds one queue); pass num_threads=1 when exact file
    order matters.
    """

    def __init__(self, path: str, shuffle: bool = False,
                 seed: Optional[int] = 0, num_threads: int = 2,
                 capacity: int = 4096):
        self.path = path
        self.shuffle = shuffle
        self.num_threads = num_threads
        self.capacity = capacity
        self._rng = random.Random(seed)
        self._chunks = recordio.chunk_offsets(path)
        self.path_taken: Optional[str] = None

    def __iter__(self) -> Iterator:
        offsets = [off for off, _ in self._chunks]
        if self.shuffle:
            self._rng.shuffle(offsets)
        lib = native.get()
        self.path_taken = "native" if lib is not None else "python"
        if lib is not None:
            yield from self._iter_native(lib, offsets)
        else:
            yield from self._iter_python(offsets)

    def _iter_native(self, lib, offsets):
        arr = (ctypes.c_longlong * len(offsets))(*offsets)
        handle = lib.loader_create(self.path.encode(), arr, len(offsets),
                                   self.num_threads, self.capacity)
        if not handle:
            raise IOError(f"loader_create failed for {self.path}")
        try:
            buf = ctypes.POINTER(ctypes.c_uint8)()
            while True:
                n = lib.loader_next(handle, ctypes.byref(buf))
                if n == 0:
                    break
                if n < 0:
                    raise IOError(f"native loader error {n} on {self.path}")
                try:
                    rec = ctypes.string_at(buf, n)
                finally:
                    lib.rio_free(buf)
                yield pickle.loads(rec)
        finally:
            lib.loader_destroy(handle)

    def _iter_python(self, offsets):
        q: "queue.Queue" = queue.Queue(maxsize=self.capacity)
        sentinel = object()
        err: list = []
        stop = threading.Event()

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for off in offsets:
                    for rec in recordio.read_chunk(self.path, off):
                        if not put(rec):
                            return          # consumer abandoned us
            except BaseException as e:      # propagate to the consumer
                err.append(e)
            finally:
                put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield item
        finally:
            stop.set()
            while not q.empty():            # unblock a full queue
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join()
        if err:
            raise err[0]


def reader_creator(path: str, shuffle: bool = False, seed: Optional[int] = 0,
                   num_threads: int = 2):
    """A v2-style reader() factory over a recordio file (reference:
    python/paddle/v2/reader/creator.py recordio)."""
    loader = PrefetchLoader(path, shuffle=shuffle, seed=seed,
                            num_threads=num_threads)

    def reader():
        return iter(loader)

    return reader


class DenseBatchLoader:
    """Whole batches of FIXED-SIZE raw records assembled in C++.

    The full native data path: recordio files written with
    ``Writer(raw=True)`` hold fixed-layout byte records; C++ reader
    threads decode chunks and ``loader_next_batch`` memcpys a whole
    [batch, record_bytes] matrix into a numpy buffer — no per-record
    Python object, pickle, or malloc anywhere (the DataProvider
    double-buffer pushed to its endpoint; reference:
    gserver/dataproviders/PyDataProvider2.cpp:195 async pool).
    Falls back to the Python chunk reader when the native lib is
    unavailable. Yields np.uint8 arrays [n, record_bytes]; the tail
    batch is short unless drop_last.

    shuffle=True shuffles CHUNK order only — record grouping within a
    batch recurs across epochs (and is fixed when chunk_records ==
    batch_size). Write files with chunk_records >> batch_size (and >1
    reader thread) for cross-epoch batch diversity, or pre-shuffle
    records at write time; sample-level reshuffling is only available on
    the per-sample reader path."""

    def __init__(self, path: str, record_bytes: int, batch_size: int,
                 shuffle: bool = False, seed: Optional[int] = 0,
                 num_threads: int = 2, capacity: Optional[int] = None,
                 drop_last: bool = False):
        self.path = path
        self.record_bytes = int(record_bytes)
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.num_threads = num_threads
        # capacity is counted in RECORDS; with large fixed-layout records
        # the default is a byte budget (a few batches, <=64 MB) so the
        # prefetch queue can't balloon to gigabytes
        if capacity is None:
            capacity = max(2 * self.batch_size,
                           min(4096, (64 << 20) // max(1, self.record_bytes)))
        self.capacity = capacity
        self.drop_last = drop_last
        self._rng = random.Random(seed)
        self._chunks = recordio.chunk_offsets(path)
        self.path_taken: Optional[str] = None

    def __iter__(self):
        import numpy as np
        offsets = [off for off, _ in self._chunks]
        if self.shuffle:
            self._rng.shuffle(offsets)
        lib = native.get()
        self.path_taken = "native" if lib is not None else "python"
        if lib is None:
            yield from self._iter_python(np, offsets)
            return
        arr = (ctypes.c_longlong * len(offsets))(*offsets)
        handle = lib.loader_create(self.path.encode(), arr, len(offsets),
                                   self.num_threads, self.capacity)
        if not handle:
            raise IOError(f"loader_create failed for {self.path}")
        try:
            while True:
                out = np.empty((self.batch_size, self.record_bytes),
                               dtype=np.uint8)
                n = lib.loader_next_batch(
                    handle, out.ctypes.data_as(
                        ctypes.POINTER(ctypes.c_uint8)),
                    self.batch_size, self.record_bytes)
                if n < 0:
                    raise IOError(
                        f"native batch loader error {n} on {self.path} "
                        f"(-100 = record size != {self.record_bytes}; "
                        f"other codes are chunk I/O/corruption)")
                if n == 0:
                    break
                if n < self.batch_size:
                    # short batch = end-of-data OR a deferred mid-batch
                    # error (the native side returns copied records
                    # first and re-surfaces the error on the next call);
                    # poke with batch=0 to distinguish, after yielding
                    # the records that were already assembled
                    probe = lib.loader_next_batch(
                        handle, out.ctypes.data_as(
                            ctypes.POINTER(ctypes.c_uint8)),
                        0, self.record_bytes)
                    if not self.drop_last:
                        yield out[:n]
                    if probe < 0:
                        raise IOError(
                            f"native batch loader error {probe} on "
                            f"{self.path} after a partial batch of {n} "
                            f"(-100 = record size != {self.record_bytes})")
                    break
                yield out
        finally:
            lib.loader_destroy(handle)

    def _iter_python(self, np, offsets):
        buf, fill = None, 0
        for off in offsets:
            for rec in recordio.read_chunk(self.path, off, raw=True):
                if len(rec) != self.record_bytes:
                    raise IOError(
                        f"record size {len(rec)} != {self.record_bytes} "
                        f"in {self.path}")
                if buf is None:
                    buf = np.empty((self.batch_size, self.record_bytes),
                                   dtype=np.uint8)
                buf[fill] = np.frombuffer(rec, dtype=np.uint8)
                fill += 1
                if fill == self.batch_size:
                    yield buf
                    buf, fill = None, 0
        if fill and not self.drop_last:
            yield buf[:fill]


def write_dense(path: str, samples, dim: int,
                chunk_records: int = 1024) -> int:
    """Pack (features float32[dim], int label) samples as fixed-layout raw
    records for DenseBatchLoader / dense_batch_reader."""
    import numpy as np

    def encode():
        for feat, label in samples:
            f = np.ascontiguousarray(feat, dtype=np.float32).reshape(-1)
            if f.size != dim:
                raise ValueError(f"feature size {f.size} != dim {dim}")
            yield f.tobytes() + np.int32(label).tobytes()

    return recordio.write_records(path, encode(),
                                  chunk_records=chunk_records, raw=True)


def dense_batch_reader(path: str, dim: int, batch_size: int,
                       shuffle: bool = False, seed: Optional[int] = 0,
                       num_threads: int = 2, drop_last: bool = False):
    """reader() factory yielding (features [n, dim] f32, labels [n] i32)
    batches assembled natively — plug straight into a feed dict or wrap
    for trainer.SGD."""
    import numpy as np

    rec_bytes = dim * 4 + 4
    rec_dtype = np.dtype([("feat", np.float32, (dim,)),
                          ("label", np.int32)])
    assert rec_dtype.itemsize == rec_bytes
    loader = DenseBatchLoader(path, rec_bytes, batch_size, shuffle=shuffle,
                              seed=seed, num_threads=num_threads,
                              drop_last=drop_last)

    def reader():
        for raw in loader:
            # zero-copy reinterpret of the contiguous [n, rec_bytes] block
            arr = raw.reshape(-1).view(rec_dtype)
            yield arr["feat"], arr["label"]

    return reader
