"""Chunked record file format (counterpart of
``paddle_tpu/runtime/recordio.py``; the files are that module's byte
for byte, written and read on either package's native or pure-Python
path).

Reference: the Go recordio library consumed by go/master (service.go
partitions datasets into recordio chunk tasks). Format here: sequence of
chunks, each = [u32 magic][u32 nrecords][u64 payload_len][crc32]
[payload: nrecords x (u32 len + bytes)]. Pickled python objects ride as
records. A chunk is the unit of task dispatch for the data service.
"""

import ctypes
import pickle
import struct
import zlib
from typing import Iterable, Iterator, List, Tuple

from paddle_tpu_torch.runtime import native

MAGIC = 0x0A0D5EC5
HEADER = struct.Struct("<IIQI")


class Writer:
    """Streaming chunk writer; each ``records_per_chunk`` records become one
    chunk (the master's task-dispatch unit). Framing + CRC run in the native
    codec when built."""

    def __init__(self, path: str, records_per_chunk: int = 1024,
                 raw: bool = False):
        self.path = path
        self.records_per_chunk = records_per_chunk
        self.raw = raw
        self._lib = native.get()
        self._buf: List[bytes] = []
        self._count = 0
        if self._lib is not None:
            open(path, "wb").close()      # native writer appends
            self._out = None
        else:
            self._out = open(path, "wb")

    def write(self, record) -> None:
        """Append one record (any picklable object; with raw=True the
        record must be bytes and is framed verbatim — the fixed-layout
        fast path the native batch loader consumes)."""
        if self.raw:
            if not isinstance(record, (bytes, bytearray, memoryview)):
                raise TypeError(
                    f"raw=True writer takes bytes-like records, got "
                    f"{type(record).__name__} (bytes(int) would silently "
                    f"write zeros)")
            self._buf.append(bytes(record))
        else:
            self._buf.append(pickle.dumps(record, protocol=4))
        self._count += 1
        if len(self._buf) >= self.records_per_chunk:
            self._flush()

    def _flush(self) -> None:
        if not self._buf:
            return
        buf, self._buf = self._buf, []
        if self._lib is not None:
            data = b"".join(buf)
            lens = (ctypes.c_uint * len(buf))(*[len(r) for r in buf])
            rc = self._lib.rio_write_chunk(self.path.encode(), data, lens,
                                           len(buf))
            if rc < 0:
                raise IOError(f"rio_write_chunk failed ({rc}) "
                              f"for {self.path}")
            return
        payload = b"".join(struct.pack("<I", len(r)) + r for r in buf)
        self._out.write(HEADER.pack(MAGIC, len(buf), len(payload),
                                    zlib.crc32(payload) & 0xFFFFFFFF))
        self._out.write(payload)

    def close(self) -> int:
        """Flush the tail chunk; returns total records written."""
        self._flush()
        if self._out is not None:
            self._out.close()
            self._out = None
        return self._count

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_records(path: str, records: Iterable, chunk_records: int = 1024,
                  raw: bool = False):
    """Write records (pickled, or verbatim bytes with raw=True) into
    chunks of chunk_records each."""
    with Writer(path, records_per_chunk=chunk_records, raw=raw) as w:
        for rec in records:
            w.write(rec)
    return w.close()


def chunk_offsets(path: str) -> List[Tuple[int, int]]:
    """Index pass: [(offset, nrecords)] per chunk — what the master
    partitions into tasks (go/master/service.go:106 partition)."""
    lib = native.get()
    if lib is not None:
        offs = ctypes.POINTER(ctypes.c_longlong)()
        cnts = ctypes.POINTER(ctypes.c_uint)()
        n = lib.rio_index(path.encode(), ctypes.byref(offs),
                          ctypes.byref(cnts))
        if n < 0:
            raise IOError(f"rio_index failed ({n}) for {path}")
        try:
            return [(int(offs[i]), int(cnts[i])) for i in range(n)]
        finally:
            lib.rio_free(offs)
            lib.rio_free(cnts)
    out = []
    with open(path, "rb") as f:
        while True:
            pos = f.tell()
            hdr = f.read(HEADER.size)
            if len(hdr) < HEADER.size:
                break
            magic, n, plen, crc = HEADER.unpack(hdr)
            if magic != MAGIC:
                raise IOError(f"bad chunk magic at {pos} in {path}")
            out.append((pos, n))
            f.seek(plen, 1)
    return out


def _iter_payload(payload: bytes, n: int, raw: bool = False) -> Iterator:
    pos = 0
    for _ in range(n):
        (rlen,) = struct.unpack_from("<I", payload, pos)
        pos += 4
        rec = payload[pos:pos + rlen]
        yield rec if raw else pickle.loads(rec)
        pos += rlen


def read_chunk(path: str, offset: int, raw: bool = False) -> Iterator:
    lib = native.get()
    if lib is not None:
        buf = ctypes.POINTER(ctypes.c_uint8)()
        nrec = ctypes.c_uint()
        plen = lib.rio_read_chunk(path.encode(), offset, ctypes.byref(buf),
                                  ctypes.byref(nrec))
        if plen < 0:
            raise IOError(f"rio_read_chunk failed ({plen}) at {offset} "
                          f"in {path}")
        try:
            payload = ctypes.string_at(buf, plen)
        finally:
            lib.rio_free(buf)
        yield from _iter_payload(payload, nrec.value, raw)
        return
    with open(path, "rb") as f:
        f.seek(offset)
        hdr = f.read(HEADER.size)
        magic, n, plen, crc = HEADER.unpack(hdr)
        if magic != MAGIC:
            raise IOError(f"bad chunk magic at {offset}")
        payload = f.read(plen)
        if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
            raise IOError(f"chunk crc mismatch at {offset} in {path}")
        yield from _iter_payload(payload, n, raw)


def read_records(path: str) -> Iterator:
    for offset, _ in chunk_offsets(path):
        yield from read_chunk(path, offset)
