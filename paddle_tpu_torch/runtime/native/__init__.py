"""ctypes loader for the native record codec (counterpart of
``paddle_tpu/runtime/native/__init__.py``).

Builds this directory's own ``recordio.cc`` with g++ at first use into
``build/native/<key>/`` at the root of the checkout (``.gitignore``
lists ``build/``), where ``<key>`` hashes the source and the flags: an
edited source builds afresh, an unchanged one loads the library already
there. The compiler writes a per-process temporary file that
``os.replace`` publishes, under the directory's build lock
(``utils/buildlock.py``), so processes starting together compile once.
Nothing is built beside the source, and the JAX package's checked-in
library is never loaded. :func:`get` returns None where the toolchain
is missing, so the pure-Python paths keep working.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

from paddle_tpu_torch.utils.buildlock import build_lock

SRC = Path(__file__).resolve().with_name("recordio.cc")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "native"
LIB_NAME = "librecordio.so"
CXX = "g++"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib = None
_tried = False


def lib_path() -> Path:
    """Where the library of the current source lives once built."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def _build() -> Optional[Path]:
    """The built library's path (compiled now if missing), or None when
    the compiler is missing or fails."""
    out = lib_path()
    if out.exists():
        return out
    try:
        with build_lock(out.parent):
            if out.exists():            # another process built it
                return out
            tmp = out.with_name(f"{LIB_NAME}.tmp.{os.getpid()}")
            cmd = [CXX, *CXX_FLAGS, str(SRC), "-o", str(tmp), "-lz"]
            subprocess.run(cmd, check=True, capture_output=True,
                           timeout=120)
            os.replace(tmp, out)
            return out
    except (OSError, subprocess.SubprocessError):
        return None


def _bind(lib):
    c = ctypes
    lib.rio_index.restype = c.c_long
    lib.rio_index.argtypes = [c.c_char_p, c.POINTER(c.POINTER(c.c_longlong)),
                              c.POINTER(c.POINTER(c.c_uint))]
    lib.rio_read_chunk.restype = c.c_longlong
    lib.rio_read_chunk.argtypes = [c.c_char_p, c.c_longlong,
                                   c.POINTER(c.POINTER(c.c_uint8)),
                                   c.POINTER(c.c_uint)]
    lib.rio_write_chunk.restype = c.c_longlong
    lib.rio_write_chunk.argtypes = [c.c_char_p, c.c_char_p,
                                    c.POINTER(c.c_uint), c.c_uint]
    lib.rio_free.restype = None
    lib.rio_free.argtypes = [c.c_void_p]
    lib.loader_create.restype = c.c_void_p
    lib.loader_create.argtypes = [c.c_char_p, c.POINTER(c.c_longlong),
                                  c.c_long, c.c_int, c.c_long]
    lib.loader_next.restype = c.c_longlong
    lib.loader_next.argtypes = [c.c_void_p, c.POINTER(c.POINTER(c.c_uint8))]
    lib.loader_next_batch.restype = c.c_longlong
    lib.loader_next_batch.argtypes = [c.c_void_p, c.POINTER(c.c_uint8),
                                      c.c_long, c.c_longlong]
    lib.loader_destroy.restype = None
    lib.loader_destroy.argtypes = [c.c_void_p]
    return lib


def get():
    """The loaded native library, or None when unavailable."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = _build()
        if path is not None:
            try:
                _lib = _bind(ctypes.CDLL(str(path)))
            except OSError:
                _lib = None
        return _lib
