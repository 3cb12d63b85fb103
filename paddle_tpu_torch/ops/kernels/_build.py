"""Build the Hopper kernels from ``csrc/`` and bind them with ctypes.

Each ``csrc/*.cu`` source has a plain C interface (no PyTorch headers),
so ``nvcc`` compiles it in seconds. The sources compile in parallel,
one ``nvcc`` process each, into objects that one more ``nvcc`` call
links into a single shared library; ``ctypes`` loads it. The build
happens at first use, never at import, into ``build/kernels/<key>/``
at the root of the checkout (``.gitignore`` lists ``build/``), where
``<key>`` hashes the sources and flags — an edited source builds
afresh, an unchanged one loads the library already there.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an
exception naming the kernel.
"""

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().with_name("csrc")
SOURCES = ("decode_attention.cu", "fused_sample.cu", "chunk_prefill.cu",
           "chunk_prefill_f32.cu", "span_write.cu", "flash_attn_fwd.cu",
           "flash_attn_bwd.cu", "flash_attn_fwd_f32.cu",
           "flash_attn_bwd_f32.cu")
HEADERS = ("common.cuh", "flash_tc.cuh", "flash_tile.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
LIB_NAME = "libpaddle_kernels.so"
SMEM_LIMIT = 232448          # bytes one block may use on Hopper (227 KB)

# dtype codes of the C interface (csrc/common.cuh: pk::DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# KV pool storage codes (csrc/common.cuh: pk::KvStore)
KV_CODES = {"none": 0, "int8": 1, "int4": 2}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argtypes of every C entry point: pointers and the stream as void*,
# so ctypes never truncates a 64-bit address to an int
SIGNATURES = {
    # q, k, v, k_scale, v_scale, pages, pos, out, partials, counters, B,
    # Hkv, G, Dh, M, P, bs, scale, dtype, kv, smem_bytes, stream
    "pk_decode_attention": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                            _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P],
    # logits, temperature, top_k, out, B, V, seed (device int32), threefry,
    # stream
    "pk_fused_sample": [_P, _P, _P, _P, _I, _I, _P, _I, _P],
    # q, k_chunk, v_chunk, k, v, k_scale, v_scale, pages, out, partials,
    # counters, C, Hkv, G, Dh, M, P_ctx, bs, rows_per_cta, scale, dtype,
    # kv, smem_bytes, stream
    "pk_chunk_prefill": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                         _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P],
    # pool x4, span x4, row_bytes x4, n, pages, valid, LH, pc, M, bs,
    # stream
    "pk_span_write": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                      _P, _P, _I, _I, _I, _I, _P],
    # q, k, v, out, lse, BH, T, D, scale, causal, dtype, stream
    "pk_flash_attn_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _P],
    # q, k, v, do, lse, delta, dq, dk, dv, BH, T, D, scale, causal, dtype,
    # stream
    "pk_flash_attn_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                          _F, _I, _I, _P],
}


class _Library:
    """The loaded shared library, built once per process."""

    def __init__(self):
        self._lock = threading.Lock()
        self.lib = None
        self.build_seconds = None      # nvcc wall time; 0.0 = cached
        self.build_dir = None

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self.lib is None:
                self.lib = self._load()
            return self.lib

    def _load(self) -> ctypes.CDLL:
        key = _source_key()
        out_dir = BUILD_ROOT / key
        lib_path = out_dir / LIB_NAME
        t0 = time.perf_counter()
        if lib_path.exists():
            self.build_seconds = 0.0
        else:
            _compile(out_dir, lib_path)
            self.build_seconds = time.perf_counter() - t0
        self.build_dir = out_dir
        lib = ctypes.CDLL(str(lib_path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        return lib


_LIBRARY = _Library()


def library() -> ctypes.CDLL:
    """The kernels' shared library, built from ``csrc/`` at first use."""
    return _LIBRARY.get()


def build_info() -> dict:
    """``{"seconds", "dir"}`` of the build this process loaded (seconds
    is 0.0 when the library was already built)."""
    return {"seconds": _LIBRARY.build_seconds,
            "dir": str(_LIBRARY.build_dir) if _LIBRARY.build_dir else None}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under CUDA_HOME or
    /usr/local/cuda. Raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the Hopper kernels are built from "
                       "source and need the CUDA toolkit")


def _source_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _compile(out_dir: Path, lib_path: Path):
    """One nvcc per source, all started together, then one link."""
    nvcc = nvcc_path()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in SOURCES:
        obj = out_dir / (Path(src).stem + ".o")
        log = open(out_dir / (Path(src).stem + ".log"), "w")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)]
        procs.append((src, obj, log,
                      subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT)))
    failed = []
    for src, _, log, proc in procs:
        if proc.wait() != 0:
            failed.append(src)
        log.close()
    if failed:
        msgs = "\n".join((out_dir / (Path(s).stem + ".log")).read_text()
                         for s in failed)
        raise RuntimeError(f"nvcc failed on {failed}:\n{msgs}")
    tmp = out_dir / (LIB_NAME + f".tmp{os.getpid()}")
    cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
           *[str(obj) for _, obj, _, _ in procs]]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{done.stdout}{done.stderr}")
    os.replace(tmp, lib_path)


def check(err: int, kernel: str):
    """Raise when a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA error {err} at launch")


def ptr(t):
    """A tensor's device address as an int for a ``c_void_p`` argument
    (None, a null pointer, for None)."""
    return None if t is None else t.data_ptr()


def stream(device: torch.device) -> int:
    """The raw handle of ``device``'s current stream (0 for the legacy
    default stream), for a ``c_void_p`` argument: read straight from
    PyTorch's stream registry, without building a ``torch.cuda.Stream``
    (a few microseconds a launch)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


_CURRENT = contextlib.nullcontext()


def on_device(device: torch.device):
    """A context that makes ``device`` the current CUDA device for a
    launch: nothing to do when it is current already (the common case,
    and a device switch costs a few microseconds a launch)."""
    if device.index == torch.cuda.current_device():
        return _CURRENT
    return torch.cuda.device(device)


def require(t: torch.Tensor, what: str, *, device: torch.device,
            dtype=None, shape=None, ndim=None):
    """Validate one kernel operand: CUDA device, dtype, shape,
    contiguity. Raises ValueError naming the operand."""
    if t.device != device:
        raise ValueError(f"{what}: on {t.device}, expected {device}")
    if dtype is not None and t.dtype not in (
            dtype if isinstance(dtype, tuple) else (dtype,)):
        raise ValueError(f"{what}: dtype {t.dtype}, expected {dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{what}: rank {t.dim()}, expected {ndim}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: must be contiguous")


def kv_store(kv_dtype, kernel: str) -> str:
    """A pool's ``kv_dtype`` as a key of ``KV_CODES`` (None is
    ``"none"``); raises ValueError for one the kernels do not take."""
    kv = "none" if kv_dtype is None else kv_dtype
    if kv not in KV_CODES:
        raise ValueError(f"{kernel}: kv_dtype {kv_dtype!r}, expected one "
                         f"of {tuple(KV_CODES)}")
    return kv


def new_launch_counts(branches=tuple(KV_CODES)) -> dict:
    """Per-branch launch counts of a wrapper with more than one kernel
    instantiation: one count per branch, the model-dtype branch first
    (by default the ``KV_CODES`` keys, for a kernel templated on the
    pool storage)."""
    return {b: 0 for b in branches}


def on_cpu(t: torch.Tensor, kernel: str) -> bool:
    """True for a CPU tensor (the caller then runs the plain version);
    False for a CUDA tensor; raises for any other device."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"{kernel}: no kernel for device {t.device}")

