"""Multi-process runtime initialisation — the cluster-training control
plane (counterpart of ``paddle_tpu/distributed.py``).

Reference: the trainer/pserver process topology was assembled by gflags
(--trainer_id/--num_gradient_servers/--pservers, utils/Flags.cpp:58-81)
and launcher scripts (paddle/scripts/cluster_train/paddle.py SSH fan-out,
submit_local.sh.in).

One process per rank joins a ``torch.distributed`` process group: NCCL
on the card, gloo only when the caller (or ``PADDLE_PLATFORM=cpu``)
asks for the CPU. There is no gloo fallback when NCCL fails, and no CPU
fallback where there is no card: ``init`` raises. Every group gets an
explicit timeout (``group_timeout``), so a lost rank fails the
collective that waits for it instead of hanging it.

- ``init()``         — join the group (env-var or explicit args)
- ``hybrid_mesh()``  — an outer ``dcn`` axis (one slice per process
  group of ranks) over a per-slice mesh
- the local N-process simulation lives in
  ``paddle_tpu_torch.runtime.launch``

Env contract (written by ``runtime.launch.spawn_local_procs`` or your
scheduler):
  PADDLE_COORDINATOR   host:port of rank 0 (the TCP rendezvous)
  PADDLE_NUM_PROCESSES total process count
  PADDLE_PROCESS_ID    this process's rank
  PADDLE_PLATFORM      "cpu" selects gloo on the CPU; else NCCL
  PADDLE_DIST_TIMEOUT_S  the group timeout in seconds (default 300)
``PADDLE_LOCAL_CPU_DEVICES`` is read and ignored: a rank drives one
device.
"""

import datetime
import os
import time
from typing import Optional, Sequence

from paddle_tpu_torch.observe import metrics as _metrics
from paddle_tpu_torch.utils.logger import get_logger

log = get_logger("distributed")

_initialized = False
_timeout = datetime.timedelta(seconds=300)

_m_init_s = _metrics.gauge(
    "distributed_init_seconds", "wall time of init_process_group")
_m_procs = _metrics.gauge("distributed_process_count",
                          "processes in the cluster")
_m_devices = _metrics.gauge("distributed_global_devices",
                            "global device count")
_m_barriers = _metrics.counter("distributed_barriers_total",
                               "cross-process barriers entered")
_m_barrier_s = _metrics.histogram(
    "distributed_barrier_seconds",
    "barrier wait time — the straggler detector (BarrierStat slot)")


def is_initialized() -> bool:
    return _initialized


def group_timeout() -> datetime.timedelta:
    """The timeout every group of this process is made with."""
    return _timeout


def backend() -> Optional[str]:
    """"nccl" or "gloo" once initialised, else None."""
    import torch.distributed as dist
    return dist.get_backend() if _initialized else None


def init(coordinator_address: Optional[str] = None,
         num_processes: Optional[int] = None,
         process_id: Optional[int] = None,
         platform: Optional[str] = None,
         local_cpu_devices: Optional[int] = None,
         timeout_s: Optional[float] = None) -> None:
    """Join (or create) the process group.

    With no arguments, reads the PADDLE_* env contract; with nothing set
    it does nothing, keeping single-process semantics (as the JAX
    package's does off a TPU pod). NCCL unless ``platform`` (or
    ``PADDLE_PLATFORM``) is "cpu"; NCCL without a card raises. The rank
    drives ``cuda:<rank % cards>``."""
    global _initialized, _timeout
    if _initialized:
        log.warning("distributed.init() called twice; ignoring")
        return
    import torch
    import torch.distributed as dist

    coordinator_address = coordinator_address or os.environ.get(
        "PADDLE_COORDINATOR")
    if num_processes is None and os.environ.get("PADDLE_NUM_PROCESSES"):
        num_processes = int(os.environ["PADDLE_NUM_PROCESSES"])
    if process_id is None and os.environ.get("PADDLE_PROCESS_ID"):
        process_id = int(os.environ["PADDLE_PROCESS_ID"])
    platform = platform or os.environ.get("PADDLE_PLATFORM")
    if timeout_s is None and os.environ.get("PADDLE_DIST_TIMEOUT_S"):
        timeout_s = float(os.environ["PADDLE_DIST_TIMEOUT_S"])
    del local_cpu_devices            # one device per rank
    if coordinator_address is None and num_processes is None:
        log.info("distributed: single-process mode (no PADDLE_* env)")
        return
    if coordinator_address is None or num_processes is None:
        raise ValueError("distributed.init needs both the coordinator "
                         "address and the process count")
    process_id = int(process_id or 0)
    if platform == "cpu":
        be = "gloo"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "distributed.init: no CUDA device for NCCL; set "
                "PADDLE_PLATFORM=cpu (or platform='cpu') to run gloo on "
                "the CPU")
        be = "nccl"
    if timeout_s is not None:
        _timeout = datetime.timedelta(seconds=float(timeout_s))
    kw = {}
    if be == "nccl":
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    t0 = time.perf_counter()
    dist.init_process_group(be, init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=process_id,
                            timeout=_timeout, **kw)
    _initialized = True
    _m_init_s.set(time.perf_counter() - t0)
    _m_procs.set(dist.get_world_size())
    _m_devices.set(dist.get_world_size())
    log.info("distributed: joined as process %d/%d over %s", process_id,
             num_processes, be)


def shutdown():
    global _initialized
    if _initialized:
        import torch.distributed as dist
        from paddle_tpu_torch.core import place
        place._MESHES.clear()
        dist.destroy_process_group()
        _initialized = False


_barrier_win = None


def barrier_window(create: bool = True):
    """The raw barrier-wait window this process exports to a gang
    supervisor: pooled gang quantiles need raw samples, which the
    histogram above has binned away. Lazy; ``create=False`` peeks."""
    global _barrier_win
    if _barrier_win is None and create:
        from paddle_tpu_torch.observe.window import WindowedQuantiles
        _barrier_win = WindowedQuantiles(window_s=120.0,
                                         max_samples=1024)
    return _barrier_win


def barrier(name: str = "barrier") -> float:
    """Block until every process reaches this point; returns (and
    records) this process's wait in seconds — the straggler detector
    the reference built BarrierStat for (paddle/utils/Stat.h): a process
    whose wait is consistently near zero while peers wait long IS the
    straggler. Single-process: returns at once (still counted)."""
    wall0 = time.time()
    t0 = time.perf_counter()
    if _initialized and process_count() > 1:
        import torch
        import torch.distributed as dist
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()
    elif _initialized and backend() == "nccl":
        import torch
        import torch.distributed as dist
        # a world of one still makes the NCCL round trip, so a barrier
        # there measures the collective's own latency
        dist.barrier(device_ids=[torch.cuda.current_device()])
    dt = time.perf_counter() - t0
    _m_barriers.inc(name=name)
    _m_barrier_s.observe(dt, name=name)
    barrier_window().observe(dt)
    from paddle_tpu_torch.observe import chrome_trace
    chrome_trace.record_span(f"barrier/{name}", wall0, dt)
    chrome_trace.note_alignment(f"barrier/{name}", wall0 + dt)
    return dt


def process_index() -> int:
    if not _initialized:
        return 0
    import torch.distributed as dist
    return dist.get_rank()


def process_count() -> int:
    if not _initialized:
        return 1
    import torch.distributed as dist
    return dist.get_world_size()


def hybrid_mesh(ici_shape: Sequence[int], axis_names: Sequence[str],
                dcn_axis: str = "dcn",
                num_slices: Optional[int] = None):
    """A ``dcn`` x per-slice mesh for multi-slice jobs.

    ``ici_shape`` / ``axis_names`` lay out the ranks within a slice; the
    leading ``dcn_axis`` spans slices (usually the pure-DP axis). A
    single slice (``num_slices=1``) gets a plain mesh without the DCN
    axis. The slice count defaults to the world over the slice size."""
    import numpy as np
    from paddle_tpu_torch.core import place

    n = place.device_count()
    per_slice = int(np.prod(ici_shape))
    if num_slices is None:
        num_slices = max(1, n // per_slice)
    if per_slice * num_slices != n:
        raise ValueError(
            f"ici {tuple(ici_shape)} x {num_slices} slices needs "
            f"{per_slice * num_slices} devices, have {n}")
    if num_slices == 1:
        return place.make_mesh(tuple(ici_shape), tuple(axis_names))
    return place.make_mesh((num_slices,) + tuple(ici_shape),
                           (dcn_axis,) + tuple(axis_names))
