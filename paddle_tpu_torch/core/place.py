"""Device placement (counterpart of ``paddle_tpu/core/place.py``).

Entry points take an explicit ``device``; when it is omitted they run
on :func:`default_device`, the first CUDA card. There is no quiet CPU
fallback: a caller that wants the CPU (the tests do) says so.
"""

import os
from typing import Optional

import torch

# Declared peak dense FLOP/s per card, bf16 inputs with fp32
# accumulation on the tensor cores (NVIDIA data sheets, SXM parts,
# without sparsity), matched against ``torch.cuda.get_device_name``
# longest pattern first. The MFU accounting in ``observe.costs``
# divides by it; an unknown card (or the CPU) reports no MFU rather
# than an invented one.
PEAK_FLOPS_TABLE = (
    ("h100", 989e12),
)


def default_device() -> torch.device:
    """The first CUDA card. Raises where there is none: the port never
    decides on its own to run on the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' explicitly to run the "
            "plain PyTorch path on the CPU")
    return torch.device("cuda:0")


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the card. A
    bare ``"cuda"`` gets its index, so devices compare equal to the ones
    tensors report."""
    if device is None:
        return default_device()
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def peak_flops(device=None) -> Optional[float]:
    """Declared peak FLOP/s of a CUDA ``device`` (default: the first
    card), or None for the CPU and for cards the table does not know.
    ``PADDLE_TPU_PEAK_TFLOPS`` (in TFLOP/s) overrides the table for any
    device, as in the JAX package."""
    env = os.environ.get("PADDLE_TPU_PEAK_TFLOPS")
    if env:
        try:
            return float(env) * 1e12
        except ValueError:
            pass
    device = resolve_device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device).lower()
    best = None
    for pat, flops in PEAK_FLOPS_TABLE:
        if pat in name and (best is None or len(pat) > len(best[0])):
            best = (pat, flops)
    return best[1] if best else None


# ---------------------------------------------------------------------------
# meshes (the multi-rank tier)
# ---------------------------------------------------------------------------

# Canonical mesh-axis names, the JAX package's: data (DP), model (TP),
# seq (SP / context parallelism), expert (EP), stage (PP).
AXIS_DATA = "data"
AXIS_MODEL = "model"
AXIS_SEQ = "seq"
AXIS_EXPERT = "expert"
AXIS_STAGE = "stage"

# meshes are built once per (shape, axes): building one creates process
# groups, which every rank must do in the same order
_MESHES = {}


def _world():
    import torch.distributed as dist
    if not dist.is_available() or not dist.is_initialized():
        return None
    return dist.get_world_size()


def local_devices(platform: Optional[str] = None):
    """The devices this process drives: one per rank, the rank's card
    under NCCL (``cuda:<local rank>``), else the CPU. ``platform``
    ("gpu" / "cpu") asks for one kind."""
    import torch.distributed as dist
    if platform == "cpu":
        return [torch.device("cpu")]
    if platform in (None, "gpu", "cuda"):
        if dist.is_available() and dist.is_initialized() \
                and dist.get_backend() == "nccl":
            return [torch.device("cuda", torch.cuda.current_device())]
        if platform is not None or torch.cuda.is_available():
            return [default_device()]
    return [torch.device("cpu")]


def device_count() -> int:
    """Global device count: the ranks of the process group (one device
    per rank), 1 without one."""
    return _world() or 1


def make_mesh(shape, axes):
    """A ``torch.distributed.device_mesh.DeviceMesh`` of ``shape`` named
    ``axes`` over the ranks of the initialised process group
    (``distributed.init``), rank-major as ``jax.devices()`` is laid out.
    Each axis's groups are made with the group timeout of ``init``; the
    mesh must cover every rank (one device per rank)."""
    import numpy as np
    from torch.distributed.device_mesh import DeviceMesh
    import torch.distributed as dist
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} vs axes {axes}")
    n = int(np.prod(shape))
    world = _world()
    if world is None:
        raise RuntimeError(
            f"mesh {shape} needs a process group: call "
            f"paddle_tpu_torch.distributed.init() first")
    if n != world:
        raise ValueError(f"mesh {shape} needs {n} devices, have {world}")
    key = (shape, axes)
    if key in _MESHES:
        return _MESHES[key]
    from paddle_tpu_torch import distributed
    ranks = np.arange(n).reshape(shape)
    me = dist.get_rank()
    groups = []
    for d in range(len(shape)):
        moved = np.moveaxis(ranks, d, -1).reshape(-1, shape[d])
        mine = None
        for row in moved:
            g = dist.new_group([int(r) for r in row],
                               timeout=distributed.group_timeout())
            if me in row:
                mine = g
        groups.append(mine)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = DeviceMesh.from_group(groups, device_type,
                                 mesh=torch.as_tensor(ranks),
                                 mesh_dim_names=axes)
    _MESHES[key] = mesh
    return mesh


def default_mesh(data_parallel: Optional[int] = None):
    """1-D data-parallel mesh over every rank."""
    n = data_parallel or device_count()
    return make_mesh((n,), (AXIS_DATA,))


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a mesh (``dict(jax_mesh.shape)``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))
