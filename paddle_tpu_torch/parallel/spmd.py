"""SPMD distribution: sharding rules, ZeRO and the collectives that carry
them (counterpart of ``paddle_tpu/parallel/spmd.py``).

Replaces the reference's parameter-server/data-parallel machinery
(pserver/ParameterServer2.h, go/pserver, MultiGradientMachine.h:44,
nccl_op.cc) with collectives over ``torch.distributed`` process groups,
one process per rank. The JAX package annotates arrays with
``NamedSharding``s and lets XLA place the collectives; here every rank
runs the same program on its own shard and the collectives are explicit,
issued through this module's wrappers so that one record
(``record_collectives``) holds every collective the port issued.

Conventions, the same everywhere in the port's parallel tier:

- a mesh is a ``DeviceMesh`` (``core.place.make_mesh``); a
  ``PartitionSpec`` names, per tensor dim, the mesh axis (or axes) that
  dim is split over, and ``Layout(mesh, spec)`` is ``NamedSharding``'s
  counterpart (``placements()`` gives the DTensor placements);
- a value whose spec is replicated is held whole by every rank;
  functions that take global arrays take them whole on every rank and
  return global results whole on every rank (``compat.shard_map``);
- a tensor STORED sharded (a ZeRO shard, a TP layout) is a ``DTensor``
  over the mesh with those placements; its local shard is what the
  rank computes with and updates.

ZeRO (``zero_stage=1..3`` / ``data_parallel(zero=N)``), the JAX
package's policy and its collective pattern:

- **stage 0** — gradients are all-reduced whole over the batch axis;
- **stage 1** — the optimizer state of replicated parameters is stored
  as 1/N shards of the largest dim divisible by the axis size (tiny,
  scalar and indivisible leaves stay replicated, ``zero_report`` says
  why); gradients are reduce-scattered into that shard, the update runs
  on the shard, the updated shard is all-gathered back;
- **stage 2** — gradients (and the accumulation carry) take the same
  layout: every microbatch reduce-scatters into the shard, no full
  gradient is all-reduced anywhere;
- **stage 3** — parameters are stored as 1/N shards and all-gathered on
  use; the updated shard stays sharded (no post-update all-gather).

TP-matched parameters keep their rule's layout at every stage. The
numerics are those of stage 0 at every stage (the same sums).
"""

import contextlib
import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from paddle_tpu_torch.core import place


class PartitionSpec(tuple):
    """Per-dim mesh axes: ``P(None, "model")`` splits dim 1 over
    ``model``; an entry may be a tuple of axes (split over their
    product, the first outermost); missing trailing dims are
    replicated."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return "PartitionSpec" + super().__repr__()


P = PartitionSpec


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, (tuple, list)):
        return tuple(entry)
    return (entry,)


def axis_size(mesh, axes) -> int:
    """Product of the sizes of ``axes`` (a name or a tuple of names);
    an axis the mesh does not carry counts 1."""
    shape = place.mesh_shape(mesh)
    return int(np.prod([shape.get(a, 1) for a in _axes_of(axes)] or [1]))


def axis_index(mesh, axes) -> int:
    """This rank's coordinate along ``axes`` (row-major over a tuple)."""
    shape = place.mesh_shape(mesh)
    idx = 0
    for a in _axes_of(axes):
        if a in shape:
            idx = idx * shape[a] + mesh.get_local_rank(a)
    return idx


@dataclasses.dataclass(frozen=True)
class Layout:
    """``NamedSharding``'s counterpart: a mesh and a PartitionSpec."""
    mesh: object
    spec: PartitionSpec

    def placements(self):
        """The DTensor placements of this layout, one per mesh dim
        (``Shard(d)`` where tensor dim d splits over that axis, else
        ``Replicate()``)."""
        from torch.distributed.tensor import Replicate, Shard
        out = [Replicate()] * len(self.mesh.mesh_dim_names)
        for d, entry in enumerate(self.spec):
            for a in _axes_of(entry):
                if a in self.mesh.mesh_dim_names:
                    out[self.mesh.mesh_dim_names.index(a)] = Shard(d)
        return tuple(out)

    @property
    def is_fully_replicated(self) -> bool:
        return all(axis_size(self.mesh, e) == 1 for e in self.spec)

    def local_slices(self, shape) -> Tuple[slice, ...]:
        """This rank's slice of a global array of ``shape``."""
        out = []
        for d, n in enumerate(shape):
            entry = self.spec[d] if d < len(self.spec) else None
            k = axis_size(self.mesh, entry)
            if n % k:
                raise ValueError(f"dim {d} of {tuple(shape)} does not "
                                 f"split over {entry} ({k})")
            i = axis_index(self.mesh, entry)
            out.append(slice(i * n // k, (i + 1) * n // k))
        return tuple(out)

    def shard(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of a global tensor (a contiguous copy)."""
        return full[self.local_slices(full.shape)].contiguous()

    def stored(self, full: torch.Tensor):
        """``full`` in this layout: the tensor itself when replicated,
        else a DTensor over this rank's shard."""
        if self.is_fully_replicated:
            return full
        return as_dtensor(self.shard(full.detach()), self, full.shape)



def as_dtensor(local: torch.Tensor, layout: Layout, shape):
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, layout.mesh, layout.placements(),
                              run_check=False, shape=torch.Size(shape),
                              stride=_contig_stride(shape))


def _contig_stride(shape):
    st, acc = [], 1
    for n in reversed(tuple(shape)):
        st.append(acc)
        acc *= int(n)
    return tuple(reversed(st))


def is_sharded(t) -> bool:
    return type(t).__name__ == "DTensor"


def local(t) -> torch.Tensor:
    """The rank's own tensor: a DTensor's local shard (a view sharing its
    storage, differentiable back to the DTensor), any other tensor
    itself."""
    if is_sharded(t):
        return t.to_local()
    return t


def spec_of(t) -> PartitionSpec:
    """The PartitionSpec a stored tensor carries (``P()`` when whole)."""
    if not is_sharded(t):
        return P()
    from torch.distributed.tensor import Shard
    names = t.device_mesh.mesh_dim_names
    dims: Dict[int, List[str]] = {}
    for name, pl in zip(names, t.placements):
        if isinstance(pl, Shard):
            dims.setdefault(pl.dim, []).append(name)
    n = max(dims) + 1 if dims else 0
    return P(*[(tuple(dims[d]) if len(dims.get(d, ())) > 1
                else (dims[d][0] if d in dims else None))
               for d in range(n)])


def full(t, tag: str = "gather") -> torch.Tensor:
    """The whole value of a stored tensor (all-gathered when sharded;
    ``tag`` names the gathers in the collective record)."""
    if not is_sharded(t):
        return t
    lay = Layout(t.device_mesh, spec_of(t))
    out = local(t)
    for d, entry in enumerate(lay.spec):
        for a in reversed(_axes_of(entry)):
            out = all_gather(out, lay.mesh, a, dim=d, tag=tag)
    return out


# ---------------------------------------------------------------------------
# collectives: every one the port issues goes through these, and the
# active record (if any) gets one entry per call
# ---------------------------------------------------------------------------

_RECORDS: List[list] = []


@contextlib.contextmanager
def record_collectives():
    """Record every collective issued inside the block: a list of
    ``{"kind", "axis", "bytes", "tag"}`` (bytes of the local result;
    ``tag`` says what the collective moved: "grad", "param", "on_use",
    "output", "activation", ...). The trainer also records each stored
    parameter's resident bytes as ``kind="parameter"`` at step entry.
    ``zero_collective_evidence`` classifies such a record."""
    rec: list = []
    _RECORDS.append(rec)
    try:
        yield rec
    finally:
        _RECORDS.remove(rec)


def _note(kind: str, axis, nbytes: int, tag: str = ""):
    for rec in _RECORDS:
        rec.append({"kind": kind, "axis": axis, "bytes": int(nbytes),
                    "tag": tag})


def note_resident(nbytes: int, tag: str = "param"):
    """Record a resident tensor (no communication) in the active record."""
    _note("parameter", None, nbytes, tag)


def _dist_fn(new: str, old: str):
    import torch.distributed as dist
    return getattr(dist, new, None) or getattr(dist, old)


def _all_gather_into(out, src, group):
    _dist_fn("all_gather_single", "all_gather_into_tensor")(
        out, src, group=group)


def _reduce_scatter_into(out, src, group):
    _dist_fn("reduce_scatter_single", "reduce_scatter_tensor")(
        out, src, group=group)


def _group(mesh, axis):
    return mesh.get_group(axis)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_reduce(t: torch.Tensor, mesh, axes, op: str = "sum",
               tag: str = "", inplace: bool = False) -> torch.Tensor:
    """Sum (or max / mean) of ``t`` over ``axes``. Axes of one rank (or
    that the mesh lacks) are skipped on every backend; with none left
    ``t`` itself comes back. Otherwise the result is a new tensor, or,
    with ``inplace`` and a row-major contiguous ``t`` (a gradient only
    its caller reads), ``t`` reduced in its own storage."""
    import torch.distributed as dist
    live = [a for a in _axes_of(axes) if axis_size(mesh, a) > 1]
    if not live:
        return t
    # collectives refuse other layouts (a channels_last weight's
    # gradient, a transposed view): those reduce a row-major copy
    out = t if inplace and t.is_contiguous() else \
        t.clone(memory_format=torch.contiguous_format)
    red = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
    for a in live:
        dist.all_reduce(out, op=red, group=_group(mesh, a))
        _note("all_reduce", a, _nbytes(out), tag)
    if op == "mean":
        out = out / axis_size(mesh, live)
    return out


def all_gather(t: torch.Tensor, mesh, axis: str, dim: int = 0,
               tag: str = "") -> torch.Tensor:
    """Concatenation of every rank's ``t`` along ``dim``, in axis order."""
    n = axis_size(mesh, axis)
    if n == 1:
        return t
    src = t.movedim(dim, 0).contiguous()
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=t.dtype, device=t.device)
    _all_gather_into(out, src, group=_group(mesh, axis))
    _note("all_gather", axis, _nbytes(out), tag)
    return out.movedim(0, dim)


def reduce_scatter(t: torch.Tensor, mesh, axis: str, dim: int = 0,
                   tag: str = "") -> torch.Tensor:
    """This rank's 1/N slice along ``dim`` of the sum of ``t`` over
    ``axis``."""
    n = axis_size(mesh, axis)
    if n == 1:
        return t
    src = t.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                      dtype=t.dtype, device=t.device)
    _reduce_scatter_into(out, src, group=_group(mesh, axis))
    _note("reduce_scatter", axis, _nbytes(out), tag)
    return out.movedim(0, dim)


def all_to_all(t: torch.Tensor, mesh, axis: str, tag: str = "",
               split_dim: int = 0, concat_dim: int = 0) -> torch.Tensor:
    """``lax.all_to_all(t, axis, split_dim, concat_dim, tiled=True)``:
    ``t`` split into N blocks along ``split_dim``, block j sent to rank
    j, the received blocks concatenated along ``concat_dim`` in source
    order (``all_to_all_single`` over the leading axis)."""
    import torch.distributed as dist
    n = axis_size(mesh, axis)
    if n == 1:
        return t.clone()
    blocks = t.movedim(split_dim, 0)
    blocks = blocks.reshape((n, blocks.shape[0] // n)
                            + tuple(blocks.shape[1:])).contiguous()
    out = torch.empty_like(blocks)
    dist.all_to_all_single(out, blocks, group=_group(mesh, axis))
    _note("all_to_all", axis, _nbytes(out), tag)
    # out[s] = the block source s sent: [n, m, ...] with the split dim
    # of ``t`` at position 1; put it back and concatenate the sources
    out = out.movedim(1, split_dim + 1)          # [n, ... t's dims ...]
    return torch.cat(list(out.unbind(0)), dim=concat_dim)


def ppermute(t: torch.Tensor, mesh, axis: str, perm, tag: str = "",
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``lax.ppermute``: rank i (along ``axis``) sends ``t`` to the rank
    ``perm`` maps it to and receives from the rank that maps to it
    (``batch_isend_irecv`` in the permutation's order); a rank no pair
    sends to gets zeros. ``out`` (optional) is the receive buffer."""
    import torch.distributed as dist
    me = axis_index(mesh, axis)
    group = _group(mesh, axis)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    t = t.contiguous()
    recv = out if out is not None else torch.empty(
        t.shape, dtype=t.dtype, device=t.device)
    if dst and src and dst[0] == me and src[0] == me:
        recv.copy_(t)
        return recv
    ops = []
    if dst:
        ops.append(dist.P2POp(dist.isend, t,
                              dist.get_global_rank(group, dst[0]), group))
    if src:
        ops.append(dist.P2POp(dist.irecv, recv,
                              dist.get_global_rank(group, src[0]), group))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        _note("ppermute", axis, _nbytes(t), tag)
    if not src:
        recv.zero_()
    return recv


# ---------------------------------------------------------------------------
# differentiable collectives (the transposes JAX derives, written out)
# ---------------------------------------------------------------------------

class _CopyToAxis(torch.autograd.Function):
    """Identity forward; all-reduce of the gradient backward (a
    replicated activation entering a region split over ``axes``)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axes, tag="activation"), \
            None, None


class _ReduceFromAxis(torch.autograd.Function):
    """All-reduce (sum) forward; identity backward (partial sums leaving
    a split region)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce(x, mesh, axes, tag="activation")

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherOnUse(torch.autograd.Function):
    """All-gather a stored shard forward; reduce-scatter its gradient
    backward (the ZeRO-3 / TP gather-on-use and its transpose)."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return all_gather(x, mesh, axis, dim, tag="on_use")

    @staticmethod
    def backward(ctx, g):
        return (reduce_scatter(g, ctx.mesh, ctx.axis, ctx.dim, tag="grad"),
                None, None, None)


class _GatherReplicated(torch.autograd.Function):
    """All-gather forward into a value every rank then uses alike; the
    backward takes this rank's slice of the (identical) gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim, ctx.n = mesh, axis, dim, x.shape[dim]
        return all_gather(x, mesh, axis, dim, tag="output")

    @staticmethod
    def backward(ctx, g):
        i = axis_index(ctx.mesh, ctx.axis)
        return (g.narrow(ctx.dim, i * ctx.n, ctx.n).contiguous(),
                None, None, None)


class _SliceLocal(torch.autograd.Function):
    """This rank's slice of a replicated global value forward; the
    gradient slices of every rank all-gathered backward (the true
    gradient of the global value, on every rank)."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        n = axis_size(mesh, axis)
        m = x.shape[dim] // n
        return x.narrow(dim, axis_index(mesh, axis) * m, m).contiguous()

    @staticmethod
    def backward(ctx, g):
        return (all_gather(g.contiguous(), ctx.mesh, ctx.axis, ctx.dim,
                           tag="grad"), None, None, None)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_dim, concat_dim):
        ctx.args = (mesh, axis, split_dim, concat_dim)
        return all_to_all(x, mesh, axis, tag="activation",
                          split_dim=split_dim, concat_dim=concat_dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, split_dim, concat_dim = ctx.args
        return (all_to_all(g.contiguous(), mesh, axis, tag="activation",
                           split_dim=concat_dim, concat_dim=split_dim),
                None, None, None, None)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.args = (mesh, axis, perm)
        return ppermute(x, mesh, axis, perm, tag="activation")

    @staticmethod
    def backward(ctx, g):
        mesh, axis, perm = ctx.args
        inv = tuple((d, s) for s, d in perm)
        return (ppermute(g.contiguous(), mesh, axis, inv, tag="activation"),
                None, None, None)


class _MeanReplicated(torch.autograd.Function):
    """Mean over ``axes`` forward into a value every rank uses alike;
    backward: the gradient over the axis size, no communication."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.n = axis_size(mesh, axes)
        return all_reduce(x, mesh, axes, op="mean", tag="activation")

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


def copy_to(x, mesh, axes):
    return _CopyToAxis.apply(x, mesh, axes) if _active(mesh, axes) else x


def reduce_from(x, mesh, axes):
    return _ReduceFromAxis.apply(x, mesh, axes) if _active(mesh, axes) \
        else x


def gather_on_use(x, mesh, axis, dim):
    return _GatherOnUse.apply(x, mesh, axis, dim) \
        if _active(mesh, axis) else x


def gather_replicated(x, mesh, axis, dim):
    return _GatherReplicated.apply(x, mesh, axis, dim) \
        if _active(mesh, axis) else x


def slice_local(x, mesh, axis, dim):
    return _SliceLocal.apply(x, mesh, axis, dim) \
        if _active(mesh, axis) else x


def all_to_all_grad(x, mesh, axis, split_dim, concat_dim):
    return _AllToAll.apply(x, mesh, axis, split_dim, concat_dim) \
        if _active(mesh, axis) else x


def ppermute_grad(x, mesh, axis, perm):
    return _PPermute.apply(x, mesh, axis, tuple(perm)) \
        if _active(mesh, axis) else x


def mean_replicated(x, mesh, axes):
    return _MeanReplicated.apply(x, mesh, axes) if _active(mesh, axes) \
        else x


def _active(mesh, axes) -> bool:
    """A collective over ``axes`` does something: there is a mesh and
    the axes span more than one rank of it (an axis the mesh lacks
    counts 1), on every backend."""
    return mesh is not None and axis_size(mesh, axes) > 1


# ---------------------------------------------------------------------------
# the distribution plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DistConfig:
    """Distribution plan for a training/inference step."""
    mesh: object
    # [(param-name regex, PartitionSpec)] first match wins; unmatched ->
    # replicated
    param_rules: Sequence[Tuple[str, PartitionSpec]] = ()
    batch_axis: str = place.AXIS_DATA
    zero_stage: int = 0
    zero_min_size: int = 0

    def param_spec(self, name: str, ndim: int) -> PartitionSpec:
        """First matching rule wins; rules whose spec rank exceeds the
        array's rank are skipped."""
        for pattern, spec in self.param_rules:
            if re.search(pattern, name) and len(spec) <= ndim:
                return spec
        return P()

    def param_sharding(self, name: str, arr) -> Layout:
        return Layout(self.mesh, self.param_spec(name, np.ndim(arr)
                                                  if not isinstance(
                                                      arr, torch.Tensor)
                                                  else arr.ndim))

    def dcn_axis(self) -> Optional[str]:
        names = tuple(self.mesh.mesh_dim_names)
        if "dcn" in names and self.batch_axis != "dcn":
            return "dcn"
        return None

    def batch_axes(self) -> Tuple[str, ...]:
        """The axes the batch splits over, outermost first."""
        d = self.dcn_axis()
        return (d, self.batch_axis) if d else (self.batch_axis,)

    def batch_sharding(self) -> Layout:
        d = self.dcn_axis()
        spec = P((d, self.batch_axis)) if d else P(self.batch_axis)
        return Layout(self.mesh, spec)

    def replicated(self) -> Layout:
        return Layout(self.mesh, P())

    # -- trees -------------------------------------------------------------
    def shard_params(self, params: Dict) -> Dict:
        """Params in their STORED layout (DTensors where sharded)."""
        return {k: self.store_sharding(k, v).stored(v)
                for k, v in params.items()}

    def param_shardings(self, params: Dict) -> Dict:
        return {k: self.param_sharding(k, v) for k, v in params.items()}

    # -- ZeRO policy -------------------------------------------------------
    def zero_axis_size(self) -> int:
        return axis_size(self.mesh, self.batch_axis)

    def _zero_dim(self, shape) -> Optional[int]:
        n = self.zero_axis_size()
        if n <= 1 or not shape:
            return None
        if int(np.prod(shape)) < self.zero_min_size:
            return None
        best = None
        for d, size in enumerate(shape):
            if size and size % n == 0:
                if best is None or size > shape[best]:
                    best = d
        return best

    def zero_spec(self, name: str, shape) -> PartitionSpec:
        if self.zero_stage < 1:
            return P()
        if self.param_spec(name, len(shape)) != P():
            return self.param_spec(name, len(shape))
        d = self._zero_dim(tuple(shape))
        if d is None:
            return P()
        return P(*([None] * d + [self.batch_axis]))

    def zero_update_shardings(self, params: Dict) -> Dict:
        return {k: Layout(self.mesh, self.zero_spec(k, tuple(v.shape)))
                for k, v in params.items()}

    def grad_spec(self, name: str, shape, accum: bool = False):
        if self.zero_stage >= 2 or (accum and self.zero_stage >= 1):
            return self.zero_spec(name, tuple(shape))
        return self.param_spec(name, len(shape))

    def grad_shardings(self, params: Dict, accum: bool = False) -> Dict:
        return {k: Layout(self.mesh, self.grad_spec(k, tuple(v.shape),
                                                    accum))
                for k, v in params.items()}

    def store_spec(self, name: str, shape) -> PartitionSpec:
        if self.zero_stage >= 3:
            return self.zero_spec(name, tuple(shape))
        return self.param_spec(name, len(shape))

    def store_sharding(self, name: str, arr) -> Layout:
        return Layout(self.mesh, self.store_spec(name, tuple(arr.shape)))

    def store_shardings(self, params: Dict) -> Dict:
        return {k: self.store_sharding(k, v) for k, v in params.items()}

    def _zero_classify(self, params: Dict):
        n = self.zero_axis_size()
        sharded, replicated = {}, {}
        for k, v in params.items():
            shape = tuple(v.shape)
            if self.param_spec(k, len(shape)) != P():
                replicated[k] = "matched param rule (state mirrors param)"
                continue
            d = self._zero_dim(shape)
            if d is not None:
                sharded[k] = {"dim": d, "shape": list(shape),
                              "shard_shape": [
                                  s // n if i == d else s
                                  for i, s in enumerate(shape)]}
            elif not shape:
                replicated[k] = "scalar"
            elif int(np.prod(shape)) < self.zero_min_size:
                replicated[k] = (f"tiny ({int(np.prod(shape))} < "
                                 f"zero_min_size={self.zero_min_size})")
            else:
                replicated[k] = (f"no dim of {list(shape)} divisible by "
                                 f"{self.batch_axis}={n}")
        return sharded, replicated

    def zero_report(self, params: Dict) -> Dict:
        """What the zero stage does to each param, per leaf (the JAX
        package's report, key for key)."""
        n = self.zero_axis_size()
        sharded, replicated = self._zero_classify(params)
        stage = self.zero_stage

        def view(active, gate_msg):
            if active:
                return {"sharded": sharded, "replicated": replicated}
            return {"sharded": {},
                    "replicated": {k: gate_msg for k in params}}

        return {"zero_stage": stage, "axis": self.batch_axis,
                "axis_size": n, "dcn_axis": self.dcn_axis(),
                "sharded": sharded if stage >= 1 else {},
                "replicated": replicated if stage >= 1
                else {k: "zero_stage<1 (state mirrors param layout)"
                      for k in params},
                "grads": view(stage >= 2,
                              "zero_stage<2 (grads keep param layout; "
                              "the accum carry still rides sharded at "
                              "stage 1)"),
                "params": view(stage >= 3,
                               "zero_stage<3 (params stored in compute "
                               "layout)")}

    def state_shardings(self, state: Dict) -> Dict:
        """Optimizer state mirrors its parameter's layout; under
        ``zero_stage>=1`` the leaves of replicated params take the zero
        spec."""
        def tree(v, fn):
            if isinstance(v, (tuple, list)):
                return type(v)(tree(x, fn) for x in v)
            if isinstance(v, dict):
                return {kk: tree(x, fn) for kk, x in v.items()}
            return fn(v)

        out = {}
        for k, v in state.items():
            if self.zero_stage >= 1:
                out[k] = tree(v, lambda leaf, k=k: Layout(
                    self.mesh, self.zero_spec(k, tuple(np.shape(leaf)))))
            else:
                out[k] = tree(v, lambda leaf, k=k: Layout(
                    self.mesh, self.param_spec(k, np.ndim(leaf))))
        return out

    def feed_shardings(self, feeds):
        bs = self.batch_sharding()
        return {k: bs for k in feeds}


def data_parallel(mesh=None, zero: int = 0) -> DistConfig:
    """Pure DP: params replicated, batch split over ``data``; ``zero``
    selects the ZeRO stage (module docstring)."""
    return DistConfig(mesh or place.default_mesh(), zero_stage=zero)


def data_model_parallel(mesh, tp_rules) -> DistConfig:
    """DP x TP over a 2-D mesh."""
    return DistConfig(mesh, tp_rules)


# ---------------------------------------------------------------------------
# the ZeRO update
# ---------------------------------------------------------------------------

def _zero_dim_of(spec: PartitionSpec, axis: str) -> Optional[int]:
    for d, e in enumerate(spec):
        if axis in _axes_of(e):
            return d
    return None


def reduce_grads(dist_cfg: DistConfig, grads: Dict, layouts: Dict,
                 sharded: bool) -> Dict:
    """Gradients of this rank's batch shard -> gradients of the global
    batch: summed over the batch axes (the cost each rank
    differentiates is its shard's share of the global mean). With
    ``sharded`` a leaf whose update layout splits over the batch axis is
    reduce-scattered into that shard (stage >= 1), else all-reduced
    whole. Order: sorted names, the same on every rank."""
    out = {}
    ax = dist_cfg.batch_axis
    dcn = dist_cfg.dcn_axis()
    seen: set = set()
    for k in sorted(grads):
        g = grads[k]
        own = owned(g, seen)
        d = _zero_dim_of(layouts[k].spec, ax) if sharded else None
        if d is not None:
            r = reduce_scatter(g, dist_cfg.mesh, ax, d, tag="grad")
        else:
            r = all_reduce(g, dist_cfg.mesh, ax, tag="grad", inplace=own)
        if dcn is not None:
            r = all_reduce(r, dist_cfg.mesh, dcn, tag="grad_dcn",
                           inplace=own or r is not g)
        out[k] = r
    return out


def owned(g: torch.Tensor, seen: set) -> bool:
    """Whether a gradient may be reduced in place: no gradient before it
    in ``seen`` (storages of this reduction, updated here) shares its
    storage. Autograd hands one tensor to both inputs of an add, and
    reducing it twice in place would double it."""
    key = g.untyped_storage().data_ptr()
    if key in seen:
        return False
    seen.add(key)
    return True


def zero_constrained_update(dist: DistConfig, opt, step, grads, params,
                            opt_state, update_shardings=None,
                            keep_shardings=None, state_shardings=None):
    """One optimizer update in the ZeRO layout: ``grads`` already hold
    this rank's update-layout shards (``reduce_grads(sharded=True)``);
    ``params`` are the stored tensors (DTensors where sharded). The
    update runs on the shards against the sharded state; each updated
    shard is written back into its stored tensor: directly when the
    stored layout is the update layout (stage 3, TP leaves), else by an
    all-gather of the updated shards (stages 1-2, the post-update
    regather). Global-norm clipping sums the squared shards over the
    axis first. With ``zero_stage<1`` this is exactly ``opt.update``."""
    if dist is None or dist.zero_stage < 1:
        return opt.update(step, grads, params, opt_state)
    upd = update_shardings or dist.zero_update_shardings(params)
    ax = dist.batch_axis
    work, back = {}, {}
    for k, p in params.items():
        dz = _zero_dim_of(upd[k].spec, ax)
        if is_sharded(p):
            work[k] = local(p)                  # already the shard
        elif dz is not None:
            n = axis_size(dist.mesh, ax)
            i = axis_index(dist.mesh, ax)
            m = p.shape[dz] // n
            work[k] = p.narrow(dz, i * m, m).clone()
            back[k] = (p, dz)
        else:
            work[k] = p
    clip = getattr(opt, "clip_threshold", None)
    if clip:
        sq = torch.zeros((), dtype=torch.float32, device=next(
            iter(grads.values())).device)
        rep = torch.zeros_like(sq)
        for k, g in grads.items():
            s = torch.sum(torch.square(g.float()))
            if _zero_dim_of(upd[k].spec, ax) is not None:
                sq = sq + s
            else:
                rep = rep + s
        gnorm = torch.sqrt(all_reduce(sq, dist.mesh, ax, tag="norm") + rep)
        scale = torch.clamp_max(clip / (gnorm + 1e-12), 1.0)
        grads = {k: g * scale.to(g.dtype) for k, g in grads.items()}
        opt.clip_threshold = None
    try:
        _, new_state = opt.update(step, grads, work, opt_state)
    finally:
        if clip:
            opt.clip_threshold = clip
    with torch.no_grad():
        for k in sorted(back):
            p, dz = back[k]
            p.copy_(all_gather(work[k], dist.mesh, ax, dz, tag="output"))
    return params, new_state


def shard_state(dist_cfg: DistConfig, state: Dict) -> Dict:
    """Optimizer state in its stored layout: DTensors over the zero
    spec's shard under ``zero_stage >= 1``, whole tensors otherwise."""
    lays = dist_cfg.state_shardings(state)

    def put(v, lay):
        if isinstance(v, (tuple, list)):
            return type(v)(put(x, l) for x, l in zip(v, lay))
        if isinstance(v, dict):
            return {kk: put(x, lay[kk]) for kk, x in v.items()}
        if not isinstance(v, torch.Tensor) or lay.is_fully_replicated:
            return v
        return lay.stored(v)

    return {k: put(v, lays[k]) for k, v in state.items()}


def local_tree(tree):
    """A tree with every DTensor replaced by its local shard."""
    if isinstance(tree, dict):
        return {k: local_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(local_tree(v) for v in tree)
    return local(tree)


def full_tree(tree):
    """A tree with every DTensor all-gathered whole (sorted order)."""
    if isinstance(tree, dict):
        return {k: full_tree(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(full_tree(v) for v in tree)
    return full(tree)


# ---------------------------------------------------------------------------
# ZeRO evidence: the record's collectives, classified as the JAX
# package's HLO classifier classifies a compiled module's
# ---------------------------------------------------------------------------

def zero_collective_evidence(record, min_bytes: int) -> Dict:
    """Classify a ``record_collectives()`` record for the ZeRO
    contracts, with the keys of the JAX package's HLO classifier:

    - ``reduce_scatter``: reduce-scatters issued;
    - ``param_all_gather``: all-gathers of at least ``min_bytes``, split
      into ``on_use_all_gather`` (a stored shard gathered for compute,
      stage 3) and ``output_all_gather`` (updated shards regathered
      after the update, stages 1-2);
    - ``full_grad_all_reduce``: gradient all-reduces of at least
      ``min_bytes`` (the classic DP sync ZeRO removes), with a line each
      in ``full_grad_all_reduce_lines``;
    - ``resident_full_args``: resident parameters of at least
      ``min_bytes`` (stage 3's contract is 0).
    ``min_bytes`` separates parameter-sized tensors from scalar
    bookkeeping: pass the largest replicated param's nbytes."""
    out = {"reduce_scatter": 0, "param_all_gather": 0,
           "on_use_all_gather": 0, "output_all_gather": 0,
           "resident_full_args": 0,
           "full_grad_all_reduce": 0, "full_grad_all_reduce_lines": []}
    for r in record:
        kind, nbytes, tag = r["kind"], r["bytes"], r.get("tag", "")
        if kind == "reduce_scatter":
            out["reduce_scatter"] += 1
        elif kind == "parameter":
            if nbytes >= min_bytes:
                out["resident_full_args"] += 1
        elif kind == "all_gather" and nbytes >= min_bytes:
            out["param_all_gather"] += 1
            out["on_use_all_gather" if tag == "on_use"
                else "output_all_gather"] += 1
        elif kind == "all_reduce" and tag == "grad" \
                and nbytes >= min_bytes:
            out["full_grad_all_reduce"] += 1
            out["full_grad_all_reduce_lines"].append(
                f"all_reduce over {r['axis']}: {nbytes} bytes")
    return out


# Canonical TP rule helpers -------------------------------------------------

def fc_column_rule(pattern: str):
    """Shard an fc weight [in, out] on the out axis (column parallel)."""
    return (pattern, P(None, place.AXIS_MODEL))


def fc_row_rule(pattern: str):
    """Shard an fc weight [in, out] on the in axis (row parallel)."""
    return (pattern, P(place.AXIS_MODEL, None))


def embedding_vocab_rule(pattern: str):
    """Shard an embedding table [vocab, dim] across vocab (the
    sparse_remote_update slot, reference RemoteParameterUpdater.h:265)."""
    return (pattern, P(place.AXIS_MODEL, None))


def param_bytes(tree) -> int:
    """Resident bytes of a tree's tensors (a DTensor's local shard)."""
    if isinstance(tree, dict):
        return sum(param_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(param_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = local(tree)
        return t.numel() * t.element_size()
    return 0


__all__ = ["P", "PartitionSpec", "Layout", "DistConfig",
           "data_parallel", "data_model_parallel",
           "zero_constrained_update", "zero_collective_evidence",
           "fc_column_rule", "fc_row_rule", "embedding_vocab_rule",
           "record_collectives"]
