"""``shard_map`` for the port (counterpart of
``paddle_tpu/parallel/compat.py``): run a per-shard function on every
rank over its shards of global inputs.

The inputs are the global values, held whole by every rank; each is
sliced to this rank's shard by its ``in_specs`` entry (the slice's
backward all-gathers the gradient slices, so the gradient of a global
input is whole on every rank). The function sees the shards, with the
mesh bound for the axis names it uses (``current_mesh``); each output
is all-gathered whole along the dims its ``out_specs`` entry splits (the
gather's backward takes this rank's slice). A replicated output spec
(``P()``) returns the function's value as it is: the function made it
equal on every rank (a psum). ``check_vma`` has no counterpart and is
accepted and ignored."""

import contextlib
from typing import List

from paddle_tpu_torch.parallel import spmd

_MESHES: List[object] = []


def current_mesh():
    """The mesh of the innermost running ``shard_map``."""
    if not _MESHES:
        raise RuntimeError("axis names resolve inside shard_map only")
    return _MESHES[-1]


@contextlib.contextmanager
def bind_mesh(mesh):
    _MESHES.append(mesh)
    try:
        yield mesh
    finally:
        _MESHES.pop()


def _to_local(x, spec, mesh):
    if x is None or spec is None:
        return x
    if isinstance(x, dict):
        return {k: _to_local(v, spec[k] if isinstance(spec, dict) else spec,
                             mesh) for k, v in x.items()}
    for d, entry in enumerate(spec):
        for a in spmd._axes_of(entry):
            x = spmd.slice_local(x, mesh, a, d)
    return x


def _to_global(x, spec, mesh):
    if x is None or spec is None:
        return x
    if isinstance(x, dict):
        return {k: _to_global(v, spec[k] if isinstance(spec, dict) else spec,
                              mesh) for k, v in x.items()}
    for d, entry in enumerate(spec):
        for a in reversed(spmd._axes_of(entry)):
            x = spmd.gather_replicated(x, mesh, a, d)
    return x


def shard_map(f, *, mesh, in_specs, out_specs, check_vma=None):
    del check_vma
    single_in = isinstance(in_specs, spmd.PartitionSpec)
    single_out = isinstance(out_specs, spmd.PartitionSpec)

    def run(*args):
        specs = (in_specs,) if single_in else in_specs
        local_args = [_to_local(a, s, mesh) for a, s in zip(args, specs)]
        with bind_mesh(mesh):
            out = f(*local_args)
        if single_out:
            return _to_global(out, out_specs, mesh)
        return type(out)(_to_global(o, s, mesh)
                         for o, s in zip(out, out_specs))

    return run
