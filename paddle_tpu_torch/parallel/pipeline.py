"""Pipeline parallelism over the ``stage`` mesh axis, GPipe and
interleaved (counterpart of ``paddle_tpu/parallel/pipeline.py``).

The network is cut into S stages of identical signature; rank d of the
``stage`` axis holds stage d's weights (with ``v`` chunks, the virtual
stages {c·S + d}), and activations pass from rank to rank by
send/recv (``spmd.ppermute`` up the ring, every rank in the same order
each step). The schedule is the JAX package's: virtual stage j of
microbatch m runs at step T(m, j) = (m // S)·S·v + m % S + j on rank
j % S, so GPipe is the v = 1 case (makespan M + S - 1) and v chunks cut
the fill/drain bubble to (S - 1)/v stage-times.

The inputs are global (every rank holds x and the stacked params, as
``shard_map`` takes them) and so is the output: the last stage's
microbatches are all-reduced to every rank. A batch split over a
``data`` axis of the mesh runs one pipeline per data rank. The backward
is written out (``_Pipeline``): the reverse schedule runs each stage's
recomputed forward under autograd from its saved input, the input
gradient travels down the ring step by step, and the stage-parameter
gradients are summed over the mesh, so every rank holds the true
gradient of the global inputs."""

from typing import Callable

import torch

from paddle_tpu_torch.core import place
from paddle_tpu_torch.parallel import spmd


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], f"{prefix}{k}/")
        return out
    return [(prefix.rstrip("/"), tree)]


def _unflatten(like, leaves):
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(like)


def pipeline_apply(stage_params, x: torch.Tensor, stage_fn: Callable,
                   mesh, num_microbatches: int,
                   stage_axis: str = place.AXIS_STAGE,
                   wire_int8: bool = False) -> torch.Tensor:
    """Run ``stage_fn`` S times (once per stage) as a pipeline.

    stage_params: a tree whose leaves carry a leading stage dim [S, ...];
    x: [B, ...] with B divisible by num_microbatches; stage_fn(params_s,
    mb) maps [mb, ...] -> [mb, ...]. Returns [B, ...] equal to applying
    the stages in order. The single-chunk case of the interleaved
    schedule; microbatch counts that do not divide S are padded (the
    padding's outputs are dropped)."""
    S = spmd.axis_size(mesh, stage_axis)
    M = num_microbatches
    B = x.shape[0]
    assert B % M == 0, f"batch {B} not divisible by {M} microbatches"
    mb = B // M
    Mp = -(-M // S) * S
    if Mp != M:
        pad = torch.zeros(((Mp - M) * mb,) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        x = torch.cat([x, pad], 0)
    chunked = _unflatten(stage_params,
                         [l[None] for _, l in _flatten(stage_params)])
    out = pipeline_apply_interleaved(chunked, x, stage_fn, mesh, Mp,
                                     num_chunks=1, stage_axis=stage_axis,
                                     wire_int8=wire_int8)
    return out[:B]


def interleaved_schedule(num_microbatches: int, num_stages: int,
                         num_chunks: int):
    """Static timetable of the interleaved schedule: (table, makespan,
    bubble) where table maps ``(step, device) -> (microbatch,
    virtual_stage)``; virtual stage j runs on device j % S at step
    T(m, j) = (m // S)·S·v + (m % S) + j; the bubble in stage-times is
    (S - 1)/v."""
    M, S, v = num_microbatches, num_stages, num_chunks
    if M % S:
        raise ValueError(f"interleaved schedule needs microbatches ({M}) "
                         f"divisible by stages ({S})")
    table = {}
    for m in range(M):
        for j in range(S * v):
            t = (m // S) * S * v + (m % S) + j
            key = (t, j % S)
            if key in table:
                raise AssertionError(f"schedule conflict at {key}")
            table[key] = (m, j)
    makespan = M * v + S - 1
    return table, makespan, (S - 1) / v


def _steps(M, S, v, d):
    """[(t, m, c)] of device d: at step t it runs chunk c of
    microbatch m."""
    out = []
    for m in range(M):
        for c in range(v):
            j = c * S + d
            out.append(((m // S) * S * v + m % S + j, m, c))
    return sorted(out)


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, stage_fn, mesh, stage_axis, M, v, wire_int8,
                treedef, *leaves):
        S = spmd.axis_size(mesh, stage_axis)
        d = spmd.axis_index(mesh, stage_axis)
        Sv = S * v
        mb = x.shape[0] // M
        xs = x.reshape((M, mb) + tuple(x.shape[1:]))
        mine = [l[:, d] for l in leaves]          # [v, ...] per leaf
        T = M * v + S - 1
        plan = {t: (m, c) for t, m, c in _steps(M, S, v, d)}
        up = tuple((i, (i + 1) % S) for i in range(S))
        state = torch.zeros_like(xs[0])
        saved = {}
        outs = torch.zeros_like(xs)
        with torch.no_grad():
            for t in range(T):
                out = torch.zeros_like(xs[0])
                if t in plan:
                    m, c = plan[t]
                    first = d == 0 and c == 0
                    cur = xs[m] if first else state
                    saved[t] = cur
                    p = _unflatten(treedef, [l[c] for l in mine])
                    out = stage_fn(p, cur)
                    if d == S - 1 and c == v - 1:
                        outs[m] = out
                state = _hop(out, mesh, stage_axis, up, wire_int8)
            # the last stage's outputs reach every rank
            outs = spmd.all_reduce(outs, mesh, stage_axis, tag="output")
        ctx.stage_fn, ctx.mesh, ctx.axis = stage_fn, mesh, stage_axis
        ctx.M, ctx.v, ctx.wire, ctx.treedef = M, v, wire_int8, treedef
        ctx.saved = saved
        ctx.x_shape = x.shape
        ctx.save_for_backward(*leaves)
        return outs.reshape(x.shape)

    @staticmethod
    def backward(ctx, gout):
        leaves = ctx.saved_tensors
        mesh, axis, M, v = ctx.mesh, ctx.axis, ctx.M, ctx.v
        S = spmd.axis_size(mesh, axis)
        d = spmd.axis_index(mesh, axis)
        mb = ctx.x_shape[0] // M
        gouts = gout.reshape((M, mb) + tuple(ctx.x_shape[1:]))
        mine = [l[:, d] for l in leaves]
        grads = [torch.zeros_like(l) for l in leaves]
        gx = torch.zeros_like(gouts)
        T = M * v + S - 1
        plan = {t: (m, c) for t, m, c in _steps(M, S, v, d)}
        down = tuple((i, (i - 1) % S) for i in range(S))
        g_state = torch.zeros_like(gouts[0])
        for t in reversed(range(T)):
            # the gradient of what this rank sent at step t comes back
            # from the rank it went to
            g_out = _hop(g_state, mesh, axis, down, ctx.wire)
            g_state = torch.zeros_like(g_out)
            if t not in plan:
                continue
            m, c = plan[t]
            if d == S - 1 and c == v - 1:
                g_out = gouts[m]
            cur = ctx.saved[t].detach().requires_grad_()
            ps = [l[c].detach().requires_grad_() for l in mine]
            with torch.enable_grad():
                out = ctx.stage_fn(_unflatten(ctx.treedef, ps), cur)
                got = torch.autograd.grad(out, [cur] + ps, g_out,
                                          allow_unused=True)
            g_cur = got[0] if got[0] is not None else torch.zeros_like(cur)
            for i, g in enumerate(got[1:]):
                if g is not None:
                    grads[i][c, d] += g
            if d == 0 and c == 0:
                gx[m] = g_cur
            else:
                g_state = g_cur
        # every rank holds the true gradient of the global inputs
        grads = [spmd.all_reduce(g, mesh, mesh.mesh_dim_names, tag="grad")
                 for g in grads]
        gx = spmd.all_reduce(gx, mesh, axis, tag="grad")
        return (gx.reshape(ctx.x_shape), None, None, None, None, None,
                None, None, *grads)


def _hop(t, mesh, axis, perm, wire_int8):
    if wire_int8:
        from paddle_tpu_torch.ops import q8 as ops_q8
        return ops_q8.ppermute_q8_raw(t, axis, perm, mesh=mesh)
    return spmd.ppermute(t.contiguous(), mesh, axis, perm, tag="activation")


def pipeline_apply_interleaved(stage_params, x: torch.Tensor,
                               stage_fn: Callable, mesh,
                               num_microbatches: int, num_chunks: int = 2,
                               stage_axis: str = place.AXIS_STAGE,
                               wire_int8: bool = False) -> torch.Tensor:
    """Interleaved virtual-stage pipeline.

    stage_params: a tree with leading dims [v, S, ...] (virtual stage
    j = c·S + d at ``[c, d]``); stage_fn maps (params_leaf [...], mb) ->
    mb. x: [B, ...] with B divisible by num_microbatches and
    num_microbatches divisible by S. Equal to ``sequential_apply`` on the
    [S·v, ...] stacking. ``wire_int8``: the inter-stage activation sends
    (and their gradients) travel as int8 + a per-shard scale. With a
    ``data`` axis in the mesh the batch splits over it."""
    S = spmd.axis_size(mesh, stage_axis)
    v = num_chunks
    M = num_microbatches
    B = x.shape[0]
    assert B % M == 0, f"batch {B} not divisible by {M} microbatches"
    if M % S:
        raise ValueError(f"microbatches ({M}) must divide by stages ({S}) "
                         f"for the interleaved schedule")
    flat = _flatten(stage_params)
    for path, leaf in flat:
        if leaf.ndim < 2 or leaf.shape[0] != v or leaf.shape[1] != S:
            raise ValueError(
                f"stage_params leaf {path!r} must have leading dims "
                f"[num_chunks={v}, stages={S}, ...], got "
                f"{tuple(leaf.shape)}")
    data = place.AXIS_DATA if place.AXIS_DATA in mesh.mesh_dim_names \
        else None
    xl = spmd.slice_local(x, mesh, data, 0) if data else x
    if data:
        nd = spmd.axis_size(mesh, data)
        if (B // nd) % M:
            raise ValueError(f"the data shard of {B} rows does not divide "
                             f"into {M} microbatches")
    out = _Pipeline.apply(xl, stage_fn, mesh, stage_axis, M, v,
                          bool(wire_int8), stage_params,
                          *[l for _, l in flat])
    if data:
        out = spmd.gather_replicated(out, mesh, data, 0)
    return out


def sequential_apply(stage_params, x: torch.Tensor,
                     stage_fn: Callable) -> torch.Tensor:
    """Reference semantics: apply the S stages one after another."""
    flat = _flatten(stage_params)
    n = flat[0][1].shape[0]
    for s in range(n):
        x = stage_fn(_unflatten(stage_params, [l[s] for _, l in flat]), x)
    return x
