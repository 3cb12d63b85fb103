"""The q8 training pipeline and serving quantization (counterpart of
``paddle_tpu/ops/q8.py``).

Training (the ResNet recipe of ``fused_bn="q8" | "defer" | "q8sr"``):
between conv/BN blocks an activation is kept only as a centered int8
(or bf16, "defer") stash under delayed scaling: the previous step's
per-channel mean and absmax / ``QMAX`` are this step's quantization
constants. Each block is a ``torch.autograd.Function`` whose backward is
the JAX package's ``bwd``, term for term: it rebuilds its operands from
the stash (straight-through through the round), keeps the exact batch
statistic terms ``g_mu / nhw`` and ``g_var * 2 (y - mu) / nhw``, and
saves only the stashes and O(C) vectors. Blocks exchange (carrier,
stash) pairs. The carrier is the gradient edge: XLA drops it from the
JAX forward; here it is a stand-in holding one element (a zero-stride
view of the full shape), so no dense activation is kept between
blocks, while its gradient has the full shape. Deferred BN affines act
on the dequantized basis: ``x = act(yhat * M + B)``.

No block runs a hand kernel, in the JAX package either: its Pallas
conv kernels lost to XLA's fusions and were deleted. The convolutions
are ``ops/conv.conv2d`` (cuDNN on the card); the rest is elementwise
torch.

Serving: per-output-channel int8 weights and per-(token, head)
int8/int4 KV rows. The op chains are the JAX package's, step for step
(fp32 absmax, ``max(amax, 1e-8) / qmax``, divide, round half to even,
clip, int8), so the same fp32 inputs give the same bytes and the same
fp32 scales. The kernels that read a quantized pool widen each element
exactly as :func:`dequantize_kv` does.

The wire: ``ppermute_q8_raw`` / ``all_to_all_q8_raw`` (and their
straight-through autograd forms ``make_ppermute_q8`` /
``make_all_to_all_q8``) send int8 codes and fp32 scales through the
parallel tier's collectives (``parallel/spmd.py``): the JAX package's
codec (``wire_encode``), so the codes and scales are its bytes.
"""

import functools

import torch
from torch.utils import _pytree as pytree

from paddle_tpu_torch.core import dtypes
from paddle_tpu_torch.ops import conv as ops_conv
from paddle_tpu_torch.ops import norm as ops_norm
from paddle_tpu_torch.ops import prng

QMAX = 112.0  # quantization target for the delayed absmax: ~12% headroom
              # before the int8 clip saturates on a growing activation


def scale_from_amax(amax: torch.Tensor) -> torch.Tensor:
    """Next step's per-channel scale from this step's absmax."""
    return torch.clamp_min(amax, 1e-6) / QMAX


_STASHES = ("int8", "bf16")


def _check_stash(stash: str, stochastic: bool = False) -> None:
    if stash not in _STASHES:
        raise ValueError(f"unknown stash dtype {stash!r}; one of {_STASHES}")
    if stochastic and stash != "int8":
        raise ValueError(
            "stochastic rounding applies to the int8 stash only (a bf16 "
            "stash casts, it does not round to a grid)")


def _quantize(z: torch.Tensor, stash: str = "int8",
              key=None) -> torch.Tensor:
    """The stash of fp32 ``z``: bf16 for "defer"; else int8, rounded
    half to even, or with an ops/prng ``key`` stochastically,
    ``floor(z + U[0, 1))`` with ``jax.random.uniform(key, z.shape)``'s
    draws (unbiased: E[q] == z), clipped to [-127, 127]."""
    if stash == "bf16":
        return z.to(torch.bfloat16)
    if key is not None:
        u = prng.uniform(key, z.shape, minval=0.0, device=z.device)
        return torch.clamp(torch.floor(z + u), -127.0, 127.0).to(torch.int8)
    return torch.clamp(torch.round(z), -127.0, 127.0).to(torch.int8)


def _dequant(q, mu_p, s_p):
    return q.float() * s_p + mu_p


def _red(x, like):
    """Sum a [N, H, W, C] fp32 tensor to per-channel, in ``like``'s dtype."""
    return x.sum(dim=(0, 1, 2)).to(like.dtype)


def _stash_zero(q):
    """The stash's cotangent: none for an int8 stash (JAX's float0), a
    real zero for a bf16 ("defer") stash."""
    if q.is_floating_point():
        return torch.zeros_like(q)
    return None


def _carrier(like: torch.Tensor) -> torch.Tensor:
    """The ghost carrier: ``like``'s shape in the compute dtype, one
    element of storage (a zero-stride view)."""
    return torch.zeros((), dtype=dtypes.compute_dtype(),
                       device=like.device).expand(like.shape)


def _zero_if_none(g, like):
    return torch.zeros_like(like, dtype=torch.float32) if g is None \
        else g.float()


def _stash(yf, mu_po, s_po, stash: str = "int8", key=None):
    """Center and quantize with the delayed constants: (stash, the
    absmax that becomes next step's scale)."""
    amax = (yf - mu_po).abs().amax(dim=(0, 1, 2))
    return _quantize((yf - mu_po) / s_po, stash, key), amax


def _nhw(t) -> float:
    return float(t.shape[0] * t.shape[1] * t.shape[2])


def _sync():
    """The data-parallel step's reducers (``norm.synced_statistics``):
    (sum, max) over the ranks, or None outside one."""
    if not ops_norm._SYNC:
        return None
    return ops_norm._SYNC[-1], ops_norm._SYNC_MAX[-1]


def _batch_mean(yf, sync):
    """(per-channel mean over N·H·W, the row count): this rank's, or the
    global batch's under a sync."""
    if sync is None:
        return yf.mean(dim=(0, 1, 2)), _nhw(yf)
    s1 = yf.sum(dim=(0, 1, 2))
    tot = sync[0](torch.cat([s1, s1.new_tensor([_nhw(yf)])]))
    return tot[:-1] / tot[-1], tot[-1]


def _batch_var(yf, mu, n, sync):
    """The per-channel mean square of ``yf - mu`` over the batch."""
    if sync is None:
        return (yf - mu).square().mean(dim=(0, 1, 2))
    return sync[0]((yf - mu).square().sum(dim=(0, 1, 2))) / n


def _global_max(amax, sync):
    return amax if sync is None else sync[1](amax)


def _global_sum(g, sync):
    """A statistic's cotangent: each rank's loss reads the global
    statistic, so the gradient by it is the ranks' sum."""
    return g if sync is None or g is None else sync[0](g.float())


# ---------------------------------------------------------------------------
# entry: dense -> (carrier, stash)
# ---------------------------------------------------------------------------


class _Entry(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mu_p, s_p, key, stash):
        ctx.set_materialize_grads(False)
        xf = x.float()
        ctx.sync = _sync()
        q, amax = _stash(xf, mu_p, s_p, stash, key)
        mu, ctx.nhw = _batch_mean(xf, ctx.sync)
        amax = _global_max(amax, ctx.sync)
        ctx.x_like = (x.shape, x.device)
        ctx.mark_non_differentiable(q, amax)
        return _carrier(x), q, mu, amax

    @staticmethod
    def backward(ctx, g_yhat, _gq, g_mu, _ga):
        # straight-through: the carrier's cotangent is the input's, plus
        # d(mean(x))/dx = 1/nhw of the mu output; amax is state
        if g_yhat is None and g_mu is None:
            return None, None, None, None, None
        shape, device = ctx.x_like
        g = (torch.zeros(shape, device=device) if g_yhat is None
             else g_yhat.float())
        g_mu = _global_sum(g_mu, ctx.sync)
        if g_mu is not None:
            g = g + g_mu.float() / ctx.nhw
        return g.to(dtypes.compute_dtype()), None, None, None, None


@functools.lru_cache(maxsize=None)
def make_entry(stash: str = "int8", stochastic: bool = False):
    """The entry block: ``(x, mu_p, s_p[, key]) -> (carrier, q, mu,
    amax)``; with ``stochastic`` the signature gains a trailing ops/prng
    key and the rounding is unbiased."""
    _check_stash(stash, stochastic)

    def entry(x, mu_p, s_p, *key):
        return _Entry.apply(x, mu_p, s_p, key[0] if stochastic else None,
                            stash)

    return entry


def entry_stash(x, mu_p, s_p):
    """The int8 entry (see :func:`make_entry`)."""
    return make_entry("int8")(x, mu_p, s_p)


# ---------------------------------------------------------------------------
# exit: (carrier, stash) -> dense
# ---------------------------------------------------------------------------


class _Exit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, yhat, q, M, B, mu_p, s_p, relu):
        ctx.set_materialize_grads(False)
        x = _dequant(q, mu_p, s_p) * M + B
        if relu:
            x = torch.clamp_min(x, 0.0)
        ctx.relu = relu
        ctx.save_for_backward(q, M, B, mu_p, s_p)
        return x.to(dtypes.compute_dtype())

    @staticmethod
    def backward(ctx, g):
        q, M, B, mu_p, s_p = ctx.saved_tensors
        if g is None:
            return (None,) * 7
        yd = _dequant(q, mu_p, s_p)
        gf = g.float()
        if ctx.relu:
            gf = gf * (yd * M + B > 0)
        return ((gf * M).to(dtypes.compute_dtype()), _stash_zero(q),
                _red(gf * yd, M), _red(gf, B), None, None, None)


@functools.lru_cache(maxsize=None)
def make_exit(relu: bool):
    """Out of the pipeline: ``x = act(yhat * M + B)`` from the stash;
    ``(yhat, q, M, B, mu_p, s_p) -> x`` in the compute dtype. The
    backward needs only the stash."""

    def exit_deq(yhat, q, M, B, mu_p, s_p):
        return _Exit.apply(yhat, q, M, B, mu_p, s_p, relu)

    return exit_deq


# ---------------------------------------------------------------------------
# the conv block: prologue (dequant + affine + act) -> conv -> stats +
# quantize
# ---------------------------------------------------------------------------


def _prologue(q_in, M, B, mu_pi, s_pi, relu_in):
    x = _dequant(q_in, mu_pi, s_pi) * M + B
    if relu_in:
        x = torch.clamp_min(x, 0.0)
    return x.to(dtypes.compute_dtype())


def _conv_vjp(xt, w, dy, stride, padding):
    """(dx, dw) of ``ops_conv.conv2d(xt, w, stride, padding)`` at the
    cotangent ``dy``, as ``jax.vjp(conv, xt, w)`` gives them: one
    ``convolution_backward`` (cuDNN's on the card) of the rounded
    operands, ``dw`` in ``w``'s dtype; no forward is recomputed."""
    cdt = dtypes.compute_dtype()
    H, W = xt.shape[1:3]
    xc, wc, sym = ops_conv.nchw_operands(xt.to(cdt), w.to(cdt), stride,
                                         padding, 1)
    s = ops_conv._pair(stride)
    gy = dy.to(cdt).permute(0, 3, 1, 2)
    if xc.device.type == "cpu":
        # the CPU backward of a channels_last 1x1 stride-2 convolution
        # corrupts the heap (torch 2.13): hand it NCHW-contiguous
        # operands there; cuDNN takes the channels_last views
        xc, wc, gy = xc.contiguous(), wc.contiguous(), gy.contiguous()
    dxc, dwc, _ = torch.ops.aten.convolution_backward(
        gy, xc, wc, None, s, sym, (1, 1), False, (0, 0), 1,
        (True, True, False))
    if xc.shape[2:] != (H, W):      # asymmetric pads were applied first
        (h0, _), (w0, _) = ops_conv.resolve_pads((H, W), padding,
                                                 w.shape[:2], s)
        dxc = dxc[:, :, h0:h0 + H, w0:w0 + W]
    return dxc.permute(0, 2, 3, 1), dwc.permute(2, 3, 1, 0).to(w.dtype)


class _ConvQ8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, yhat_in, q_in, w, M, B, mu_pi, s_pi, mu_po, s_po, key,
                cfg):
        ctx.set_materialize_grads(False)
        stride, padding, relu_in, stash = cfg
        xt = _prologue(q_in, M, B, mu_pi, s_pi, relu_in)
        yf = ops_conv.conv2d(xt, w, stride=stride, padding=padding).float()
        ctx.sync = _sync()
        mu, ctx.n = _batch_mean(yf, ctx.sync)
        var = _batch_var(yf, mu, ctx.n, ctx.sync)
        q_out, amax = _stash(yf, mu_po, s_po, stash, key)
        amax = _global_max(amax, ctx.sync)
        ctx.cfg = cfg
        ctx.save_for_backward(q_in, q_out, mu, w, M, B, mu_pi, s_pi, mu_po,
                              s_po)
        ctx.mark_non_differentiable(q_out, amax)
        return _carrier(yf), q_out, mu, var, amax

    @staticmethod
    def backward(ctx, g_yhat, _gq, g_mu, g_var, _ga):
        q_in, q_out, mu, w, M, B, mu_pi, s_pi, mu_po, s_po = \
            ctx.saved_tensors
        stride, padding, relu_in, _ = ctx.cfg
        cdt = dtypes.compute_dtype()
        # y rebuilt from its own stash (straight-through through the round)
        yf = _dequant(q_out, mu_po, s_po)
        nhw = ctx.n
        g_mu = _global_sum(g_mu, ctx.sync)
        g_var = _global_sum(g_var, ctx.sync)
        dy = _zero_if_none(g_yhat, yf)
        if g_mu is not None:
            dy = dy + g_mu / nhw
        if g_var is not None:
            dy = dy + g_var * 2.0 * (yf - mu) / nhw
        xt = _prologue(q_in, M, B, mu_pi, s_pi, relu_in)
        dxt, dw = _conv_vjp(xt, w, dy.to(cdt), stride, padding)
        dpre = dxt.float()
        yd_in = _dequant(q_in, mu_pi, s_pi)
        if relu_in:
            dpre = dpre * (yd_in * M + B > 0)
        return ((dpre * M).to(cdt), _stash_zero(q_in), dw,
                _red(dpre * yd_in, M), _red(dpre, B),
                None, None, None, None, None, None)


@functools.lru_cache(maxsize=None)
def make_conv_q8(stride: int, padding, relu_in: bool,
                 stash: str = "int8", stochastic: bool = False):
    """The conv block for a static (stride, padding, input activation):

      (yhat_in, q_in, w, M, B, mu_pi, s_pi, mu_po, s_po[, key])
        -> (yhat_out, q_out, mu, var, amax)

    ``q_in`` is the producer's stash (the data path), ``yhat_in`` its
    carrier (the gradient edge); ``M, B`` the producer's deferred BN on
    the dequantized basis, ``x = act(yhat * M + B)`` (gradients reach
    its gamma / beta through them); ``mu_pi, s_pi`` / ``mu_po, s_po``
    the input / output stash's delayed center and scale (state);
    ``mu, var`` this conv's batch statistics over its raw output, whose
    cotangents carry the exact BN batch-statistic terms."""
    _check_stash(stash, stochastic)
    cfg = (stride, padding, relu_in, stash)

    def block(yhat_in, q_in, w, M, B, mu_pi, s_pi, mu_po, s_po, *key):
        return _ConvQ8.apply(yhat_in, q_in, w, M, B, mu_pi, s_pi, mu_po,
                             s_po, key[0] if stochastic else None, cfg)

    return block


# ---------------------------------------------------------------------------
# residual add: affine both branches, add, stash pre-activation
# ---------------------------------------------------------------------------


def _branch(q, M, B, mu_p, s_p, relu):
    v = _dequant(q, mu_p, s_p) * M + B
    return torch.clamp_min(v, 0.0) if relu else v


class _AddQ8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ya, qa, Ma, Ba, mu_pa, s_pa, yb, qb, Mb, Bb, mu_pb,
                s_pb, mu_po, s_po, key, cfg):
        ctx.set_materialize_grads(False)
        relu_a, relu_b, stash = cfg
        z = (_branch(qa, Ma, Ba, mu_pa, s_pa, relu_a)
             + _branch(qb, Mb, Bb, mu_pb, s_pb, relu_b))
        ctx.sync = _sync()
        mu, ctx.nhw = _batch_mean(z, ctx.sync)
        q_out, amax = _stash(z, mu_po, s_po, stash, key)
        amax = _global_max(amax, ctx.sync)
        ctx.cfg = cfg
        ctx.save_for_backward(qa, Ma, Ba, mu_pa, s_pa, qb, Mb, Bb, mu_pb,
                              s_pb)
        ctx.mark_non_differentiable(q_out, amax)
        return _carrier(z), q_out, mu, amax

    @staticmethod
    def backward(ctx, g_yhat, _gq, g_mu, _ga):
        qa, Ma, Ba, mu_pa, s_pa, qb, Mb, Bb, mu_pb, s_pb = ctx.saved_tensors
        relu_a, relu_b, _ = ctx.cfg
        cdt = dtypes.compute_dtype()
        dz = _zero_if_none(g_yhat, qa)
        g_mu = _global_sum(g_mu, ctx.sync)
        if g_mu is not None:
            dz = dz + g_mu / ctx.nhw

        def back(q, M, B, mu_p, s_p, relu):
            g = dz
            yd = _dequant(q, mu_p, s_p)
            if relu:
                g = g * (yd * M + B > 0)
            return (g * M).to(cdt), _red(g * yd, M), _red(g, B)

        dya, dMa, dBa = back(qa, Ma, Ba, mu_pa, s_pa, relu_a)
        dyb, dMb, dBb = back(qb, Mb, Bb, mu_pb, s_pb, relu_b)
        return (dya, _stash_zero(qa), dMa, dBa, None, None,
                dyb, _stash_zero(qb), dMb, dBb, None, None, None, None,
                None, None)


@functools.lru_cache(maxsize=None)
def make_add_q8(relu_a: bool, relu_b: bool, stash: str = "int8",
                stochastic: bool = False):
    """The residual-add block: both branches come in as stashes with
    their deferred affines (Ma, Ba / Mb, Bb) and ReLUs; the sum is
    stashed centered BEFORE the activation (consumers defer it), so
    the int8 range is not halved on the non-negative side.

      (ya, qa, Ma, Ba, mu_pa, s_pa, yb, qb, Mb, Bb, mu_pb, s_pb,
       mu_po, s_po[, key]) -> (yhat_out, q_out, mu, amax)
    """
    _check_stash(stash, stochastic)
    cfg = (relu_a, relu_b, stash)

    def block(*args):
        key = args[14] if stochastic else None
        return _AddQ8.apply(*args[:14], key, cfg)

    return block


# ---------------------------------------------------------------------------
# per-channel affine folding (plain differentiable vector math)
# ---------------------------------------------------------------------------


def fold_bn_affine(mu, var, gamma, beta, eps: float = 1e-5):
    """A producer's deferred batch norm as one affine on the dequantized
    basis: bn(y) = (y - mu) r gamma + beta = y (r gamma) + (beta -
    mu r gamma), r = rsqrt(var + eps); gradients flow through all four."""
    r = torch.rsqrt(var + eps)
    M = r * gamma
    return M, beta - mu * r * gamma


def fold_identity(like):
    """The unit affine of a stash with no deferred BN (an add's output,
    the entry)."""
    return torch.ones_like(like), torch.zeros_like(like)


# ---------------------------------------------------------------------------
# layer-granular remat with a quantized stash (the transformer's blocks)
# ---------------------------------------------------------------------------


class _Remat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, x, *flat_args):
        fn, stash, generator, spec_args, box = run
        ctx.set_materialize_grads(False)
        args = pytree.tree_unflatten(list(flat_args), spec_args)
        if stash == "bf16":
            q = x.to(torch.bfloat16)
            scale = torch.ones((), dtype=torch.float32, device=x.device)
        else:
            amax = x.float().abs().amax()
            scale = torch.clamp_min(amax, 1e-6) / 127.0
            q = _quantize(x.float() / scale)
        ctx.rng = None if generator is None else generator.get_state()
        out = fn(x, args)
        flat_out, box["spec"] = pytree.tree_flatten(out)
        ctx.n_out = len(flat_out)
        ctx.run = run
        ctx.x_dtype = x.dtype
        ctx.save_for_backward(q, scale, *flat_args)
        return tuple(flat_out)

    @staticmethod
    def backward(ctx, *gs):
        fn, _, generator, spec_args, _ = ctx.run
        q, scale, *flat_args = ctx.saved_tensors
        xt = (q.float() * scale).to(ctx.x_dtype).requires_grad_()
        args = [a.detach().requires_grad_(a.requires_grad)
                if isinstance(a, torch.Tensor) and a.is_floating_point()
                else a for a in flat_args]
        now = None
        if generator is not None:     # redraw the forward's masks
            now = generator.get_state()
            generator.set_state(ctx.rng)
        try:
            with torch.enable_grad():
                out, _ = pytree.tree_flatten(
                    fn(xt, pytree.tree_unflatten(args, spec_args)))
        finally:
            if now is not None:
                generator.set_state(now)
        pairs = [(o, g) for o, g in zip(out, gs)
                 if g is not None and isinstance(o, torch.Tensor)
                 and o.requires_grad]
        wrt = [xt] + [a for a in args if isinstance(a, torch.Tensor)
                      and a.requires_grad]
        grads = iter(torch.autograd.grad(
            [o for o, _ in pairs], wrt, [g for _, g in pairs],
            allow_unused=True) if pairs else [None] * len(wrt))
        gx = next(grads)
        g_args = [next(grads) if isinstance(a, torch.Tensor)
                  and a.requires_grad else None for a in args]
        return (None, gx, *g_args)


def q8_remat(fn, stash: str = "int8"):
    """Wrap ``fn(x, args) -> out`` so that autograd saves only a
    quantized copy of ``x`` (with ``args``) and the backward recomputes
    the block. The forward runs on the exact ``x`` under no_grad; the
    backward rebuilds ``fn``'s vjp at ``x~ = dequant(stash)``: "int8"
    with one per-tensor scale from the current absmax (``max(amax,
    1e-6) / 127``), "bf16" a cast (classic block remat). ``args`` is a
    pytree of tensors (weights); every output of ``out`` gets its
    cotangent. The wrapped call takes ``generator=``, the
    ``torch.Generator`` ``fn`` draws dropout masks from: its state is
    saved before the forward and restored around the recompute, so the
    backward redraws the same masks."""
    _check_stash(stash)

    def wrapped(x, args, generator=None):
        flat_args, spec_args = pytree.tree_flatten(args)
        box = {}
        run = (fn, stash, generator, spec_args, box)
        flat_out = _Remat.apply(run, x, *flat_args)
        return pytree.tree_unflatten(list(flat_out), box["spec"])

    return wrapped


# ---------------------------------------------------------------------------
# quantized collectives: int8 payloads on the wire
# ---------------------------------------------------------------------------

def wire_encode(x: torch.Tensor, block_dims: int = 0):
    """The int8 wire codec of the JAX package's ``ppermute_q8_raw`` /
    ``all_to_all_q8_raw``: symmetric codes ``round(x / sc)`` (half to
    even, clipped to [-127, 127]) with ``sc = max(absmax, 1e-8) / 127``
    in fp32, one scale per shard (``block_dims=0``) or one per index of
    the leading axis (``block_dims=1``, the all-to-all's destination
    blocks). Returns (codes int8, scales fp32)."""
    xf = x.float()
    if block_dims:
        amax = xf.abs().amax(dim=tuple(range(1, x.ndim)))
        sc = torch.clamp_min(amax, 1e-8) / 127.0
        z = xf / sc.reshape((-1,) + (1,) * (x.ndim - 1))
    else:
        sc = torch.clamp_min(xf.abs().amax(), 1e-8) / 127.0
        z = xf / sc
    return torch.clamp(torch.round(z), -127.0, 127.0).to(torch.int8), sc


def wire_decode(q: torch.Tensor, sc: torch.Tensor, dtype) -> torch.Tensor:
    if sc.ndim:
        sc = sc.reshape((-1,) + (1,) * (q.ndim - 1))
    return (q.float() * sc).to(dtype)


def _wire_mesh(mesh):
    if mesh is not None:
        return mesh
    from paddle_tpu_torch.parallel import compat
    return compat.current_mesh()


def ppermute_q8_raw(x: torch.Tensor, axis_name: str, perm,
                    mesh=None) -> torch.Tensor:
    """One quantized hop (int8 codes + one fp32 scale) with no autograd:
    for hand-written backward passes (the flash ring). ``mesh``
    defaults to the running ``shard_map``'s."""
    from paddle_tpu_torch.parallel import spmd
    mesh = _wire_mesh(mesh)
    q, sc = wire_encode(x)
    qp = spmd.ppermute(q, mesh, axis_name, perm, tag="wire_int8")
    sp = spmd.ppermute(sc.reshape(1), mesh, axis_name, perm,
                       tag="wire_scale")
    return wire_decode(qp, sp.reshape(()), x.dtype)


class _PPermuteQ8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, perm, mesh):
        ctx.args = (axis_name, perm, mesh)
        return ppermute_q8_raw(x, axis_name, perm, mesh)

    @staticmethod
    def backward(ctx, g):
        axis_name, perm, mesh = ctx.args
        inv = tuple((d, s) for s, d in perm)
        return ppermute_q8_raw(g, axis_name, inv, mesh), None, None, None


def make_ppermute_q8(axis_name: str, perm, mesh=None):
    """``ppermute`` with the int8 wire codec in BOTH directions: the
    forward payload and the backward gradient each travel as int8 codes
    + an fp32 scale (straight-through: the reversed permutation with the
    same codec). For pipeline sends and ring K/V rotations."""
    perm = tuple(tuple(p) for p in perm)

    def pq(x):
        return _PPermuteQ8.apply(x, axis_name, perm, _wire_mesh(mesh))
    return pq


def all_to_all_q8_raw(x: torch.Tensor, axis_name: str,
                      mesh=None) -> torch.Tensor:
    """One quantized all-to-all with no autograd: ``x``'s leading axis
    indexes the DESTINATION rank (size = the axis size), the result's
    the SOURCE rank; each block has its own scale and the scale vector
    rides the same all-to-all."""
    from paddle_tpu_torch.parallel import spmd
    mesh = _wire_mesh(mesh)
    q, sc = wire_encode(x, block_dims=1)
    qp = spmd.all_to_all(q, mesh, axis_name, tag="wire_int8")
    sp = spmd.all_to_all(sc, mesh, axis_name, tag="wire_scale")
    return wire_decode(qp, sp, x.dtype)


class _AllToAllQ8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, mesh):
        ctx.args = (axis_name, mesh)
        return all_to_all_q8_raw(x, axis_name, mesh)

    @staticmethod
    def backward(ctx, g):
        axis_name, mesh = ctx.args
        return all_to_all_q8_raw(g.contiguous(), axis_name, mesh), None, \
            None


def make_all_to_all_q8(axis_name: str, mesh=None):
    """``all_to_all`` (leading axis) with the int8 codec in both
    directions; the block exchange is its own inverse, so the backward
    is the same codec on the gradient. For MoE dispatch/combine."""
    def a2a(x):
        return _AllToAllQ8.apply(x, axis_name, _wire_mesh(mesh))
    return a2a


# ---------------------------------------------------------------------------
# weight quantization (serving): per-output-channel symmetric int8
# ---------------------------------------------------------------------------


def quantize_weight(w: torch.Tensor, reduce_axis) -> dict:
    """Symmetric per-output-channel int8: the scale is the absmax over
    the contraction axis (or axes) ``reduce_axis`` over 127, kept at
    ``w``'s rank so it broadcasts. Returns {"q8", "scale"}."""
    wf = w.float()
    amax = wf.abs().amax(dim=reduce_axis, keepdim=True)
    scale = torch.clamp_min(amax, 1e-8) / 127.0
    return {"q8": _quantize(wf / scale), "scale": scale}


def dequantize_weight(node: dict, dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_weight`: ``q8 * scale`` in fp32,
    then cast to ``dtype``. The multiply runs in place on the widened
    codes, so one fp32 copy of the weight exists at a time (the vocab
    head dequantizes the whole embedding every step)."""
    return node["q8"].float().mul_(node["scale"]).to(dtype)


def is_quantized_weight(node) -> bool:
    return isinstance(node, dict) and set(node) == {"q8", "scale"}


def dequantize_tree(tree, dtype=torch.float32):
    """A parameter dict with every {"q8", "scale"} node dequantized;
    every other leaf passes through."""
    if is_quantized_weight(tree):
        return dequantize_weight(tree, dtype)
    if isinstance(tree, dict):
        return {k: dequantize_tree(v, dtype) for k, v in tree.items()}
    return tree


# ---------------------------------------------------------------------------
# KV-cache quantization (serving): per-token, per-head symmetric int8/int4
# ---------------------------------------------------------------------------

# symmetric clip targets: int8 uses the signed range without -128; int4
# packs two nibbles per byte, each a two's-complement value in [-7, 7]
KV_QMAX = {"int8": 127.0, "int4": 7.0}
KV_DTYPES = tuple(KV_QMAX)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8 values in [-7, 7] over an even last axis -> one byte per
    pair: even positions in the low nibble, odd in the high. Shape
    [..., D] -> [..., D//2] int8."""
    if q.shape[-1] % 2:
        raise ValueError(f"pack_int4 needs an even last axis, got "
                         f"{tuple(q.shape)}")
    lo = q[..., 0::2].to(torch.int32)
    hi = q[..., 1::2].to(torch.int32)
    return ((hi << 4) | (lo & 0xF)).to(torch.int8)


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: [..., D//2] int8 -> [..., D] int32.
    The low nibble sign-extends as ``((p & 0xF) ^ 8) - 8``, the high one
    as an arithmetic shift of the sign-extended byte: no shift leaves
    int32's range, and the integers are the JAX package's."""
    p32 = p.to(torch.int32)
    lo = ((p32 & 0xF) ^ 8) - 8
    hi = p32 >> 4
    return torch.stack([lo, hi], dim=-1).reshape(
        p.shape[:-1] + (p.shape[-1] * 2,))


def quantize_kv(x: torch.Tensor, kv_dtype: str):
    """Symmetric per-row quantization of KV vectors: ``x [..., Dh]`` ->
    ``(q, scale)``, one fp32 scale per leading index. ``q`` is int8
    ``[..., Dh]`` for int8 and nibble-packed int8 ``[..., Dh//2]`` for
    int4."""
    if kv_dtype not in KV_QMAX:
        raise ValueError(f"kv_dtype {kv_dtype!r}: one of {KV_DTYPES}")
    qmax = KV_QMAX[kv_dtype]
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp_min(amax, 1e-8) / qmax
    q = torch.clamp(torch.round(xf / scale[..., None]),
                    -qmax, qmax).to(torch.int8)
    if kv_dtype == "int4":
        q = pack_int4(q)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  kv_dtype: str) -> torch.Tensor:
    """``(q [..., Dh'], scale [...]) -> fp32 [..., Dh]``: exact integer
    unpack, widen to fp32, multiply by the row's scale."""
    qi = unpack_int4(q) if kv_dtype == "int4" else q
    return qi.float() * scale[..., None]
