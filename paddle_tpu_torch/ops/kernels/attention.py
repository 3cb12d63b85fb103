"""Flash attention, forward and backward (counterpart of
``paddle_tpu/ops/pallas/attention.py``).

- :func:`flash_attention_fwd` — (out, logsumexp) of causal or full
  attention with an online softmax (``csrc/flash_attn_fwd.cuh``);
- :func:`flash_attention_bwd` — (dq, dk, dv) from the saved state, p
  rebuilt from the logsumexp (``csrc/flash_attn_bwd.cuh``);
- :class:`FlashAttention` — the ``torch.autograd.Function`` that calls
  the two, and :func:`flash_attention`, the public ``[B, T, H, D]``
  entry with grouped-query expansion;
- :func:`flash_block_fwd` / :func:`flash_block_bwd` — the block-level
  entries composed attentions (ring attention) drive themselves.

Wrappers as in ``ops/kernels/decode.py``: a CUDA tensor launches the
hand-written kernel or raises, a CPU tensor runs the ``*_plain``
version. Each C entry dispatches by dtype to one instantiation of the
same tensor-core kernels (wgmma). bf16: q, k, v, do one bf16 term
each, p and ds split into bf16 hi and lo halves so the products keep
fp32 accuracy. fp32: every operand, p and ds included, split into
three bf16 terms (six products in place of each fp32 one,
fp32-accurate). ``<wrapper>.launches`` counts launches per branch,
``{"bf16": n, "fp32": n}``. Both take any ``T >= 1`` and head dims 32,
64, 96 and 128; the kernels stage tiles by 16-byte copies, so their
operands must be 16-byte aligned (a misaligned one raises; it is never
copied).
The JAX package's block-size table (``select_block_sizes``,
``MEASURED_BLOCKS``, ``VMEM_BYTES``) sizes TPU VMEM tiles and has no
counterpart: the CUDA kernels fix their own 64 x 64 tiles.
"""

import math
from typing import Optional

import torch

from paddle_tpu_torch.ops.kernels import _build

NEG_INF = -1e30
# must match the head_dim ``switch`` of both csrc/flash_attn_*.cuh
# dispatchers: a size listed here and missing there raises on the card
HEAD_DIMS = (32, 64, 96, 128)


def bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| in bf16 ulps of max(|want|, 2**-6): the unit of
    the bf16 tolerances the kernels are held to against their plain
    versions (the floor keeps near-zero entries from asking for more
    than absolute bf16 rounding can give)."""
    mag = want.float().abs().clamp_min(2.0 ** -6)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return ((got.float() - want.float()).abs() / ulp).max().item()


def _acc(t: torch.Tensor) -> torch.Tensor:
    """``t`` in its accumulation type: fp32, or fp64 for fp64 inputs
    (so ``gradcheck`` can run the plain versions in double)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _valid(T: int, causal: bool, device) -> Optional[torch.Tensor]:
    """[T, T] bool of visible (query, key) pairs, None when all are."""
    if not causal:
        return None
    i = torch.arange(T, device=device)
    return i[:, None] >= i[None, :]


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def flash_attention_fwd_plain(q, k, v, *, sm_scale: float, causal: bool):
    """Plain forward with dense scores: q scaled before the dot, -1e30
    mask, ``out = (exp(s - m) @ v) / max(l, 1e-30)`` and
    ``lse = m + log(max(l, 1e-30))``.

    q, k, v [BH, T, D] -> (out [BH, T, D] in q's dtype, lse [BH, T] in
    the accumulation type)."""
    qf, kf, vf = _acc(q), _acc(k), _acc(v)
    s = (qf * sm_scale) @ kf.transpose(-1, -2)
    valid = _valid(q.shape[1], causal, q.device)
    if valid is not None:
        s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l_safe = p.sum(dim=-1).clamp_min(1e-30)
    out = (p @ vf) / l_safe[..., None]
    return out.to(q.dtype), m + torch.log(l_safe)


def flash_attention_bwd_plain(q, k, v, out, lse, do, *, sm_scale: float,
                              causal: bool):
    """Plain backward from the saved state: ``delta = sum(do * out)``,
    ``s = (q @ k^T) * scale``, ``p = exp(s - lse)`` zeroed where
    invalid, ``dv = p^T do``, ``ds = p * (do @ v^T - delta) * scale``,
    ``dq = ds @ k``, ``dk = ds^T q``; each cast to its input's dtype.
    ``lse`` may be the logsumexp over more keys than ``k`` holds (a
    block of a composed attention): the identity holds for any block."""
    qf, kf, vf, dof = _acc(q), _acc(k), _acc(v), _acc(do)
    delta = (dof * _acc(out)).sum(dim=-1)
    s = (qf @ kf.transpose(-1, -2)) * sm_scale
    p = torch.exp(s - lse.to(s.dtype)[..., None])
    valid = _valid(q.shape[1], causal, q.device)
    if valid is not None:
        p = torch.where(valid, p, 0.0)
    dv = p.transpose(-1, -2) @ dof
    ds = p * (dof @ vf.transpose(-1, -2) - delta[..., None]) * sm_scale
    dq = ds @ kf
    dk = ds.transpose(-1, -2) @ qf
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

# the kernel branch each input dtype launches (``<wrapper>.launches`` keys)
BRANCHES = {torch.bfloat16: "bf16", torch.float32: "fp32"}


def _check(q, named, what: str):
    """Validate [BH, T, D] operands for the CUDA kernels, 16-byte
    aligned included."""
    dev = q.device
    _build.require(q, "q", device=dev, dtype=tuple(_build.DTYPE_CODES),
                   ndim=3)
    BH, T, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {D}; the kernel takes "
                         f"{HEAD_DIMS}")
    if BH > 65535:
        raise ValueError(f"{what}: {BH} batch x heads, over the kernel's "
                         f"grid limit of 65535")
    for name, t in named.items():
        _build.require(t, name, device=dev, dtype=q.dtype, shape=(BH, T, D))
    for name, t in (("q", q), *named.items()):
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} is not 16-byte aligned (the "
                             f"tensor-core kernels stage tiles in 16-byte "
                             f"copies)")
    return BH, T, D


def flash_attention_fwd(q, k, v, *, sm_scale: float, causal: bool):
    """(out, lse) of attention over q, k, v [BH, T, D] (fp32 or bf16,
    contiguous): out [BH, T, D] in q's dtype, lse [BH, T] fp32."""
    if _build.on_cpu(q, "flash_attention_fwd"):
        return flash_attention_fwd_plain(q, k, v, sm_scale=sm_scale,
                                         causal=causal)
    BH, T, D = _check(q, {"k": k, "v": v}, "flash_attention_fwd")
    dev = q.device
    out = torch.empty_like(q)
    lse = torch.empty((BH, T), dtype=torch.float32, device=dev)
    with _build.on_device(dev):
        err = _build.library().pk_flash_attn_fwd(
            _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
            _build.ptr(lse), BH, T, D, float(sm_scale), int(bool(causal)),
            _build.DTYPE_CODES[q.dtype], _build.stream(dev))
    _build.check(err, "flash_attention_fwd")
    flash_attention_fwd.launches[BRANCHES[q.dtype]] += 1
    return out, lse


flash_attention_fwd.launches = _build.new_launch_counts(BRANCHES.values())


def flash_attention_bwd(q, k, v, out, lse, do, *, sm_scale: float,
                        causal: bool):
    """(dq, dk, dv) of attention from the saved (q, k, v, out, lse) and
    the output gradient ``do``, all [BH, T, D] in one dtype (lse
    [BH, T] fp32). One launch runs both kernels of the backward (dk/dv,
    then dq); delta = sum(do * out) in fp32 is computed here first, as
    the JAX package computes it outside its kernel."""
    if _build.on_cpu(q, "flash_attention_bwd"):
        return flash_attention_bwd_plain(q, k, v, out, lse, do,
                                         sm_scale=sm_scale, causal=causal)
    BH, T, D = _check(q, {"k": k, "v": v, "out": out, "do": do},
                      "flash_attention_bwd")
    dev = q.device
    _build.require(lse, "lse", device=dev, dtype=torch.float32,
                   shape=(BH, T))
    delta = (do.float() * out.float()).sum(dim=-1)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    with _build.on_device(dev):
        err = _build.library().pk_flash_attn_bwd(
            _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(do),
            _build.ptr(lse), _build.ptr(delta), _build.ptr(dq),
            _build.ptr(dk), _build.ptr(dv), BH, T, D, float(sm_scale),
            int(bool(causal)), _build.DTYPE_CODES[q.dtype],
            _build.stream(dev))
    _build.check(err, "flash_attention_bwd")
    flash_attention_bwd.launches[BRANCHES[q.dtype]] += 1
    return dq, dk, dv


flash_attention_bwd.launches = _build.new_launch_counts(BRANCHES.values())


# ---------------------------------------------------------------------------
# autograd and the public entries
# ---------------------------------------------------------------------------


class FlashAttention(torch.autograd.Function):
    """Attention over [BH, T, D] whose forward and backward are the two
    kernel wrappers; saves (q, k, v, out, lse) as the JAX VJP does."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale: float, causal: bool):
        out, lse = flash_attention_fwd(q, k, v, sm_scale=sm_scale,
                                       causal=causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.sm_scale, ctx.causal = sm_scale, causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, lse, do.contiguous(), sm_scale=ctx.sm_scale,
            causal=ctx.causal)
        return dq, dk, dv, None, None


def expand_kv_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, T, Hkv, D] -> [B, T, heads, D], each kv head repeated
    ``heads // Hkv`` times in a row (``jnp.repeat`` on axis 2). Written
    as expand + reshape, whose backward sums each group in a fixed
    order."""
    B, T, Hkv, D = x.shape
    if Hkv == heads:
        return x
    return (x[:, :, :, None, :].expand(B, T, Hkv, heads // Hkv, D)
            .reshape(B, T, heads, D))


def flash_attention(q, k, v, *, causal: bool = True,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Fused attention. q [B, T, H, D], k/v [B, T, Hkv, D] with
    H % Hkv == 0 -> [B, T, H, D] in q's dtype. Differentiable through
    :class:`FlashAttention`; grouped-query k/v are expanded to H heads
    before it, so autograd sums each group's gradient."""
    B, T, H, D = q.shape
    if H % k.shape[2]:
        raise ValueError(f"{H} query heads over {k.shape[2]} kv heads")
    k, v = expand_kv_heads(k, H), expand_kv_heads(v, H)
    sm_scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)

    def rows(x):
        return x.transpose(1, 2).reshape(B * H, T, D).contiguous()

    out = FlashAttention.apply(rows(q), rows(k), rows(v), sm_scale, causal)
    return out.reshape(B, H, T, D).transpose(1, 2)


def flash_block_fwd(q, k, v, sm_scale: float, causal: bool):
    """Block-level forward for composed attentions (ring/context
    parallelism): (normalized out, lse) of one q-shard against one k/v
    block, both [BH, T, D]. The caller folds blocks with the logsumexp
    rule and drives the backward through :func:`flash_block_bwd`."""
    return flash_attention_fwd(q, k, v, sm_scale=sm_scale, causal=causal)


def flash_block_bwd(q, k, v, out, lse, do, sm_scale: float, causal: bool):
    """Block-level backward: gradients of sum(out * do) for one q-shard
    against one k/v block, given the GLOBAL logsumexp over all blocks."""
    return flash_attention_bwd(q, k, v, out, lse, do, sm_scale=sm_scale,
                               causal=causal)
