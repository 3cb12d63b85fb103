"""Serving quantization (counterpart of the serving part of
``paddle_tpu/ops/q8.py``): per-output-channel int8 weights and
per-(token, head) int8/int4 KV rows.

Plain PyTorch: none of this runs inside a kernel in the JAX package
either. The op chains are the JAX package's, step for step (fp32
absmax, ``max(amax, 1e-8) / qmax``, divide, round half to even, clip,
int8), so the same fp32 inputs give the same bytes and the same fp32
scales. The kernels that read a quantized pool widen each element
exactly as :func:`dequantize_kv` does.
"""

import torch

# ---------------------------------------------------------------------------
# weight quantization (serving): per-output-channel symmetric int8
# ---------------------------------------------------------------------------


def _quantize(z: torch.Tensor) -> torch.Tensor:
    """Round half to even, clip to the symmetric int8 grid, cast."""
    return torch.clamp(torch.round(z), -127.0, 127.0).to(torch.int8)


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
