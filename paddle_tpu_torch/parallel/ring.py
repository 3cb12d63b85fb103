"""Single-device attention reference (counterpart of
``paddle_tpu/parallel/ring.py::full_attention``). Ring and all-to-all
context parallelism are not ported yet."""

import math
from typing import Optional

import torch

NEG_INF = -1e30


def full_attention(q, k, v, *, causal: bool = False,
                   lengths: Optional[torch.Tensor] = None,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Plain attention with dense scores. q [B, T, H, D], k/v
    [B, T, Hkv, D] (H % Hkv == 0, grouped in the product, no repeated
    heads); ``lengths`` [B] masks keys at or past each row's length.
    Scores and softmax in fp32, masked entries -1e30 and their
    probabilities zeroed -> [B, T, H, D] in q's dtype."""
    B, T, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    scale = scale or (1.0 / math.sqrt(D))
    qg = q.reshape(B, T, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    mask = torch.ones((B, T, T), dtype=torch.bool, device=q.device)
    if causal:
        i = torch.arange(T, device=q.device)
        mask = mask & (i[None, :, None] >= i[None, None, :])
    if lengths is not None:
        mask = mask & (torch.arange(T, device=q.device)[None, None, :]
                       < lengths.to(q.device)[:, None, None])
    mask = mask[:, None, None]
    s = torch.where(mask, s, NEG_INF)
    p = torch.where(mask, torch.softmax(s, dim=-1), 0.0)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, T, H, D).to(q.dtype)
