"""int8 serving weights for the transformer LM (counterpart of
``paddle_tpu/io/lm_serving.py``, its ``quantize_lm_params`` only; the
artifact export is not ported).
"""

import numpy as np
import torch

from paddle_tpu_torch.core import place
from paddle_tpu_torch.ops import q8

# the big matmul weights, each with the axis its consumer contracts over
# (the scale's reduce axis): blocks.* are [L, in, out] (axis -2); embed
# [V, D] doubles as the vocab head contracting over D (axis -1), so an
# embedding row gather dequantizes with its row's scale
_W8_LEAVES = {("blocks", "qkv"): -2, ("blocks", "attn_out"): -2,
              ("blocks", "mlp_in"): -2, ("blocks", "mlp_out"): -2,
              ("embed",): -1}


def _fp32(a, where: str) -> torch.Tensor:
    """An fp32 leaf as a tensor; any other dtype raises."""
    if isinstance(a, torch.Tensor):
        if a.dtype != torch.float32:
            raise ValueError(f"quantize_lm_params: {where} is {a.dtype}; "
                             f"it quantizes the fp32 tree (quantizing "
                             f"rounded weights gives other bytes)")
        return a.detach()
    a = np.asarray(a)
    if a.dtype != np.float32:
        raise ValueError(f"quantize_lm_params: {where} is {a.dtype}; it "
                         f"quantizes the fp32 tree")
    return torch.from_numpy(a.copy())


def quantize_lm_params(params, device=None):
    """Per-output-channel int8 for the big matmul weights of an fp32
    parameter tree (numpy arrays, ``paddle_tpu``'s tree as numpy, or
    fp32 tensors such as ``init_train_params``'s): each becomes a
    {"q8", "scale"} node; layer norms and the position table stay fp32.
    The result is a serving tree for ``decode_step_paged``,
    ``prefill_into_blocks`` and ``PagedDecodeEngine``, on the card
    unless ``device`` says otherwise.

    Only the fp32 tree is accepted: the serving dict of ``init_params``
    holds the matmul weights already rounded to ``cfg.dtype``, and
    quantizing those gives other bytes than ``paddle_tpu`` does."""
    device = place.resolve_device(device)
    out = {}
    for name, leaf in params.items():
        if name == "blocks":
            out[name] = {}
            for bname, bleaf in leaf.items():
                t = _fp32(bleaf, f"blocks.{bname}").to(device)
                axis = _W8_LEAVES.get((name, bname))
                out[name][bname] = (q8.quantize_weight(t, axis)
                                    if axis is not None else t.contiguous())
        else:
            t = _fp32(leaf, name).to(device)
            axis = _W8_LEAVES.get((name,))
            out[name] = (q8.quantize_weight(t, axis) if axis is not None
                         else t.contiguous())
    return out
