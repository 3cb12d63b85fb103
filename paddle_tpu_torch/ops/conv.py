"""Convolutions, NHWC with HWIO filters (counterpart of
``paddle_tpu/ops/conv.py``).

The convolution itself is cuDNN's (``F.conv2d``) on the card: the JAX
package has no hand kernel here either (it deleted its Pallas conv
kernels), so there is none to port. ``x.permute(0, 3, 1, 2)`` of an
NHWC-contiguous tensor is a channels_last NCHW view, which cuDNN takes
without a copy, and the output's inverse permute is NHWC-contiguous
again. Padding follows XLA: ``"SAME"`` pads ``(out - 1) * stride +
k_eff - n`` in total with the extra row or column at the bottom/right,
which ``F.conv2d(padding="same")`` (stride 1 only, symmetric) does not;
asymmetric pads are applied with ``F.pad`` first.
"""

from typing import Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.core import dtypes

IntOr2 = Union[int, Tuple[int, int], Sequence[int]]


def _pair(v: IntOr2) -> Tuple[int, int]:
    if isinstance(v, int):
        return (v, v)
    return tuple(v)


def _same_pads(n: int, k: int, s: int):
    """XLA's ``SAME`` (lo, hi) pads of one spatial axis: input ``n``,
    effective window ``k``, stride ``s`` (``lax.padtype_to_pads``)."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def resolve_pads(hw, padding, k, s, dilation=(1, 1)):
    """((ph0, ph1), (pw0, pw1)) of ``padding``: "SAME" | "VALID" | int |
    (ph, pw) | ((ph0, ph1), (pw0, pw1)), for spatial size ``hw``, window
    ``k``, stride ``s`` and dilation."""
    if isinstance(padding, str):
        if padding == "VALID":
            return ((0, 0), (0, 0))
        if padding != "SAME":
            raise ValueError(f"padding {padding!r}: 'SAME' or 'VALID'")
        return tuple(_same_pads(hw[i], (k[i] - 1) * dilation[i] + 1, s[i])
                     for i in range(2))
    if isinstance(padding, int):
        return ((padding, padding), (padding, padding))
    padding = tuple(padding)
    if isinstance(padding[0], int):
        return ((padding[0], padding[0]), (padding[1], padding[1]))
    return tuple(tuple(p) for p in padding)


def nchw_operands(x, w, stride, padding, dilation):
    """(x as a channels_last NCHW view, padded where the pads are
    asymmetric; w as OIHW; the symmetric pads left for ``F.conv2d``)."""
    k, s, d = w.shape[:2], _pair(stride), _pair(dilation)
    (h0, h1), (w0, w1) = resolve_pads(x.shape[1:3], padding, k, s, d)
    xc = x.permute(0, 3, 1, 2)
    if h0 == h1 and w0 == w1:
        sym = (h0, w0)
    else:
        xc = F.pad(xc, (w0, w1, h0, h1))
        sym = (0, 0)
    return xc, w.permute(3, 2, 0, 1), sym


def conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: IntOr2 = 1,
           padding="SAME", dilation: IntOr2 = 1, groups: int = 1
           ) -> torch.Tensor:
    """2-D convolution, computed and returned in the compute dtype.

    x: [N, H, W, Cin]; w: [kH, kW, Cin//groups, Cout]; padding: "SAME" |
    "VALID" | int | (ph, pw) | ((ph0,ph1),(pw0,pw1)).
    """
    cdt = dtypes.compute_dtype()
    xc, wc, sym = nchw_operands(x.to(cdt), w.to(cdt), stride, padding,
                                dilation)
    y = F.conv2d(xc, wc, stride=_pair(stride), padding=sym,
                 dilation=_pair(dilation), groups=groups)
    return y.permute(0, 2, 3, 1)


def depthwise_conv2d(x: torch.Tensor, w: torch.Tensor, *,
                     stride: IntOr2 = 1, padding="SAME",
                     dilation: IntOr2 = 1) -> torch.Tensor:
    """Depthwise conv: w is [kH, kW, 1, C*multiplier], groups = Cin."""
    return conv2d(x, w, stride=stride, padding=padding, dilation=dilation,
                  groups=x.shape[-1])


def _transpose_pads(k: int, s: int, padding: str):
    """(lo, hi) pads of the stride-dilated input (``lax.conv_transpose``'s
    ``_conv_transpose_padding``)."""
    if padding == "SAME":
        pad_len = k + s - 2
        lo = k - 1 if s > k - 1 else -(-pad_len // 2)
    elif padding == "VALID":
        pad_len = k + s - 2 + max(k - s, 0)
        lo = k - 1
    else:
        raise ValueError("padding must be 'SAME' or 'VALID'")
    return lo, pad_len - lo


def conv2d_transpose(x: torch.Tensor, w: torch.Tensor, *,
                     stride: IntOr2 = 1, padding="SAME") -> torch.Tensor:
    """Transposed conv: ``lax.conv_transpose`` with its default
    ``transpose_kernel=False``, i.e. a correlation of the HWIO kernel
    (not flipped, I = x's channels) over the input dilated by ``stride``
    and padded (lo, hi) per axis (XLA's rule for "SAME"/"VALID", or
    explicit pairs).

    ``F.conv_transpose2d`` with the kernel flipped is that correlation
    over the dilated input padded (k-1, k-1); the output is then cropped
    (or zero-extended) by lo - (k-1) and hi - (k-1) at each end."""
    cdt = dtypes.compute_dtype()
    s = _pair(stride)
    k = w.shape[:2]
    if isinstance(padding, str):
        pads = [_transpose_pads(k[i], s[i], padding) for i in range(2)]
    else:
        pads = [tuple(p) for p in padding]
    wt = torch.flip(w.to(cdt), dims=(0, 1)).permute(2, 3, 0, 1)
    y = F.conv_transpose2d(x.to(cdt).permute(0, 3, 1, 2), wt, stride=s)
    adj = (pads[1][0] - (k[1] - 1), pads[1][1] - (k[1] - 1),
           pads[0][0] - (k[0] - 1), pads[0][1] - (k[0] - 1))
    if any(adj):
        y = F.pad(y, adj)
    return y.permute(0, 2, 3, 1)


def conv3d(x: torch.Tensor, w: torch.Tensor, *, stride=1,
           padding=((0, 0), (0, 0), (0, 0))) -> torch.Tensor:
    """3-D convolution in ``x``'s dtype (the layer API's
    ``lax.conv_general_dilated`` over NDHWC / DHWIO, no compute-dtype
    cast). x: [N, D, H, W, Cin]; w: [kD, kH, kW, Cin, Cout]; padding:
    (lo, hi) per spatial axis, applied with ``F.pad`` where asymmetric."""
    s = (stride,) * 3 if isinstance(stride, int) else tuple(stride)
    pads = [tuple(p) for p in padding]
    xc = x.permute(0, 4, 1, 2, 3)
    if all(lo == hi for lo, hi in pads):
        sym = tuple(lo for lo, _ in pads)
    else:
        xc = F.pad(xc, tuple(v for lo_hi in reversed(pads) for v in lo_hi))
        sym = (0, 0, 0)
    y = F.conv3d(xc, w.permute(4, 3, 0, 1, 2), stride=s, padding=sym)
    return y.permute(0, 2, 3, 4, 1)


def conv3d_transpose(x: torch.Tensor, w: torch.Tensor, *, stride=1,
                     padding="SAME") -> torch.Tensor:
    """3-D ``lax.conv_transpose`` (``transpose_kernel=False``) in ``x``'s
    dtype, NDHWC / DHWIO: :func:`conv2d_transpose`'s construction with a
    third axis. "SAME" pads are XLA's, asymmetric when the stride exceeds
    k - 1 (stride 2 and k = 2: (1, 1) of the dilated input, the output
    dims ``in * stride``)."""
    s = (stride,) * 3 if isinstance(stride, int) else tuple(stride)
    k = w.shape[:3]
    if isinstance(padding, str):
        pads = [_transpose_pads(k[i], s[i], padding) for i in range(3)]
    else:
        pads = [tuple(p) for p in padding]
    wt = torch.flip(w, dims=(0, 1, 2)).permute(3, 4, 0, 1, 2)
    y = F.conv_transpose3d(x.permute(0, 4, 1, 2, 3), wt, stride=s)
    adj = []
    for i in (2, 1, 0):
        adj += [pads[i][0] - (k[i] - 1), pads[i][1] - (k[i] - 1)]
    if any(adj):
        y = F.pad(y, tuple(adj))
    return y.permute(0, 2, 3, 4, 1)


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """[N, H, W, C] -> [N, H/b, W/b, C*b*b], channels merged in (dy, dx,
    c) order (the MLPerf ResNet stem layout)."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // block, block, w // block, block, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(
        n, h // block, w // block, block * block * c)


def space_to_depth_conv_transform(w: torch.Tensor, block: int = 2):
    """Transform [kH, kW, Cin, Cout] weights of a stride-``block`` conv
    with padding k//2 into the equivalent stride-1 kernel over
    space-to-depth input. Returns ``(weights, padding)``.

    Original tap r reads offset e = r − k//2 from the strided output
    origin; writing e = block·j + d places w[r] in s2d kernel cell
    a = j − jmin, channel slot d, with companion padding (left −jmin,
    right jmax)."""
    kh, kw, cin, cout = w.shape

    def axis_map(k):
        e = np.arange(k) - k // 2
        j = np.floor_divide(e, block)
        return (j - j.min(), e - j * block,
                int(-j.min()), int(j.max()), int(j.max() - j.min() + 1))

    a_h, d_h, pl_h, pr_h, ah = axis_map(kh)
    a_w, d_w, pl_w, pr_w, aw = axis_map(kw)
    ws = torch.zeros((ah, aw, block, block, cin, cout), dtype=w.dtype,
                     device=w.device)
    idx = [torch.from_numpy(v).to(w.device)
           for v in (a_h[:, None], a_w[None, :], d_h[:, None], d_w[None, :])]
    # one scatter over all kh*kw taps (tap cells are disjoint)
    ws = ws.index_put(tuple(idx), w)
    ws = ws.reshape(ah, aw, block * block * cin, cout)
    return ws, ((pl_h, pr_h), (pl_w, pr_w))
