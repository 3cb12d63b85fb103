"""Pooling, NHWC (counterpart of ``paddle_tpu/ops/pool.py``).

Pads are XLA's (``"SAME"`` puts the extra row or column at the
bottom/right, which ``F.max_pool2d`` / ``F.avg_pool2d`` cannot express:
they pad symmetrically and by at most k/2), so the input is padded with
``F.pad`` (-inf for max pooling) and pooled without padding on a
channels_last NCHW view.
"""

from typing import Tuple, Union

import torch
import torch.nn.functional as F

from paddle_tpu_torch.ops.conv import _pair, resolve_pads

IntOr2 = Union[int, Tuple[int, int]]


def _padded(x, padding, k, s, value):
    """x as a channels_last NCHW view, padded per ``resolve_pads``."""
    (h0, h1), (w0, w1) = resolve_pads(x.shape[1:3], padding, k, s)
    xc = x.permute(0, 3, 1, 2)
    if h0 or h1 or w0 or w1:
        xc = F.pad(xc, (w0, w1, h0, h1), value=value)
    return xc


def max_pool2d(x: torch.Tensor, ksize: IntOr2, *, stride: IntOr2 = None,
               padding="VALID") -> torch.Tensor:
    k, s = _pair(ksize), _pair(stride if stride is not None else ksize)
    fill = (float("-inf") if x.is_floating_point()
            else torch.iinfo(x.dtype).min)
    y = F.max_pool2d(_padded(x, padding, k, s, fill), k, s)
    return y.permute(0, 2, 3, 1)


def _window_sum(xc, k, s):
    return F.avg_pool2d(xc, k, s, divisor_override=1)


def avg_pool2d(x: torch.Tensor, ksize: IntOr2, *, stride: IntOr2 = None,
               padding="VALID", count_include_pad=False) -> torch.Tensor:
    """Average pooling; excludes padding from the divisor by default: each
    window's sum over the count of real elements in it (ones pooled the
    same way), accumulated in fp32 for bf16 inputs."""
    k, s = _pair(ksize), _pair(stride if stride is not None else ksize)
    xf = x.float() if x.dtype == torch.bfloat16 else x
    summed = _window_sum(_padded(xf, padding, k, s, 0.0), k, s)
    if count_include_pad:
        out = summed / (k[0] * k[1])
    else:
        ones = torch.ones(x.shape[:3] + (1,), dtype=summed.dtype,
                          device=x.device)
        out = summed / _window_sum(_padded(ones, padding, k, s, 0.0), k, s)
    return out.permute(0, 2, 3, 1).to(x.dtype)


def _padded3d(x, padding, value):
    """NDHWC ``x`` as an NCDHW view padded by (lo, hi) per spatial axis."""
    xc = x.permute(0, 4, 1, 2, 3)
    flat = tuple(v for lo_hi in reversed(padding) for v in lo_hi)
    return F.pad(xc, flat, value=value) if any(flat) else xc


def max_pool3d(x: torch.Tensor, ksize, *, stride=None,
               padding=((0, 0), (0, 0), (0, 0))) -> torch.Tensor:
    """3-D max pooling, NDHWC, over -inf padding (``lax.reduce_window``
    with ``lax.max``)."""
    y = F.max_pool3d(_padded3d(x, padding, float("-inf")), tuple(ksize),
                     tuple(stride or ksize))
    return y.permute(0, 2, 3, 4, 1)


def avg_pool3d(x: torch.Tensor, ksize, *, stride=None,
               padding=((0, 0), (0, 0), (0, 0))) -> torch.Tensor:
    """3-D average pooling, NDHWC: the window sum over zero padding
    divided by the whole window volume (a ``lax.reduce_window`` sum over
    the product of the window sizes)."""
    k = tuple(ksize)
    y = F.avg_pool3d(_padded3d(x, padding, 0.0), k, tuple(stride or k),
                     divisor_override=1)
    return (y / float(k[0] * k[1] * k[2])).permute(0, 2, 3, 4, 1)


def global_avg_pool2d(x: torch.Tensor) -> torch.Tensor:
    """[N,H,W,C] -> [N,C]; fp32 accumulation."""
    return x.mean(dim=(1, 2), dtype=torch.float32).to(x.dtype)


def global_max_pool2d(x: torch.Tensor) -> torch.Tensor:
    return x.amax(dim=(1, 2))


def spp(x: torch.Tensor, pyramid_height: int, pool_type="max"
        ) -> torch.Tensor:
    """Spatial pyramid pooling: concat of pooled [1x1, 2x2, ...
    2^(h-1) bins] flattened per image; each level pads bottom/right up
    to bins*ceil(dim/bins), so its window grid is exactly bins x bins.

    Where that padding is a whole window or more (width 9 at 4 bins:
    windows of 3, padded to 12), the last cells hold padding only; the
    JAX package returns -inf (max) or NaN (avg, 0/0) there, the port 0
    (ROADMAP C8). Every other cell is the reference's."""
    n, h, w, c = x.shape
    fn = max_pool2d if pool_type == "max" else avg_pool2d
    outs = []
    for lvl in range(pyramid_height):
        bins = 2 ** lvl
        kh, kw = -(-h // bins), -(-w // bins)
        ph, pw = kh * bins - h, kw * bins - w
        pooled = fn(x, (kh, kw), stride=(kh, kw),
                    padding=((0, ph), (0, pw)))
        if ph >= kh or pw >= kw:
            cells = torch.arange(bins, device=x.device)
            real = ((cells * kh < h)[:, None, None]
                    & (cells * kw < w)[None, :, None])
            pooled = torch.where(real, pooled, 0.0)
        outs.append(pooled.reshape(n, -1))
    return torch.cat(outs, dim=1)
