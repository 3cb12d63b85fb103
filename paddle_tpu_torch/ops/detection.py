"""Detection ops: box IoU, SSD prior boxes, box codec, NMS, ROI pooling
(counterpart of ``paddle_tpu/ops/detection.py``).

Boxes are (xmin, ymin, xmax, ymax), normalized to [0, 1], in fixed-width
tensors; NMS is a fixed loop of ``max_out`` suppression steps that keeps
its state on the device (no host read inside the loop).
"""

import math
from typing import Sequence

import torch

from paddle_tpu_torch.core import place


def iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of every pair: a [N, 4] x b [M, 4] -> [N, M]."""
    ax1, ay1, ax2, ay2 = (a[:, i:i + 1] for i in range(4))     # [N, 1]
    bx1, by1, bx2, by2 = (b[None, :, i] for i in range(4))     # [1, M]
    ix1 = torch.maximum(ax1, bx1)
    iy1 = torch.maximum(ay1, by1)
    ix2 = torch.minimum(ax2, bx2)
    iy2 = torch.minimum(ay2, by2)
    inter = torch.clamp_min(ix2 - ix1, 0) * torch.clamp_min(iy2 - iy1, 0)
    area_a = torch.clamp_min(ax2 - ax1, 0) * torch.clamp_min(ay2 - ay1, 0)
    area_b = torch.clamp_min(bx2 - bx1, 0) * torch.clamp_min(by2 - by1, 0)
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / union, 0.0)


def prior_boxes(feat_h: int, feat_w: int, img_h: int, img_w: int,
                min_size: float, max_size: float = None,
                aspect_ratios: Sequence[float] = (2.0,),
                flip: bool = True, clip: bool = True, device=None
                ) -> torch.Tensor:
    """SSD prior boxes for one feature map -> [feat_h*feat_w*P, 4] fp32 on
    ``device`` (default: the card): per cell centre one square min box,
    an optional sqrt(min*max) box, then the aspect-ratio boxes."""
    device = place.resolve_device(device)
    ratios = [1.0]
    for ar in aspect_ratios:
        ratios.append(ar)
        if flip:
            ratios.append(1.0 / ar)
    whs = [(min_size, min_size)]
    if max_size:
        s = math.sqrt(min_size * max_size)
        whs.append((s, s))
    for r in ratios[1:]:
        whs.append((min_size * math.sqrt(r), min_size / math.sqrt(r)))

    f32 = torch.float32
    cx = (torch.arange(feat_w, dtype=f32, device=device) + 0.5) / feat_w
    cy = (torch.arange(feat_h, dtype=f32, device=device) + 0.5) / feat_h
    cyx = torch.stack(torch.meshgrid(cy, cx, indexing="ij"), -1)   # [H,W,2]
    boxes = []
    for w, h in whs:
        wn, hn = w / img_w, h / img_h
        boxes.append(torch.cat([
            cyx[..., 1:2] - wn / 2, cyx[..., 0:1] - hn / 2,
            cyx[..., 1:2] + wn / 2, cyx[..., 0:1] + hn / 2], -1))
    out = torch.stack(boxes, 2).reshape(-1, 4)                   # [H*W*P, 4]
    return torch.clamp(out, 0.0, 1.0) if clip else out


def _centres(boxes):
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return w, h, (boxes[..., 0] + boxes[..., 2]) / 2, \
        (boxes[..., 1] + boxes[..., 3]) / 2


def encode_boxes(gt: torch.Tensor, priors: torch.Tensor,
                 variances=(0.1, 0.1, 0.2, 0.2)) -> torch.Tensor:
    """SSD box targets: centre/size offsets scaled by variances."""
    pw, ph, pcx, pcy = _centres(priors)
    gw = torch.clamp_min(gt[..., 2] - gt[..., 0], 1e-8)
    gh = torch.clamp_min(gt[..., 3] - gt[..., 1], 1e-8)
    gcx = (gt[..., 0] + gt[..., 2]) / 2
    gcy = (gt[..., 1] + gt[..., 3]) / 2
    v = variances
    return torch.stack([
        (gcx - pcx) / pw / v[0], (gcy - pcy) / ph / v[1],
        torch.log(gw / pw) / v[2], torch.log(gh / ph) / v[3]], -1)


def decode_boxes(loc: torch.Tensor, priors: torch.Tensor,
                 variances=(0.1, 0.1, 0.2, 0.2)) -> torch.Tensor:
    """Inverse of encode_boxes."""
    pw, ph, pcx, pcy = _centres(priors)
    v = variances
    cx = loc[..., 0] * v[0] * pw + pcx
    cy = loc[..., 1] * v[1] * ph + pcy
    w = torch.exp(loc[..., 2] * v[2]) * pw
    h = torch.exp(loc[..., 3] * v[3]) * ph
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def match_priors(priors: torch.Tensor, gt_boxes: torch.Tensor,
                 gt_valid: torch.Tensor, overlap_threshold: float = 0.5):
    """SSD bipartite + per-prediction matching: every gt claims its best
    prior; the other priors match their best gt if IoU >= threshold.

    priors [P, 4], gt_boxes [G, 4], gt_valid [G] bool ->
    (match_idx [P] int32 — gt index or -1, match_iou [P]). Ties go to
    the lower index."""
    iou = iou_matrix(priors, gt_boxes)                      # [P, G]
    iou = torch.where(gt_valid[None, :], iou, -1.0)
    best_gt = iou.argmax(dim=1).to(torch.int32)             # per prior
    best_gt_iou = iou.amax(dim=1)
    match = torch.where(best_gt_iou >= overlap_threshold, best_gt, -1)
    # bipartite pass: each gt's best prior is forced to that gt
    best_prior = iou.argmax(dim=0)                           # [G]
    prior_ids = torch.arange(priors.shape[0], device=priors.device)
    for_gt = ((prior_ids[:, None] == best_prior[None, :]) & gt_valid[None, :]
              & (iou.amax(dim=0) > 0)[None, :])
    forced = for_gt.to(torch.int8).argmax(dim=1)
    has_forced = for_gt.any(dim=1)
    match = torch.where(has_forced, forced.to(torch.int32), match)
    match_iou = torch.where(has_forced, iou.gather(1, forced[:, None])[:, 0],
                            best_gt_iou)
    return match, match_iou


def nms(boxes: torch.Tensor, scores: torch.Tensor, max_out: int,
        iou_threshold: float = 0.45, score_threshold: float = 0.01):
    """Greedy NMS with static shapes: boxes [N, 4], scores [N] ->
    (sel_idx [max_out] int32 (-1 pad), sel_scores [max_out] fp32). Each of
    the ``max_out`` steps takes the best remaining score (ties to the
    lower index) and suppresses its overlaps; the state stays on the
    device, so the loop never waits for it."""
    N = boxes.shape[0]
    dev = boxes.device
    iou = iou_matrix(boxes, boxes)                          # [N, N]
    alive = scores >= score_threshold
    ids = torch.arange(N, device=dev)
    neg_inf = torch.tensor(float("-inf"), dtype=scores.dtype, device=dev)
    sel = torch.full((max_out,), -1, dtype=torch.int32, device=dev)
    sel_sc = torch.zeros((max_out,), dtype=torch.float32, device=dev)
    for i in range(max_out):
        masked = torch.where(alive, scores, neg_inf)
        best = masked.argmax().reshape(1)
        ok = masked.gather(0, best) > neg_inf
        sel[i:i + 1] = torch.where(ok, best.to(torch.int32), -1)
        sel_sc[i:i + 1] = torch.where(ok, scores.gather(0, best).float(), 0.0)
        suppress = ((iou.index_select(0, best)[0] >= iou_threshold)
                    | (ids == best))
        alive = alive & (~suppress | ~ok)
    return sel, sel_sc


def roi_pool(feat: torch.Tensor, rois: torch.Tensor, out_h: int, out_w: int,
             spatial_scale: float = 1.0) -> torch.Tensor:
    """Max-pool each ROI to a fixed grid. feat [H, W, C] (one image), rois
    [R, 4] in feature coords after spatial_scale -> [R, out_h, out_w, C];
    an empty cell gives 0.

    A cell's rows and columns are [floor(c0), ceil(c1)) ranges, so its
    max is separable: for each of the ``out_h`` row bands, the max over
    the band's rows ([R, W, C] from a masked [R, H, W, C]), then per
    column band the max over its columns. The reference's dense
    [R, out_h, out_w, H, W, C] mask is never built."""
    H, W, C = feat.shape
    dev = feat.device
    x1 = rois[:, 0] * spatial_scale
    y1 = rois[:, 1] * spatial_scale
    x2 = rois[:, 2] * spatial_scale
    y2 = rois[:, 3] * spatial_scale
    rw = torch.clamp_min(x2 - x1, 1e-6)
    rh = torch.clamp_min(y2 - y1, 1e-6)

    ys = torch.arange(H, dtype=torch.float32, device=dev)
    xs = torch.arange(W, dtype=torch.float32, device=dev)
    ih = torch.arange(out_h, device=dev)
    iw = torch.arange(out_w, device=dev)
    cy0 = y1[:, None] + (ih / out_h)[None, :] * rh[:, None]
    cy1 = y1[:, None] + ((ih + 1) / out_h)[None, :] * rh[:, None]
    cx0 = x1[:, None] + (iw / out_w)[None, :] * rw[:, None]
    cx1 = x1[:, None] + ((iw + 1) / out_w)[None, :] * rw[:, None]
    # membership: [R, out_h, H], [R, out_w, W] — floor/ceil like the ref
    in_y = ((ys[None, None, :] >= torch.floor(cy0[..., None]))
            & (ys[None, None, :] < torch.ceil(cy1[..., None])))
    in_x = ((xs[None, None, :] >= torch.floor(cx0[..., None]))
            & (xs[None, None, :] < torch.ceil(cx1[..., None])))
    neg_inf = torch.tensor(float("-inf"), dtype=feat.dtype, device=dev)
    rows = []
    for i in range(out_h):
        band = torch.where(in_y[:, i, :, None, None], feat[None],
                           neg_inf).amax(dim=1)             # [R, W, C]
        rows.append(torch.stack([
            torch.where(in_x[:, j, :, None], band, neg_inf).amax(dim=1)
            for j in range(out_w)], dim=1))                 # [R, out_w, C]
    out = torch.stack(rows, dim=1)                          # [R, oh, ow, C]
    return torch.where(torch.isfinite(out), out, 0.0)
