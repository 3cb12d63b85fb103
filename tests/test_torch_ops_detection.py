"""The port's detection ops against ``paddle_tpu``'s on the CPU.

``iou_matrix``, ``prior_boxes`` (with and without a max size, flip and
clip), the box codec and its round trip, ``match_priors`` (bipartite and
threshold matches, invalid ground truth), ``nms`` (suppression,
the score threshold, fewer survivors than ``max_out``, tied scores) and
``roi_pool`` (forward and gradient, ROIs with empty cells, which pool to
0 as in the reference), on seeded boxes. The JAX package has no
separate detection op test; ``tests/test_detection_evaluators.py`` runs
these ops under its evaluators.

Tolerances: fp32 forward 1e-5 (of max(1, max|JAX value|)), gradients
1e-4; ``match_priors`` and ``nms`` indices exactly.
"""

import numpy as np
import pytest
import torch

from paddle_tpu.ops import detection as jdet
from paddle_tpu_torch.ops import detection as tdet
from tests.torch_ops_util import parity, to_j, to_t

torch.set_num_threads(1)


def _boxes(rng, n, lo=0.0, hi=1.0, min_wh=0.02):
    xy = rng.uniform(lo, hi - 0.1, (n, 2))
    wh = rng.uniform(min_wh, 0.4, (n, 2))
    return np.concatenate([xy, np.minimum(xy + wh, hi)], -1).astype(
        np.float32)


def test_iou_matrix(rng):
    a, b = _boxes(rng, 7), _boxes(rng, 5)
    b[0] = b[0, [2, 3, 0, 1]]          # a degenerate (inverted) box
    parity(jdet.iou_matrix, tdet.iou_matrix, [a, b], wrt=(0, 1))


@pytest.mark.parametrize("kw", [
    dict(min_size=30.0, max_size=60.0, aspect_ratios=(2.0, 3.0)),
    dict(min_size=30.0, aspect_ratios=(2.0,), flip=False),
    dict(min_size=120.0, max_size=200.0, clip=False),
])
def test_prior_boxes(kw):
    j = jdet.prior_boxes(5, 4, 300, 300, **kw)
    t = tdet.prior_boxes(5, 4, 300, 300, device="cpu", **kw)
    assert t.dtype == torch.float32 and t.device.type == "cpu"
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-6)


def test_box_codec_round_trip(rng):
    priors = tdet.prior_boxes(3, 3, 300, 300, 60.0, 90.0, device="cpu")
    gt = _boxes(rng, priors.shape[0])
    pn = priors.numpy()
    t, _ = parity(jdet.encode_boxes, tdet.encode_boxes, [gt, pn],
                  wrt=(0, 1))
    d, _ = parity(jdet.decode_boxes, tdet.decode_boxes,
                  [t.detach().numpy(), pn], wrt=(0, 1))
    np.testing.assert_allclose(d.detach().numpy(), gt, atol=1e-5)


def test_match_priors(rng):
    priors = tdet.prior_boxes(6, 6, 300, 300, 45.0, 90.0,
                              device="cpu").numpy()
    gt = _boxes(rng, 5)
    gt[3] = gt[1]                       # two gt boxes claim the same prior
    valid = np.array([True, True, False, True, True])
    for thr in (0.5, 0.2):
        t, _ = parity(lambda p, g: jdet.match_priors(p, g, to_j(valid), thr),
                      lambda p, g: tdet.match_priors(p, g, to_t(valid), thr),
                      [priors, gt])
        m = t[0].numpy()
        assert t[0].dtype == torch.int32 and not (m == 2).any()
        assert (m >= 0).any()


@pytest.mark.parametrize("max_out", [6, 40])
def test_nms(rng, max_out):
    """Clustered boxes so suppression matters; ``max_out`` 40 exceeds the
    survivors (the tail is -1 / 0)."""
    centres = _boxes(rng, 4)
    boxes = np.concatenate([c + rng.uniform(-0.02, 0.02, (6, 4))
                            for c in centres]).astype(np.float32)
    scores = rng.rand(24).astype(np.float32)
    scores[5] = 0.005                                # under the threshold
    scores[7] = scores[8]                            # a tie: lower index
    t, _ = parity(lambda b, s: jdet.nms(b, s, max_out),
                  lambda b, s: tdet.nms(b, s, max_out), [boxes, scores])
    sel = t[0].numpy()
    assert t[0].dtype == torch.int32 and 5 not in sel
    if max_out == 40:
        assert (sel == -1).any()


def test_nms_all_suppressed():
    boxes = np.tile(np.array([[0.1, 0.1, 0.5, 0.5]], np.float32), (5, 1))
    scores = np.array([0.3, 0.9, 0.9, 0.1, 0.2], np.float32)
    t, _ = parity(lambda b, s: jdet.nms(b, s, 3),
                  lambda b, s: tdet.nms(b, s, 3), [boxes, scores])
    assert t[0].numpy().tolist() == [1, -1, -1]


def test_roi_pool(rng):
    feat = rng.randn(12, 10, 3).astype(np.float32)
    rois = np.array([[0.0, 0.0, 9.0, 11.0],      # whole map
                     [2.5, 1.2, 6.1, 4.9],
                     [3.0, 3.0, 4.0, 4.0],        # smaller than the grid
                     [4.0, 2.0, 4.0, 9.0]],       # zero width
                    np.float32)
    t, j = parity(lambda f, r: jdet.roi_pool(f, r, 3, 4),
                  lambda f, r: tdet.roi_pool(f, r, 3, 4), [feat, rois],
                  wrt=(0,))
    assert tuple(t.shape) == (4, 3, 4, 3)


def test_roi_pool_empty_cells_give_zero(rng):
    """A ROI past the map's edge has cells that cover no position; they
    pool to 0 in both packages (the gradient skips them)."""
    feat = rng.randn(6, 6, 2).astype(np.float32)
    rois = np.array([[4.0, 4.0, 12.0, 12.0], [0.5, 0.5, 2.0, 2.0]],
                    np.float32)
    t, _ = parity(lambda f: jdet.roi_pool(f, to_j(rois), 4, 4, 1.0),
                  lambda f: tdet.roi_pool(f, to_t(rois), 4, 4, 1.0), [feat],
                  wrt=(0,))
    out = t.detach().numpy()
    assert (out[0, 2:, 2:] == 0).all() and (out[0, 0, 0] != 0).all()


def test_roi_pool_spatial_scale(rng):
    feat = rng.randn(8, 8, 4).astype(np.float32)
    rois = _boxes(rng, 5, hi=1.0) * np.float32(64.0)
    parity(lambda f, r: jdet.roi_pool(f, r, 2, 2, 0.125),
           lambda f, r: tdet.roi_pool(f, r, 2, 2, 0.125), [feat, rois],
           wrt=(0,))
