"""The port's detection suite and evaluators against ``paddle_tpu``'s on
the CPU.

Every case of ``tests/test_detection_evaluators.py``: the detection ops
(IoU, the box codec, prior boxes, NMS, prior matching, ROI pooling; each
equal to the JAX op), the detection layers (``multibox_loss`` trained a
few steps by the port, its first loss and gradients JAX's;
``detection_output`` rows equal to JAX's), the chunk evaluator in its
schemes, the CTC edit-distance evaluator and detection mAP, plus
``classification_error`` (top-1 and top-k, sequence), ``precision_recall``,
``auc``, ``sum_cost``, ``roi_pool`` as a layer, and ``EvaluatorSet``
accumulating batches. Evaluator counts and accumulables are exactly
JAX's: chunk counts, edit distances, true-positive flags and histogram
bins are integers.

Tolerances: fp32 forward 1e-5, gradients 1e-4 (of max(1, max|JAX
value|)); counts exact.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu.ops import detection as jdet
from paddle_tpu_torch.ops import detection as tdet
from tests.torch_layers_util import Net, both_values
from tests.torch_ops_util import parity

torch.set_num_threads(1)


def _boxes(rng, n):
    return np.sort(rng.rand(n, 2, 2), axis=1).reshape(n, 4)[
        :, [0, 2, 1, 3]].astype(np.float32)


class TestDetectionOps:
    def test_iou_matrix(self, rng):
        parity(jdet.iou_matrix, tdet.iou_matrix,
               [_boxes(rng, 5), _boxes(rng, 4)])

    def test_encode_decode_roundtrip(self, rng):
        priors = np.array([[0.1, 0.1, 0.5, 0.5], [0.4, 0.4, 0.9, 0.8]],
                          np.float32)
        gt = np.array([[0.15, 0.2, 0.45, 0.55], [0.35, 0.42, 0.8, 0.85]],
                      np.float32)
        tout, _ = parity(lambda g, p: jdet.decode_boxes(
                             jdet.encode_boxes(g, p), p),
                         lambda g, p: tdet.decode_boxes(
                             tdet.encode_boxes(g, p), p), [gt, priors])
        np.testing.assert_allclose(tout.numpy(), gt, rtol=1e-4, atol=1e-5)

    def test_prior_boxes_properties(self):
        tb = tdet.prior_boxes(2, 3, 100, 100, min_size=30, max_size=60,
                              aspect_ratios=(2.0,), device="cpu")
        jb = jdet.prior_boxes(2, 3, 100, 100, min_size=30, max_size=60,
                              aspect_ratios=(2.0,))
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-7)
        assert tuple(tb.shape) == (24, 4)

    def test_nms_suppresses_overlaps(self):
        boxes = np.array([[0.1, 0.1, 0.4, 0.4], [0.12, 0.12, 0.42, 0.42],
                          [0.6, 0.6, 0.9, 0.9], [0.61, 0.61, 0.91, 0.91]],
                         np.float32)
        scores = np.array([0.9, 0.8, 0.95, 0.5], np.float32)
        (sel, sc), _ = parity(
            lambda b, s: jdet.nms(b, s, max_out=4, iou_threshold=0.5),
            lambda b, s: tdet.nms(b, s, max_out=4, iou_threshold=0.5),
            [boxes, scores])
        assert [int(i) for i in sel if i >= 0] == [2, 0]

    def test_match_priors_forces_best(self):
        priors = np.array([[0.0, 0.0, 0.3, 0.3], [0.5, 0.5, 0.9, 0.9],
                           [0.05, 0.05, 0.35, 0.35]], np.float32)
        gt = np.array([[0.0, 0.0, 0.31, 0.31]], np.float32)
        (match, miou), _ = parity(
            lambda p, g, v: jdet.match_priors(p, g, v, 0.5),
            lambda p, g, v: tdet.match_priors(p, g, v, 0.5),
            [priors, gt, np.array([True])])
        assert match[0] == 0 and match[1] == -1 and float(miou[0]) > 0.8

    def test_roi_pool(self, rng):
        feat = rng.randn(6, 6, 2).astype(np.float32)
        rois = np.array([[0, 0, 3, 3], [2, 2, 6, 6]], np.float32)
        out, _ = parity(lambda f, r: jdet.roi_pool(f, r, 2, 2),
                        lambda f, r: tdet.roi_pool(f, r, 2, 2), [feat, rois])
        np.testing.assert_allclose(out[0, 0, 0].numpy(),
                                   feat[0:2, 0:2].max((0, 1)), rtol=1e-6)


def _det_heads(P, C, with_gt):
    L = P.layer
    img = L.data("img", P.data_type.dense_vector(2 * 4 * 4))
    img._out_channels = 2
    img._img_shape = (4, 4)
    pb = L.priorbox(img, image_size=100, min_size=30, aspect_ratio=(),
                    name="pb")
    loc = L.fc(img, pb.num_priors * 4, act="linear", name="loc")
    conf = L.fc(img, pb.num_priors * C, act="linear", name="conf")
    if with_gt:
        gt = L.data("gt", P.data_type.dense_vector(5))
        return L.multibox_loss(loc, conf, pb, gt, num_classes=C, name="mbl")
    return L.detection_output(loc, conf, pb, num_classes=C, keep_top_k=10,
                              name="det")


class TestDetectionLayers:
    def test_multibox_loss_trains(self, rng):
        B, G = 4, 2
        gtb = np.zeros((B, G, 5), np.float32)
        gtb[:, 0] = [1, 0.1, 0.1, 0.45, 0.45]
        gtb[:, 1] = [2, 0.55, 0.55, 0.95, 0.95]
        net = Net(lambda P: _det_heads(P, 3, True), seed=0)
        feeds = both_values({"img": rng.randn(B, 32).astype(np.float32),
                             "gt": (gtb, np.full(B, G, np.int32))})
        net.check(*feeds, grad=True)
        vals = {k: v.clone() for k, v in net.tparams.values.items()}
        hist = []
        for _ in range(40):
            leaves = {k: v.requires_grad_() for k, v in vals.items()}
            o, _ = net.tfwd(leaves, {}, feeds[1])
            loss = o["mbl"].array.mean()
            grads = torch.autograd.grad(loss, list(leaves.values()))
            vals = {k: (v - 0.01 * g).detach()
                    for (k, v), g in zip(leaves.items(), grads)}
            hist.append(loss.item())
        assert np.isfinite(hist).all()
        assert hist[-1] < hist[0] * 0.8, (hist[0], hist[-1])

    def test_detection_output_shape_and_order(self, rng):
        net = Net(lambda P: _det_heads(P, 3, False), seed=0)
        j, t = net.check(*both_values(
            {"img": rng.randn(2, 32).astype(np.float32)}))
        d = t[0]["det"].array.numpy()
        assert d.shape == (2, 10, 6)
        valid = d[0][d[0][:, 0] >= 0]
        assert np.all(np.diff(valid[:, 1]) <= 1e-6)

    def test_roi_pool_layer(self, rng):
        def b(P):
            img = P.layer.data("x", P.data_type.dense_vector(2 * 6 * 6))
            img._out_channels = 2
            rois = P.layer.data("r", P.data_type.dense_vector(4))
            return P.layer.roi_pool(img, rois, pooled_width=2,
                                    pooled_height=2, name="rp")
        rois = np.array([[[0, 0, 3, 3], [2, 2, 6, 6], [0, 0, 0, 0]],
                         [[1, 1, 5, 4], [0, 0, 0, 0], [0, 0, 0, 0]]],
                        np.float32)
        Net(b).check(*both_values({
            "x": rng.randn(2, 72).astype(np.float32),
            "r": (rois, np.array([2, 1], np.int32))}), grad=True)


class TestChunkEvaluator:
    def _run(self, pred_tags, lab_tags, lens, num_types=2, scheme="IOB"):
        def b(P):
            dt = P.data_type
            return P.evaluator.chunk(
                P.layer.data("p", dt.integer_value_sequence(10)),
                P.layer.data("l", dt.integer_value_sequence(10)),
                num_chunk_types=num_types, chunk_scheme=scheme, name="ch")
        net = Net(b)
        j, t = net.check(*both_values({"p": (pred_tags, lens),
                                       "l": (lab_tags, lens)}), atol=0.0)
        acc = T.evaluator.MetricAccumulator("ch", net.tout.metric_finalize,
                                            3)
        acc.add(t[0]["ch"].array)
        return t[0]["ch"].array.tolist(), acc.value()

    def test_iob_exact(self):
        vec, m = self._run(np.array([[0, 1, 4, 2, 1, 4]], np.int32),
                           np.array([[0, 1, 4, 2, 3, 4]], np.int32),
                           np.array([6], np.int32))
        assert vec == [1.0, 3.0, 2.0]
        assert abs(m["recall"] - 0.5) < 1e-9

    def test_iob_perfect(self):
        lab = np.array([[0, 1, 1, 4, 2, 4], [4, 0, 4, 4, 4, 4]], np.int32)
        vec, m = self._run(lab, lab, np.array([6, 3], np.int32))
        assert m["f1"] == pytest.approx(1.0)
        assert vec == [3.0, 3.0, 3.0]

    def test_iobes_chunk_to_sequence_end(self):
        lab = np.array([[0, 1]], np.int32)
        vec, m = self._run(lab, lab, np.array([2], np.int32), num_types=1,
                           scheme="IOBES")
        assert vec == [1.0, 1.0, 1.0]
        assert m["f1"] == pytest.approx(1.0)

    def test_iobes_singles_and_pairs(self):
        lab = np.array([[3, 0, 2, 4]], np.int32)
        vec, m = self._run(lab, lab, np.array([4], np.int32), num_types=1,
                           scheme="IOBES")
        assert vec == [2.0, 2.0, 2.0]

    def test_padding_ignored(self):
        lab = np.array([[0, 1, 0, 0, 0, 0]], np.int32)
        vec, _ = self._run(lab, lab, np.array([2], np.int32))
        assert vec == [1.0, 1.0, 1.0]

    @pytest.mark.parametrize("scheme,types", [("IOB", 3), ("IOE", 3),
                                              ("IOBES", 2), ("plain", 5)])
    def test_random_tags_all_schemes(self, rng, scheme, types):
        ntag = {"IOB": 2, "IOE": 2, "IOBES": 4, "plain": 1}[scheme] * types
        pred = rng.randint(0, ntag + 1, (4, 12)).astype(np.int32)
        lab = rng.randint(0, ntag + 1, (4, 12)).astype(np.int32)
        lab[:2] = pred[:2]
        self._run(pred, lab, np.array([12, 7, 10, 1], np.int32), types,
                  scheme)


class TestCTCErrorEvaluator:
    def _net(self, V):
        def b(P):
            dt = P.data_type
            return P.evaluator.ctc_error(
                P.layer.data("p", dt.dense_vector_sequence(V)),
                P.layer.data("l", dt.integer_value_sequence(V)), name="cer")
        return Net(b)

    def test_edit_distance(self):
        V, Tn, L = 4, 5, 4
        logits = np.full((1, Tn, V), -5.0, np.float32)
        for t, c in enumerate([1, 1, 3, 2, 2]):
            logits[0, t, c] = 5.0
        lab = np.zeros((1, L), np.int32)
        lab[0, :3] = [1, 0, 2]
        j, t = self._net(V).check(*both_values(
            {"p": (logits, [Tn]), "l": (lab, [3])}), atol=0.0)
        assert t[0]["cer"].array.tolist() == [1.0, 3.0]

    def test_random_batch(self, rng):
        V = 6
        j, t = self._net(V).check(*both_values({
            "p": (rng.randn(4, 9, V).astype(np.float32), [9, 4, 7, 1]),
            "l": (rng.randint(0, V - 1, (4, 6)).astype(np.int32),
                  [6, 2, 5, 0])}), atol=0.0)


class TestDetectionMAP:
    def _map(self, det, gt, glens, name):
        def b(P):
            dt = P.data_type
            return P.evaluator.detection_map(
                P.layer.data("d", dt.dense_vector(6)),
                P.layer.data("g", dt.dense_vector(5)), num_classes=3,
                name=name)
        net = Net(b)
        j, t = net.check(*both_values({"d": det, "g": (gt, glens)}),
                         atol=0.0)
        acc = T.evaluator.MetricAccumulator(name, net.tout.metric_finalize,
                                            net.tout.metric_width)
        acc.add(t[0][name].array)
        return acc.value()

    def test_perfect_detections_map_1(self):
        gt = np.array([[[1, 0.1, 0.1, 0.4, 0.4], [2, 0.5, 0.5, 0.9, 0.9]]],
                      np.float32)
        det = np.full((1, 4, 6), -1, np.float32)
        det[0, 0] = [1, 0.9, 0.1, 0.1, 0.4, 0.4]
        det[0, 1] = [2, 0.8, 0.5, 0.5, 0.9, 0.9]
        assert self._map(det, gt, [2], "map") == pytest.approx(1.0, abs=1e-6)

    def test_false_positives_lower_map(self):
        gt = np.array([[[1, 0.1, 0.1, 0.4, 0.4]]], np.float32)
        det = np.full((1, 4, 6), -1, np.float32)
        det[0, 0] = [1, 0.9, 0.6, 0.6, 0.9, 0.9]
        det[0, 1] = [1, 0.8, 0.1, 0.1, 0.4, 0.4]
        assert 0.0 < self._map(det, gt, [1], "map2") < 1.0


class TestClassificationEvaluators:
    def test_error_precision_recall_auc_sum(self, rng):
        def b(P):
            L, E, dt = P.layer, P.evaluator, P.data_type
            x = L.data("x", dt.dense_vector(5))
            y = L.data("y", dt.integer_value(4))
            y2 = L.data("y2", dt.integer_value(2))
            p = L.fc(x, 4, act="softmax", name="p")
            p2 = L.fc(x, 2, act="softmax", name="p2")
            return [E.classification_error(p, y, name="err"),
                    E.classification_error(p, y, top_k=2, name="err2"),
                    E.precision_recall(p2, y2, name="pr"),
                    E.auc(p2, y2, name="auc", num_thresholds=50),
                    E.sum_cost(L.fc(x, 1, name="s"), name="sc")]
        net = Net(b)
        feeds = both_values({"x": rng.randn(64, 5).astype(np.float32),
                             "y": rng.randint(0, 4, 64).astype(np.int32),
                             "y2": rng.randint(0, 2, 64).astype(np.int32)})
        j, t = net.check(*feeds)
        jset = J.evaluator.EvaluatorSet(net.jtopo.outputs)
        tset = T.evaluator.EvaluatorSet(net.ttopo.outputs)
        for _ in range(2):
            jset.add_batch(j[0])
            tset.add_batch(t[0])
        jr, tr = jset.result(), tset.result()
        for k in jr:
            assert tr[k] == pytest.approx(jr[k], abs=1e-6), k
        tset.reset()
        assert np.isnan(tset.result()["err"])

    def test_sequence_classification_error(self, rng):
        def b(P):
            dt = P.data_type
            return P.evaluator.classification_error(
                P.layer.data("p", dt.dense_vector_sequence(3)),
                P.layer.data("l", dt.integer_value_sequence(3)), name="se")
        j, t = Net(b).check(*both_values({
            "p": (rng.randn(3, 5, 3).astype(np.float32), [5, 2, 4]),
            "l": (rng.randint(0, 3, (3, 5)).astype(np.int32), [5, 2, 4])}),
            atol=0.0)
        assert t[0]["se"].array.tolist()[1] == 11.0
