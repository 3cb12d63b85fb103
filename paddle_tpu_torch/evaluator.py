"""Evaluators — training/test metrics (counterpart of
``paddle_tpu/evaluator.py``).

Reference: paddle/gserver/evaluators/Evaluator.h:42 hierarchy (classification
error, precision/recall, AUC, chunk-F1, CTC error, ...) wrapped by
python/paddle/v2/evaluator.py. An evaluator is a LayerOutput emitting a
small vector of *accumulables* per batch, on the batch's device, plus a
host-side finalize() that turns summed accumulables into the metric. The
JAX package's scans and vmaps (chunk runs, edit distances, greedy
detection matching) become loops over time, rows or detections here; the
integer results (counts, distances, true-positive flags) are exact.
"""

from typing import Optional

import numpy as np
import torch

from paddle_tpu_torch.topology import LayerOutput, Value, auto_name


class MetricAccumulator:
    """Host-side accumulator over batch accumulable vectors."""

    def __init__(self, name, finalize_fn, width):
        self.name = name
        self.finalize_fn = finalize_fn
        self.width = width
        self.total = None

    def reset(self):
        self.total = None

    def add(self, vec):
        if isinstance(vec, torch.Tensor):
            vec = vec.detach().cpu().numpy()
        vec = np.asarray(vec, np.float64)
        self.total = vec if self.total is None else self.total + vec

    def value(self):
        if self.total is None:
            return float("nan")
        return self.finalize_fn(self.total)


def _evaluator_layer(name, etype, inputs, accum_fn, finalize_fn, width):
    def fwd(params, parents, ctx):
        return Value(accum_fn(params, parents, ctx))
    lo = LayerOutput(name, etype, inputs, fwd, [], size=width)
    lo.metric_finalize = finalize_fn
    lo.metric_width = width
    return lo


def _f32(n, device):
    return torch.full((), float(n), dtype=torch.float32, device=device)


def classification_error(input, label, name: Optional[str] = None, top_k=1):
    """Error rate (reference: ClassificationErrorEvaluator, Evaluator.cpp).
    Accumulables: [#wrong, #examples]. Sequence inputs count per-token."""
    name = name or auto_name("classification_error_evaluator")

    def accum(params, parents, ctx):
        pv, lv = parents
        pred, lab = pv.array, lv.array
        if pv.is_sequence:
            mask = (torch.arange(pred.shape[1], device=pred.device)[None, :]
                    < pv.lengths[:, None]).float()
            lab2 = lab if lab.dim() == 2 else lab.reshape(lab.shape[0], -1)
            wrong = (torch.argmax(pred, -1) != lab2).float() * mask
            return torch.stack([wrong.sum(), mask.sum()])
        lab1 = lab.reshape(-1)
        if top_k == 1:
            wrong = (torch.argmax(pred, -1) != lab1).float()
        else:
            topi = torch.argsort(-pred, dim=-1, stable=True)[:, :top_k]
            wrong = 1.0 - torch.any(topi == lab1[:, None], dim=-1).float()
        return torch.stack([wrong.sum(), _f32(wrong.shape[0], pred.device)])

    return _evaluator_layer(name, "classification_error", [input, label],
                            accum, lambda t: t[0] / max(t[1], 1), 2)


def precision_recall(input, label, name: Optional[str] = None,
                     positive_label=1):
    """Binary precision/recall/F1 (reference: PrecisionRecallEvaluator).
    Accumulables: [tp, fp, fn]."""
    name = name or auto_name("precision_recall_evaluator")

    def accum(params, parents, ctx):
        pred = torch.argmax(parents[0].array, -1)
        lab = parents[1].array.reshape(-1)
        pos = pred == positive_label
        truth = lab == positive_label
        tp = torch.sum(pos & truth).float()
        fp = torch.sum(pos & ~truth).float()
        fn = torch.sum(~pos & truth).float()
        return torch.stack([tp, fp, fn])

    def fin(t):
        tp, fp, fn = t
        p = tp / max(tp + fp, 1e-12)
        r = tp / max(tp + fn, 1e-12)
        return {"precision": p, "recall": r,
                "f1": 2 * p * r / max(p + r, 1e-12)}

    return _evaluator_layer(name, "precision_recall", [input, label],
                            accum, fin, 3)


def auc(input, label, name: Optional[str] = None, num_thresholds=200):
    """Binned AUC (reference: AucEvaluator — bucketed ROC; operators/
    auc_op.cc). Accumulables: [pos_hist..., neg_hist...]."""
    name = name or auto_name("auc_evaluator")

    def accum(params, parents, ctx):
        probs = parents[0].array
        # positive-class probability: column 1 of softmax output, or the
        # single sigmoid output
        p = probs[:, 1] if probs.shape[-1] >= 2 else probs[:, 0]
        lab = parents[1].array.reshape(-1).float()
        bins = torch.clamp((p * num_thresholds).to(torch.int32), 0,
                           num_thresholds - 1).long()
        zeros = torch.zeros(num_thresholds, device=p.device)
        pos = zeros.index_add(0, bins, lab)
        neg = zeros.index_add(0, bins, 1.0 - lab)
        return torch.cat([pos, neg])

    def fin(t):
        pos, neg = t[:num_thresholds], t[num_thresholds:]
        # sweep thresholds high->low accumulating TPR/FPR, trapezoid rule
        tp = np.cumsum(pos[::-1])
        fp = np.cumsum(neg[::-1])
        tot_p, tot_n = max(tp[-1], 1e-12), max(fp[-1], 1e-12)
        tpr = np.concatenate([[0.0], tp / tot_p])
        fpr = np.concatenate([[0.0], fp / tot_n])
        return float(np.trapezoid(tpr, fpr))

    return _evaluator_layer(name, "auc", [input, label], accum, fin,
                            2 * num_thresholds)


def sum_cost(input, name: Optional[str] = None):
    """(reference: SumCostEvaluator) Accumulables: [sum, count]."""
    name = name or auto_name("sum_evaluator")

    def accum(params, parents, ctx):
        v = parents[0].array.float()
        return torch.stack([v.sum(), _f32(v.shape[0], v.device)])

    return _evaluator_layer(name, "sum_cost", [input], accum,
                            lambda t: t[0] / max(t[1], 1), 2)


def positive_negative_pair(input, label, query_id,
                           name: Optional[str] = None, weight=None):
    """Pos/neg pair ordering ratio for ranking (reference: PnpairEvaluator,
    Evaluator.cpp:932-960 — within each query, pairs with differing labels
    count pos if the higher-labelled sample scores strictly higher, neg if
    strictly lower, spe on score ties; pair weight = mean of sample
    weights). Accumulables: [pos, neg, spe]. Pairs are counted within each
    minibatch."""
    name = name or auto_name("pnpair_evaluator")
    inputs = [input, label, query_id] + ([weight] if weight else [])

    def accum(params, parents, ctx):
        score = parents[0].array.reshape(-1).float()
        lab = parents[1].array.reshape(-1).to(torch.int32)
        qid = parents[2].array.reshape(-1).to(torch.int32)
        w = (parents[3].array.reshape(-1).float()
             if len(parents) > 3 else torch.ones_like(score))
        n = score.shape[0]
        same_q = qid[:, None] == qid[None, :]
        diff_lab = lab[:, None] != lab[None, :]
        ar = torch.arange(n, device=score.device)
        upper = ar[:, None] < ar[None, :]
        pair_w = (w[:, None] + w[None, :]) * 0.5
        consider = same_q & diff_lab & upper
        gt = score[:, None] > score[None, :]
        lt = score[:, None] < score[None, :]
        lab_gt = lab[:, None] > lab[None, :]
        lab_lt = lab[:, None] < lab[None, :]
        correct = (gt & lab_gt) | (lt & lab_lt)
        wrong = (gt & lab_lt) | (lt & lab_gt)
        tie = ~(correct | wrong)
        pos = torch.sum(torch.where(consider & correct, pair_w, 0.0))
        neg = torch.sum(torch.where(consider & wrong, pair_w, 0.0))
        spe = torch.sum(torch.where(consider & tie, pair_w, 0.0))
        return torch.stack([pos, neg, spe])

    def fin(t):
        pos, neg, spe = t
        return {"pos": pos, "neg": neg, "spe": spe,
                "ratio": pos / max(neg, 1e-12)}

    return _evaluator_layer(name, "pnpair", inputs, accum, fin, 3)


class EvaluatorSet:
    """Host-side bundle the trainer drives (reset per pass / per test)."""

    def __init__(self, layers):
        self.layers = [l for l in layers if hasattr(l, "metric_finalize")]
        self.accs = {l.name: MetricAccumulator(l.name, l.metric_finalize,
                                               l.metric_width)
                     for l in self.layers}

    def reset(self):
        for a in self.accs.values():
            a.reset()

    def add_batch(self, outputs):
        for l in self.layers:
            if l.name in outputs:
                self.accs[l.name].add(outputs[l.name].array)

    def result(self):
        return {name: acc.value() for name, acc in self.accs.items()}


def _shift(x, by: int, fill):
    """x [B, T] shifted along time: by=1 gives x[t-1] at t (``fill`` at
    t=0), by=-1 gives x[t+1] (``fill`` at the end)."""
    pad = torch.full_like(x[:, :1], fill)
    if by == 1:
        return torch.cat([pad, x[:, :-1]], dim=1)
    return torch.cat([x[:, 1:], pad], dim=1)


def chunk(input, label, num_chunk_types: int, chunk_scheme: str = "IOB",
          name: Optional[str] = None):
    """Chunking F1 (NER-style) over predicted vs gold tag sequences
    (reference: ChunkEvaluator.cpp — IOB/IOE/IOBES/plain schemes; tag
    layout tag = chunk_type * num_tag_types + tag_type, O = the last id).

    Accumulables: [#correct_chunks, #pred_chunks, #label_chunks]. Chunk
    boundaries are masks; the segmented "aligned since the label chunk
    began" run is a loop over time (the reference's ``lax.scan``).
    """
    name = name or auto_name("chunk_evaluator")
    schemes = {"IOB": 2, "IOE": 2, "IOBES": 4, "plain": 1}
    if chunk_scheme not in schemes:
        raise ValueError(f"unknown chunk scheme {chunk_scheme}")
    num_tag_types = schemes[chunk_scheme]
    other_tag = num_chunk_types * num_tag_types      # the "O" id

    def boundaries(tags):
        """begin/end/type masks [B, T] for one scheme."""
        inside = tags < other_tag
        ttype = torch.where(inside, tags % num_tag_types, -1)
        ctype = torch.where(inside, tags // num_tag_types, -1)
        prev_in, nxt_in = _shift(inside, 1, False), _shift(inside, -1, False)
        prev_ct, nxt_ct = _shift(ctype, 1, -1), _shift(ctype, -1, -1)
        prev_tt, nxt_tt = _shift(ttype, 1, -1), _shift(ttype, -1, -1)
        if chunk_scheme == "IOB":          # B=0, I=1
            begin = inside & ((ttype == 0) | ~prev_in | (prev_ct != ctype))
            end = inside & (~nxt_in | (nxt_ct != ctype) | (nxt_tt == 0))
        elif chunk_scheme == "IOE":        # I=0, E=1
            begin = inside & (~prev_in | (prev_ct != ctype) |
                              (prev_tt == 1))
            end = inside & ((ttype == 1) | ~nxt_in | (nxt_ct != ctype))
        elif chunk_scheme == "IOBES":      # B=0, I=1, E=2, S=3
            begin = inside & ((ttype == 0) | (ttype == 3) | ~prev_in |
                              (prev_ct != ctype) | (prev_tt == 2) |
                              (prev_tt == 3))
            end = inside & ((ttype == 2) | (ttype == 3) | ~nxt_in |
                            (nxt_ct != ctype) | (nxt_tt == 0) |
                            (nxt_tt == 3))
        else:                              # plain: every tag its own chunk run
            begin = inside & (~prev_in | (prev_ct != ctype))
            end = inside & (~nxt_in | (nxt_ct != ctype))
        return begin, end, ctype

    def accum(params, parents, ctx):
        pv, lv = parents
        pred = pv.array
        if pred.dim() == 3:                # scores -> tag ids
            pred = torch.argmax(pred, dim=-1)
        pred = pred.to(torch.int32)
        lab = lv.array.to(torch.int32)
        if lab.dim() == 3:
            lab = lab[..., 0]
        T = pred.shape[1]
        valid = torch.arange(T, device=pred.device)[None, :] < \
            pv.lengths[:, None]
        pred = torch.where(valid, pred, other_tag)
        lab = torch.where(valid, lab, other_tag)
        pb, pe, pc = boundaries(pred)
        lb, le, lc = boundaries(lab)
        align = (pb == lb) & (pe == le) & (pc == lc)
        run = torch.zeros(pred.shape[0], dtype=torch.bool, device=pred.device)
        runs = []
        for t in range(T):
            run = align[:, t] & (lb[:, t] | run)
            runs.append(run)
        run_ok = torch.stack(runs, dim=1)
        correct = le & pe & run_ok
        return torch.stack([torch.sum(correct).float(),
                            torch.sum(pb).float(),
                            torch.sum(lb).float()])

    def fin(t):
        c, p, l = t
        prec = c / max(p, 1e-12)
        rec = c / max(l, 1e-12)
        return {"precision": prec, "recall": rec,
                "f1": 2 * prec * rec / max(prec + rec, 1e-12)}

    return _evaluator_layer(name, "chunk", [input, label], accum, fin, 3)


def _edit_distance(a, a_len: int, b, b_len: int) -> int:
    """Levenshtein distance of a[:a_len] and b[:b_len] (host ints)."""
    row = list(range(b_len + 1))
    for i in range(a_len):
        new = [i + 1]
        for j in range(b_len):
            new.append(min(new[j] + 1, row[j + 1] + 1,
                           row[j] + (a[i] != b[j])))
        row = new
    return row[b_len]


def ctc_error(input, label, blank: Optional[int] = None,
              name: Optional[str] = None):
    """Sequence error: edit distance between the greedy CTC decode of
    ``input`` and the label, normalized by label length (reference:
    CTCErrorEvaluator.cpp). Accumulables: [total_edit, total_label_len].
    The decode runs on the device; the distances are computed on the host
    from the decoded ids (an integer dynamic programme)."""
    from paddle_tpu_torch.ops import ctc as ops_ctc
    name = name or auto_name("ctc_error_evaluator")

    def accum(params, parents, ctx):
        pv, lv = parents
        n_cls = pv.array.shape[-1]
        blk = (n_cls - 1) if blank is None else blank
        logp = torch.log(torch.clamp_min(pv.array.float(), 1e-30)) \
            if input.activation == "softmax" else \
            torch.log_softmax(pv.array.float(), dim=-1)
        dec, dec_len = ops_ctc.ctc_greedy_decode(logp, pv.lengths, blank=blk)
        lab = lv.array.to(torch.int32)
        if lab.dim() == 3:
            lab = lab[..., 0]
        dec, dec_len, lab, lab_len = (t.cpu().tolist() for t in
                                      (dec, dec_len, lab, lv.lengths))
        dist = sum(_edit_distance(a, la, b, lb) for a, la, b, lb in
                   zip(dec, dec_len, lab, lab_len))
        return torch.tensor([float(dist), float(sum(lab_len))],
                            dtype=torch.float32, device=pv.array.device)

    return _evaluator_layer(name, "ctc_error", [input, label], accum,
                            lambda t: t[0] / max(t[1], 1e-12), 2)


def detection_map(detections, label, num_classes: int,
                  overlap_threshold: float = 0.5, background_id: int = 0,
                  score_bins: int = 100, name: Optional[str] = None):
    """Detection mAP over detection_output results (reference:
    DetectionMAPEvaluator.cpp — 11-point / integral AP).

    TP/FP are histogrammed into ``score_bins`` confidence bins per class on
    the device; AP integrates the binned precision/recall curve on the
    host. Accumulables per class: [tp_hist, fp_hist, #gt].
    """
    name = name or auto_name("detection_map_evaluator")
    C, BINS = num_classes, score_bins

    def accum(params, parents, ctx):
        from paddle_tpu_torch.ops import detection as ops_det
        dv, lv = parents
        det = dv.array                                   # [B, K, 6]
        gt = lv.array                                    # [B, G, 5]
        dev = det.device
        gt_valid = (torch.arange(gt.shape[1], device=dev)[None, :] <
                    lv.lengths[:, None])
        total = torch.zeros(2 * C * BINS + C, device=dev)
        for det_b, gt_b, valid_b in zip(det, gt, gt_valid):
            iou = ops_det.iou_matrix(det_b[:, 2:6], gt_b[:, 1:5])  # [K,G]
            cls_match = (det_b[:, 0:1] == gt_b[None, :, 0]) & valid_b[None]
            iou = torch.where(cls_match, iou, 0.0)
            K, G = iou.shape
            # greedy: detections are score-sorted (detection_output
            # output); each claims its best unclaimed gt above threshold
            claimed = torch.zeros(G, dtype=torch.bool, device=dev)
            hits = []
            for i in range(K):
                row = torch.where(claimed, 0.0, iou[i])
                j = torch.argmax(row)
                hit = (row[j] >= overlap_threshold) & (det_b[i, 0] >= 0)
                claimed = claimed | ((torch.arange(G, device=dev) == j) & hit)
                hits.append(hit)
            tp = torch.stack(hits)
            valid_det = det_b[:, 0] >= 0
            fp = valid_det & ~tp
            bins = torch.clamp((det_b[:, 1] * BINS).to(torch.int32), 0,
                               BINS - 1)
            cls = torch.clamp_min(det_b[:, 0].to(torch.int32), 0)
            flat = (cls * BINS + bins).long()
            zeros = torch.zeros(C * BINS, device=dev)
            tp_h = zeros.index_add(0, flat, (tp & valid_det).float())
            fp_h = zeros.index_add(0, flat, fp.float())
            gt_h = torch.zeros(C, device=dev).index_add(
                0, gt_b[:, 0].long(), valid_b.float())
            total = total + torch.cat([tp_h, fp_h, gt_h])
        return total

    def fin(t):
        tp_h = t[:C * BINS].reshape(C, BINS)
        fp_h = t[C * BINS:2 * C * BINS].reshape(C, BINS)
        ngt = t[2 * C * BINS:]
        aps = []
        for c in range(C):
            if c == background_id or ngt[c] <= 0:
                continue
            # sweep score bins high -> low
            tp = np.cumsum(tp_h[c][::-1])
            fp = np.cumsum(fp_h[c][::-1])
            rec = tp / ngt[c]
            prec = tp / np.maximum(tp + fp, 1e-12)
            # integral AP with monotone precision envelope
            prec = np.maximum.accumulate(prec[::-1])[::-1]
            ap = 0.0
            prev_r = 0.0
            for r, p in zip(rec, prec):
                ap += (r - prev_r) * p
                prev_r = r
            aps.append(ap)
        return float(np.mean(aps)) if aps else 0.0

    return _evaluator_layer(name, "detection_map", [detections, label],
                            accum, fin, 2 * C * BINS + C)
