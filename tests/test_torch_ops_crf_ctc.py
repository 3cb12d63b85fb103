"""The port's CRF and CTC against ``paddle_tpu``'s on the CPU.

Every case of ``tests/test_ops_crf_ctc.py``: the CRF log-likelihood and
Viterbi decode against exhaustive path enumeration and the JAX package,
their gradients, padding invariance; CTC against enumeration, the
empty (length-0) label, its gradient through a log-softmax, greedy
decoding; and the CRF layer pair (a linear emission layer trained under
the CRF cost and decoded with the same transitions) at the op level.
Also: Viterbi ties, CTC with repeated labels and padded frames.

Tolerances: fp32 forward 1e-5, gradients through the scans 1e-4 (of
max(1, max|JAX value|)); Viterbi tags, CTC greedy ids and lengths
exactly; enumeration checks 1e-4 (fp32 against float64).
"""

import itertools

import jax
import numpy as np
import torch

from paddle_tpu.ops import crf as jcrf
from paddle_tpu.ops import ctc as jctc
from paddle_tpu_torch.ops import crf as tcrf
from paddle_tpu_torch.ops import ctc as tctc
from tests.torch_ops_util import parity, to_j, to_t

torch.set_num_threads(1)


def brute_crf(emis, tags, length, w):
    """Path score and logZ by enumeration. emis [T, N], w [(N+2), N]."""
    start, end, trans = w[0], w[1], w[2:]
    N = emis.shape[1]

    def score(path):
        s = start[path[0]] + end[path[length - 1]]
        s += sum(emis[t, path[t]] for t in range(length))
        s += sum(trans[path[t - 1], path[t]] for t in range(1, length))
        return s

    all_scores = [score(p) for p in itertools.product(range(N),
                                                       repeat=length)]
    return score(tags[:length]), np.logaddexp.reduce(np.array(all_scores))


class TestCRF:
    def setup_method(self, _):
        rng = np.random.RandomState(7)
        self.B, self.T, self.N = 3, 4, 3
        self.emis = rng.randn(self.B, self.T, self.N).astype(np.float32)
        self.w = (0.5 * rng.randn(self.N + 2, self.N)).astype(np.float32)
        self.lengths = np.array([4, 2, 3], np.int32)
        self.tags = rng.randint(0, self.N, (self.B, self.T)).astype(np.int32)

    def _ll(self, wrt=(0, 1)):
        lens, tags = self.lengths, self.tags
        return parity(
            lambda e, w: jcrf.crf_log_likelihood(e, to_j(tags), to_j(lens), w),
            lambda e, w: tcrf.crf_log_likelihood(e, to_t(tags), to_t(lens), w),
            [self.emis, self.w], wrt=wrt)

    def test_log_likelihood_vs_enumeration(self):
        got = self._ll(wrt=())[0].numpy()
        for b in range(self.B):
            sc, logz = brute_crf(self.emis[b].astype(np.float64),
                                 self.tags[b], int(self.lengths[b]),
                                 self.w.astype(np.float64))
            np.testing.assert_allclose(got[b], sc - logz, rtol=1e-4,
                                       atol=1e-4)

    def test_decode_vs_enumeration(self):
        lens = self.lengths
        t, _ = parity(lambda e, w: jcrf.crf_decode(e, to_j(lens), w),
                      lambda e, w: tcrf.crf_decode(e, to_t(lens), w),
                      [self.emis, self.w])
        tags, score = t[0].numpy(), t[1].numpy()
        assert t[0].dtype == torch.int32
        for b in range(self.B):
            L = int(lens[b])
            best, best_p = -1e30, None
            for p in itertools.product(range(self.N), repeat=L):
                s, _ = brute_crf(self.emis[b].astype(np.float64), list(p), L,
                                 self.w.astype(np.float64))
                if s > best:
                    best, best_p = s, p
            assert tuple(tags[b, :L]) == best_p
            np.testing.assert_allclose(score[b], best, rtol=1e-4, atol=1e-4)

    def test_grads(self):
        self._ll(wrt=(0, 1))
        lens = self.lengths
        parity(lambda e, w: jcrf.crf_log_norm(e, to_j(lens), w),
               lambda e, w: tcrf.crf_log_norm(e, to_t(lens), w),
               [self.emis, self.w], wrt=(0, 1))

    def test_padding_invariance(self):
        e2 = self.emis.copy()
        e2[1, 2:] = 999.0  # sequence 1 has length 2
        a = self._ll(wrt=())[0]
        b = tcrf.crf_log_likelihood(to_t(e2), to_t(self.tags),
                                    to_t(self.lengths), to_t(self.w))
        np.testing.assert_allclose(a[1].item(), b[1].item(), rtol=1e-5)

    def test_decode_ties_take_the_lower_tag(self):
        """All-equal scores: every argmax ties; both packages pick tag 0."""
        emis = np.zeros((2, 5, 4), np.float32)
        w = np.zeros((6, 4), np.float32)
        lens = np.array([5, 3], np.int32)
        t, _ = parity(lambda e, w_: jcrf.crf_decode(e, to_j(lens), w_),
                      lambda e, w_: tcrf.crf_decode(e, to_t(lens), w_),
                      [emis, w])
        assert t[0].numpy().tolist() == [[0] * 5] * 2


def brute_ctc(logp, label, T):
    """-log p(label) by enumerating all T-length alignment paths."""
    C = logp.shape[1]
    total = -np.inf
    for path in itertools.product(range(C), repeat=T):
        collapsed, prev = [], -1
        for c in path:
            if c != prev and c != 0:
                collapsed.append(c)
            prev = c
        if collapsed == list(label):
            total = np.logaddexp(total, sum(logp[t, path[t]]
                                            for t in range(T)))
    return -total


def _logp(rng, B, T, C):
    x = rng.randn(B, T, C)
    return (x - np.log(np.sum(np.exp(x), -1, keepdims=True))).astype(
        np.float32)


def _ctc(logp, labels, in_len, lab_len, wrt=(0,)):
    return parity(
        lambda lp: jctc.ctc_loss(lp, to_j(labels), to_j(in_len),
                                 to_j(lab_len)),
        lambda lp: tctc.ctc_loss(lp, to_t(labels), to_t(in_len),
                                 to_t(lab_len)), [logp], wrt=wrt)


class TestCTC:
    def test_vs_enumeration(self):
        rng = np.random.RandomState(3)
        logp = _logp(rng, 3, 4, 3)
        labels = np.array([[1, 2], [2, 2], [1, 0]], np.int32)
        lab_len = np.array([2, 2, 1], np.int32)
        in_len = np.array([4, 4, 3], np.int32)
        got = _ctc(logp, labels, in_len, lab_len)[0].detach().numpy()
        for b in range(3):
            want = brute_ctc(logp[b, :in_len[b]].astype(np.float64),
                             list(labels[b, :lab_len[b]]), int(in_len[b]))
            np.testing.assert_allclose(got[b], want, rtol=1e-4, atol=1e-4)

    def test_empty_label(self):
        """A length-0 label has only the all-blank path."""
        rng = np.random.RandomState(4)
        logp = _logp(rng, 2, 3, 3)
        t, _ = _ctc(logp, np.zeros((2, 2), np.int32), np.array([3, 2],
                                                               np.int32),
                    np.array([0, 1], np.int32))
        want = -float(logp[0, 0, 0] + logp[0, 1, 0] + logp[0, 2, 0])
        np.testing.assert_allclose(t[0].item(), want, rtol=1e-5)

    def test_grad(self):
        rng = np.random.RandomState(5)
        x = rng.randn(3, 6, 4).astype(np.float32)
        labels = np.array([[1, 2, 0], [2, 2, 1], [3, 0, 0]], np.int32)
        in_len = np.array([6, 5, 2], np.int32)
        lab_len = np.array([2, 3, 1], np.int32)
        parity(lambda a: jctc.ctc_loss(jax.nn.log_softmax(a, -1),
                                       to_j(labels), to_j(in_len),
                                       to_j(lab_len)),
               lambda a: tctc.ctc_loss(torch.log_softmax(a, -1),
                                       to_t(labels), to_t(in_len),
                                       to_t(lab_len)), [x], wrt=(0,))

    def test_greedy_decode(self):
        logp = np.full((2, 6, 3), -5.0, np.float32)
        for t, c in enumerate([1, 1, 0, 2, 2, 1]):
            logp[0, t, c] = 0.0
        for t, c in enumerate([2, 0, 2, 1, 1, 1]):
            logp[1, t, c] = 0.0
        in_len = np.array([4, 6], np.int32)
        t, _ = parity(lambda a: jctc.ctc_greedy_decode(a, to_j(in_len)),
                      lambda a: tctc.ctc_greedy_decode(a, to_t(in_len)),
                      [logp])
        assert t[1].numpy().tolist() == [2, 3]
        assert t[0].numpy()[0, :2].tolist() == [1, 2]
        assert t[0].numpy()[1, :3].tolist() == [2, 2, 1]

    def test_greedy_decode_random(self):
        rng = np.random.RandomState(6)
        logp = _logp(rng, 4, 12, 5)
        in_len = np.array([12, 7, 0, 3], np.int32)
        parity(lambda a: jctc.ctc_greedy_decode(a, to_j(in_len)),
               lambda a: tctc.ctc_greedy_decode(a, to_t(in_len)), [logp])


class TestCRFLayers:
    def test_crf_train_and_decode_layers(self):
        """The CRF layer pair at the op level: emissions from a linear
        layer, the CRF cost's gradient reaching the emission weights and
        the transitions, and the decode sharing the transitions."""
        from paddle_tpu.ops import math as jmath
        from paddle_tpu_torch.ops import math as tmath
        rng = np.random.RandomState(0)
        B, T, N = 3, 5, 4
        x = rng.randn(B, T, 8).astype(np.float32)
        lens = np.array([5, 3, 4], np.int32)
        y = rng.randint(0, N, (B, T)).astype(np.int32)
        w_fc = (rng.randn(8, N) * 0.3).astype(np.float32)
        crfw = (rng.randn(N + 2, N) * 0.3).astype(np.float32)

        def run(math, crf, to, a, fc, tr):
            emis = math.linear(a, fc)
            return (-crf.crf_log_likelihood(emis, to(y), to(lens), tr),
                    crf.crf_decode(emis, to(lens), tr)[0])

        t, _ = parity(lambda *a: run(jmath, jcrf, to_j, *a),
                      lambda *a: run(tmath, tcrf, to_t, *a),
                      [x, w_fc, crfw], wrt=(1, 2))
        assert tuple(t[0].shape) == (B,) and (t[0] > 0).all()
        assert tuple(t[1].shape) == (B, T)
