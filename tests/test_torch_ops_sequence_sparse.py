"""The port's sequence and sparse ops against ``paddle_tpu``'s on the CPU.

Every case of ``tests/test_ops_sequence.py`` (the 14 sequence functions,
``sub_nested_seq``'s selection, gradient, 2-D ids, out-of-range and
overflow contracts) and of ``tests/test_ops_math.py``'s sparse half
(embedding, ``padding_idx``, ``scatter_add_rows``, the CSR matrix),
held against the JAX functions on the same seeded arrays, plus
``one_hot`` (out-of-range ids give zero rows), ``sparse_vector_to_dense``
and ``kmax_score_indices`` ties.

Tolerances: fp32 forward 1e-5, gradients 1e-4 (of max(1, max|JAX
value|)); indices, lengths, ``one_hot`` and ``sub_nested_seq``'s lengths
exactly.
"""

import numpy as np
import pytest
import torch

from paddle_tpu.ops import sequence as jseq
from paddle_tpu.ops import sparse as jsparse
from paddle_tpu_torch.ops import sequence as tseq
from paddle_tpu_torch.ops import sparse as tsparse
from tests.torch_ops_util import parity, to_j, to_t

torch.set_num_threads(1)


def _mk(rng, lens, d=4):
    t = max(lens) + 2  # deliberately over-padded
    return (rng.randn(len(lens), t, d).astype(np.float32),
            np.array(lens, np.int32))


def _seq_parity(name, x, lens, *extra, wrt=(0,)):
    jf, tf = getattr(jseq, name), getattr(tseq, name)
    return parity(lambda a: jf(a, to_j(lens), *extra),
                  lambda a: tf(a, to_t(lens), *extra), [x], wrt=wrt)


@pytest.mark.parametrize("name", ["seq_sum", "seq_avg", "seq_sqrt", "seq_max",
                                  "seq_last", "seq_first"])
def test_pools(rng, name):
    x, lens = _mk(rng, [3, 5, 1])
    t, _ = _seq_parity(name, x, lens)
    ref = {"seq_sum": lambda r, n: r[:n].sum(0),
           "seq_avg": lambda r, n: r[:n].mean(0),
           "seq_sqrt": lambda r, n: r[:n].sum(0) / np.sqrt(n),
           "seq_max": lambda r, n: r[:n].max(0),
           "seq_last": lambda r, n: r[n - 1],
           "seq_first": lambda r, n: r[0]}[name]
    for i, n in enumerate(lens):
        np.testing.assert_allclose(t.detach().numpy()[i], ref(x[i], n),
                                   rtol=1e-5, atol=1e-6)
    # trailing feature dims broadcast the same way
    _seq_parity(name, rng.randn(3, 6, 2, 3).astype(np.float32), lens)


def test_seq_softmax(rng):
    x, lens = _mk(rng, [3, 5], d=1)
    t, _ = _seq_parity("seq_softmax", x, lens)
    out = t.detach().numpy()[..., 0]
    for i, n in enumerate([3, 5]):
        e = np.exp(x[i, :n, 0] - x[i, :n, 0].max())
        np.testing.assert_allclose(out[i, :n], e / e.sum(), rtol=1e-5)
        assert np.abs(out[i, n:]).max() == 0
    _seq_parity("seq_softmax", rng.randn(2, 5).astype(np.float32),
                np.array([2, 5], np.int32))


def test_seq_reverse(rng):
    x, lens = _mk(rng, [3, 5])
    t, _ = _seq_parity("seq_reverse", x, lens)
    out = t.detach().numpy()
    np.testing.assert_allclose(out[0, :3], x[0, :3][::-1], rtol=1e-6)
    np.testing.assert_allclose(out[0, 3:], x[0, 3:], rtol=1e-6)


def test_seq_expand(rng):
    v = rng.randn(2, 4).astype(np.float32)
    t, _ = _seq_parity("seq_expand", v, np.array([2, 3], np.int32), 5)
    out = t.detach().numpy()
    np.testing.assert_allclose(out[0, :2], np.tile(v[0], (2, 1)), rtol=1e-6)
    assert np.abs(out[0, 2:]).max() == 0


@pytest.mark.parametrize("context_len,context_start", [(3, -1), (2, 0),
                                                       (4, -3)])
def test_context_projection(rng, context_len, context_start):
    x, lens = _mk(rng, [4, 2], d=3)
    t, _ = _seq_parity("context_projection", x, lens, context_len,
                       context_start)
    if (context_len, context_start) == (3, -1):
        out = t.detach().numpy()
        np.testing.assert_allclose(out[0, 0, :3], 0, atol=1e-6)
        np.testing.assert_allclose(out[0, 0, 3:6], x[0, 0], rtol=1e-6)
        np.testing.assert_allclose(out[0, 3, 6:9], 0, atol=1e-6)
        np.testing.assert_allclose(out[1, 1, 6:9], 0, atol=1e-6)


def test_row_conv(rng):
    x, lens = _mk(rng, [4, 3], d=2)
    w = rng.randn(3, 2).astype(np.float32)
    t, _ = parity(lambda a, b: jseq.row_conv(a, to_j(lens), b),
                  lambda a, b: tseq.row_conv(a, to_t(lens), b), [x, w],
                  wrt=(0, 1))
    out = t.detach().numpy()
    np.testing.assert_allclose(out[0, 3], x[0, 3] * w[0], rtol=1e-5)


def test_kmax_scores(rng):
    s = np.array([[0.1, 0.9, 0.5, 99.0], [0.3, 0.2, 0.0, 0.0],
                  [0.5, 0.7, 0.5, 0.7]], np.float32)
    t, _ = _seq_parity("kmax_score_indices", s,
                       np.array([3, 2, 4], np.int32), 2, wrt=())
    assert t.numpy().tolist() == [[1, 2], [0, 1], [1, 3]]


def test_seq_concat(rng):
    x, xl = _mk(rng, [2, 3], d=2)
    y, yl = _mk(rng, [1, 2], d=2)
    t, _ = parity(lambda a, b: jseq.seq_concat(a, to_j(xl), b, to_j(yl)),
                  lambda a, b: tseq.seq_concat(a, to_t(xl), b, to_t(yl)),
                  [x, y], wrt=(0, 1))
    assert t[1].numpy().tolist() == [3, 5]


class TestSubNestedSeq:
    SUB = np.asarray([[3, 1, 0], [2, 2, 1]], np.int32)

    def _run(self, x, sel, cnt, wrt=(0,)):
        sel, cnt = np.asarray(sel, np.int32), np.asarray(cnt, np.int32)
        t, _ = parity(
            lambda a: jseq.sub_nested_seq(a, to_j(self.SUB), to_j(sel),
                                          to_j(cnt)),
            lambda a: tseq.sub_nested_seq(a, to_t(self.SUB), to_t(sel),
                                          to_t(cnt)), [x], wrt=wrt)
        return [v.detach().numpy() for v in t]

    def test_selection_matches_manual(self, rng):
        d = rng.randn(2, 5, 2).astype(np.float32)
        out, lens, sub = self._run(d, [[1, 0], [2, 0]], [2, 1])
        assert lens.tolist() == [4, 1] and sub.tolist() == [[1, 3], [1, 0]]
        np.testing.assert_allclose(out[0, 1:4], d[0, 0:3])

    def test_gradients_flow_to_selected_rows_only(self, rng):
        d = rng.randn(2, 5, 2).astype(np.float32)
        xt = to_t(d, True)
        out, _, _ = tseq.sub_nested_seq(xt, to_t(self.SUB),
                                        torch.tensor([[1], [0]]),
                                        torch.tensor([1, 1]))
        g = torch.autograd.grad(out.sum(), xt)[0].numpy()
        assert g[0, 3].tolist() == [1, 1]
        assert np.abs(g[0, [0, 1, 2, 4]]).max() == 0
        assert g[1, :2].tolist() == [[1, 1], [1, 1]]
        self._run(d, [[1], [0]], [1, 1])

    def test_index_data_2d(self, rng):
        ids = np.asarray([[5, 6, 7, 8, 0], [1, 2, 3, 4, 9]], np.int32)
        out, lens, _ = self._run(ids, [[1, 0], [1, 0]], [1, 2], wrt=())
        assert out.tolist()[1] == [3, 4, 1, 2, 0]
        assert lens.tolist() == [1, 4]

    def test_out_of_range_selection_contributes_nothing(self, rng):
        d = rng.randn(2, 5, 2).astype(np.float32)
        out, lens, sub = self._run(d, [[7, 0], [-2, 1]], [2, 2])
        assert sub.tolist() == [[0, 3], [0, 2]] and lens.tolist() == [3, 2]

    def test_duplicate_overflow_truncates_consistently(self, rng):
        d = rng.randn(2, 5, 2).astype(np.float32)
        out, lens, sub = self._run(d, [[0, 0], [1, 1]], [2, 2])
        assert lens.tolist() == [5, 4] and sub.tolist() == [[3, 2], [2, 2]]


def test_embedding(rng):
    ids = np.array([[1, 3], [19, 0]], np.int32)
    t, _ = parity(lambda a: jsparse.embedding_lookup(a, to_j(ids)),
                  lambda a: tsparse.embedding_lookup(a, to_t(ids)),
                  [rng.randn(20, 6).astype(np.float32)], wrt=(0,))


def test_embedding_padding_idx(rng):
    ids = np.array([0, 2, 0, 4], np.int32)
    t, _ = parity(lambda a: jsparse.embedding_lookup(a, to_j(ids), 0),
                  lambda a: tsparse.embedding_lookup(a, to_t(ids), 0),
                  [rng.randn(5, 4).astype(np.float32)], wrt=(0,))
    assert np.abs(t.detach().numpy()[0]).max() == 0.0


def test_scatter_add_rows(rng):
    ids = np.array([1, 1, 3], np.int32)
    t, _ = parity(lambda a, r: jsparse.scatter_add_rows(a, to_j(ids), r),
                  lambda a, r: tsparse.scatter_add_rows(a, to_t(ids), r),
                  [rng.randn(4, 2).astype(np.float32),
                   rng.randn(3, 2).astype(np.float32)], wrt=(0, 1))


def test_one_hot():
    ids = np.array([[0, 3, -1], [2, 7, 1]], np.int32)
    parity(lambda a: jsparse.one_hot(a, 5), lambda a: tsparse.one_hot(a, 5),
           [ids])


def test_sparse_vector_to_dense():
    idx, val, off = np.array([0, 3, 1, 2, 4]), np.arange(5.0), [0, 2, 2, 5]
    for v in (val, None):
        np.testing.assert_array_equal(
            tsparse.sparse_vector_to_dense(idx, v, 6, off),
            jsparse.sparse_vector_to_dense(idx, v, 6, off))
    np.testing.assert_array_equal(
        tsparse.sparse_vector_to_dense(idx[:2], val[:2], 6),
        jsparse.sparse_vector_to_dense(idx[:2], val[:2], 6))


class TestCSR:
    def _random_sparse(self, rng, rows=6, cols=8, density=0.3):
        d = (rng.rand(rows, cols) < density) * rng.randn(rows, cols)
        return d.astype(np.float32)

    def _both(self, d):
        return (jsparse.CSRMatrix.from_dense(d),
                tsparse.CSRMatrix.from_dense(d, device="cpu"))

    def test_roundtrip(self, rng):
        d = self._random_sparse(rng)
        jm, tm = self._both(d)
        np.testing.assert_array_equal(tm.to_dense().numpy(), d)
        for name in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                          np.asarray(getattr(jm, name)))
        assert tm.nnz == jm.nnz == int((d != 0).sum())
        assert tsparse.CSRMatrix.from_dense(to_t(d)).data.device.type == "cpu"

    def test_spmm_matches_dense(self, rng):
        d = self._random_sparse(rng)
        jm, tm = self._both(d)
        parity(jm.matmul_dense, tm.matmul_dense,
               [rng.randn(8, 5).astype(np.float32)], wrt=(0,))

    def test_transpose_spmm_matches_dense(self, rng):
        d = self._random_sparse(rng)
        jm, tm = self._both(d)
        b = rng.randn(6, 4).astype(np.float32)
        t, _ = parity(jm.transpose_matmul_dense, tm.transpose_matmul_dense,
                      [b], wrt=(0,))
        np.testing.assert_allclose(t.detach().numpy(), d.T @ b, rtol=1e-5,
                                   atol=1e-5)

    def test_empty_rows(self):
        d = np.zeros((3, 4), np.float32)
        d[1, 2] = 5.0
        jm, tm = self._both(d)
        t, _ = parity(jm.matmul_dense, tm.matmul_dense,
                      [np.eye(4, dtype=np.float32)])
        np.testing.assert_allclose(t.numpy(), d)

    def test_padding_entries_drop(self, rng):
        """Static-nnz padding (index 0, data 0 past indptr[-1]) adds
        nothing, in both packages."""
        indptr, indices = np.array([0, 1, 3]), np.array([2, 0, 1, 0, 0])
        data = np.array([1.0, 2.0, 3.0, 0.0, 0.0], np.float32)
        jm = jsparse.CSRMatrix(indptr, indices, data, (2, 3))
        tm = tsparse.CSRMatrix(indptr, indices, data, (2, 3), device="cpu")
        b = rng.randn(3, 2).astype(np.float32)
        parity(jm.matmul_dense, tm.matmul_dense, [b])
        np.testing.assert_array_equal(tm.to_dense().numpy(),
                                      np.asarray(jm.to_dense()))
