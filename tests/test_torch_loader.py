"""The port's ``runtime/loader.py`` against ``paddle_tpu``'s on the CPU.

The counterparts of ``tests/test_runtime_native.py::TestPrefetchLoader``
and ``TestDenseBatchLoader``, each on the port's native path (its own
``recordio.cc``, built by g++) and its pure-Python path, with the JAX
package's loader over the same files as the reference: records equal
(``num_threads=1``, plain and seeded chunk shuffle), ``write_dense``
files byte-equal, ``DenseBatchLoader`` batches equal, and a dense
stream training the port's ``SGD``.
"""

import numpy as np
import pytest

from paddle_tpu.runtime import loader as jloader
from paddle_tpu.runtime import recordio as jrio
from paddle_tpu_torch.runtime import loader as tloader
from paddle_tpu_torch.runtime import native, recordio as trio


def _records(n):
    return [{"i": i, "x": list(range(i % 5))} for i in range(n)]


@pytest.fixture
def rio_file(tmp_path):
    path = str(tmp_path / "data.rio")
    jrio.write_records(path, _records(257), chunk_records=50)
    return path


@pytest.fixture(params=["native", "python"])
def path_kind(request, monkeypatch):
    """Run the port's loader on its native path, then on its pure-Python
    path (``native.get`` returning None, as without g++)."""
    if request.param == "native":
        assert native.get() is not None, "g++ build of recordio.cc failed"
    else:
        monkeypatch.setattr(native, "get", lambda: None)
    return request.param


class TestPrefetchLoader:
    def test_yields_all_records(self, rio_file, path_kind):
        ld = tloader.PrefetchLoader(rio_file, num_threads=3)
        got = list(ld)
        assert ld.path_taken == path_kind
        # multi-threaded chunk reads may interleave chunk order
        assert sorted(got, key=lambda r: r["i"]) == _records(257)

    def test_single_thread_matches_jax(self, rio_file, path_kind):
        got = list(tloader.PrefetchLoader(rio_file, num_threads=1))
        assert got == _records(257)
        assert got == list(jloader.PrefetchLoader(rio_file, num_threads=1))

    @pytest.mark.parametrize("seed", [1, 2])
    def test_shuffled_chunk_order_matches_jax(self, rio_file, path_kind,
                                              seed):
        t = tloader.PrefetchLoader(rio_file, shuffle=True, seed=seed,
                                   num_threads=1)
        j = jloader.PrefetchLoader(rio_file, shuffle=True, seed=seed,
                                   num_threads=1)
        for _ in range(2):                  # the epochs' orders too
            got = list(t)
            assert got == list(j)
            assert sorted(r["i"] for r in got) == list(range(257))

    def test_shuffle_changes_chunk_order(self, rio_file):
        a = list(tloader.PrefetchLoader(rio_file, shuffle=True, seed=1,
                                        num_threads=1))
        b = list(tloader.PrefetchLoader(rio_file, shuffle=True, seed=2,
                                        num_threads=1))
        assert sorted(r["i"] for r in a) == list(range(257))
        assert [r["i"] for r in a] != [r["i"] for r in b]

    def test_reader_creator_restartable(self, rio_file, path_kind):
        reader = tloader.reader_creator(rio_file, num_threads=1)
        assert list(reader()) == _records(257)
        assert list(reader()) == _records(257)   # second epoch works

    def test_reads_a_port_written_file_as_jax_does(self, tmp_path,
                                                   path_kind):
        path = str(tmp_path / "port.rio")
        trio.write_records(path, _records(40), chunk_records=7)
        got = list(tloader.PrefetchLoader(path, num_threads=1))
        assert got == list(jloader.PrefetchLoader(path, num_threads=1))
        assert got == _records(40)


class TestDenseBatchLoader:
    def _feats(self, n=300, dim=5):
        rng = np.random.RandomState(0)
        return (rng.rand(n, dim).astype(np.float32),
                rng.randint(0, 7, n).astype(np.int32))

    def _write(self, tmp_path, n=300, dim=5):
        feats, labels = self._feats(n, dim)
        path = str(tmp_path / "dense.rio")
        assert tloader.write_dense(path, zip(feats, labels), dim,
                                   chunk_records=64) == n
        return path, feats, labels

    def test_write_dense_bytes_equal_jax(self, tmp_path, path_kind):
        feats, labels = self._feats()
        tp, jp = str(tmp_path / "t.rio"), str(tmp_path / "j.rio")
        assert tloader.write_dense(tp, zip(feats, labels), 5,
                                   chunk_records=64) == 300
        assert jloader.write_dense(jp, zip(feats, labels), 5,
                                   chunk_records=64) == 300
        assert open(tp, "rb").read() == open(jp, "rb").read()

    def test_roundtrip_batches_match_jax(self, tmp_path, path_kind):
        path, feats, labels = self._write(tmp_path)
        # num_threads=1: exact file order
        got = list(tloader.dense_batch_reader(path, 5, 128,
                                              num_threads=1)())
        want = list(jloader.dense_batch_reader(path, 5, 128,
                                               num_threads=1)())
        assert [len(l) for _, l in got] == [128, 128, 44]   # tail kept
        assert len(got) == len(want)
        for (gf, gl), (wf, wl) in zip(got, want):
            np.testing.assert_array_equal(gf, wf)
            np.testing.assert_array_equal(gl, wl)
        np.testing.assert_array_equal(
            np.concatenate([np.array(f) for f, _ in got]), feats)
        np.testing.assert_array_equal(
            np.concatenate([np.array(l) for _, l in got]), labels)

    def test_shuffled_batches_match_jax(self, tmp_path, path_kind):
        path, *_ = self._write(tmp_path)
        t = tloader.DenseBatchLoader(path, 24, 32, shuffle=True, seed=4,
                                     num_threads=1)
        j = jloader.DenseBatchLoader(path, 24, 32, shuffle=True, seed=4,
                                     num_threads=1)
        got = [b.copy() for b in t]
        assert t.path_taken == path_kind
        want = [b.copy() for b in j]
        assert len(got) == len(want) == 10
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)

    def test_python_fallback_matches(self, tmp_path, monkeypatch):
        path, *_ = self._write(tmp_path)
        native_batches = [np.array(l) for _, l in tloader.dense_batch_reader(
            path, 5, 64, num_threads=1)()]
        monkeypatch.setattr(native, "get", lambda: None)
        py_batches = [np.array(l) for _, l in tloader.dense_batch_reader(
            path, 5, 64, num_threads=1)()]
        assert len(native_batches) == len(py_batches)
        for a, b in zip(native_batches, py_batches):
            np.testing.assert_array_equal(a, b)

    def test_size_mismatch_rejected(self, tmp_path, path_kind):
        path = str(tmp_path / "bad.rio")
        trio.write_records(path, [b"abc", b"defgh"], raw=True)
        with pytest.raises(IOError):
            list(tloader.DenseBatchLoader(path, 3, 2))

    def test_partial_batch_survives_mid_batch_error(self, tmp_path):
        """A mid-batch size mismatch yields the records already assembled
        first; the error surfaces on the next native call."""
        path = str(tmp_path / "bad2.rio")
        trio.write_records(path, [b"abc", b"xyz", b"defgh"], raw=True)
        got = []
        with pytest.raises(IOError, match="partial batch of 2"):
            for b in tloader.DenseBatchLoader(path, 3, 4):
                got.append(b.copy())
        assert len(got) == 1 and len(got[0]) == 2
        assert bytes(got[0][0]) + bytes(got[0][1]) in (b"abcxyz", b"xyzabc")

    def test_drop_last(self, tmp_path, path_kind):
        path, *_ = self._write(tmp_path, n=100)
        sizes = [len(l) for _, l in
                 tloader.dense_batch_reader(path, 5, 64, drop_last=True)()]
        assert sizes == [64]

    def test_trains_through_sgd(self, tmp_path):
        """The native batch path feeds the port's ``trainer.SGD`` through
        the pre-batched DataFeeder path, and the costs are the JAX
        package's on the same stream (its parameters carried across)."""
        import paddle_tpu as J
        import paddle_tpu_torch as T
        from paddle_tpu.utils.rng import KeySource
        from tests.torch_layers_util import carry

        dim, classes, n = 12, 3, 192
        rng = np.random.RandomState(0)
        protos = rng.randn(classes, dim).astype(np.float32)
        labels = rng.randint(0, classes, n).astype(np.int32)
        feats = protos[labels] + rng.randn(n, dim).astype(np.float32) * 0.2
        path = str(tmp_path / "train.rio")
        tloader.write_dense(path, zip(feats, labels), dim, chunk_records=32)

        def build(P):
            x = P.layer.data("x", P.data_type.dense_vector(dim))
            y = P.layer.data("y", P.data_type.integer_value(classes))
            out = P.layer.fc(x, classes, act=P.activation.Softmax(),
                             name="nb_fc")
            return P.layer.classification_cost(out, y, name="nb_cost")
        jcost, tcost = build(J), build(T)
        jp = J.parameters.create(jcost, KeySource(1))
        tp = carry(jp, T.topology.Topology(tcost))
        costs = {}
        for P, cost, params, ld in ((J, jcost, jp, jloader),
                                    (T, tcost, tp, tloader)):
            tr = P.trainer.SGD(cost=cost, parameters=params,
                               update_equation=P.optimizer.Momentum(
                                   momentum=0.9, learning_rate=0.5))
            got = costs[P.__name__] = []
            tr.train(reader=ld.dense_batch_reader(path, dim, 64,
                                                  drop_last=True,
                                                  num_threads=1),
                     num_passes=6,
                     event_handler=lambda e, got=got, P=P: got.append(
                         e.cost) if isinstance(e, P.event.EndIteration)
                     else None)
        tc, jc = costs["paddle_tpu_torch"], costs["paddle_tpu"]
        assert tc[-1] < tc[0] * 0.5, tc
        np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-4)
