"""The port's ``SGD.train(checkpoint_dir=..., prefetch=..., reader=Pipeline)``
on the CPU, against ``paddle_tpu``'s.

The counterparts of ``tests/test_checkpoint_async.py::TestTrainerResume::
test_train_writes_and_resumes``, ``tests/test_pipeline.py::
TestTrainerMidEpochPreemption::test_preempt_restore_identical_stream``
and ``tests/test_trainer_mnist.py::test_checkpoint_roundtrip``, each
beside the JAX package's run of the same case (its parameters carried
into the port): costs within the trainer tests' 1e-4, the step counters
and checkpoint names equal. ``prefetch=3`` trains bitwise equal to
``prefetch=0``, with a ``Pipeline`` reader too; the step accountant books
``checkpoint_save`` and ``restore``.
"""

import shutil

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu.trainer  # noqa: F401
import paddle_tpu_torch as T
import paddle_tpu_torch.trainer  # noqa: F401
from paddle_tpu.io import checkpoint as jck
from paddle_tpu.runtime import recordio as jrio
from paddle_tpu.utils.flags import GLOBAL_FLAGS as JFLAGS
from paddle_tpu.utils.rng import KeySource as JKeySource
from paddle_tpu_torch.io import checkpoint as ck
from paddle_tpu_torch.utils.flags import GLOBAL_FLAGS as TFLAGS
from tests.torch_layers_util import carry, keep_global_seed  # noqa: F401

pytestmark = pytest.mark.usefixtures("keep_global_seed")

TOL = 1e-4


def _pair(build, seed=3, lr=0.1):
    """A JAX and a port trainer over one graph, from the same initial
    parameters; a fresh pair on every call."""
    jcost, tcost = build(J), build(T)
    jp = J.parameters.create(J.topology.Topology(jcost), JKeySource(seed))
    tp = carry(jp, T.topology.Topology(tcost))
    jt = J.trainer.SGD(cost=jcost, parameters=jp,
                       update_equation=J.optimizer.Momentum(
                           learning_rate=lr))
    tt = T.trainer.SGD(cost=tcost, parameters=tp,
                       update_equation=T.optimizer.Momentum(
                           learning_rate=lr))
    return jt, tt


def _costs(P, out, stop_at=None):
    def h(ev):
        if isinstance(ev, P.event.EndIteration):
            out.append(ev.cost)
            if stop_at is not None and len(out) == stop_at:
                raise KeyboardInterrupt("preempt")
    return h


@pytest.fixture
def period(request):
    """Set both packages' ``checkpoint_period`` flag for one test."""
    old = (JFLAGS.get("checkpoint_period"), TFLAGS.get("checkpoint_period"))

    def set_(n):
        JFLAGS.set("checkpoint_period", n)
        TFLAGS.set("checkpoint_period", n)
    yield set_
    JFLAGS.set("checkpoint_period", old[0])
    TFLAGS.set("checkpoint_period", old[1])


class TestTrainerResume:
    def _build(self, P):
        L = P.layer
        x = L.data("cr_x", P.data_type.dense_vector(4))
        lbl = L.data("cr_l", P.data_type.integer_value(2))
        out = L.fc(x, 2, act=P.activation.Softmax(), name="cr_out")
        return L.classification_cost(out, lbl, name="cr_cost")

    def _reader(self, n=32):
        def reader():
            r = np.random.RandomState(0)
            for _ in range(n):
                y = int(r.randint(2))
                yield [(r.randn(4) + 3 * y).astype(np.float32), y]
        return reader

    def test_train_writes_and_resumes(self, tmp_path):
        runs = {}
        jt, tt = _pair(self._build)
        jt2, tt2 = _pair(self._build)
        for P, tr, tr2 in ((J, jt, jt2), (T, tt, tt2)):
            d = str(tmp_path / P.__name__)
            P.init(seed=1)
            c1, c2 = [], []
            tr.train(reader=P.batch(self._reader(), 8), num_passes=2,
                     event_handler=_costs(P, c1), checkpoint_dir=d)
            assert tr._step == 8
            latest = ck.latest_checkpoint(d)
            assert latest and latest.endswith("00000008")
            # a fresh trainer resumes at step 8 and continues to 12
            tr2.train(reader=P.batch(self._reader(), 8), num_passes=1,
                      event_handler=_costs(P, c2), checkpoint_dir=d)
            assert tr2._step == 12
            assert ck.latest_checkpoint(d).endswith("00000012")
            runs[P.__name__] = (c1, c2, tr2)
        (jc1, jc2, jt2), (tc1, tc2, tt2) = (runs["paddle_tpu"],
                                            runs["paddle_tpu_torch"])
        np.testing.assert_allclose(tc1, jc1, rtol=0, atol=TOL)
        np.testing.assert_allclose(tc2, jc2, rtol=0, atol=TOL)
        # resumed params came from the checkpoint, not re-init
        w = tt2.parameters.values["cr_out.w"]
        step, p, _, _ = ck.load_checkpoint(
            ck.latest_checkpoint(str(tmp_path / "paddle_tpu_torch")),
            tt2.parameters.values)
        assert step == 12 and torch.equal(p["cr_out.w"], w)
        np.testing.assert_allclose(w.numpy(), np.asarray(
            jt2.parameters.values["cr_out.w"]), rtol=0, atol=TOL)
        # the accountant booked the restore and the saves
        b = tt2._acct.snapshot()["buckets"]
        assert b["restore"] > 0 and b["checkpoint_save"] > 0
        assert tt2.last_checkpointer.write_seconds

    def test_period_saves_every_n_batches(self, tmp_path, period):
        period(3)
        _, tt = _pair(self._build)
        d = str(tmp_path / "ck")
        tt.train(reader=T.batch(self._reader(), 8), num_passes=2,
                 checkpoint_dir=d)
        assert tt._step == 8
        assert len(tt.last_checkpointer.write_seconds) == 2   # steps 3, 6
        assert ck.latest_checkpoint(d).endswith("00000006")


def _write_shards(tmp_path, n_shards=2, chunks=2, per_chunk=8, dim=6):
    paths, gid = [], 0
    r = np.random.RandomState(7)
    for s in range(n_shards):
        p = str(tmp_path / f"part-{s:05d}.rio")
        with jrio.Writer(p, records_per_chunk=per_chunk) as w:
            for _ in range(chunks * per_chunk):
                feat = r.rand(dim).astype(np.float32)
                feat[0] = gid
                w.write((feat, int(gid % 4)))
                gid += 1
        paths.append(p)
    return paths


class TestTrainerMidEpochPreemption:
    """``SGD.train`` over a ``Pipeline`` with checkpointing, preempted
    mid-epoch, resumes on the exact next batch: the resumed costs equal
    the uninterrupted run's (and the JAX package's)."""

    def _build(self, P):
        L = P.layer
        x = L.data("pl_x", P.data_type.dense_vector(6))
        lbl = L.data("pl_l", P.data_type.integer_value(4))
        out = L.fc(x, 4, act=P.activation.Softmax(), name="pl_out")
        return L.classification_cost(out, lbl, name="pl_cost")

    def _pipe(self, P, paths):
        return P.pipeline.Pipeline(
            P.pipeline.ShardSource(paths, shuffle_chunks=True, seed=2),
            shuffle_size=12, seed=4, batch_size=8, prefetch=2)

    def _losses(self, P, tr, pipe, ckpt_dir=None, stop_at=None):
        seen = []
        try:
            tr.train(reader=pipe, num_passes=2,
                     event_handler=_costs(P, seen, stop_at),
                     checkpoint_dir=ckpt_dir)
        except KeyboardInterrupt:
            pass
        return seen

    def test_preempt_restore_identical_stream(self, tmp_path, period):
        paths = _write_shards(tmp_path)
        build = self._build
        fulls = {}
        for P, tr in zip((J, T), _pair(build, lr=0.05)):
            with self._pipe(P, paths) as p:
                fulls[P] = self._losses(P, tr, p)
            assert len(fulls[P]) == 8
        np.testing.assert_allclose(fulls[T], fulls[J], rtol=0, atol=TOL)
        full = fulls[T]
        period(2)
        d = str(tmp_path / "ck")
        # preempted run from the same init: dies after batch 3
        # (checkpoint landed at step 2)
        _, tr2 = _pair(build, lr=0.05)
        p2 = self._pipe(T, paths)
        part = self._losses(T, tr2, p2, ckpt_dir=d, stop_at=3)
        p2.close()
        assert len(part) == 3
        np.testing.assert_allclose(part, full[:3], rtol=1e-6)
        latest = ck.latest_checkpoint(d)
        assert latest and latest.endswith("00000002")
        assert ck.load_pipeline_state(latest) is not None
        # the same checkpoint, for the JAX trainer to resume from below
        shutil.copytree(latest, str(tmp_path / "ck_jax" / "ckpt-00000002"))
        # a fresh trainer and pipeline adopt the checkpoint (params AND
        # stream position) and continue on batch index 2 — mid-epoch,
        # shuffle on, across the epoch boundary into pass 2
        _, tr3 = _pair(build, lr=0.05)
        with self._pipe(T, paths) as p3:
            resumed = self._losses(T, tr3, p3, ckpt_dir=d)
        np.testing.assert_allclose(resumed, full[2:], rtol=1e-6,
                                   err_msg="resumed stream diverged")
        # the JAX trainer resumes from the port's step-2 checkpoint alike
        jtr, _ = _pair(build, lr=0.05)
        with self._pipe(J, paths) as pj:
            jresumed = self._losses(J, jtr, pj,
                                    ckpt_dir=str(tmp_path / "ck_jax"))
        assert jtr._step == 8
        np.testing.assert_allclose(jresumed, full[2:], rtol=0, atol=TOL)


class TestPrefetch:
    def _build(self, P):
        L, A = P.layer, P.activation
        x = L.data("pf_x", P.data_type.dense_vector(20))
        y = L.data("pf_y", P.data_type.integer_value(5))
        h = L.fc(x, 16, act=A.Relu(), name="pf_h")
        h = L.dropout(h, 0.2, name="pf_drop")
        out = L.fc(h, 5, act=A.Softmax(), name="pf_o")
        return L.classification_cost(out, y, name="pf_c")

    def _rows(self, n=96):
        rng = np.random.RandomState(9)
        return [(rng.randn(20).astype(np.float32), int(rng.randint(5)))
                for _ in range(n)]

    def _train(self, reader, **kw):
        _, tt = _pair(self._build)
        T.init(seed=3)
        costs = []
        tt.train(reader, num_passes=2, event_handler=_costs(T, costs), **kw)
        return costs, tt

    def test_prefetch_trains_bitwise_equal_to_sync(self):
        rows = self._rows()
        reader = T.batch(lambda: iter(rows), 16)
        base, t0 = self._train(reader)
        for kw in ({"prefetch": 3}, {"prefetch": 1}):
            costs, t1 = self._train(reader, **kw)
            assert costs == base, kw
            for k, v in t0.parameters.values.items():
                assert torch.equal(t1.parameters.values[k], v), (kw, k)
        pipe = T.pipeline.Pipeline(reader, prefetch=3)
        try:
            costs, t2 = self._train(pipe)
        finally:
            pipe.close()
        assert costs == base
        for k, v in t0.parameters.values.items():
            assert torch.equal(t2.parameters.values[k], v), k

    def test_prefetch_matches_jax(self):
        rows = self._rows()
        jt, tt = _pair(self._build)
        out = {}
        for P, tr in ((J, jt), (T, tt)):
            P.init(seed=3)
            out[P] = []
            tr.train(P.batch(lambda: iter(rows), 16), num_passes=2,
                     event_handler=_costs(P, out[P]), prefetch=3)
        assert len(out[T]) == 12
        np.testing.assert_allclose(out[T], out[J], rtol=0, atol=TOL)

    def test_owned_pipeline_is_closed(self):
        import threading
        self._train(T.batch(lambda: iter(self._rows()), 16), prefetch=2)
        assert not [t.name for t in threading.enumerate()
                    if t.name.startswith("pipeline-")]


class TestMnistCheckpointRoundtrip:
    """``tests/test_trainer_mnist.py::test_checkpoint_roundtrip`` on the
    port: a LeNet's parameters, Momentum state and model state after two
    passes, saved and loaded back (step 42), bitwise; the JAX package
    loads the same directory to the same values."""

    def test_checkpoint_roundtrip(self, tmp_path):
        from tests.test_torch_trainer import _lenet, _mnist_rows
        jcost = _lenet(J)[1]
        tcost = _lenet(T)[1]
        jp = J.parameters.create(J.topology.Topology(jcost), JKeySource(3))
        tp = carry(jp, T.topology.Topology(tcost))
        tt = T.trainer.SGD(tcost, tp, T.optimizer.Momentum(
            momentum=0.9, learning_rate=0.05))
        rows = _mnist_rows(64, 0)
        T.init(seed=1)
        tt.train(T.batch(lambda: iter(rows), 32), num_passes=2)
        d = str(tmp_path / "ckpt")
        ck.save_checkpoint(d, 42, tp.values, tt.opt_state, tp.state)
        path = ck.latest_checkpoint(d)
        step, p2, o2, s2 = ck.load_checkpoint(path, tp.values, tt.opt_state,
                                              tp.state)
        assert step == 42
        for a, b in ((p2, tp.values), (o2, tt.opt_state), (s2, tp.state)):
            assert set(a) == set(b)
            for k in a:
                assert torch.equal(a[k], b[k]), k
        np.testing.assert_array_equal(p2["fc1.w"].numpy(), tp["fc1.w"])
        jstep, jp2, jo2, _ = jck.load_checkpoint(
            path, jp.values, {k: np.zeros(v.shape, np.float32)
                              for k, v in tp.values.items()}, jp.state)
        assert jstep == 42
        for k, v in tp.values.items():
            np.testing.assert_array_equal(np.asarray(jp2[k]), v.numpy())
            np.testing.assert_array_equal(np.asarray(jo2[k]),
                                          tt.opt_state[k].numpy())
