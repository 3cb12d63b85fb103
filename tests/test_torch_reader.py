"""The port's readers against ``paddle_tpu``'s on the CPU.

``utils/threadq``; every creator (``np_array``, ``text_file``,
``recordio`` over files written by either package) and every decorator
(``map_readers``, ``shuffle`` — seeded, from the seed flag and from the
global ``random`` module —, ``chain``, ``compose``, ``buffered``,
``firstn``, ``cache``, ``xmap_readers``) gives the JAX package's stream
for the same inputs, element for element. Plus the counterparts of
``tests/test_pipeline.py::TestReaderDecoratorRobustness``: worker
exceptions reach the consumer and closing a generator mid-stream joins
its ``reader-*`` threads (``tests/conftest.py``'s leak guard checks
every test here).
"""

import itertools
import queue
import random
import threading
import time

import numpy as np
import pytest

from paddle_tpu.reader import creator as jcreator
from paddle_tpu.reader import decorator as jdec
from paddle_tpu.runtime import recordio as jrio
from paddle_tpu.utils.flags import GLOBAL_FLAGS as JFLAGS
from paddle_tpu_torch import reader as treader
from paddle_tpu_torch.reader import creator as tcreator
from paddle_tpu_torch.reader import decorator as tdec
from paddle_tpu_torch.runtime import recordio as trio
from paddle_tpu_torch.utils import threadq
from paddle_tpu_torch.utils.flags import GLOBAL_FLAGS as TFLAGS


def _eq(a, b):
    """Streams equal element for element (arrays bitwise)."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, tuple):
            assert isinstance(y, tuple) and len(x) == len(y)
            _eq(list(x), list(y))
        elif isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype
        else:
            assert x == y


def _samples(n=23, seed=0):
    r = np.random.RandomState(seed)
    return [(r.rand(3).astype(np.float32), int(r.randint(10)))
            for _ in range(n)]


@pytest.fixture
def fresh_shuffle_ids(monkeypatch):
    """Both packages fold a per-process decoration counter into a
    seeded shuffle's order: start both at 0."""
    monkeypatch.setattr(jdec, "_shuffle_ids", itertools.count())
    monkeypatch.setattr(tdec, "_shuffle_ids", itertools.count())


class TestThreadq:
    def test_put_stoppable_returns_false_once_stopped(self):
        q, stop = queue.Queue(maxsize=1), threading.Event()
        assert threadq.put_stoppable(q, 1, stop)
        stop.set()
        t0 = time.time()
        assert not threadq.put_stoppable(q, 2, stop)   # full and stopped
        assert time.time() - t0 < 1.0
        assert q.get_nowait() == 1

    def test_put_stoppable_waits_for_room(self):
        q, stop = queue.Queue(maxsize=1), threading.Event()
        q.put(0)
        threading.Timer(0.2, q.get).start()
        assert threadq.put_stoppable(q, 1, stop)
        assert q.get_nowait() == 1

    def test_drain_join_wakes_blocked_producers(self):
        q, stop = queue.Queue(maxsize=1), threading.Event()

        def produce():
            for i in itertools.count():
                if not threadq.put_stoppable(q, i, stop):
                    return
        ts = [threading.Thread(target=produce, name="reader-test")
              for _ in range(3)]
        for t in ts:
            t.start()
        time.sleep(0.1)
        assert threadq.drain_join([q], ts, stop) == []
        assert stop.is_set() and not any(t.is_alive() for t in ts)

    def test_drain_join_reports_stuck_threads(self):
        stop, release = threading.Event(), threading.Event()
        t = threading.Thread(target=release.wait, name="reader-stuck")
        t.start()
        try:
            alive = threadq.drain_join([], [t], stop, deadline_s=0.2)
            assert alive == [t]
        finally:
            release.set()
            t.join()


class TestCreators:
    def test_np_array(self):
        x = np.arange(12, dtype=np.float32).reshape(4, 3)
        _eq(list(tcreator.np_array(x)()), list(jcreator.np_array(x)()))

    def test_text_file(self, tmp_path):
        p = tmp_path / "lines.txt"
        p.write_text("alpha\nbeta\n\ngamma delta\n")
        got = list(tcreator.text_file(str(p))())
        assert got == list(jcreator.text_file(str(p))())
        assert got == ["alpha", "beta", "", "gamma delta"]

    @pytest.mark.parametrize("writer", ["jax", "torch"])
    def test_recordio_reads_either_packages_files(self, tmp_path, writer):
        rio = jrio if writer == "jax" else trio
        paths = []
        for i in range(2):
            p = str(tmp_path / f"part-{i}.rio")
            rio.write_records(p, _samples(17, seed=i), chunk_records=5)
            paths.append(p)
        _eq(list(tcreator.recordio(paths)()),
            list(jcreator.recordio(paths)()))
        _eq(list(tcreator.recordio(paths[0])()), _samples(17, seed=0))


class TestDecorators:
    def test_map_readers(self):
        a, b = (lambda: iter(range(7))), (lambda: iter(range(10, 20)))
        f = lambda x, y: x * 100 + y  # noqa: E731
        assert list(tdec.map_readers(f, a, b)()) == \
            list(jdec.map_readers(f, a, b)())

    @pytest.mark.usefixtures("fresh_shuffle_ids")
    def test_shuffle_seeded_orders_equal_per_pass(self):
        src = lambda: iter(range(53))  # noqa: E731
        jr = [jdec.shuffle(src, 8, seed=5), jdec.shuffle(src, 16, seed=5)]
        tr = [tdec.shuffle(src, 8, seed=5), tdec.shuffle(src, 16, seed=5)]
        for j, t in zip(jr, tr):
            passes = [(list(t()), list(j())) for _ in range(3)]
            for got, want in passes:
                assert got == want
                assert sorted(got) == list(range(53))
            assert passes[0][0] != passes[1][0]     # each pass reshuffles
        assert list(tr[0]()) != list(tr[1]())      # decorations differ

    @pytest.mark.usefixtures("fresh_shuffle_ids")
    def test_shuffle_from_the_seed_flag(self):
        old = (JFLAGS.get("seed"), TFLAGS.get("seed"))
        JFLAGS.set("seed", 77)
        TFLAGS.set("seed", 77)
        try:
            src = lambda: iter(range(40))  # noqa: E731
            assert list(tdec.shuffle(src, 10)()) == \
                list(jdec.shuffle(src, 10)())
        finally:
            JFLAGS.set("seed", old[0])
            TFLAGS.set("seed", old[1])

    def test_shuffle_from_the_global_random_module(self):
        old = (JFLAGS.get("seed"), TFLAGS.get("seed"))
        JFLAGS.set("seed", 0)
        TFLAGS.set("seed", 0)
        state = random.getstate()
        try:
            src = lambda: iter(range(30))  # noqa: E731
            random.seed(11)
            want = list(jdec.shuffle(src, 7)())
            random.seed(11)
            assert list(tdec.shuffle(src, 7)()) == want
        finally:
            random.setstate(state)
            JFLAGS.set("seed", old[0])
            TFLAGS.set("seed", old[1])

    def test_chain(self):
        rs = [lambda: iter(range(3)), lambda: iter([]),
              lambda: iter("ab")]
        assert list(tdec.chain(*rs)()) == list(jdec.chain(*rs)())

    def test_compose(self):
        a = lambda: iter([(1, 2), (3, 4)])  # noqa: E731
        b = lambda: iter(["x", "y"])  # noqa: E731
        got = list(tdec.compose(a, b)())
        assert got == list(jdec.compose(a, b)()) == [(1, 2, "x"),
                                                      (3, 4, "y")]

    def test_buffered(self):
        src = lambda: iter(_samples(40))  # noqa: E731
        _eq(list(tdec.buffered(src, 4)()), list(jdec.buffered(src, 4)()))

    def test_firstn(self):
        src = lambda: iter(range(100))  # noqa: E731
        assert list(tdec.firstn(src, 9)()) == list(jdec.firstn(src, 9)())

    def test_cache_materialises_once(self):
        calls = []

        def src():
            calls.append(1)
            return iter(range(5))
        r = tdec.cache(src)
        assert list(r()) == list(r()) == list(jdec.cache(src)())
        assert len(calls) == 2      # once here, once for the JAX cache

    @pytest.mark.parametrize("order", [True, False])
    def test_xmap_readers(self, order):
        src = lambda: iter(range(60))  # noqa: E731
        f = lambda x: x * x  # noqa: E731
        got = list(tdec.xmap_readers(f, src, 3, 8, order=order)())
        want = list(jdec.xmap_readers(f, src, 3, 8, order=order)())
        if order:
            assert got == want
        else:
            assert sorted(got) == sorted(want)

    def test_package_exports(self):
        for name in ("buffered", "cache", "chain", "compose", "firstn",
                     "map_readers", "shuffle", "xmap_readers", "creator",
                     "minibatch"):
            assert hasattr(treader, name), name

    def test_worker_threads_are_named_reader(self):
        seen = []

        def src():
            seen.extend(t.name for t in threading.enumerate())
            yield 1
        list(tdec.buffered(src, 2)())
        list(tdec.xmap_readers(lambda x: x, src, 2, 2)())
        assert "reader-buffered" in seen
        assert "reader-xmap-feed" in seen


class TestReaderDecoratorRobustness:
    """Counterparts of ``tests/test_pipeline.py::
    TestReaderDecoratorRobustness`` on the port."""

    def test_buffered_propagates_source_exception(self):
        def bad():
            yield 1
            raise RuntimeError("boom")
        r = tdec.buffered(bad, 4)
        got = []
        with pytest.raises(RuntimeError, match="boom"):
            for x in r():
                got.append(x)
        assert got == [1]                  # prefix delivered, then raise

    def test_buffered_partial_iteration_joins_thread(self):
        r = tdec.buffered(lambda: iter(range(100000)), 4)
        it = r()
        assert next(it) == 0
        it.close()                          # guard asserts no leak

    def test_xmap_source_exception_propagates_not_hangs(self):
        def bad():
            yield from range(3)
            raise RuntimeError("src died")
        r = tdec.xmap_readers(lambda x: x, bad, 3, 4)
        with pytest.raises(RuntimeError, match="src died"):
            list(r())

    def test_xmap_mapper_exception_propagates(self):
        def m(x):
            if x == 5:
                raise ValueError("map boom")
            return x
        r = tdec.xmap_readers(m, lambda: iter(range(10)), 2, 4)
        with pytest.raises(ValueError, match="map boom"):
            list(r())

    def test_xmap_ordered_complete_and_partial_close(self):
        r = tdec.xmap_readers(lambda x: x + 1, lambda: iter(range(50)),
                              3, 8, order=True)
        assert list(r()) == list(range(1, 51))
        it = r()
        next(it)
        it.close()                          # guard asserts no leak

    def test_xmap_unordered_complete(self):
        r = tdec.xmap_readers(lambda x: x + 1, lambda: iter(range(50)),
                              3, 8)
        assert sorted(r()) == list(range(1, 51))
