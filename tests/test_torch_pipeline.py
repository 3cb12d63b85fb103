"""The port's input pipeline (``paddle_tpu_torch/pipeline/``) against
``paddle_tpu``'s on the CPU.

The counterparts of ``tests/test_pipeline.py``'s sources, stages,
pipeline and ``TestExactMidEpochResume`` cases (k in {1, 5, 9, 10, 11}:
k = 9 and 10 land in the end-of-epoch tail drain), and its checkpoint
carry, on recordio shards that both packages read. Across packages: the
port's batch stream equals the JAX package's for the same configuration
(ids and payloads bitwise), and a ``state_dict`` taken from a JAX
``Pipeline`` at batch k and loaded into the port's continues on JAX's
stream exactly, and the other way round.
"""

import pickle
import time

import numpy as np
import pytest

from paddle_tpu import pipeline as jpipe
from paddle_tpu.runtime import recordio as jrio
from paddle_tpu_torch import pipeline as tpipe
from paddle_tpu_torch.io import checkpoint as ckpt_io
from paddle_tpu_torch.runtime import recordio as trio


def _write_shards(tmp_path, n_shards=2, chunks=3, per_chunk=8, dim=6):
    """Recordio shards of (features f32[dim], label) samples with
    globally unique feature[0] so streams compare exactly."""
    paths, gid = [], 0
    r = np.random.RandomState(7)
    for s in range(n_shards):
        p = str(tmp_path / f"part-{s:05d}.rio")
        with jrio.Writer(p, records_per_chunk=per_chunk) as w:
            for _ in range(chunks * per_chunk):
                feat = r.rand(dim).astype(np.float32)
                feat[0] = gid          # unique id rides in the sample
                w.write((feat, int(gid % 4)))
                gid += 1
        paths.append(p)
    return paths


def _ids(batches):
    """Flatten a batch stream to the unique-id sequence."""
    return [int(s[0][0]) for b in batches for s in b]


def _same_batches(got, want):
    assert _ids(got) == _ids(want)
    for gb, wb in zip(got, want):
        assert len(gb) == len(wb)
        for gs, ws in zip(gb, wb):
            np.testing.assert_array_equal(gs[0], ws[0])
            assert gs[0].dtype == ws[0].dtype and gs[1] == ws[1]


class TestSources:
    def test_reader_source_resume_skips(self):
        src = tpipe.ReaderSource(lambda: iter(range(10)))
        it = iter(src)
        assert [next(it) for _ in range(4)] == [0, 1, 2, 3]
        st = src.state_dict()
        assert st == {"kind": "reader", "epoch": 0, "offset": 4}
        it.close()
        src2 = tpipe.ReaderSource(lambda: iter(range(10)))
        src2.load_state_dict(st)
        assert list(iter(src2)) == list(range(4, 10))
        assert src2.state_dict() == {"kind": "reader", "epoch": 1,
                                     "offset": 0}

    def test_reader_source_shrunk_data_is_loud(self):
        src = tpipe.ReaderSource(lambda: iter(range(3)))
        src.load_state_dict({"kind": "reader", "epoch": 0, "offset": 7})
        with pytest.raises(RuntimeError, match="exhausted before"):
            list(iter(src))

    def test_shard_source_epochs_match_jax(self, tmp_path):
        paths = _write_shards(tmp_path)
        t = tpipe.ShardSource(paths, shuffle_chunks=True, seed=3)
        j = jpipe.ShardSource(paths, shuffle_chunks=True, seed=3)
        assert t.num_records() == j.num_records() == 48
        epochs = []
        for _ in range(2):
            got = [int(s[0][0]) for s in iter(t)]
            assert got == [int(s[0][0]) for s in iter(j)]
            assert sorted(got) == list(range(48))
            epochs.append(got)
        assert epochs[0] != epochs[1]       # permutations differ by epoch

    def test_shard_source_mid_chunk_resume_exact(self, tmp_path):
        paths = _write_shards(tmp_path)
        src = tpipe.ShardSource(paths, shuffle_chunks=True, seed=3)
        it = iter(src)
        head = [next(it) for _ in range(13)]   # mid-chunk (per_chunk=8)
        st = src.state_dict()
        it.close()
        full = [int(s[0][0]) for s in iter(
            jpipe.ShardSource(paths, shuffle_chunks=True, seed=3))]
        src2 = tpipe.ShardSource(paths, shuffle_chunks=True, seed=3)
        src2.load_state_dict(st)
        assert [int(s[0][0]) for s in head] == full[:13]
        assert [int(s[0][0]) for s in iter(src2)] == full[13:]

    def test_shard_source_reads_port_written_shards(self, tmp_path):
        p = str(tmp_path / "port.rio")
        trio.write_records(p, [(np.float32(i), i) for i in range(20)],
                           chunk_records=6)
        got = [s[1] for s in iter(tpipe.ShardSource([p], seed=1))]
        assert got == [s[1] for s in iter(jpipe.ShardSource([p], seed=1))]
        assert sorted(got) == list(range(20))

    def test_source_kind_mismatch_is_loud(self):
        src = tpipe.ReaderSource(lambda: iter(range(3)))
        with pytest.raises(Exception, match="state mismatch"):
            src.load_state_dict({"kind": "shards", "epoch": 0,
                                 "chunk_pos": 0, "record_pos": 0})

    def test_as_source(self):
        src = tpipe.ShardSource.__new__(tpipe.ShardSource)
        assert tpipe.as_source(src) is src
        assert isinstance(tpipe.as_source(lambda: iter([])),
                          tpipe.ReaderSource)
        with pytest.raises(TypeError, match="reader callable"):
            tpipe.as_source(3)

    def test_master_source_streams_task_records(self, tmp_path):
        from paddle_tpu_torch.runtime import master as m
        path = str(tmp_path / "data.rio")
        trio.write_records(path, list(range(20)), chunk_records=5)
        svc = m.MasterService(lease_seconds=30)
        svc.set_dataset([path], chunks_per_task=1)
        try:
            src = tpipe.MasterSource(m.MasterClient(service=svc))
            with tpipe.Pipeline(src, batch_size=4) as p:
                got = [x for b in iter(p) for x in b]
            assert sorted(got) == list(range(20))
            assert src.state_dict()["records"] == 20
        finally:
            svc.close()


class TestStages:
    def test_transform_ordered_despite_uneven_latency(self):
        def fn(x):
            time.sleep(0.02 if x % 3 == 0 else 0.0)
            return x * 2
        with tpipe.Pipeline(lambda: iter(range(24)), transform=fn,
                            transform_workers=4, batch_size=6) as p:
            out = [x for b in iter(p) for x in b]
        assert out == [x * 2 for x in range(24)]

    def test_transform_exception_reraises_at_next(self):
        def fn(x):
            if x == 7:
                raise ValueError("xform boom")
            return x
        with tpipe.Pipeline(lambda: iter(range(20)), transform=fn,
                            transform_workers=2, batch_size=4) as p:
            with pytest.raises(ValueError, match="xform boom"):
                list(iter(p))

    def test_drop_last_tail_dies_with_its_epoch(self):
        with tpipe.Pipeline(lambda: iter(range(10)), batch_size=4) as p:
            e1, e2 = list(iter(p)), list(iter(p))
        assert e1 == [[0, 1, 2, 3], [4, 5, 6, 7]]
        assert e2 == e1

    def test_drop_last_false_emits_ragged_tail(self):
        with tpipe.Pipeline(lambda: iter(range(10)), batch_size=4,
                            drop_last=False) as p:
            assert list(iter(p)) == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9]]

    def test_shuffle_seeded_matches_jax(self):
        def run(P):
            with P.Pipeline(lambda: iter(range(40)), shuffle_size=8,
                            seed=11, batch_size=5) as p:
                return [x for b in iter(p) for x in b]
        a = run(tpipe)
        assert a == run(tpipe) == run(jpipe)
        assert a != list(range(40))
        assert sorted(a) == list(range(40))

    def test_stage_snapshots_match_jax(self):
        for P in (tpipe, jpipe):
            with pytest.raises(ValueError):
                P.ShuffleStage(0)
            with pytest.raises(ValueError):
                P.BatchStage(0)
            with pytest.raises(ValueError):
                P.TransformStage(abs, workers=0)
        ts, js = tpipe.ShuffleStage(4, seed=2), jpipe.ShuffleStage(4, seed=2)
        assert list(ts.feed(range(9))) == list(js.feed(range(9)))
        assert ts.state() == js.state()
        tb, jb = tpipe.BatchStage(3), jpipe.BatchStage(3)
        assert list(tb.feed(range(7))) == list(jb.feed(range(7)))
        assert tb.state() == jb.state()


class TestPipeline:
    def test_source_exception_reraises_not_hangs(self):
        def bad():
            yield from range(5)
            raise RuntimeError("src boom")
        with tpipe.Pipeline(bad, batch_size=2) as p:
            with pytest.raises(RuntimeError, match="src boom"):
                list(iter(p))

    def test_convert_exception_reraises(self):
        with tpipe.Pipeline(lambda: iter(range(8)), batch_size=2,
                            convert=lambda b: 1 / 0) as p:
            with pytest.raises(ZeroDivisionError):
                list(iter(p))

    def test_transfer_exception_reraises(self):
        def transfer(b):
            raise RuntimeError("copy failed")
        with tpipe.Pipeline(lambda: iter(range(8)), batch_size=2) as p:
            p.attach(transfer=transfer)
            with pytest.raises(RuntimeError, match="copy failed"):
                list(iter(p))

    def test_close_is_idempotent_and_final(self):
        p = tpipe.Pipeline(lambda: iter(range(100)), batch_size=4)
        it = iter(p)
        next(it)
        p.close()
        p.close()
        with pytest.raises(tpipe.PipelineClosed):
            list(iter(p))

    def test_backpressure_bounds_staging(self):
        produced = []

        def src():
            for i in range(1000):
                produced.append(i)
                yield i
        p = tpipe.Pipeline(src, batch_size=1, prefetch=3, device_depth=2)
        it = iter(p)
        next(it)
        time.sleep(0.3)                    # let the producer run ahead
        assert len(produced) < 50          # ring + device + slack only
        p.close()

    def test_abandoned_epoch_then_reiterate_not_poisoned(self):
        with tpipe.Pipeline(lambda: iter(range(30)),
                            transform=lambda x: x * 2,
                            transform_workers=2, batch_size=2,
                            prefetch=2) as p:
            it = iter(p)
            first = [next(it) for _ in range(2)]
            it.close()                     # abandoned epoch
            rest = list(iter(p))           # continue without restore
        got = [x for b in first + rest for x in b]
        full = [x * 2 for x in range(30)]
        assert got[:4] == full[:4]
        assert sorted(set(got)) == got     # in order, no duplicates
        resume_at = full.index(rest[0][0])
        assert got[4:] == full[resume_at:]
        assert resume_at - 4 <= 2 * (2 + 2) + 4 + 2

    def test_track_state_off_skips_snapshots_and_refuses(self):
        with tpipe.Pipeline(lambda: iter(range(8)), batch_size=2,
                            track_state=False) as p:
            assert len(list(iter(p))) == 4
            with pytest.raises(Exception, match="track_state=False"):
                p.state_dict()

    def test_threads_named_and_joined(self):
        import threading
        seen = []

        def here(x):
            seen.append(threading.current_thread().name)
            return x
        with tpipe.Pipeline(lambda: iter(range(8)), transform=here,
                            batch_size=2, convert=here) as p:
            assert len(list(iter(p))) == 4
        assert seen.count("pipeline-feed") == 4
        assert all(n.startswith("pipeline-xform") for n in seen
                   if n != "pipeline-feed")
        assert not any(t.name.startswith("pipeline-")
                       for t in threading.enumerate())

    def test_feed_metrics_populated(self):
        from paddle_tpu_torch.observe import metrics as om
        with tpipe.Pipeline(lambda: iter(range(12)), batch_size=3,
                            name="mtest") as p:
            assert len(list(iter(p))) == 4
        text = om.default_registry().render_prometheus()
        for name in ("pipeline_batches_total", "feed_wait_seconds_total",
                     "pipeline_queue_depth", "pipeline_stage_seconds"):
            assert name in text
        assert 'pipeline="mtest"' in text

    def test_state_version_is_jax_s(self):
        from paddle_tpu.pipeline import core as jcore
        from paddle_tpu_torch.pipeline import core as tcore
        assert tcore.STATE_VERSION == jcore.STATE_VERSION
        with tpipe.Pipeline(lambda: iter(range(8)), batch_size=2) as p:
            with pytest.raises(Exception, match="version"):
                p.load_state_dict({"version": 99})


def _make(P, paths):
    return P.Pipeline(
        P.ShardSource(paths, shuffle_chunks=True, seed=5),
        transform=lambda s: (s[0] * 2.0, s[1]),
        transform_workers=3, shuffle_size=10, seed=9, batch_size=4,
        prefetch=3)


def _head_and_state(P, paths, k):
    """k batches of ``P``'s pipeline, then its state as it would travel
    through a checkpoint; the pipeline abandoned (a kill)."""
    p = _make(P, paths)
    it = iter(p)
    head = [next(it) for _ in range(k)]
    st = pickle.loads(pickle.dumps(p.state_dict()))
    p.close()
    return head, st


def _resumed(P, paths, st):
    p = _make(P, paths)
    p.load_state_dict(st)
    with p:
        return list(iter(p)) + list(iter(p))


class TestExactMidEpochResume:
    """The preemption contract: checkpoint at batch k, kill, restore —
    the resumed stream is identical to an uninterrupted run (shuffle on,
    multi-shard, parallel transform on), in the port and across the two
    packages."""

    @pytest.fixture
    def shards(self, tmp_path):
        paths = _write_shards(tmp_path)
        with _make(jpipe, paths) as p:
            full = list(iter(p)) + list(iter(p))
        return paths, full

    def test_full_stream_matches_jax(self, shards):
        paths, full = shards
        with _make(tpipe, paths) as p:
            got = list(iter(p)) + list(iter(p))
        assert len(got) == len(full) == 24
        _same_batches(got, full)

    @pytest.mark.parametrize("k", [1, 5, 9, 10, 11])
    def test_resume_bitwise_identical(self, shards, k):
        paths, full = shards
        head, st = _head_and_state(tpipe, paths, k)
        _same_batches(head, full[:k])
        _same_batches(_resumed(tpipe, paths, st), full[k:])

    @pytest.mark.parametrize("k", [1, 5, 9, 10, 11])
    def test_jax_state_resumes_in_the_port(self, shards, k):
        paths, full = shards
        _, st = _head_and_state(jpipe, paths, k)
        _same_batches(_resumed(tpipe, paths, st), full[k:])

    @pytest.mark.parametrize("k", [1, 5, 9, 10, 11])
    def test_port_state_resumes_in_jax(self, shards, k):
        paths, full = shards
        _, st = _head_and_state(tpipe, paths, k)
        _same_batches(_resumed(jpipe, paths, st), full[k:])


class TestCheckpointCarry:
    def test_save_and_load_pipeline_state(self, tmp_path):
        d = str(tmp_path / "ck")
        state = {"version": 1, "source": {"kind": "reader", "epoch": 2,
                                          "offset": 17},
                 "pending": [np.arange(3)], "shuffle": None,
                 "batch": {"partial": [], "batches": 40}}
        path = ckpt_io.save_checkpoint(d, 8, {"w": np.zeros((2, 2))},
                                       pipeline_state=state)
        got = ckpt_io.load_pipeline_state(path)
        assert got["source"] == state["source"]
        assert got["batch"] == state["batch"]
        np.testing.assert_array_equal(got["pending"][0], np.arange(3))
        step, p, _, _ = ckpt_io.load_checkpoint(path, {"w": np.ones((2, 2))})
        assert step == 8
        np.testing.assert_array_equal(p["w"].numpy(), np.zeros((2, 2)))
        p2 = ckpt_io.save_checkpoint(d, 9, {"w": np.zeros((2, 2))})
        assert ckpt_io.load_pipeline_state(p2) is None

    def test_async_checkpointer_carries_frozen_snapshot(self, tmp_path):
        d = str(tmp_path / "ack")
        state = {"cursor": 5}
        ck = ckpt_io.AsyncCheckpointer(d)
        try:
            ck.save(3, {"w": np.ones(2)}, pipeline_state=state)
            state["cursor"] = 999          # mutate AFTER save: must not leak
            ck.wait()
        finally:
            ck.close()
        got = ckpt_io.load_pipeline_state(ckpt_io.latest_checkpoint(d))
        assert got == {"cursor": 5}
