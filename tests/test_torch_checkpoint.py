"""The port's ``io/checkpoint.py`` against ``paddle_tpu``'s on the CPU.

The counterparts of ``tests/test_checkpoint_async.py`` (roundtrip and
prune, checksum corruption, worker error, and the load side of
``test_multi_process_files_merge``: the JAX package writes the two
processes' shard files, the port merges them) and of
``tests/test_elastic.py::TestCheckpointCrashConsistency`` (each chaos
phase of the commit, the torn multi-process publish, pruning that counts
complete checkpoints only), plus the fence. Across packages: an
MNIST-width MLP's checkpoint (parameters, Momentum state, batch-norm
state and the pipeline's stream position) written by the JAX trainer
resumes in the port's, and the other way round; the next steps' costs
agree within the trainer tests' 1e-4. The snapshot: an
``AsyncCheckpointer.save`` followed at once by an in-place update writes
the values from before the update. Reference fault (ROADMAP C10): the
JAX package cannot load its own bf16 leaves (``jnp.asarray`` of the
``|V2`` words np.load gives); the port reads them as bf16.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu.trainer  # noqa: F401
import paddle_tpu_torch as T
import paddle_tpu_torch.trainer  # noqa: F401
from paddle_tpu.io import checkpoint as jck
from paddle_tpu.utils.flags import GLOBAL_FLAGS as JFLAGS
from paddle_tpu.utils.rng import KeySource as JKeySource
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.io import checkpoint as ck
from paddle_tpu_torch.runtime import chaos
from paddle_tpu_torch.utils.flags import GLOBAL_FLAGS as TFLAGS
from tests.torch_layers_util import carry, keep_global_seed  # noqa: F401

TOL = 1e-4


def _p(v=1.0):
    return {"w": torch.full((4,), v)}


class TestAsyncCheckpointer:
    def test_roundtrip_and_prune(self, tmp_path):
        d = str(tmp_path)
        ac = ck.AsyncCheckpointer(d, keep=2)
        params = {"w": torch.arange(6.0).reshape(2, 3)}
        opt = {"m": (torch.zeros(3), torch.ones(2))}
        for step in (1, 2, 3, 4):
            ac.save(step, {"w": params["w"] * step}, opt)
        ac.close()
        kept = sorted(x for x in os.listdir(d) if x.startswith("ckpt-"))
        assert kept == ["ckpt-00000003", "ckpt-00000004"]
        assert len(ac.write_seconds) == 4
        step, p, o, _ = ck.load_checkpoint(os.path.join(d, kept[-1]),
                                           params, opt)
        assert step == 4
        np.testing.assert_array_equal(p["w"].numpy(),
                                      np.arange(6.0).reshape(2, 3) * 4)
        assert isinstance(o["m"], tuple) and o["m"][1].shape == (2,)

    def test_checksum_detects_corruption(self, tmp_path):
        path = ck.save_checkpoint(str(tmp_path), 7, {"w": torch.ones(4)})
        target = os.path.join(path, "params.npz")
        raw = bytearray(open(target, "rb").read())
        raw[-1] ^= 0xFF
        open(target, "wb").write(bytes(raw))
        with pytest.raises(IOError, match="checksum"):
            ck.load_checkpoint(path, {"w": torch.ones(4)})

    def test_worker_error_surfaces_and_recovers(self, tmp_path):
        ac = ck.AsyncCheckpointer(str(tmp_path / "nope"))
        open(tmp_path / "nope", "w").close()    # save_dir is a file
        ac.save(1, {"w": torch.ones(2)})
        with pytest.raises(Exception):
            ac.wait()
        os.remove(tmp_path / "nope")
        ac.save(2, {"w": torch.ones(2)})
        ac.close()
        assert ck.latest_checkpoint(str(tmp_path / "nope")) is not None

    def test_save_snapshots_before_an_in_place_update(self, tmp_path):
        """The trainer updates parameters in place, and a CPU tensor's
        ``numpy()`` aliases it: the save must have copied already."""
        d = str(tmp_path)
        w = torch.arange(1 << 16, dtype=torch.float32)
        want = w.clone()
        ac = ck.AsyncCheckpointer(d)
        for _ in range(3):
            ac.save(1, {"w": w}, {"w": (w,)}, {"s": w})
            w.add_(1.0)              # the next step, at once
            ac.wait()
            step, p, o, s = ck.load_checkpoint(
                ck.latest_checkpoint(d), {"w": w}, {"w": (w,)}, {"s": w})
            for got in (p["w"], o["w"][0], s["s"]):
                assert torch.equal(got, want)
            want = w.clone()
        ac.close()

    def test_save_parts_time_each_save(self, tmp_path):
        """Each save reports what it spent on the caller's thread, and
        the bytes of the pipeline state it pickled; CPU leaves are cloned,
        so no byte is copied off a device."""
        import pickle
        ac = ck.AsyncCheckpointer(str(tmp_path))
        state = {"buf": np.arange(1000, dtype=np.float32), "pos": 3}
        got = [ac.save(i, {"w": torch.ones(4)}, pipeline_state=state)
               for i in range(2)]
        ac.close()
        assert ac.save_parts == got
        for parts in got:
            assert set(parts) == {"snapshot_s", "pin_alloc_s", "pickle_s",
                                  "enqueue_s", "device_bytes",
                                  "pipeline_bytes"}
            assert all(parts[k] >= 0.0 for k in parts)
            assert parts["device_bytes"] == 0
            assert parts["pipeline_bytes"] == len(
                pickle.dumps(state, protocol=4))
        assert len(ac.write_seconds) == 2


class TestLoadPlacesLikeTheTemplate:
    def test_dtype_and_device_follow_the_template(self, tmp_path):
        path = ck.save_checkpoint(str(tmp_path), 1,
                                  {"a": torch.arange(4.0),
                                   "b": torch.arange(3, dtype=torch.int32)})
        tmpl = {"a": torch.zeros(4, dtype=torch.bfloat16),
                "b": torch.zeros(3, dtype=torch.int64)}
        _, p, _, _ = ck.load_checkpoint(path, tmpl)
        assert p["a"].dtype == torch.bfloat16 and p["b"].dtype == torch.int64
        assert p["a"].device == tmpl["a"].device
        assert p["a"].tolist() == [0.0, 1.0, 2.0, 3.0]

    def test_bf16_words_across_packages(self, tmp_path):
        """bf16 leaves are raw 2-byte words in both packages' files; the
        port reads JAX's bitwise. The JAX package's own load raises on
        them (C10), so its side is read through np.load."""
        jpath = jck.save_checkpoint(str(tmp_path / "j"), 1,
                                    {"w": jnp.arange(5.0).astype(
                                        jnp.bfloat16) / 3})
        _, p, _, _ = ck.load_checkpoint(
            jpath, {"w": torch.zeros(5, dtype=torch.bfloat16)})
        want = (torch.arange(5.0).to(torch.bfloat16) / 3)
        assert torch.equal(p["w"], want)
        with pytest.raises(TypeError, match="V2"):
            jck.load_checkpoint(jpath, {"w": jnp.zeros(5, jnp.bfloat16)})
        tpath = ck.save_checkpoint(str(tmp_path / "t"), 1, {"w": want})
        words = np.load(os.path.join(tpath, "params.npz"))["w"]
        jwords = np.load(os.path.join(jpath, "params.npz"))["w"]
        assert words.dtype == jwords.dtype and \
            words.tobytes() == jwords.tobytes()


class TestMultiProcessLayout:
    def test_multi_process_files_merge(self, tmp_path):
        """Two processes of the JAX package each save a half of a
        row-sharded array (the ``@@i`` entries with their index
        metadata); the port merges them."""
        d = str(tmp_path)
        full = np.arange(16.0).reshape(4, 4)

        class FakeShard:
            def __init__(self, index, data):
                self.index = index
                self.data = data

        class FakeArr:
            def __init__(self, idx):
                rows = slice(idx * 2, idx * 2 + 2)
                self.addressable_shards = [
                    FakeShard((rows, slice(0, 4)), full[rows]),
                    FakeShard((rows, slice(0, 4)), full[rows]),
                ]
                self.shape = full.shape

            def __array__(self, dtype=None):
                return full

        for proc in (0, 1):
            jck.save_checkpoint(d, 5, {"w": FakeArr(proc)},
                                process_index=proc, process_count=2)
        path = ck.latest_checkpoint(d)
        assert ck.is_complete(path)
        step, p, _, _ = ck.load_checkpoint(
            path, {"w": torch.zeros((4, 4), dtype=torch.float64)})
        assert step == 5
        np.testing.assert_array_equal(p["w"].numpy(), full)

    def test_port_process_files_load_in_jax(self, tmp_path):
        d = str(tmp_path)
        for proc in (0, 1):
            ck.save_checkpoint(d, 3, {"w": torch.arange(6.0)},
                               process_index=proc, process_count=2)
        assert sorted(os.listdir(os.path.join(d, "ckpt-00000003"))) == [
            "manifest.p0.json", "manifest.p1.json", "params.p0.npz",
            "params.p1.npz"]
        step, p, _, _ = jck.load_checkpoint(jck.latest_checkpoint(d),
                                            {"w": jnp.zeros(6)})
        assert step == 3
        np.testing.assert_array_equal(np.asarray(p["w"]), np.arange(6.0))

    def test_sharded_tensor_waits_for_a10(self, tmp_path):
        """Ported (the name is kept): an array exposing its addressable
        shards is written as ``@@i`` shard entries with their index
        metadata, replicas once, and both packages reassemble it; a
        plain tensor under sharded=True is written whole."""
        from paddle_tpu.io import checkpoint as jck
        full = np.arange(16.0, dtype=np.float32).reshape(4, 4)

        class Shard:
            def __init__(self, rows):
                self.index = (rows, slice(0, 4))
                self.data = torch.from_numpy(full[rows].copy())

        class Sharded:
            shape = full.shape
            is_fully_addressable = True
            addressable_shards = [Shard(slice(0, 2)), Shard(slice(0, 2)),
                                  Shard(slice(2, 4))]

        path = ck.save_checkpoint(str(tmp_path), 1, {"w": Sharded()},
                                  sharded=True)
        names = sorted(np.load(os.path.join(path, "params.npz")).files)
        assert names == ["w@@0", "w@@1"]
        _, p, _, _ = ck.load_checkpoint(path, {"w": torch.zeros(4, 4)})
        np.testing.assert_array_equal(p["w"].numpy(), full)
        _, jp, _, _ = jck.load_checkpoint(path, {"w": jnp.zeros((4, 4))})
        np.testing.assert_array_equal(np.asarray(jp["w"]), full)
        # a plain tensor under sharded=True is written whole
        path = ck.save_checkpoint(str(tmp_path), 2, {"w": torch.ones(3)},
                                  sharded=True)
        _, p, _, _ = ck.load_checkpoint(path, {"w": torch.zeros(3)})
        assert p["w"].tolist() == [1.0, 1.0, 1.0]


@pytest.fixture
def chaos_env(monkeypatch):
    def arm(spec):
        monkeypatch.setenv(chaos.ENV_VAR, spec)
        chaos.reset()

    yield arm
    monkeypatch.delenv(chaos.ENV_VAR, raising=False)
    chaos.reset()


class TestCrashConsistency:
    @pytest.mark.parametrize("phase", ["pre_write", "pre_manifest",
                                       "pre_commit"])
    def test_single_process_crash_falls_back(self, tmp_path, chaos_env,
                                             phase):
        d = str(tmp_path)
        ck.save_checkpoint(d, 1, _p(1.0))
        chaos_env(f"crash@checkpoint:phase={phase}")
        with pytest.raises(chaos.ChaosError):
            ck.save_checkpoint(d, 2, _p(2.0))
        latest = ck.latest_checkpoint(d)
        assert latest.endswith("ckpt-00000001")
        assert not [f for f in os.listdir(d) if f.startswith(".tmp")]
        step, p, _, _ = ck.load_checkpoint(latest, _p())
        assert step == 1 and p["w"].tolist() == [1.0] * 4
        os.environ.pop(chaos.ENV_VAR)
        ck.save_checkpoint(d, 2, _p(2.0))     # the retried save
        assert ck.latest_checkpoint(d).endswith("ckpt-00000002")

    def test_multi_process_torn_publish_falls_back(self, tmp_path,
                                                   chaos_env):
        """``mid_commit``: process 1 dies after moving its data files but
        before its manifest; readers skip the torn dir."""
        d = str(tmp_path)
        for pi in (0, 1):
            ck.save_checkpoint(d, 1, _p(1.0), process_index=pi,
                               process_count=2)
        ck.save_checkpoint(d, 2, _p(2.0), process_index=0, process_count=2)
        chaos_env("crash@checkpoint:phase=mid_commit")
        with pytest.raises(chaos.ChaosError):
            ck.save_checkpoint(d, 2, _p(2.0), process_index=1,
                               process_count=2)
        torn = os.path.join(d, "ckpt-00000002")
        assert os.path.isdir(torn) and not ck.is_complete(torn)
        with pytest.raises(IOError, match="incomplete"):
            ck.load_checkpoint(torn, _p())
        latest = ck.latest_checkpoint(d)
        assert latest.endswith("ckpt-00000001")
        assert jck.latest_checkpoint(d) == latest
        step, p, _, _ = ck.load_checkpoint(latest, _p())
        assert step == 1 and p["w"].tolist() == [1.0] * 4

    def test_async_checkpointer_crash_surfaces_and_falls_back(
            self, tmp_path, chaos_env):
        d = str(tmp_path)
        ac = ck.AsyncCheckpointer(d)
        ac.save(1, _p(1.0))
        ac.wait()
        chaos_env("crash@checkpoint:phase=pre_manifest")
        ac.save(2, _p(2.0))
        with pytest.raises(chaos.ChaosError):
            ac.wait()
        os.environ.pop(chaos.ENV_VAR)
        ac.close()
        assert ck.latest_checkpoint(d).endswith("ckpt-00000001")

    def test_prune_budget_counts_complete_only(self, tmp_path, chaos_env):
        d = str(tmp_path)
        for step in (1, 2):
            ck.save_checkpoint(d, step, _p(step), keep=3)
        chaos_env("crash@checkpoint:phase=mid_commit")
        with pytest.raises(chaos.ChaosError):
            ck.save_checkpoint(d, 3, _p(3.0), process_index=0,
                               process_count=2)
        os.environ.pop(chaos.ENV_VAR)
        torn = os.path.join(d, "ckpt-00000003")
        assert os.path.isdir(torn)
        ck.save_checkpoint(d, 4, _p(4.0), keep=3)     # recent: spared
        names = sorted(x for x in os.listdir(d) if x.startswith("ckpt-"))
        assert names == ["ckpt-00000001", "ckpt-00000002",
                         "ckpt-00000003", "ckpt-00000004"]
        past = ck._TORN_PRUNE_GRACE_S + 60
        assert ck._TORN_PRUNE_GRACE_S == jck._TORN_PRUNE_GRACE_S == 900.0
        os.utime(torn, (os.path.getmtime(torn) - past,
                        os.path.getmtime(torn) - past))
        ck.save_checkpoint(d, 5, _p(5.0), keep=3)
        names = sorted(x for x in os.listdir(d) if x.startswith("ckpt-"))
        assert names == ["ckpt-00000002", "ckpt-00000004",
                         "ckpt-00000005"]

    def test_resave_after_shrink_converges_torn_dir(self, tmp_path):
        d = str(tmp_path)
        for pi in range(3):                    # p0..p2 of 4: torn
            ck.save_checkpoint(d, 7, _p(1.0), process_index=pi,
                               process_count=4)
        torn = os.path.join(d, "ckpt-00000007")
        assert not ck.is_complete(torn)
        for pi in range(2):
            ck.save_checkpoint(d, 7, _p(2.0), process_index=pi,
                               process_count=2)
        assert ck.is_complete(torn)

    def test_fence_rejects_the_publish(self, tmp_path):
        d = str(tmp_path)
        ck.save_checkpoint(d, 1, _p(1.0))
        with pytest.raises(ck.CheckpointFencedError):
            ck.save_checkpoint(d, 2, _p(2.0), fence=lambda: False)
        assert ck.latest_checkpoint(d).endswith("ckpt-00000001")
        assert not [f for f in os.listdir(d) if f.startswith(".tmp")]
        ac = ck.AsyncCheckpointer(d, fence=lambda: False)
        ac.save(3, _p(3.0))
        with pytest.raises(ck.CheckpointFencedError):
            ac.wait()
        ac.close()
        ck.save_checkpoint(d, 4, _p(4.0), fence=lambda: True)
        assert ck.latest_checkpoint(d).endswith("ckpt-00000004")

    def test_meta_and_package_exports(self, tmp_path):
        path = ck.save_checkpoint(str(tmp_path), 1, _p(),
                                  meta={"layout": "single"})
        assert ck.checkpoint_meta(path) == {"layout": "single"}
        assert jck.checkpoint_meta(path) == {"layout": "single"}
        assert ck.checkpoint_meta(ck.save_checkpoint(
            str(tmp_path), 2, _p())) is None
        assert tio.latest_checkpoint is ck.latest_checkpoint
        assert tio.save_checkpoint is ck.save_checkpoint
        assert tio.load_checkpoint is ck.load_checkpoint


# ---------------------------------------------------------------------------
# an MNIST-width MLP across packages
# ---------------------------------------------------------------------------

def _mlp(P):
    L, A = P.layer, P.activation
    x = L.data("ck_x", P.data_type.dense_vector(784))
    y = L.data("ck_y", P.data_type.integer_value(10))
    h = L.fc(x, 64, act=None, name="ck_h")
    h = L.batch_norm(h, act=A.Relu(), name="ck_bn")
    out = L.fc(h, 10, act=A.Softmax(), name="ck_o")
    return L.classification_cost(out, y, name="ck_c")


def _rows(n=160, seed=0):
    rng = np.random.RandomState(seed)
    proj = np.random.RandomState(99).randn(784, 10).astype(np.float32)
    x = rng.rand(n, 784).astype(np.float32)
    y = np.argmax((x - 0.5) @ proj, axis=1)
    return [(x[i], int(y[i])) for i in range(n)]


class _Stop(Exception):
    pass


def _run(P, trainer, rows, ckpt_dir=None, stop_at=None):
    """Train over a seeded pipeline of ``rows``; the costs. ``stop_at``:
    raise out of the loop after that many batches (a preemption)."""
    seen = []

    def h(ev):
        if isinstance(ev, P.event.EndIteration):
            seen.append(ev.cost)
            if stop_at is not None and len(seen) == stop_at:
                raise _Stop
    pipe = P.pipeline.Pipeline(lambda: iter(rows), shuffle_size=32,
                               seed=4, batch_size=16, prefetch=2)
    try:
        trainer.train(reader=pipe, num_passes=2, event_handler=h,
                      checkpoint_dir=ckpt_dir)
    except _Stop:
        pass
    finally:
        pipe.close()
    return seen


@pytest.fixture
def period3():
    old = (JFLAGS.get("checkpoint_period"), TFLAGS.get("checkpoint_period"))
    JFLAGS.set("checkpoint_period", 3)
    TFLAGS.set("checkpoint_period", 3)
    yield
    JFLAGS.set("checkpoint_period", old[0])
    TFLAGS.set("checkpoint_period", old[1])


@pytest.mark.usefixtures("keep_global_seed", "period3")
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_mlp_checkpoint_resumes_across_packages(tmp_path, writer):
    """The writer package trains 4 batches (a checkpoint at step 3 with
    Momentum, batch-norm and pipeline state) and is preempted; the other
    package resumes from that directory on the exact next batch. Its
    costs equal the writer's uninterrupted run's from step 3 on (1e-4),
    and its state at the end equals that run's."""
    rows = _rows()

    def jtrainer():
        cost = _mlp(J)
        params = J.parameters.create(J.topology.Topology(cost),
                                     JKeySource(3))
        return J.trainer.SGD(cost, params, J.optimizer.Momentum(
            momentum=0.9, learning_rate=0.05))

    def ttrainer():
        # the JAX package's initial parameters, carried through the tar
        cost = _mlp(T)
        params = carry(J.parameters.create(J.topology.Topology(_mlp(J)),
                                           JKeySource(3)),
                       T.topology.Topology(cost))
        return T.trainer.SGD(cost, params, T.optimizer.Momentum(
            momentum=0.9, learning_rate=0.05))

    J.init(seed=1)
    T.init(seed=1)
    (first, first_tr), (other, other_tr) = (
        ((J, jtrainer), (T, ttrainer)) if writer == "jax"
        else ((T, ttrainer), (J, jtrainer)))
    full_tr = first_tr()
    full = _run(first, full_tr, rows)
    assert len(full) == 20
    d = str(tmp_path / "ck")
    part = _run(first, first_tr(), rows, ckpt_dir=d, stop_at=4)
    np.testing.assert_allclose(part, full[:4], rtol=0, atol=TOL)
    latest = ck.latest_checkpoint(d)
    assert latest.endswith("ckpt-00000003")
    assert ck.load_pipeline_state(latest)["version"] == 1
    resumed_tr = other_tr()
    resumed = _run(other, resumed_tr, rows, ckpt_dir=d)
    assert resumed_tr._step == 20
    np.testing.assert_allclose(resumed, full[3:], rtol=0, atol=TOL)
    # end state: parameters, Momentum state and BN statistics

    def host(v):
        return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    for a, b in ((resumed_tr.parameters.values, full_tr.parameters.values),
                 (resumed_tr.parameters.state, full_tr.parameters.state),
                 (resumed_tr.opt_state, full_tr.opt_state)):
        assert set(a) == set(b) and a
        for k in a:
            np.testing.assert_allclose(host(a[k]), host(b[k]), rtol=0,
                                       atol=TOL * max(1.0, float(np.abs(
                                           host(b[k])).max())), err_msg=k)
