"""The port's goodput ledger, step bottleneck attribution, chaos knob,
observability funnel, MFU accounting and memory tools, against the cases
of the JAX package's tests: ``test_gang_observability.py::
TestGoodputAccounting``, ``test_elastic.py::TestChaosKnob`` (the
single-process cases), ``test_request_observability.py::
TestBottleneckAttribution`` and ``TestTrainerBottleneck``,
``test_profiling.py::test_mfu_formula_and_peak_override`` and
``test_trainer_steps_carry_mfu_and_compile_count``, and
``test_foundation.py``'s memory cases. FlopCounterMode's count of one
matmul is exactly 2MNK, as ``test_lowered_cost_known_flops`` asserts of
XLA's cost model. The gang cases (a supervisor over worker processes)
wait for ROADMAP A9.
"""

import json
import math
import time

import numpy as np
import pytest
import torch

import paddle_tpu_torch as T
import paddle_tpu_torch.trainer  # noqa: F401
from paddle_tpu_torch import observe
from paddle_tpu_torch.observe import bottleneck, costs
from paddle_tpu_torch.observe import metrics as metrics_mod
from paddle_tpu_torch.observe.goodput import GoodputLedger, StepAccountant
from paddle_tpu_torch.runtime import chaos
from paddle_tpu_torch.utils import memory, sync
from paddle_tpu_torch.utils.rng import KeySource


@pytest.fixture(autouse=True)
def _fresh_observe():
    observe.reset()
    yield
    observe.reset()


# ---------------------------------------------------------------------------
# goodput (test_gang_observability.py::TestGoodputAccounting)

class TestGoodputAccounting:
    def test_accountant_splits_compile_excess_from_useful(self):
        acct = StepAccountant()
        acct.step(0.1, feed_s=0.02)
        assert acct.snapshot()["buckets"]["useful_step"] == \
            pytest.approx(0.1)
        assert acct.snapshot()["buckets"]["input_stall"] == \
            pytest.approx(0.02)
        acct.step(2.1, compile_miss=True, median_s=0.1)
        b = acct.snapshot()["buckets"]
        assert b["useful_step"] == pytest.approx(0.2)
        assert b["recompile"] == pytest.approx(2.0)
        acct2 = StepAccountant()
        acct2.step(1.5, compile_miss=True, median_s=None)
        assert acct2.snapshot()["buckets"]["recompile"] == \
            pytest.approx(1.5)

    def test_snapshot_other_bucket_closes_the_wall(self):
        t = [0.0]
        acct = StepAccountant(clock=lambda: t[0])
        acct.step(1.0)
        t[0] = 3.0
        snap = acct.snapshot()
        assert snap["buckets"]["other"] == pytest.approx(2.0)
        assert sum(snap["buckets"].values()) == \
            pytest.approx(snap["elapsed_s"])

    def test_ledger_fold_is_idempotent_and_survives_reload(self, tmp_path):
        p = str(tmp_path / "ledger.json")
        led = GoodputLedger(p)
        for _ in range(2):
            led.fold_worker(1, {"useful_step": 5.0, "recompile": 1.0})
        led.set_bucket(1, "startup", 2.0)
        led.save()
        led2 = GoodputLedger(p)
        assert led2.load_error is None
        assert led2.totals()["useful_step"] == pytest.approx(5.0)
        led2.set_bucket(2, "restart_gap", 0.5)
        led2.fold_worker(2, {"useful_step": 3.0})
        tot = led2.totals()
        assert tot["useful_step"] == pytest.approx(8.0)
        assert led2.wall_accounted() == pytest.approx(11.5)
        assert led2.goodput_fraction() == pytest.approx(8.0 / 11.5)

    def test_corrupt_ledger_starts_fresh_not_crashed(self, tmp_path):
        p = str(tmp_path / "ledger.json")
        led = GoodputLedger(p)
        led.set_bucket(1, "useful_step", 4.0)
        led.save()
        doc = json.load(open(p))
        doc["epochs"]["1"]["useful_step"] = 400.0
        json.dump(doc, open(p, "w"))
        led2 = GoodputLedger(p)
        assert led2.load_error is not None
        assert led2.totals()["useful_step"] == 0.0
        led2.set_bucket(1, "useful_step", 1.0)
        led2.save()
        assert GoodputLedger(p).load_error is None

    def test_export_publishes_fraction_and_overhead_counters(self):
        reg = metrics_mod.Registry()
        led = GoodputLedger(None)
        led.set_bucket(1, "useful_step", 8.0)
        led.set_bucket(1, "recompile", 2.0)
        led.export(reg)
        text = reg.render_prometheus()
        assert "training_goodput_fraction 0.8" in text
        assert ('training_overhead_seconds_total{bucket="recompile"} 2'
                in text)
        led.export(reg)
        assert ('training_overhead_seconds_total{bucket="recompile"} 2'
                in reg.render_prometheus())


# ---------------------------------------------------------------------------
# chaos (test_elastic.py::TestChaosKnob)

class TestChaosKnob:
    def test_crash_at_named_step_fires_once(self, monkeypatch):
        monkeypatch.setenv(chaos.ENV_VAR, "crash@step:step=3")
        chaos.reset()
        chaos.maybe_trigger("step", step=2)
        with pytest.raises(chaos.ChaosError):
            chaos.maybe_trigger("step", step=3)
        chaos.maybe_trigger("step", step=3)

    def test_rank_and_epoch_scope_from_env(self, monkeypatch):
        monkeypatch.setenv(chaos.ENV_VAR, "crash@step:step=1:rank=1:epoch=1")
        monkeypatch.setenv("PADDLE_PROCESS_ID", "1")
        monkeypatch.setenv("PADDLE_ELASTIC_EPOCH", "2")
        chaos.reset()
        chaos.maybe_trigger("step", step=1)
        monkeypatch.setenv("PADDLE_ELASTIC_EPOCH", "1")
        with pytest.raises(chaos.ChaosError):
            chaos.maybe_trigger("step", step=1)

    def test_multiple_rules_and_count(self, monkeypatch):
        monkeypatch.setenv(
            chaos.ENV_VAR,
            "crash@checkpoint:phase=pre_commit:count=2,crash@step:step=9")
        chaos.reset()
        for _ in range(2):
            with pytest.raises(chaos.ChaosError):
                chaos.maybe_trigger("checkpoint", phase="pre_commit")
        chaos.maybe_trigger("checkpoint", phase="pre_commit")
        with pytest.raises(chaos.ChaosError):
            chaos.maybe_trigger("step", step=9)

    def test_action_params_are_not_match_constraints(self, monkeypatch):
        monkeypatch.setenv(chaos.ENV_VAR, "hang@step:step=2:seconds=0.2")
        chaos.reset()
        t0 = time.perf_counter()
        chaos.maybe_trigger("step", step=2)
        assert time.perf_counter() - t0 >= 0.2

    def test_malformed_specs_ignored(self, monkeypatch):
        monkeypatch.setenv(chaos.ENV_VAR, "garbage,alsobad@,kill@step:x")
        chaos.reset()
        chaos.maybe_trigger("step", step=1)

    def test_trainer_fires_site_step_before_the_step(self, monkeypatch):
        """``crash@step:step=2`` stops the trainer with exactly 2 steps
        committed (the site fires before the step runs)."""
        monkeypatch.setenv(chaos.ENV_VAR, "crash@step:step=2")
        chaos.reset()
        tr = _smallnet()
        with pytest.raises(chaos.ChaosError):
            tr.train(T.batch(lambda: iter(_rows(32)), 8))
        assert tr._step == 2
        chaos.reset()


# ---------------------------------------------------------------------------
# bottleneck attribution (test_request_observability.py)

class TestBottleneckAttribution:
    def test_input_bound(self):
        label, fr = bottleneck.attribute_step(0.08, 0.001, 0.01)
        assert label == "input_bound"
        assert fr["input"] > 0.8
        assert sum(fr.values()) == pytest.approx(1.0)

    def test_compute_bound_without_cost_model(self):
        label, fr = bottleneck.attribute_step(0.001, 0.002, 0.2)
        assert label == "compute_bound"
        assert fr["sync"] == 0.0

    def test_sync_bound_with_cost_model(self):
        label, fr = bottleneck.attribute_step(0.001, 0.002, 0.2,
                                              est_compute_s=0.01)
        assert label == "sync_bound"
        assert fr["sync"] > 0.8

    def test_modeled_compute_caps_at_observed_sync(self):
        label, fr = bottleneck.attribute_step(0.0, 0.001, 0.05,
                                              est_compute_s=1.0)
        assert label == "compute_bound"
        assert fr["sync"] == 0.0

    def test_zero_step_is_unknown(self):
        label, fr = bottleneck.attribute_step(0.0, 0.0, 0.0)
        assert label == "unknown"
        assert all(v == 0.0 for v in fr.values())

    def test_tie_breaks_toward_earlier_stage(self):
        label, _ = bottleneck.attribute_step(0.1, 0.1, 0.0)
        assert label == "input_bound"


def _smallnet():
    L = T.layer
    img = L.data("x", T.data_type.dense_vector(8))
    lbl = L.data("y", T.data_type.integer_value(3))
    out = L.fc(img, 3, act=T.activation.Softmax(), name="sn_out")
    cost = L.classification_cost(out, lbl, name="cost")
    params = T.parameters.create(cost, KeySource(1), device="cpu")
    return T.trainer.SGD(cost=cost, parameters=params,
                         update_equation=T.optimizer.Momentum(
                             learning_rate=0.1))


def _rows(n, seed=0):
    r = np.random.RandomState(seed)
    return [(r.rand(8).astype("float32"), int(r.randint(3)))
            for _ in range(n)]


class TestTrainerObservability:
    def test_steps_carry_classification_and_fractions(self):
        recs = []
        observe.add_report_handler(recs.append)
        tr = _smallnet()
        tr.train(T.batch(lambda: iter(_rows(32)), 8), num_passes=1)
        steps = [x for x in recs if x.get("kind") == "step"]
        assert len(steps) == 4
        for s in steps:
            assert s["bottleneck"] in ("input_bound", "compute_bound",
                                       "sync_bound", "unknown")
            total = s["frac_input"] + s["frac_compute"] + s["frac_sync"]
            assert total == pytest.approx(1.0, abs=0.01)
            assert s["feed_s"] >= 0 and s["dispatch_s"] > 0
        fr = observe.default_flight_recorder().records()
        assert fr and "bottleneck" in fr[-1]
        c = observe.default_registry().get("train_steps_bottleneck_total")
        assert sum(cell.value for cell in c.series().values()) == \
            len(steps)
        passes = [x for x in recs if x.get("kind") == "pass"]
        assert len(passes) == 1 and passes[0]["examples"] == 32

    def test_trainer_steps_carry_mfu_and_compile_count(self, tmp_path,
                                                       monkeypatch):
        """The trainer's JSONL records include ``mfu`` and
        ``compile_count``, and the MFU gauge moves (a declared peak from
        PADDLE_TPU_PEAK_TFLOPS; the FLOPs counted once per signature)."""
        monkeypatch.setenv("PADDLE_TPU_PEAK_TFLOPS", "0.000001")
        path = str(tmp_path / "m.jsonl")
        observe.configure(path)
        tr = _smallnet()
        tr.train(T.batch(lambda: iter(_rows(40)), 8), num_passes=1)
        observe.configure(None)
        steps = [r for r in observe.read_jsonl(path)
                 if r.get("kind") == "step"]
        assert len(steps) == 5
        assert all(r["compile_count"] == 1 for r in steps)
        assert any(r["mfu"] > 0 for r in steps)
        assert observe.default_registry().get("train_mfu").value() > 0
        # one count per signature: fc 8->3 over 8 rows, forward and the
        # weight gradient (the input needs none)
        assert list(tr._step_flops.values()) == [2 * 8 * 8 * 3 * 2]

    def test_metrics_path_flag_configures_the_sink(self, tmp_path):
        from paddle_tpu_torch.utils.flags import GLOBAL_FLAGS
        path = str(tmp_path / "flag.jsonl")
        T.init(metrics_path=path)
        try:
            _smallnet().train(T.batch(lambda: iter(_rows(16)), 8))
            assert observe.sink_source() == "flag"
        finally:
            GLOBAL_FLAGS.set("metrics_path", "")
            observe.configure(None)
        assert [r["kind"] for r in observe.read_jsonl(path)] == \
            ["step", "step", "pass"]

    def test_attach_observability_serves_progress(self):
        import urllib.request
        tr = _smallnet()
        tr.train(T.batch(lambda: iter(_rows(16)), 8))
        srv = tr.attach_observability()
        try:
            with urllib.request.urlopen(srv.url + "/healthz",
                                        timeout=5) as r:
                doc = json.loads(r.read().decode())
        finally:
            srv.close()
        assert doc["step"] == 2 and doc["compile_count"] >= 1
        tele = tr._telemetry_doc()
        assert tele["goodput"]["buckets"]["useful_step"] > 0
        assert tele["window"]["step_time_samples"]
        assert tr.opt_state_bytes_per_device() == \
            tr.param_bytes_per_device() == 4 * (8 * 3 + 3)


class TestFunnel:
    def test_report_fans_out_and_never_raises(self, tmp_path):
        got = []

        def bad(_):
            raise RuntimeError("broken handler")
        observe.add_report_handler(bad)
        observe.add_report_handler(got.append)
        assert observe.has_consumers()
        rec = observe.report({"kind": "x"}, value=1)
        assert got == [rec] and rec == {"kind": "x", "value": 1}
        observe.remove_report_handler(bad)
        observe.remove_report_handler(got.append)
        assert not observe.has_consumers()

    def test_explicit_disable_wins_over_env(self, tmp_path, monkeypatch):
        monkeypatch.setenv("PADDLE_TPU_METRICS_PATH",
                           str(tmp_path / "env.jsonl"))
        observe.reset()
        assert observe.sink_source() == "env"
        observe.configure(None)
        assert observe.explicitly_disabled() and observe.sink() is None


# ---------------------------------------------------------------------------
# MFU and FLOP counting (test_profiling.py)

def test_counted_matmul_flops_are_2mnk():
    M, K, N = 64, 32, 16
    a, b = torch.ones(M, K), torch.ones(K, N)
    assert costs.counted_flops(lambda: a @ b) == 2 * M * K * N


def test_mfu_formula_and_peak_override(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PEAK_TFLOPS", "2.0")
    from paddle_tpu_torch.core import place
    assert place.peak_flops() == 2.0e12
    assert costs.device_peak_flops("cpu") == 2.0e12
    assert math.isclose(costs.mfu(1e9, 1e-3), 0.5)
    assert costs.mfu(None, 1e-3) is None
    assert costs.mfu(1e9, 0.0) is None
    assert costs.mfu(1e9, 1e-3, None) is None
    monkeypatch.delenv("PADDLE_TPU_PEAK_TFLOPS")
    assert costs.device_peak_flops("cpu") is None


# ---------------------------------------------------------------------------
# memory and sync (test_foundation.py)

class TestMemory:
    def test_step_memory_reports_peak(self):
        m = memory.step_memory(lambda x: (x @ x).sum(),
                               torch.ones((256, 256), dtype=torch.float32))
        assert m["peak"] >= 256 * 256 * 4
        assert m["arguments"] == 256 * 256 * 4
        assert m["outputs"] == 4

    def test_stats_on_the_cpu(self):
        assert memory.device_memory_stats("cpu") == {}
        host = memory.host_memory_stats()
        assert host.get("rss_bytes", 1) > 0

    def test_host_sync_returns_the_forced_value(self):
        t = {"a": torch.full((3,), 2.0)}
        assert sync.host_sync(t) == 6.0
        assert sync.host_sync(t, torch.tensor(1.5)) == 1.5
        assert sync.host_sync({}) == 0.0
