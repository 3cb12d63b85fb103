"""The port's training-gang observability plane against ``paddle_tpu``'s,
on the CPU: the cases of ``tests/test_gang_observability.py`` that the
gang supervisor carries.

- ``judge_gang`` on the reference's six ``TestStragglerJudgment``
  windows gives equal reports, and ``StragglerDetector`` renders equal
  gauges.
- The ``TestGangScrape`` runs (a chaos kill with its goodput ledger and
  survivor-only series, wall coverage under a restart, straggler
  attribution, the wedge alert firing then resolving, a shrink pruning
  the departed ranks' series) go through both packages' ``Supervisor``
  with the reference file's stdlib workers (``_write_gang_worker``,
  which embed the ``Heartbeat.set_telemetry`` record): verdicts,
  restarts, gang sizes, the ranks and series served, the ledger's
  epochs and buckets, the straggler verdicts and the alert transitions
  are equal. Seconds are held to the reference's bounds on each side,
  never to each other.
- ``TestTrainerTelemetry``: each package's ``SGD.train`` under the
  supervisor's env contract puts a telemetry document in its heartbeat
  with the same keys, ``barrier_wait_samples`` included.
"""

import importlib
import json
import os
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu import observe as jobserve
from paddle_tpu.observe import alerts as jalerts
from paddle_tpu.observe import goodput as jgoodput
from paddle_tpu.observe import metrics as jmetrics
from paddle_tpu.observe import straggler as jstraggler
from paddle_tpu.runtime import supervisor as jsup
from paddle_tpu_torch import observe as tobserve
from paddle_tpu_torch.observe import alerts as talerts
from paddle_tpu_torch.observe import goodput as tgoodput
from paddle_tpu_torch.observe import metrics as tmetrics
from paddle_tpu_torch.observe import straggler as tstraggler
from paddle_tpu_torch.runtime import supervisor as tsup
from tests.test_gang_observability import _write_gang_worker

SIDES = ("jax", "port")
SUP = {"jax": jsup, "port": tsup}
OBSERVE = {"jax": jobserve, "port": tobserve}
METRICS = {"jax": jmetrics, "port": tmetrics}
ALERTS = {"jax": jalerts, "port": talerts}
GOODPUT = {"jax": jgoodput, "port": tgoodput}
STRAGGLER = {"jax": jstraggler, "port": tstraggler}


@pytest.fixture(autouse=True)
def _clean_observe():
    """The supervisors' gauges land in each package's default registry:
    every test starts from cleared planes."""
    for obs in OBSERVE.values():
        obs.reset()
    yield
    for obs in OBSERVE.values():
        obs.reset()


def both(fn):
    """``fn(side)`` for both packages at once (threads: a supervisor
    spends its time waiting on its gang)."""
    with ThreadPoolExecutor(len(SIDES)) as ex:
        futs = {side: ex.submit(fn, side) for side in SIDES}
        return {side: f.result() for side, f in futs.items()}


# ---------------------------------------------------------------------------
# straggler attribution (pure)

WINDOWS = {
    # rank 1 arrives last: ITS wait is ~0 while the peers wait for it
    "barrier_rule": ({
        "0": {"step": [0.1] * 6, "barrier": [0.2] * 6},
        "1": {"step": [0.1] * 6, "barrier": [0.001] * 6},
        "2": {"step": [0.1] * 6, "barrier": [0.21] * 6}}, 1, "barrier"),
    "balanced": ({
        "0": {"step": [0.1, 0.11, 0.1, 0.12], "barrier": [0.01] * 4},
        "1": {"step": [0.11, 0.1, 0.12, 0.1], "barrier": [0.012] * 4}},
        None, None),
    # no barrier data: step-time dominance attributes
    "step_fallback": ({
        "0": {"step": [0.05] * 8, "barrier": []},
        "1": {"step": [0.30] * 8, "barrier": []}}, 1, "step_time"),
    # per-rank p50s 0.1 and 0.3: skew 0.2, not a pooled ~0
    "skew_per_rank": ({
        "0": {"step": [0.1] * 8, "barrier": []},
        "1": {"step": [0.3] * 8, "barrier": []}}, 1, "step_time"),
    "too_few_samples": ({
        "0": {"step": [0.1], "barrier": []},
        "1": {"step": [9.9], "barrier": []}}, None, None),
}


class TestStragglerJudgment:
    @pytest.mark.parametrize("case", sorted(WINDOWS))
    def test_reports_equal(self, case):
        windows, rank, rule = WINDOWS[case]
        reps = {s: STRAGGLER[s].judge_gang(windows) for s in SIDES}
        assert reps["port"] == reps["jax"]
        rep = reps["port"]
        assert (rep["straggler_rank"], rep["rule"]) == (rank, rule)
        if case == "skew_per_rank":
            assert rep["skew"]["p50"] == pytest.approx(0.2, abs=1e-6)
        if case == "too_few_samples":
            assert rep["skew"]["p50"] == 0.0

    def test_judge_knobs_equal(self):
        windows = WINDOWS["step_fallback"][0]
        for kw in ({"margin": 10.0}, {"min_samples": 9},
                   {"wait_floor_s": 0.5, "margin": 1.5}):
            assert tstraggler.judge_gang(windows, **kw) == \
                jstraggler.judge_gang(windows, **kw)

    def test_detector_publishes_gauges(self):
        texts, reports = {}, {}
        for side in SIDES:
            reg = METRICS[side].Registry()
            det = STRAGGLER[side].StragglerDetector(registry=reg)
            det.update({"0": {"step": [0.05] * 8, "barrier": []},
                        "1": {"step": [0.30] * 8, "barrier": []}})
            first = reg.render_prometheus()
            det.update({"0": {"step": [0.1] * 8, "barrier": []},
                        "1": {"step": [0.1] * 8, "barrier": []}})
            texts[side] = (first, reg.render_prometheus())
            reports[side] = det.report
        assert texts["port"] == texts["jax"]
        assert reports["port"] == reports["jax"]
        first, second = texts["port"]
        assert 'gang_step_skew_seconds{q="p50"} 0.25' in first
        assert "gang_straggler_rank 1" in first
        assert "gang_straggler_rank -1" in second


# ---------------------------------------------------------------------------
# gang runs under both supervisors (stdlib subprocess workers)


def _mk_sup(side, worker, tmp_path, nprocs, **kw):
    kw.setdefault("heartbeat_window", 3.0)
    kw.setdefault("startup_grace", 20.0)
    kw.setdefault("poll_interval", 0.05)
    kw.setdefault("backoff_base", 0.05)
    kw.setdefault("backoff_cap", 0.2)
    kw.setdefault("scrape_interval", 0.05)
    return SUP[side].Supervisor([worker], nprocs=nprocs,
                                state_dir=str(tmp_path / side / "state"),
                                **kw)


def _ledger(side, tmp_path):
    led = GOODPUT[side].GoodputLedger(
        str(tmp_path / side / "state" / "goodput_ledger.json"))
    assert led.load_error is None
    return led


class TestGangScrape:
    def test_chaos_kill_ledger_and_survivor_metrics(self, tmp_path):
        """SIGKILL one rank, let the gang shrink (no replacement): the
        live /metrics serves gang_* for the survivor only, the ledger
        holds both epochs with the restart gap in the post-kill epoch,
        and the post-mortem is goodput- and straggler-stamped."""
        worker = _write_gang_worker(tmp_path, """
            slow = 0.09 if rank == 1 else 0.03
            for step in range(30):
                beat(step, tele(steps=[slow] * min(step + 1, 8),
                                buckets={"useful_step": 0.03 * step},
                                counters={"train_steps_total": step}))
                if rank == 1 and epoch == 1 and step == 6:
                    os.kill(os.getpid(), signal.SIGKILL)
                time.sleep(0.03)
                if step >= 12 and (rank != 1 or epoch != 1):
                    break
            finish(tele(steps=[slow] * 8,
                        buckets={"useful_step": 0.03 * step}))
        """)

        def one(side):
            s = _mk_sup(side, worker, tmp_path, 2, max_restarts=2,
                        replacements=0, valid_sizes=[2, 1], http_port=0)
            try:
                res = s.run(total_timeout=60)
                url = f"http://127.0.0.1:{s.http.port}/metrics"
                text = urllib.request.urlopen(url, timeout=5).read().decode()
            finally:
                s.close()
            parsed = METRICS[side].parse_prometheus(text)
            gp = _ledger(side, tmp_path).summary()
            flight = json.load(open(tmp_path / side / "state" / "flight" /
                                    "restart_epoch0001.json"))
            pm = [r for r in flight["last_steps"]
                  if r.get("kind") == "supervisor_restart"][-1]
            return {
                "ok": res["ok"], "restarts": res["restarts"],
                "nprocs": [a["nprocs"] for a in res["attempts"]],
                "since_ranks": sorted({r["labels"].get("rank") for r in
                                       parsed["gang_seconds_since_step"]
                                       ["series"]}),
                "steps_served": parsed["gang_train_steps_total"]["series"][
                    0]["value"] > 0,
                "goodput_served": "training_goodput_fraction" in parsed,
                "epochs": sorted(gp["epochs"]),
                "gap_post_kill": gp["epochs"]["2"].get("restart_gap", 0) > 0,
                "startup_e1": gp["epochs"]["1"].get("startup", 0) > 0,
                "useful": gp["totals"]["useful_step"] > 0,
                "pm": sorted(k for k in ("goodput", "straggler") if k in pm),
                "pm_startup": pm["goodput"]["epochs"]["1"]["startup"] > 0}
        got = both(one)
        assert got["port"] == got["jax"]
        assert got["port"] == {
            "ok": True, "restarts": 1, "nprocs": [2, 1],
            "since_ranks": ["0"], "steps_served": True,
            "goodput_served": True, "epochs": ["1", "2"],
            "gap_post_kill": True, "startup_e1": True, "useful": True,
            "pm": ["goodput", "straggler"], "pm_startup": True}

    def test_ledger_covers_wall_clock_under_restart(self, tmp_path):
        """Launch-to-finish wall lands >= 80% in named buckets when the
        workers publish cumulative clocks every beat."""
        worker = _write_gang_worker(tmp_path, """
            for step in range(12):
                el = time.time() - _t0
                beat(step, tele(steps=[0.04] * min(step + 1, 8),
                                buckets={"useful_step": el * 0.5,
                                         "input_stall": el * 0.5}))
                if rank == 1 and epoch == 1 and step == 5:
                    os.kill(os.getpid(), signal.SIGKILL)
                time.sleep(0.04)
            finish(tele(buckets={"useful_step": (time.time()-_t0) * 0.5,
                                 "input_stall": (time.time()-_t0) * 0.5}))
        """)

        def one(side):
            s = _mk_sup(side, worker, tmp_path, 2, max_restarts=2)
            t0 = time.time()
            res = s.run(total_timeout=60)
            wall = time.time() - t0
            led = _ledger(side, tmp_path)
            tot = led.totals()
            return ((res["ok"], res["restarts"], tot["startup"] > 0,
                     tot["restart_gap"] > 0), led.wall_accounted() / wall)
        got = both(one)
        assert got["port"][0] == got["jax"][0] == (True, 1, True, True)
        assert got["port"][1] >= 0.8 and got["jax"][1] >= 0.8

    def test_straggler_attributed_on_skewed_gang(self, tmp_path):
        worker = _write_gang_worker(tmp_path, """
            slow = 0.3 if rank == 1 else 0.05
            for step in range(10):
                beat(step, tele(steps=[slow] * 8))
                time.sleep(0.04)
            finish(tele(steps=[slow] * 8))
        """)

        def one(side):
            s = _mk_sup(side, worker, tmp_path, 2, max_restarts=0)
            res = s.run(total_timeout=60)
            h = s.health()
            return (res["ok"], s.straggler.report, h["straggler"],
                    h["workers"]["1"]["step_p50_s"])
        got = both(one)
        assert got["port"] == got["jax"]
        ok, rep, hrep, p50 = got["port"]
        assert ok and rep == hrep
        assert (rep["straggler_rank"], rep["rule"]) == (1, "step_time")
        assert rep["skew"]["p50"] == pytest.approx(0.25, abs=1e-6)
        assert p50 == pytest.approx(0.3)

    def test_wedge_alert_fires_then_resolves(self, tmp_path):
        """One rank stalls step progress past the alert threshold while
        staying alive, then resumes and finishes clean: the firing ->
        resolved pair, in that order."""
        worker = _write_gang_worker(tmp_path, """
            for step in range(6):
                beat(step, tele(steps=[0.02] * 4))
                time.sleep(0.05)
            if rank == 0:
                for _ in range(18):
                    beat(5, tele(steps=[0.02] * 4), wedge=True)
                    time.sleep(0.05)
            for step in range(6, 10):
                beat(step, tele(steps=[0.02] * 4))
                time.sleep(0.05)
            finish()
        """)

        def one(side):
            rules = ALERTS[side].default_training_rules(wedge_s=0.4)
            s = _mk_sup(side, worker, tmp_path, 2, max_restarts=0,
                        alert_rules=rules)
            res = s.run(total_timeout=60)
            events = [e["event"] for e in s.alerts.events
                      if e["rule"] == "gang_wedge_suspect"]
            # resolved AFTER firing (the pair, not a flap artifact)
            return (res["ok"], sorted(set(events)),
                    events.index("firing") < events.index("resolved"))
        got = both(one)
        assert got["port"] == got["jax"] == (True, ["firing", "resolved"],
                                             True)

    def test_shrink_prunes_departed_rank_series(self, tmp_path):
        """After a 4 -> 2 shrink the next scrape serves survivor series
        only."""
        worker = _write_gang_worker(tmp_path, """
            if rank >= 2 and epoch == 1:
                for step in range(3):
                    beat(step, tele(steps=[0.05] * 4))
                    time.sleep(0.03)
                sys.exit(3)
            for step in range(8):
                beat(step, tele(steps=[0.05] * 4))
                time.sleep(0.03)
            finish()
        """)

        def one(side):
            s = _mk_sup(side, worker, tmp_path, 4, max_restarts=2,
                        replacements=0, valid_sizes=[4, 2, 1])
            res = s.run(total_timeout=60)
            text = OBSERVE[side].default_registry().render_prometheus()
            return (res["ok"], s.nprocs,
                    'gang_seconds_since_step{rank="0"}' in text,
                    'rank="2"' in text, 'rank="3"' in text,
                    sorted(s.aggregator.members()))
        got = both(one)
        assert got["port"] == got["jax"] == (True, 2, True, False, False,
                                             ["0", "1"])


# ---------------------------------------------------------------------------
# the trainer end of the telemetry contract


def _telemetry_run(pkg, tmp_path):
    """``pkg``'s SGD.train (2 passes of 2 batches) under a simulated
    supervisor env; the rank's heartbeat record."""
    from paddle_tpu_torch.utils.rng import KeySource
    L, A = pkg.layer, pkg.activation
    x = L.data("gt_x", pkg.data_type.dense_vector(4))
    lbl = L.data("gt_l", pkg.data_type.integer_value(2))
    h = L.fc(x, 8, act=A.Relu(), name="gt_h")
    o = L.fc(h, 2, act=A.Softmax(), name="gt_o")
    cost = L.classification_cost(o, lbl, name="gt_cost")
    if pkg is T:
        params = pkg.parameters.create(cost, KeySource(7), device="cpu")
    else:
        from paddle_tpu.utils.rng import KeySource as JKeySource
        params = pkg.parameters.create(cost, JKeySource(7))
    tr = pkg.trainer.SGD(
        cost=cost, parameters=params,
        update_equation=pkg.optimizer.Momentum(learning_rate=0.1))
    # one barrier: the window the supervisor's straggler join reads
    importlib.import_module(pkg.__name__ + ".distributed").barrier(
        "telemetry")

    def reader():
        rs = np.random.RandomState(3)
        for _ in range(6):
            y = int(rs.randint(2))
            yield ((rs.randn(4) + y).astype(np.float32), y)

    tr.train(reader=pkg.batch(reader, batch_size=3), num_passes=2)
    files = os.listdir(tmp_path / "hb")
    assert files == ["worker_0_e1.json"], files
    return json.load(open(tmp_path / "hb" / files[0]))


class TestTrainerTelemetry:
    def test_trainer_embeds_telemetry_in_heartbeat(self, tmp_path,
                                                   monkeypatch):
        monkeypatch.setenv("PADDLE_PROCESS_ID", "0")
        monkeypatch.setenv("PADDLE_ELASTIC_EPOCH", "1")
        recs = {}
        for side, pkg in (("jax", J), ("port", T)):
            d = tmp_path / side
            monkeypatch.setenv(tsup.ENV_DIR, str(d))
            recs[side] = _telemetry_run(pkg, d)
        shape = {}
        for side, rec in recs.items():
            tele = rec["telemetry"]
            shape[side] = (sorted(rec), rec["step"], rec["done"],
                           sorted(tele), sorted(tele["window"]),
                           sorted(tele["goodput"]),
                           sorted(tele["goodput"]["buckets"]),
                           "train_steps_total" in tele["snapshot"])
        assert shape["port"] == shape["jax"]
        assert shape["port"][3:6] == (
            ["goodput", "snapshot", "window"],
            ["barrier_wait_samples", "step_time_samples"],
            ["buckets", "t_start_wall"])
        tele = recs["port"]["telemetry"]
        assert len(tele["window"]["step_time_samples"]) == 4
        assert len(tele["window"]["barrier_wait_samples"]) >= 1
        assert tele["snapshot"]["train_steps_total"]["series"][0][
            "value"] == 4
        b = tele["goodput"]["buckets"]
        assert b["useful_step"] + b["recompile"] > 0
        assert tele["goodput"]["t_start_wall"] > 0

    def test_telemetry_off_by_env(self, tmp_path, monkeypatch):
        """PADDLE_GANG_TELEMETRY=0 keeps the beats and drops the doc."""
        monkeypatch.setenv("PADDLE_PROCESS_ID", "0")
        monkeypatch.setenv("PADDLE_ELASTIC_EPOCH", "1")
        monkeypatch.setenv("PADDLE_GANG_TELEMETRY", "0")
        monkeypatch.setenv(tsup.ENV_DIR, str(tmp_path))
        rec = _telemetry_run(T, tmp_path)
        assert "telemetry" not in rec and rec["done"] and rec["step"] == 4
