"""The port's elastic gang against ``paddle_tpu``'s, on the CPU.

- The coordination epoch, the env fence and the heartbeat files
  (``tests/test_elastic.py::TestElasticEpochFence`` and the fence cases
  that read ``fence_from_env``) through both packages.
- Every ``tests/test_elastic.py::TestSupervisor`` scenario runs through
  both packages' ``Supervisor`` with the same pure-stdlib workers (the
  reference file's ``_write_worker``): verdicts, reasons, failed ranks,
  restarts, epochs, gang sizes, flight files and the keys of the health
  and post-mortem documents are equal. Parity is never on seconds.
- ROADMAP C15: a rank killed by a signal names the gang's dead machine,
  though its peers exit with an error after it (the port's gangs are
  real process groups, where the JAX package's are independent
  processes).
- ``launch.multiprocess_cpu_supported`` (a gloo probe here).
- The trainer-driven gangs, the counterparts of
  ``tests/test_elastic_chaos.py``, run ``tests/torch_elastic_worker.py``
  as real gloo gangs (``cluster=True``, ``PADDLE_PLATFORM=cpu``): a rank
  SIGKILLed mid-run resumes bitwise the port's own uninterrupted run,
  whose trajectory lies within 1e-4 of the JAX worker's
  (``demos/elastic_worker.py``) on the same seed and data; a 4-rank ZeRO
  gang that loses a rank shrinks to 2 and restores the checkpoint
  resharded, bitwise the port's 2-rank run from that checkpoint.
"""

import json
import os
import shutil
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.io import checkpoint as jckpt
from paddle_tpu.runtime import chaos as jchaos
from paddle_tpu.runtime import master as jmaster
from paddle_tpu.runtime import supervisor as jsup
from paddle_tpu_torch.io import checkpoint as tckpt
from paddle_tpu_torch.runtime import chaos as tchaos
from paddle_tpu_torch.runtime import launch as tlaunch
from paddle_tpu_torch.runtime import master as tmaster
from paddle_tpu_torch.runtime import supervisor as tsup
from tests.test_elastic import _write_worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDES = ("jax", "port")
SUP = {"jax": jsup, "port": tsup}
CKPT = {"jax": jckpt, "port": tckpt}
MASTER = {"jax": jmaster, "port": tmaster}
ARRAY = {"jax": jnp.ones, "port": torch.ones}
PORT_WORKER = os.path.join(REPO, "tests", "torch_elastic_worker.py")
JAX_WORKER = os.path.join(REPO, "demos", "elastic_worker.py")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    """No supervisor contract, chaos rule or coordinator leaks in from
    the test process; both chaos parse caches start clean."""
    for k in (tsup.ENV_DIR, tsup.ENV_EPOCH, tchaos.ENV_VAR,
              "PADDLE_COORDINATOR"):
        monkeypatch.delenv(k, raising=False)
    jchaos.reset()
    tchaos.reset()
    yield
    jchaos.reset()
    tchaos.reset()


def both(fn):
    """``fn(side)`` for both packages at once (threads: a supervisor
    spends its time waiting on its gang)."""
    with ThreadPoolExecutor(len(SIDES)) as ex:
        futs = {side: ex.submit(fn, side) for side in SIDES}
        return {side: f.result() for side, f in futs.items()}


# ---------------------------------------------------------------------------
# the coordination epoch, the env fence, the heartbeat files


class TestElasticEpochFence:
    @pytest.mark.parametrize("side", SIDES)
    def test_env_fence_follows_epoch_file(self, tmp_path, monkeypatch,
                                          side):
        sup, ck = SUP[side], CKPT[side]
        sd = str(tmp_path)
        sup.write_epoch(sd, 1)
        monkeypatch.setenv(sup.ENV_DIR, sd)
        monkeypatch.setenv(sup.ENV_EPOCH, "1")
        fence = sup.fence_from_env()
        assert fence()                      # current incarnation
        sup.write_epoch(sd, 2)              # the supervisor moved on
        assert not fence()                  # zombie now
        with pytest.raises(ck.CheckpointFencedError):
            ck.save_checkpoint(str(tmp_path / "ck"), 5,
                               {"w": ARRAY[side](2)}, fence=fence)
        assert ck.latest_checkpoint(str(tmp_path / "ck")) is None

    def test_fence_none_outside_supervisor(self):
        assert [SUP[s].fence_from_env() for s in SIDES] == [None, None]
        assert [SUP[s].my_epoch() for s in SIDES] == [None, None]

    def test_epoch_file_and_names_equal(self, tmp_path, monkeypatch):
        for name in ("ENV_DIR", "ENV_EPOCH", "STATES"):
            assert getattr(tsup, name) == getattr(jsup, name)
        for side in SIDES:
            d = str(tmp_path / side)
            assert SUP[side].current_epoch(d) == 0
            SUP[side].write_epoch(d, 7)
            assert SUP[side].current_epoch(d) == 7
            doc = json.load(open(os.path.join(d, "epoch.json")))
            assert sorted(doc) == ["epoch", "ts"] and doc["epoch"] == 7
        monkeypatch.setenv(tsup.ENV_EPOCH, "x")
        assert [SUP[s].my_epoch() for s in SIDES] == [None, None]
        monkeypatch.setenv(tsup.ENV_EPOCH, "4")
        assert [SUP[s].my_epoch() for s in SIDES] == [4, 4]

    def test_heartbeat_records_equal(self, tmp_path, monkeypatch):
        """The beacon's file name, record keys and the epoch-filtered
        read: a zombie's stale-epoch beats are invisible to the
        supervisor's view, the newest incarnation wins the health
        view."""
        monkeypatch.setenv("PADDLE_GANG_HOST", "hA")
        recs = {}
        for side in SIDES:
            sup = SUP[side]
            sd = str(tmp_path / side)
            zombie = sup.Heartbeat(sd, 1, epoch=1, start_thread=False)
            live = sup.Heartbeat(sd, 1, epoch=2, health_port=9,
                                 start_thread=False)
            live.set_telemetry(lambda: {"window": {}})
            zombie.beat(3)
            live.beat(5)
            live._write()
            live.done()
            zombie.stop()
            names = sorted(os.listdir(os.path.join(sd, "hb")))
            view = sup.read_heartbeats(sd, epoch=2)
            newest = sup.read_heartbeats(sd)
            recs[side] = (names, {r: sorted(v) for r, v in view.items()},
                          {r: (v["epoch"], v.get("step"), v.get("done"))
                           for r, v in newest.items()},
                          sup.read_heartbeats(sd, epoch=9))
        assert recs["port"] == recs["jax"]
        names, view, newest, none = recs["port"]
        assert names == ["worker_1_e1.json", "worker_1_e2.json"]
        assert newest == {1: (2, 5, True)} and none == {}
        assert {"host", "health_port", "telemetry", "age"} <= set(view[1])

    def test_from_env_needs_the_contract(self, tmp_path, monkeypatch):
        assert [SUP[s].Heartbeat.from_env() for s in SIDES] == [None, None]
        monkeypatch.setenv(tsup.ENV_DIR, str(tmp_path))
        monkeypatch.setenv(tsup.ENV_EPOCH, "3")
        monkeypatch.setenv("PADDLE_PROCESS_ID", "2")
        for side in SIDES:
            hb = SUP[side].Heartbeat.from_env(interval=0.05)
            try:
                assert (hb.rank, hb.epoch) == (2, 3)
                assert hb._thread is not None and hb._thread.is_alive()
            finally:
                hb.stop()
            assert not hb._thread.is_alive()


# ---------------------------------------------------------------------------
# the gang supervisor over stdlib workers, both packages


def _mk_sup(side, worker, tmp_path, nprocs, **kw):
    kw.setdefault("heartbeat_window", 3.0)
    kw.setdefault("startup_grace", 20.0)
    kw.setdefault("poll_interval", 0.05)
    kw.setdefault("backoff_base", 0.05)
    kw.setdefault("backoff_cap", 0.2)
    return SUP[side].Supervisor([worker], nprocs=nprocs,
                                state_dir=str(tmp_path / side / "state"),
                                **kw)


def _outcome(res, s, state_dir) -> dict:
    """What two supervisors of one scenario must agree on: no
    timestamps, no seconds, and nothing a sweep's timing decides (the
    live ranks' beats when a gang is torn down, whether a short
    incarnation's step was seen before it finished)."""
    flight = os.path.join(state_dir, "flight")
    files = sorted(os.listdir(flight)) if os.path.isdir(flight) else []
    pm_keys = []
    for f in files:
        doc = json.load(open(os.path.join(flight, f)))
        pm = [r for r in doc["last_steps"]
              if r.get("kind") == "supervisor_restart"][-1]
        pm_keys.append((doc["reason"], sorted(pm), pm["epoch"],
                        pm["reason"], pm["failed_ranks"], pm["gang_size"]))
    h = s.health()
    return {
        "ok": res["ok"], "reason": res.get("reason"),
        "restarts": res["restarts"], "epoch": res["epoch"],
        "attempts": [{"epoch": a["epoch"], "nprocs": a["nprocs"],
                      "reason": a.get("reason"),
                      "failed_ranks": a.get("failed_ranks")}
                     for a in res["attempts"]],
        "nprocs": s.nprocs, "flight": files, "post_mortems": pm_keys,
        "health_keys": sorted(h), "state": h["state"],
        "healthy": h["healthy"], "gang_size": h["gang_size"],
        "workers": ({r: sorted(w) for r, w in h["workers"].items()}
                    if res["ok"] else None)}


def _run_both(tmp_path, body, nprocs, total_timeout=60, **kw):
    worker = _write_worker(tmp_path, body)

    def one(side):
        s = _mk_sup(side, worker, tmp_path, nprocs, **kw)
        res = s.run(total_timeout=total_timeout)
        return _outcome(res, s, str(tmp_path / side / "state")), s, res
    got = both(one)
    assert got["port"][0] == got["jax"][0]
    return got["port"][0], got["port"][1], {k: v[2] for k, v in got.items()}


class TestSupervisor:
    def test_killed_worker_detected_and_gang_restarted(self, tmp_path):
        out, _, res = _run_both(tmp_path, """
            for step in range(8):
                beat(step)
                if rank == 1 and epoch == 1 and step == 3:
                    os.kill(os.getpid(), signal.SIGKILL)
                time.sleep(0.03)
            finish()
        """, nprocs=2, max_restarts=3)
        assert out["ok"] and out["restarts"] == 1 and out["epoch"] == 2
        a0 = out["attempts"][0]
        assert a0["reason"] == "worker_exit:-9" and a0["failed_ranks"] == [1]
        # recovery (detect -> first post-restore step) was measured
        assert all(r["attempts"][1]["recovery_seconds"] > 0
                   for r in res.values())
        assert out["flight"] == ["restart_epoch0001.json"]
        assert out["post_mortems"][0][0].startswith("gang restart")

    def test_wedged_worker_detected_by_step_stall(self, tmp_path):
        out, _, _ = _run_both(tmp_path, """
            for step in range(40):
                beat(min(step, 2) if (rank == 0 and epoch == 1) else step,
                     wedge=(rank == 0 and epoch == 1 and step >= 2))
                time.sleep(0.05)
                if step >= 6 and not (rank == 0 and epoch == 1):
                    break
            finish()
        """, nprocs=2, max_restarts=2, wedge_window=0.6)
        assert out["ok"] and out["restarts"] == 1
        assert out["attempts"][0]["reason"] == "wedged"
        assert out["attempts"][0]["failed_ranks"] == [0]

    def test_shrink_when_no_replacement(self, tmp_path):
        # the first sweep comes after both lost ranks have exited, so
        # the failed ranks do not depend on which exit it saw first
        out, s, _ = _run_both(tmp_path, """
            if rank >= 2:
                sys.exit(3)          # this "host" is simply gone
            for step in range(5):
                beat(step); time.sleep(0.02)
            finish()
        """, nprocs=4, max_restarts=2, replacements=0,
            valid_sizes=[4, 2, 1], poll_interval=1.5)
        assert out["ok"] and out["restarts"] == 1
        assert out["attempts"][0]["failed_ranks"] == [2, 3]
        assert out["attempts"][1]["nprocs"] == 2 and s.nprocs == 2

    def test_stable_incarnation_refills_restart_budget(self, tmp_path):
        out, _, _ = _run_both(tmp_path, """
            for step in range(30):
                beat(step)
                time.sleep(0.03)
                if step == 12 and epoch < 4:
                    sys.exit(1)      # dies AFTER running stably
            finish()
        """, nprocs=1, max_restarts=1, stable_window=0.2)
        assert out["ok"] and out["restarts"] == 1 and out["epoch"] == 4

    def test_attempt_timeout_retries_same_gang_size(self, tmp_path):
        out, s, _ = _run_both(tmp_path, """
            if epoch == 1:
                for step in range(200):
                    beat(step); time.sleep(0.05)   # too slow: times out
            for step in range(3):
                beat(step); time.sleep(0.02)
            finish()
        """, nprocs=2, max_restarts=2, replacements=0, attempt_timeout=1.0)
        assert out["ok"]
        assert out["attempts"][0]["reason"] == "attempt_timeout"
        assert out["attempts"][0]["failed_ranks"] == [0, 1]
        assert out["attempts"][1]["nprocs"] == 2 and s.nprocs == 2

    def test_gives_up_after_max_restarts(self, tmp_path):
        out, _, _ = _run_both(tmp_path, "sys.exit(1)\n", nprocs=1,
                           max_restarts=1, startup_grace=5.0,
                           total_timeout=30)
        assert not out["ok"] and out["reason"] == "max_restarts"
        assert out["restarts"] == 2 and out["state"] == "failed"
        assert not out["healthy"]

    def test_gang_too_small_gives_up(self, tmp_path):
        out, _, _ = _run_both(tmp_path, """
            if rank == 1:
                sys.exit(2)
            for step in range(50):
                beat(step); time.sleep(0.05)
            finish()
        """, nprocs=2, max_restarts=3, replacements=0, min_nprocs=2,
            total_timeout=30)
        assert not out["ok"] and out["reason"] == "gang_too_small"
        assert out["attempts"][0]["failed_ranks"] == [1]

    def test_epoch_is_monotonic_across_supervisors(self, tmp_path):
        worker = _write_worker(tmp_path, "finish()\n")

        def one(side):
            epochs = [_mk_sup(side, worker, tmp_path, 1).run(
                total_timeout=30)["epoch"] for _ in range(2)]
            return epochs, SUP[side].current_epoch(
                str(tmp_path / side / "state"))
        got = both(one)
        assert got["port"] == got["jax"] == ([1, 2], 2)

    def test_master_fence_bumped_on_restart(self, tmp_path):
        worker = _write_worker(tmp_path, """
            if epoch == 1:
                sys.exit(1)
            finish()
        """)

        def one(side):
            svc = MASTER[side].MasterService()
            s = _mk_sup(side, worker, tmp_path, 1, max_restarts=2,
                        master=svc, startup_grace=5.0)
            res = s.run(total_timeout=30)
            return (res["ok"], res["restarts"], svc._epoch_fence,
                    svc.get_task(worker_epoch=1))
        got = both(one)
        assert got["port"] == got["jax"] == (True, 1, 2, None)

    def test_ssh_mode_replacement_host_injection(self, tmp_path):
        shim = tmp_path / "fakessh"
        shim.write_text("#!/bin/bash\nshift\nexec bash -c \"$*\"\n")
        shim.chmod(0o755)
        worker = tmp_path / "w.py"
        worker.write_text(textwrap.dedent("""
            import os, sys
            if os.environ["PADDLE_GANG_HOST"] == "hB":
                sys.exit(7)          # hB is a bad machine
        """))

        def one(side):
            s = SUP[side].Supervisor(
                [sys.executable, str(worker)], nprocs=0,
                state_dir=str(tmp_path / side / "state"),
                hosts=["hA", "hB"], replacement_hosts=["hC"],
                ssh_cmd=(str(shim),), startup_grace=20.0,
                poll_interval=0.05, backoff_base=0.05, backoff_cap=0.2,
                max_restarts=2)
            res = s.run(total_timeout=60)
            return (res["ok"], res["restarts"],
                    res["attempts"][0]["reason"], s.hosts)
        got = both(one)
        assert got["port"] == got["jax"] == (True, 1, "worker_exit:7",
                                             ["hA", "hC"])

    def test_health_doc(self, tmp_path):
        out, s, _ = _run_both(tmp_path, "finish()\n", nprocs=1,
                           total_timeout=30)
        assert out["ok"] and out["state"] == "done" and out["healthy"]
        assert s.health()["workers"]["0"]["done"]
        assert out["health_keys"] == [
            "alerts_firing", "epoch", "gang_size", "goodput", "healthy",
            "restarts", "state", "straggler", "workers"]

    def test_metrics_names_and_labels_equal(self, tmp_path):
        """The five module metrics (and the plane's own) under the
        reference's names, help strings and labels, after one restart."""
        from paddle_tpu import observe as jobs
        from paddle_tpu_torch import observe as tobs
        jobs.reset()
        tobs.reset()
        _run_both(tmp_path, """
            for step in range(4):
                beat(step)
                if rank == 0 and epoch == 1 and step == 1:
                    sys.exit(5)
                time.sleep(0.03)
            finish()
        """, nprocs=2, max_restarts=2)
        names = ("training_restarts_total", "worker_liveness",
                 "supervisor_state", "supervisor_last_recovery_seconds",
                 "supervisor_gang_size", "gang_seconds_since_step",
                 "gang_max_seconds_since_step",
                 "training_restarts_last_10m", "gang_step_skew_seconds",
                 "gang_straggler_rank")
        # label names only where a series exists whatever the sweeps saw
        labelled = ("training_restarts_total", "worker_liveness",
                    "supervisor_state", "supervisor_gang_size")
        docs = {}
        for side, obs in (("jax", jobs), ("port", tobs)):
            snap = obs.default_registry().snapshot()
            docs[side] = {n: (snap[n]["kind"], snap[n]["help"],
                              sorted({tuple(sorted(s["labels"]))
                                      for s in snap[n]["series"]})
                              if n in labelled else None)
                          for n in names}
        assert docs["port"] == docs["jax"]
        assert docs["port"]["training_restarts_total"][2] == [("reason",)]
        assert docs["port"]["worker_liveness"][2] == [("rank",)]
        jobs.reset()
        tobs.reset()


class TestKilledRankNamesTheFault:
    def test_peer_exiting_after_a_killed_rank_is_not_a_dead_machine(
            self, tmp_path):
        """ROADMAP C15. Rank 1 is SIGKILLed and rank 0, its peer in a
        collective, exits with an error just after; both have exited
        when the supervisor first looks. The JAX supervisor counts both
        as dead machines (its gang has no collectives, so a second exit
        there is a second fault); the port's names the killed rank."""
        worker = _write_worker(tmp_path, """
            flag = os.path.join(sd, "..", "killed_e%d" % epoch)
            if epoch == 1 and rank == 1:
                open(flag, "w").close()
                os.kill(os.getpid(), signal.SIGKILL)
            if epoch == 1 and rank == 0:
                while not os.path.exists(flag):
                    time.sleep(0.01)
                time.sleep(0.1)
                sys.exit(1)          # the broken collective's error
            beat(0)
            finish()
        """)

        def one(side):
            s = _mk_sup(side, worker, tmp_path, 2, poll_interval=3.0,
                        max_restarts=2, replacements=0)
            res = s.run(total_timeout=60)
            a = res["attempts"][0]
            return res["ok"], a["reason"], a["failed_ranks"], s.nprocs
        got = both(one)
        assert got["jax"] == (False, "worker_exit:1", [0, 1], 0)
        assert got["port"] == (True, "worker_exit:-9", [1], 1)


# ---------------------------------------------------------------------------
# the launcher's probe


class TestMultiprocessProbe:
    def test_gloo_probe_and_override(self, monkeypatch):
        monkeypatch.delenv("PADDLE_TPU_MULTIPROC_CPU", raising=False)
        monkeypatch.setattr(tlaunch, "_mp_cpu_supported", None)
        assert tlaunch.multiprocess_cpu_supported() is True
        assert tlaunch._mp_cpu_supported is True     # cached
        monkeypatch.setenv("PADDLE_TPU_MULTIPROC_CPU", "0")
        assert tlaunch.multiprocess_cpu_supported() is False
        monkeypatch.setenv("PADDLE_TPU_MULTIPROC_CPU", "1")
        assert tlaunch.multiprocess_cpu_supported() is True


# ---------------------------------------------------------------------------
# trainer-driven gangs on gloo (tests/test_elastic_chaos.py's cases)

GANG_ENV = {"PADDLE_PLATFORM": "cpu", "PADDLE_DIST_TIMEOUT_S": "30",
            "OMP_NUM_THREADS": "1"}


def _run_gang_direct(out, nprocs, nb, period=2):
    """One un-supervised gang (the reference trajectory)."""
    rcs = tlaunch.launch_local(
        nprocs, [PORT_WORKER], timeout=180,
        env_extra={**GANG_ENV, "ELASTIC_OUT": out, "ELASTIC_NB": str(nb),
                   "PADDLE_TPU_CHECKPOINT_PERIOD": str(period)})
    assert rcs == [0] * nprocs, rcs


def _supervise(out, nprocs, nb, chaos, period=2, **kw):
    kw.setdefault("heartbeat_window", 30.0)
    kw.setdefault("startup_grace", 120.0)
    kw.setdefault("poll_interval", 0.2)
    kw.setdefault("backoff_base", 0.1)
    kw.setdefault("backoff_cap", 0.5)
    kw.setdefault("max_restarts", 2)
    kw.setdefault("attempt_timeout", 150.0)
    s = tsup.Supervisor(
        [PORT_WORKER], nprocs=nprocs, state_dir=os.path.join(out, "state"),
        cluster=True,
        env_extra={**GANG_ENV, "ELASTIC_OUT": out, "ELASTIC_NB": str(nb),
                   "ELASTIC_STEP_SLEEP": "0.05",
                   "PADDLE_TPU_CHECKPOINT_PERIOD": str(period),
                   "PADDLE_TPU_CHAOS": chaos}, **kw)
    return s, s.run(total_timeout=400)


def _final(out, rank, epoch):
    path = os.path.join(out, f"final_rank{rank}_epoch{epoch}.npz")
    assert os.path.exists(path), sorted(os.listdir(out))
    return dict(np.load(path))


def _losses(out, rank, epoch):
    path = os.path.join(out, f"losses_rank{rank}_epoch{epoch}.jsonl")
    with open(path) as f:
        return {json.loads(ln)["step"]: json.loads(ln)["loss"]
                for ln in f if ln.strip()}


def _done(out, rank, epoch):
    return json.load(open(os.path.join(
        out, f"done_rank{rank}_epoch{epoch}.json")))


def _assert_params_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """The port's 2-rank gang, 12 steps, checkpoints every 2."""
    out = str(tmp_path_factory.mktemp("uninterrupted"))
    _run_gang_direct(out, nprocs=2, nb=12)
    return out


class TestKillWorkerMidRun:
    def test_trajectory_equals_uninterrupted_run(self, tmp_path,
                                                 uninterrupted):
        """SIGKILL rank 1 at step 5 of 12 in a 2-rank gloo gang: rank 0's
        collective breaks, the supervisor judges the gang from rank 1's
        exit, tears it down and relaunches it as epoch 2, which restores
        the latest intact checkpoint; the final parameters and every
        step epoch 2 ran are bitwise the uninterrupted gang's."""
        out = str(tmp_path / "elastic")
        s, res = _supervise(out, nprocs=2, nb=12,
                            chaos="kill@step:step=5:rank=1:epoch=1")
        assert res["ok"], res
        assert res["restarts"] == 1 and res["epoch"] == 2
        assert res["attempts"][0]["reason"] == "worker_exit:-9"
        assert res["attempts"][0]["failed_ranks"] == [1]
        assert os.listdir(os.path.join(out, "state", "flight"))
        for rank in (0, 1):
            done = _done(out, rank, 2)
            assert (done["step"], done["nprocs"], done["backend"],
                    done["device"]) == (12, 2, "gloo", "cpu")
            _assert_params_equal(_final(out, rank, 2),
                                 _final(uninterrupted, 0, 0))
        ref = _losses(uninterrupted, 0, 0)
        got = _losses(out, 0, 2)
        assert got and max(got) == 11 and min(got) <= 4
        for step, loss in got.items():
            assert loss == ref[step], (step, loss, ref[step])

    def test_uninterrupted_run_matches_the_jax_worker(self, tmp_path,
                                                      uninterrupted):
        """The port's real 2-rank gang against the JAX worker's
        replicated 2-device run on the same seed and data."""
        out = str(tmp_path / "jax")
        env = dict(os.environ, PADDLE_NUM_PROCESSES="2",
                   PADDLE_PROCESS_ID="0", PADDLE_LOCAL_CPU_DEVICES="4",
                   PADDLE_ELASTIC_EPOCH="0", ELASTIC_OUT=out,
                   ELASTIC_NB="12", PADDLE_TPU_CHECKPOINT_PERIOD="2")
        subprocess.run([sys.executable, JAX_WORKER], env=env, check=True,
                       timeout=300, stdout=subprocess.DEVNULL)
        want, got = _final(out, 0, 0), _final(uninterrupted, 0, 0)
        assert sorted(want) == sorted(got)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4,
                                       err_msg=k)
        jl, tl = _losses(out, 0, 0), _losses(uninterrupted, 0, 0)
        assert sorted(jl) == sorted(tl) == list(range(12))
        np.testing.assert_allclose([tl[s] for s in range(12)],
                                   [jl[s] for s in range(12)],
                                   rtol=0, atol=1e-4)


class TestShrinkFourToTwo:
    def test_resharded_resume_matches_two_rank_run(self, tmp_path):
        """A 4-rank ZeRO-1 gang loses rank 3 with no replacement: the
        gang degrades to 2 (valid_sizes snap), both survivors restore
        the step-4 checkpoint written by 4 ranks under data=4, resharded
        into data=2, and the continued trajectory is bitwise a plain
        2-rank gang resumed from the very same checkpoint."""
        seed = str(tmp_path / "seed")
        _run_gang_direct(seed, nprocs=4, nb=4)     # checkpoint @ step 4
        seed_ck = os.path.join(seed, "ckpt")
        latest = tckpt.latest_checkpoint(seed_ck)
        assert latest.endswith("ckpt-00000004")
        assert tckpt.checkpoint_meta(latest)["zero"]["axis_size"] == 4

        out = str(tmp_path / "elastic")
        ref = str(tmp_path / "ref")
        shutil.copytree(seed_ck, os.path.join(out, "ckpt"))
        shutil.copytree(seed_ck, os.path.join(ref, "ckpt"))
        # period=100: neither run writes a checkpoint before the kill, so
        # both resume from exactly step 4; the plain 2-rank gang runs
        # beside the supervised one
        with ThreadPoolExecutor(1) as ex:
            plain = ex.submit(_run_gang_direct, ref, nprocs=2, nb=10,
                              period=100)
            s, res = _supervise(out, nprocs=4, nb=10, period=100,
                                chaos="kill@step:step=5:rank=3:epoch=1",
                                replacements=0, valid_sizes=[4, 2],
                                min_nprocs=2)
            plain.result()
        assert res["ok"], res
        assert res["restarts"] == 1
        assert res["attempts"][0]["failed_ranks"] == [3]
        assert res["attempts"][1]["nprocs"] == 2
        for rank in (0, 1):
            done = _done(out, rank, res["epoch"])
            assert done["step"] == 10 and done["nprocs"] == 2
            _assert_params_equal(_final(out, rank, res["epoch"]),
                                 _final(ref, 0, 0))
        got = _losses(out, 0, res["epoch"])
        want = _losses(ref, 0, 0)
        assert got and min(got) == 4 and max(got) == 9
        assert got == want
