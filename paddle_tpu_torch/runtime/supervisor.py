"""Elastic gang supervision — training that survives worker death and
resizes its gang mid-run (counterpart of
``paddle_tpu/runtime/supervisor.py``, with its names, metrics, files and
judgments).

Reference: the Go cloud layer's elastic trainers (PAPER.md § cloud
layer: etcd-backed master task queue, fault-tolerant pserver) — any
worker may be preempted; the job continues. Composed of the blocks this
package already has:

- liveness rides the same file-mtime lease scheme as ``LeaderLock``
  (runtime/master.py): each worker heartbeats a per-rank JSON file; the
  supervisor judges a worker dead when its process exits nonzero or its
  heartbeat goes stale past ``heartbeat_window``, and WEDGED when the
  file stays fresh (the beat thread lives) but step progress stalls
  past ``wedge_window`` — a hung collective beats but does not step.
  Workers may also publish a ``health_port`` (``SGD
  .attach_observability``-style ``/healthz``); the supervisor probes it
  as a secondary judgment.
- teardown goes through ``runtime/launch.py``: stdin-watchdog close
  (the ssh remote-tree killer) + TERM-then-KILL for local gangs.
- every relaunch is a fresh **coordination epoch**: the supervisor
  bumps ``<state_dir>/epoch.json`` and stamps ``PADDLE_ELASTIC_EPOCH``
  into the new gang. With ``cluster=True`` the gang is a real
  ``torch.distributed`` process group, formed anew each epoch on a
  fresh coordinator port (the workers join it through
  ``distributed.init``): NCCL on the card, gloo on the CPU only where
  ``PADDLE_PLATFORM=cpu`` asks for it. A rank killed in such a gang
  takes its peers' collectives down with it; the supervisor judges the
  gang from the killed rank's exit and tears the survivors down
  without waiting for the group timeout. Epoch fencing closes the
  zombie hole: a worker from a torn-down gang that somehow survived the
  kill carries a stale epoch, so (a) its checkpoint commits abort
  (``io/checkpoint.py`` ``fence=``, wired automatically by
  ``SGD.train`` — write-temp + fsync + atomic rename + manifest-last
  means nothing partial is ever visible either), and (b) the master
  rejects its task RPCs (``MasterService.set_epoch_fence``).
- recovery is a restore: the relaunched trainer finds the latest
  INTACT checkpoint (torn saves are skipped), reshards it to the new
  gang size / ZeRO layout (the shards merge into whole arrays at load
  and the new layout shards them again), restores the input
  pipeline's stream position, and continues on the exact next batch.
- when a worker cannot be replaced (``replacements`` exhausted), the
  gang degrades gracefully to a smaller one (optionally snapped to
  ``valid_sizes``) instead of dying — the reference's elastic-trainer
  semantics.

Observability: ``training_restarts_total{reason}``,
``worker_liveness{rank}``, ``supervisor_state`` (coded; see STATES),
``supervisor_last_recovery_seconds``, ``supervisor_gang_size``, plus a
flight-recorder post-mortem written into ``<state_dir>/flight/`` on
every restart, and the gang plane (``gang_*`` series, the straggler
report, the goodput ledger, the training alert rules) fed by the
telemetry the workers' heartbeats carry.

The supervisor launches, watches files and processes, and kills; it
touches no device. Workers do the training.
"""

import json
import os
import shutil
import threading
import time
from typing import Dict, List, Optional, Sequence

from paddle_tpu_torch.observe import metrics as _metrics
from paddle_tpu_torch.runtime import launch as _launch
from paddle_tpu_torch.runtime.master import DecorrelatedBackoff
from paddle_tpu_torch.utils.logger import get_logger

log = get_logger("supervisor")

ENV_DIR = "PADDLE_ELASTIC_DIR"
ENV_EPOCH = "PADDLE_ELASTIC_EPOCH"

#: supervisor_state gauge encoding
STATES = {"idle": 0, "launching": 1, "running": 2, "teardown": 3,
          "backoff": 4, "done": 5, "failed": 6}

_m_restarts = _metrics.counter(
    "training_restarts_total",
    "supervised gang restarts (label reason = worker_exit|"
    "heartbeat_lost|wedged|no_heartbeat|unhealthy|attempt_timeout)")
_m_liveness = _metrics.gauge(
    "worker_liveness",
    "per-worker liveness judgment (label rank; 1 = beating, 0 = dead)")
_m_state = _metrics.gauge(
    "supervisor_state",
    "supervision state machine position (0 idle, 1 launching, "
    "2 running, 3 teardown, 4 backoff, 5 done, 6 failed)")
_m_recovery = _metrics.gauge(
    "supervisor_last_recovery_seconds",
    "kill-detection to first post-restore worker step, last restart")
_m_gang = _metrics.gauge(
    "supervisor_gang_size", "workers in the current gang incarnation")


# ---------------------------------------------------------------------------
# the coordination epoch (worker + supervisor side)
# ---------------------------------------------------------------------------

def _epoch_path(state_dir: str) -> str:
    return os.path.join(state_dir, "epoch.json")


def current_epoch(state_dir: str) -> int:
    """The fence value: the epoch of the newest gang the supervisor
    launched (0 before the first launch)."""
    try:
        with open(_epoch_path(state_dir)) as f:
            return int(json.load(f)["epoch"])
    except (OSError, ValueError, KeyError):
        return 0


def write_epoch(state_dir: str, epoch: int) -> None:
    os.makedirs(state_dir, exist_ok=True)
    tmp = f"{_epoch_path(state_dir)}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"epoch": int(epoch), "ts": time.time()}, f)
    os.replace(tmp, _epoch_path(state_dir))


def my_epoch() -> Optional[int]:
    """This worker's stamped coordination epoch (None outside a gang)."""
    v = os.environ.get(ENV_EPOCH)
    try:
        return int(v) if v else None
    except ValueError:
        return None


def fence_from_env() -> Optional[object]:
    """The checkpoint-commit fence for THIS worker: True while its
    stamped epoch is still the current one. None when not running under
    a supervisor (no env contract) — saves are then unfenced, exactly
    as before."""
    state_dir = os.environ.get(ENV_DIR)
    epoch = my_epoch()
    if not state_dir or epoch is None:
        return None
    return lambda: current_epoch(state_dir) <= epoch


# ---------------------------------------------------------------------------
# heartbeats (worker side)
# ---------------------------------------------------------------------------

def _hb_dir(state_dir: str) -> str:
    return os.path.join(state_dir, "hb")


class Heartbeat:
    """Worker-side liveness + progress beacon: an atomically-replaced
    per-rank JSON file. The file's mtime is the liveness lease (the
    background thread refreshes it every ``interval``, LeaderLock
    style); the ``step``/``step_ts`` fields are the PROGRESS signal the
    trainer updates per batch — a wedged worker keeps the lease fresh
    but stops stepping, which is precisely what the supervisor's
    ``wedge_window`` judges."""

    def __init__(self, state_dir: str, rank: int,
                 epoch: Optional[int] = None, interval: float = 0.5,
                 health_port: Optional[int] = None,
                 start_thread: bool = True):
        self.state_dir = state_dir
        self.rank = int(rank)
        self.epoch = epoch if epoch is not None else (my_epoch() or 0)
        self.interval = interval
        # epoch-scoped filename: a zombie from a torn-down gang that
        # survived the kill (ssh partition) keeps rewriting ITS file —
        # it must not alternate with the live replacement rank's beats
        # and make the supervisor judge a beating worker absent
        self.path = os.path.join(
            _hb_dir(state_dir),
            f"worker_{self.rank}_e{self.epoch}.json")
        os.makedirs(_hb_dir(state_dir), exist_ok=True)
        self._lock = threading.Lock()
        self._fields = {"rank": self.rank, "pid": os.getpid(),
                        "epoch": self.epoch}
        # ssh gangs run on another box: publish the host so the
        # supervisor's health probe targets the right machine
        if os.environ.get("PADDLE_GANG_HOST"):
            self._fields["host"] = os.environ["PADDLE_GANG_HOST"]
        if health_port is not None:
            self._fields["health_port"] = int(health_port)
        self._stop = threading.Event()
        self._last_write = 0.0
        self._telemetry_fn = None
        self._write()
        self._thread = None
        if start_thread:
            self._thread = threading.Thread(target=self._loop,
                                            daemon=True)
            self._thread.start()

    def set_telemetry(self, fn) -> None:
        """Attach a zero-arg callable returning a JSON-able dict that
        rides every heartbeat write as the record's ``telemetry`` field
        — the gang scrape transport: the supervisor reads the files it
        already watches, no extra port, works over the same shared
        filesystem as ssh-mode liveness. The callable runs on the beat
        thread OUTSIDE the field lock; keep it cheap (a registry
        snapshot + window export, not a device sync)."""
        self._telemetry_fn = fn

    @classmethod
    def from_env(cls, health_port: Optional[int] = None,
                 interval: float = 0.5) -> Optional["Heartbeat"]:
        """A Heartbeat wired from the supervisor's env contract, or
        None when this process is not a supervised gang member."""
        state_dir = os.environ.get(ENV_DIR)
        rank = os.environ.get("PADDLE_PROCESS_ID", "0")
        if not state_dir:
            return None
        return cls(state_dir, int(rank), health_port=health_port,
                   interval=interval)

    def _write(self):
        fn = self._telemetry_fn
        tele = None
        if fn is not None:
            try:
                tele = fn()
            except Exception:  # noqa: BLE001 — telemetry is best-effort
                tele = None
        with self._lock:
            rec = dict(self._fields, ts=time.time())
        if tele:
            rec["telemetry"] = tele
        tmp = f"{self.path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(rec, f)
            os.replace(tmp, self.path)
            self._last_write = time.time()
        except OSError:
            pass                 # a missed beat is survivable; dying isn't

    def _loop(self):
        while not self._stop.wait(self.interval):
            self._write()

    def beat(self, step: Optional[int] = None):
        """Record step progress (trainer: once per batch). The write
        itself is throttled to the beat-thread cadence — fast training
        steps must not pay a file rewrite (a network-filesystem round
        trip in ssh mode) per batch; the interval thread publishes the
        updated fields within one beat period anyway."""
        with self._lock:
            if step is not None:
                self._fields["step"] = int(step)
                self._fields["step_ts"] = time.time()
        if time.time() - self._last_write >= self.interval:
            self._write()

    def done(self):
        """Mark clean completion (the supervisor stops judging this
        rank's staleness) and stop the beat thread."""
        with self._lock:
            self._fields["done"] = True
        self._write()
        self.stop()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)


def read_heartbeats(state_dir: str,
                    epoch: Optional[int] = None) -> Dict[int, dict]:
    """rank -> heartbeat record (+ ``age`` seconds since last write);
    unparseable / mid-replace files are skipped. With ``epoch`` only
    records of that incarnation count (the supervisor's view — a
    zombie's stale-epoch beats are invisible, not 'absence'); without
    it the newest incarnation per rank wins (the health endpoint)."""
    out = {}
    d = _hb_dir(state_dir)
    try:
        names = os.listdir(d)
    except OSError:
        return out
    now = time.time()
    for fn in names:
        if not (fn.startswith("worker_") and fn.endswith(".json")):
            continue
        p = os.path.join(d, fn)
        try:
            with open(p) as f:
                rec = json.load(f)
            rec["age"] = now - os.path.getmtime(p)
            rank = int(rec["rank"])
        except (OSError, ValueError, KeyError):
            continue
        if epoch is not None and rec.get("epoch") != epoch:
            continue
        prev = out.get(rank)
        if prev is None or (rec.get("epoch") or 0) >= (prev.get("epoch")
                                                       or 0):
            out[rank] = rec
    return out


def _probe_healthz(port: int, host: str = "127.0.0.1",
                   timeout: float = 0.5) -> Optional[bool]:
    """True healthy / False unhealthy / None unreachable-or-unknown."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(
                f"http://{host}:{port}/healthz", timeout=timeout):
            return True
    except urllib.error.HTTPError as e:
        return False if e.code == 503 else True
    except (OSError, ValueError):
        return None


# ---------------------------------------------------------------------------
# the supervisor
# ---------------------------------------------------------------------------

class RestartBudget:
    """Restart policy for one supervised thing (a training gang, a
    serving replica): a budget of CONSECUTIVE unstable incarnations
    plus decorrelated-jitter backoff between relaunches.

    An incarnation that did real work (``stepped``) and then survived
    ``stable_window`` seconds refills the budget and cools the backoff
    when it eventually dies — routine independent preemptions spread
    over a job's lifetime must not exhaust a crash-loop guard. The
    budget is the supervisor's inline logic extracted so the fleet
    controller heals replicas under the exact same policy."""

    def __init__(self, max_restarts: int = 5,
                 stable_window: float = 300.0,
                 backoff_base: float = 0.5,
                 backoff_cap: float = 15.0):
        self.max_restarts = int(max_restarts)
        self.stable_window = float(stable_window)
        self.backoff = DecorrelatedBackoff(backoff_base, backoff_cap)
        self.restarts = 0

    def note_failure(self, *, stepped: bool, uptime_s: float):
        """Record one incarnation's death; call before consulting
        :attr:`exhausted` / :meth:`delay` for the relaunch."""
        if stepped and uptime_s >= self.stable_window:
            self.restarts = 0
            self.backoff.reset()
        self.restarts += 1

    @property
    def exhausted(self) -> bool:
        return self.restarts > self.max_restarts

    def delay(self) -> float:
        """Jittered sleep before the next relaunch."""
        return self.backoff.next()

    def reset(self):
        self.restarts = 0
        self.backoff.reset()


class Supervisor:
    """Drive a worker gang through launch → watch → teardown → relaunch
    until it completes, the restart budget runs out, or the gang cannot
    shrink any further.

    Local mode (``hosts=None``): ``nprocs`` python processes on this
    machine via ``launch.spawn_local_procs`` — ``cluster=True`` wires
    PADDLE_COORDINATOR (one process group per epoch, fresh port each
    time; on the card unless ``env_extra`` or this process's
    environment says ``PADDLE_PLATFORM=cpu``), ``cluster=False`` runs
    independent single-process workers. ``replacements`` is the
    spare-host budget: None = unlimited (a local respawn is free), an
    int = that many worker deaths can be replaced before the gang
    starts shrinking instead (graceful degradation), optionally snapped
    down to a size in ``valid_sizes`` (mesh-shape divisibility).

    SSH mode (``hosts=[...]``): one worker per host via
    ``launch.spawn_ssh_procs``; dead hosts are swapped for
    ``replacement_hosts`` entries first, dropped when the pool is dry.

    ``max_restarts`` budgets CONSECUTIVE unstable incarnations, not the
    job's lifetime: an incarnation that stepped and then survived
    ``stable_window`` seconds refills the budget and cools the backoff
    when it eventually fails — routine independent preemptions spread
    over weeks must not exhaust a crash-loop guard.

    ``master``: a MasterService/MasterClient whose ``set_epoch_fence``
    is called on every relaunch so zombies lose task-RPC rights too.
    """

    def __init__(self, argv: Sequence[str], nprocs: int, state_dir: str, *,
                 devices_per_proc: int = 1,
                 cluster: bool = False,
                 hosts: Optional[Sequence[str]] = None,
                 replacement_hosts: Sequence[str] = (),
                 ssh_port_base: int = 6007,
                 ssh_cmd: Sequence[str] = ("ssh", "-o", "BatchMode=yes"),
                 workdir: Optional[str] = None,
                 env_extra: Optional[dict] = None,
                 heartbeat_window: float = 10.0,
                 wedge_window: Optional[float] = None,
                 startup_grace: float = 120.0,
                 poll_interval: float = 0.25,
                 max_restarts: int = 5,
                 stable_window: float = 300.0,
                 backoff_base: float = 0.5,
                 backoff_cap: float = 15.0,
                 replacements: Optional[int] = None,
                 min_nprocs: int = 1,
                 valid_sizes: Optional[Sequence[int]] = None,
                 attempt_timeout: Optional[float] = None,
                 master=None,
                 probe_health: bool = True,
                 http_port: Optional[int] = None,
                 scrape_interval: float = 1.0,
                 alert_rules: Optional[Sequence] = None):
        self.argv = list(argv)
        self.state_dir = state_dir
        self.devices_per_proc = devices_per_proc
        self.cluster = cluster
        self.hosts = list(hosts) if hosts is not None else None
        self._spares = list(replacement_hosts)
        self.ssh_port_base = ssh_port_base
        self.ssh_cmd = tuple(ssh_cmd)
        self.workdir = workdir
        self.env_extra = dict(env_extra or {})
        self.nprocs = len(self.hosts) if self.hosts is not None \
            else int(nprocs)
        self.heartbeat_window = heartbeat_window
        self.wedge_window = wedge_window
        self.startup_grace = startup_grace
        self.poll_interval = poll_interval
        self.max_restarts = max_restarts
        self.stable_window = stable_window
        self._budget = RestartBudget(max_restarts, stable_window,
                                     backoff_base, backoff_cap)
        self._replacements = replacements
        self.min_nprocs = min_nprocs
        self.valid_sizes = (sorted(valid_sizes, reverse=True)
                            if valid_sizes else None)
        self.attempt_timeout = attempt_timeout
        self.master = master
        self.probe_health = probe_health
        self._state = "idle"
        self._epoch = current_epoch(state_dir)
        self._attempts: List[dict] = []
        self._last_probe: Dict[int, float] = {}
        os.makedirs(state_dir, exist_ok=True)
        # -- the gang observability plane (PR-16's fleet plane, ported
        # to training): heartbeats carry worker telemetry; the scrape
        # loop joins it into gang_* series, the straggler report, and
        # the goodput ledger, all on the default registry so the
        # supervisor's /metrics serves them.
        from paddle_tpu_torch.observe import alerts as _alerts
        from paddle_tpu_torch.observe import fleet as _fleet
        from paddle_tpu_torch.observe import goodput as _goodput
        from paddle_tpu_torch.observe import straggler as _straggler
        self.scrape_interval = float(scrape_interval)
        self.aggregator = _fleet.FleetAggregator(
            registry=_metrics.default_registry(),
            prefix="gang", entity_label="rank",
            window_keys=("step_time", "barrier_wait"),
            count_suffix="_samples")
        self.straggler = _straggler.StragglerDetector()
        self.ledger = _goodput.GoodputLedger(
            os.path.join(state_dir, "goodput_ledger.json"))
        self.alerts = _alerts.AlertEvaluator(
            _metrics.default_registry(),
            (list(alert_rules) if alert_rules is not None
             else _alerts.default_training_rules()))
        self._m_since_step = _metrics.gauge(
            "gang_seconds_since_step",
            "per-rank seconds since the last step-progress beat "
            "(label rank)")
        self._m_max_since = _metrics.gauge(
            "gang_max_seconds_since_step",
            "slowest rank's seconds since its last step-progress beat "
            "— the wedge-suspect alert's input")
        self._m_restart_rate = _metrics.gauge(
            "training_restarts_last_10m",
            "gang restarts inside the trailing 10 minutes — the "
            "restart-storm alert's input")
        self._restart_times: List[float] = []
        self._last_scrape = 0.0
        self._worker_stats: Dict[str, dict] = {}
        self.http = None
        if http_port is not None:
            from paddle_tpu_torch.observe.health import HealthServer
            self.http = HealthServer(health_fn=self.health,
                                     port=http_port,
                                     alerts_fn=self.alerts.doc)

    # -- introspection ----------------------------------------------------
    def health(self) -> dict:
        workers = {}
        for rank, rec in read_heartbeats(self.state_dir).items():
            doc = {
                "age": round(rec.get("age", -1), 3),
                "step": rec.get("step"),
                "epoch": rec.get("epoch"),
                "done": bool(rec.get("done"))}
            derived = self._worker_stats.get(str(rank), {})
            for k in ("since_step_s", "step_p50_s", "barrier_p50_s"):
                if k in derived:
                    doc[k] = derived[k]
            workers[str(rank)] = doc
        return {"state": self._state, "epoch": self._epoch,
                "gang_size": self.nprocs, "restarts": self._restarts,
                "healthy": self._state != "failed",
                "workers": workers,
                "straggler": self.straggler.report,
                "goodput": self.ledger.summary(),
                "alerts_firing": self.alerts.firing()}

    def _set_state(self, state: str):
        self._state = state
        _m_state.set(STATES[state])

    # -- gang lifecycle ---------------------------------------------------
    def _spawn(self, epoch: int):
        env = dict(self.env_extra)
        env[ENV_DIR] = self.state_dir
        env[ENV_EPOCH] = str(epoch)
        if self.hosts is not None:
            # the coordinator binds on hosts[0], so a locally-probed
            # free_port() would be a lie — walk a per-epoch offset off
            # ssh_port_base instead: never the previous incarnation's
            # port (a lingering zombie there can't wedge the rebind),
            # and deterministic for firewall rules
            return _launch.spawn_ssh_procs(
                self.hosts, self.argv,
                port=self.ssh_port_base + (epoch % 64),
                workdir=self.workdir, env_extra=env,
                ssh_cmd=self.ssh_cmd)
        return _launch.spawn_local_procs(
            self.nprocs, self.argv,
            devices_per_proc=self.devices_per_proc,
            env_extra=env, cluster=self.cluster)

    def _judge(self, procs, epoch, t_launch, attempt):
        """One monitoring sweep. Returns (verdict, failed_ranks, reason):
        verdict 'ok' (all exited 0), 'running', or 'fail'."""
        now = time.time()
        rcs = [p.poll() for p in procs]
        failed = [r for r, rc in enumerate(rcs)
                  if rc is not None and rc != 0]
        # a rank killed by a signal (preemption, the OOM killer, chaos)
        # breaks its peers' collectives, and they exit with an error
        # after it: the killed ranks alone are the gang's dead machines
        failed = [r for r in failed if rcs[r] < 0] or failed
        if failed:
            for r in failed:
                _m_liveness.set(0, rank=str(r))
            return "fail", failed, f"worker_exit:{rcs[failed[0]]}"
        if all(rc == 0 for rc in rcs):
            return "ok", [], None
        hbs = read_heartbeats(self.state_dir, epoch)
        for rank, p in enumerate(procs):
            if p.poll() == 0:
                continue                       # clean exit, no judgment
            rec = hbs.get(rank)
            if rec is None:
                # nothing from THIS incarnation yet: imports and the
                # process group's rendezvous take a while — the startup
                # grace bounds it
                if now - t_launch > self.startup_grace:
                    _m_liveness.set(0, rank=str(rank))
                    return "fail", [rank], "no_heartbeat"
                continue
            if attempt.get("t_first_step") is None and "step" in rec:
                attempt["t_first_step"] = now
            if rec.get("done"):
                _m_liveness.set(1, rank=str(rank))
                continue
            if rec.get("age", 0.0) > self.heartbeat_window:
                _m_liveness.set(0, rank=str(rank))
                return "fail", [rank], "heartbeat_lost"
            _m_liveness.set(1, rank=str(rank))
            if (self.wedge_window is not None
                    and rec.get("step_ts") is not None
                    and now - rec["step_ts"] > self.wedge_window):
                return "fail", [rank], "wedged"
            port = rec.get("health_port")
            if (self.probe_health and port
                    and now - self._last_probe.get(rank, 0.0) > 2.0):
                self._last_probe[rank] = now
                if _probe_healthz(port, rec.get("host")
                                  or "127.0.0.1") is False:
                    return "fail", [rank], "unhealthy"
        if (self.attempt_timeout is not None
                and now - t_launch > self.attempt_timeout):
            return "fail", list(range(len(procs))), "attempt_timeout"
        return "running", [], None

    @property
    def _restarts(self) -> int:
        """Consecutive-unstable restart count (the budget owns it)."""
        return self._budget.restarts

    def _post_mortem(self, reason, failed_ranks, epoch):
        """Flight-recorder artifact for this restart: the judgment, the
        last heartbeats, and the standard config/env/metrics snapshot."""
        from paddle_tpu_torch import observe
        rec = observe.default_flight_recorder()
        rec.record({"kind": "supervisor_restart", "epoch": epoch,
                    "reason": reason, "failed_ranks": failed_ranks,
                    "gang_size": self.nprocs,
                    "heartbeats": read_heartbeats(self.state_dir),
                    "goodput": self.ledger.summary(),
                    "straggler": self.straggler.report,
                    "alerts_firing": self.alerts.firing()})
        rec.dump(path=os.path.join(self.state_dir, "flight",
                                   f"restart_epoch{epoch:04d}.json"),
                 reason=f"gang restart: {reason}")

    # -- the gang scrape (telemetry -> gang_* series + ledger) -------------
    def _scrape(self, epoch: int, t_launch: float,
                final: bool = False):
        """Join the current incarnation's heartbeat telemetry into the
        observability plane: per-rank registry snapshots through the
        aggregator (gang_* series), raw step/barrier windows through
        the straggler detector, worker goodput buckets + the
        supervisor-attributed startup span into the ledger, then one
        alert evaluation round. Throttled to ``scrape_interval`` so the
        poll loop's cadence stays the liveness judge's; ``final`` forces
        a round (verdict just broke — fold the last telemetry before
        the heartbeat dir is cleared)."""
        now = time.time()
        if not final and now - self._last_scrape < self.scrape_interval:
            return
        self._last_scrape = now
        hbs = read_heartbeats(self.state_dir, epoch)
        per_rank: Dict[str, dict] = {}
        since: List[float] = []
        stats: Dict[str, dict] = {}
        gp_src = None
        for rank, rec in sorted(hbs.items()):
            tele = rec.get("telemetry") or {}
            state = "done" if rec.get("done") else "ok"
            self.aggregator.observe_replica(
                str(rank), state=state,
                health={"window": tele.get("window") or {}},
                snapshot=tele.get("snapshot") or {})
            win = tele.get("window") or {}
            per_rank[str(rank)] = {
                "step": [v for _, v in
                         (win.get("step_time_samples") or ())],
                "barrier": [v for _, v in
                            (win.get("barrier_wait_samples") or ())]}
            stats[str(rank)] = {"step": rec.get("step"),
                                "done": bool(rec.get("done")),
                                "age": round(rec.get("age", -1), 3)}
            if rec.get("step_ts") is not None and not rec.get("done"):
                s = max(0.0, now - rec["step_ts"])
                self._m_since_step.set(round(s, 3), rank=str(rank))
                stats[str(rank)]["since_step_s"] = round(s, 3)
                since.append(s)
            gp = tele.get("goodput")
            if gp and (gp_src is None or rank < gp_src[0]):
                gp_src = (rank, gp)
        self._m_max_since.set(round(max(since), 3) if since else 0.0)
        rep = self.straggler.update(per_rank)
        for rank, pr in rep.get("per_rank", {}).items():
            if rank in stats:
                stats[rank].update(
                    step_p50_s=pr.get("step_p50_s"),
                    barrier_p50_s=pr.get("barrier_p50_s"))
        self._worker_stats = stats
        if gp_src is not None:
            # one worker's accounting stands for the gang: the ranks
            # run the same synchronous loop, and summing N replicated
            # clocks would count the same wall N times
            rank, gp = gp_src
            self.ledger.fold_worker(epoch, gp.get("buckets") or {})
            t0 = gp.get("t_start_wall")
            if t0:
                self.ledger.set_bucket(epoch, "startup",
                                       max(0.0, float(t0) - t_launch))
        self.aggregator.finish_scrape()
        cut = now - 600.0
        self._restart_times = [t for t in self._restart_times
                               if t >= cut]
        self._m_restart_rate.set(len(self._restart_times))
        self.ledger.export()
        self.ledger.save()
        self.alerts.evaluate()

    def _prune_ranks(self, keep: int):
        """Stale-sample hygiene before each (re)launch: a shrink or
        replacement leaves the departed ranks' per-rank gauges frozen
        at their last value — ``Metric.remove()`` them so the next
        scrape serves survivors only."""
        for m in (_m_liveness, self._m_since_step):
            snap = m.series()
            for labels in list(snap):
                d = dict(labels)
                try:
                    rank = int(d.get("rank", -1))
                except (TypeError, ValueError):
                    continue
                if rank >= keep:
                    m.remove(**d)
        for name in list(self.aggregator.members()):
            try:
                rank = int(name)
            except ValueError:
                continue
            if rank >= keep:
                self.aggregator.drop_replica(name)
                self.aggregator.forget_state(name)

    def _next_gang(self, failed_ranks: List[int]) -> bool:
        """Replacement-host injection / graceful shrink. Returns False
        when the gang cannot be re-formed within min_nprocs."""
        nfail = max(1, len(failed_ranks))
        if self.hosts is not None:
            dead = [self.hosts[r] for r in failed_ranks
                    if r < len(self.hosts)] or [self.hosts[-1]]
            for h in dead:
                if self._spares:
                    sub = self._spares.pop(0)
                    log.warning("supervisor: replacing dead host %s "
                                "with %s", h, sub)
                    self.hosts[self.hosts.index(h)] = sub
                else:
                    log.warning("supervisor: no replacement for %s — "
                                "shrinking gang", h)
                    self.hosts.remove(h)
            self.nprocs = len(self.hosts)
        else:
            covered = nfail
            if self._replacements is not None:
                covered = min(nfail, self._replacements)
                self._replacements -= covered
            short = nfail - covered
            if short:
                log.warning("supervisor: %d worker(s) not replaceable — "
                            "shrinking gang %d -> %d", short,
                            self.nprocs, self.nprocs - short)
            self.nprocs -= short
        if self.valid_sizes is not None:
            snapped = next((s for s in self.valid_sizes
                            if s <= self.nprocs), 0)
            if snapped != self.nprocs:
                log.warning("supervisor: snapping gang size %d -> %d "
                            "(valid mesh sizes)", self.nprocs, snapped)
            self.nprocs = snapped
            if self.hosts is not None:
                self.hosts = self.hosts[:snapped]
        _m_gang.set(self.nprocs)
        return self.nprocs >= self.min_nprocs

    # -- the supervision loop ---------------------------------------------
    def run(self, total_timeout: Optional[float] = None) -> dict:
        """Supervise until success or give-up; returns a result dict:
        ``ok``, ``reason`` (on failure), ``restarts``, ``epoch``,
        ``attempts`` (per-incarnation history with detection and
        first-post-restore-step timestamps — recovery_seconds rides on
        every attempt after a restart)."""
        t_end = (time.time() + total_timeout
                 if total_timeout is not None else None)
        while True:
            epoch = current_epoch(self.state_dir) + 1
            write_epoch(self.state_dir, epoch)
            self._epoch = epoch
            if self.master is not None:
                self.master.set_epoch_fence(epoch)
            # stale beats from the previous incarnation must not count
            shutil.rmtree(_hb_dir(self.state_dir), ignore_errors=True)
            self._last_probe.clear()
            self._prune_ranks(self.nprocs)
            self._set_state("launching")
            _m_gang.set(self.nprocs)
            log.info("supervisor: launching gang epoch %d (%d workers)",
                     epoch, self.nprocs)
            procs = self._spawn(epoch)
            t_launch = time.time()
            prev_detect = (self._attempts[-1].get("t_detect")
                           if self._attempts else None)
            if prev_detect:
                # detection -> this launch: teardown + post-mortem +
                # backoff, attributed to the epoch that pays for it
                self.ledger.set_bucket(epoch, "restart_gap",
                                       t_launch - prev_detect)
            attempt = {"epoch": epoch, "nprocs": self.nprocs,
                       "t_launch": t_launch, "t_first_step": None}
            self._set_state("running")
            while True:
                time.sleep(self.poll_interval)
                verdict, failed, reason = self._judge(
                    procs, epoch, t_launch, attempt)
                if verdict != "running":
                    break
                self._scrape(epoch, t_launch)
                if t_end is not None and time.time() > t_end:
                    verdict, failed = "fail", list(range(len(procs)))
                    reason = "total_timeout"
                    break
            t_detect = time.time()
            # fold the incarnation's last telemetry before the next
            # epoch clears the heartbeat dir
            self._scrape(epoch, t_launch, final=True)
            if self._attempts and self._attempts[-1].get("t_detect") \
                    and attempt["t_first_step"]:
                rec_s = attempt["t_first_step"] \
                    - self._attempts[-1]["t_detect"]
                attempt["recovery_seconds"] = round(rec_s, 3)
                _m_recovery.set(rec_s)
            if verdict == "ok":
                attempt["rcs"] = [p.returncode for p in procs]
                self._attempts.append(attempt)
                self._set_state("done")
                log.info("supervisor: gang epoch %d completed after %d "
                         "restart(s)", epoch, self._restarts)
                return {"ok": True, "restarts": self._restarts,
                        "epoch": epoch, "attempts": self._attempts}
            attempt.update(reason=reason, failed_ranks=failed,
                           t_detect=t_detect)
            self._attempts.append(attempt)
            self._set_state("teardown")
            log.warning("supervisor: gang epoch %d failed (%s, ranks "
                        "%s) — tearing down", epoch, reason, failed)
            _m_restarts.inc(reason=(reason or "unknown").split(":")[0])
            self._restart_times.append(time.time())
            self._m_restart_rate.set(len(self._restart_times))
            self._post_mortem(reason, failed, epoch)
            _launch.terminate_procs(procs)
            # a long-stable incarnation failing is a NEW fault, not a
            # crash loop: the budget refills and the backoff cools
            # (see RestartBudget)
            self._budget.note_failure(
                stepped=attempt["t_first_step"] is not None,
                uptime_s=t_detect - t_launch)
            fail_why = None
            if reason == "total_timeout" or (
                    t_end is not None and time.time() > t_end):
                fail_why = "total_timeout"
            elif self._budget.exhausted:
                fail_why = "max_restarts"
            elif reason == "attempt_timeout":
                # a whole-gang timeout names no dead machine: retry the
                # SAME gang instead of debiting N hosts/replacements
                # for one slow incarnation
                pass
            elif not self._next_gang(failed):
                fail_why = "gang_too_small"
            if fail_why:
                self._set_state("failed")
                log.error("supervisor: giving up (%s) after %d "
                          "restart(s)", fail_why, self._restarts)
                return {"ok": False, "reason": fail_why,
                        "restarts": self._restarts, "epoch": epoch,
                        "attempts": self._attempts}
            self._set_state("backoff")
            delay = self._budget.delay()
            log.info("supervisor: restart %d/%d in %.2fs (gang -> %d)",
                     self._restarts, self.max_restarts, delay,
                     self.nprocs)
            time.sleep(delay)

    def close(self):
        if self.http is not None:
            self.http.close()
