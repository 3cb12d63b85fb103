"""Elastic data-dispatch service — the Go master equivalent — and the
serving fleet's replica processes (counterpart of
``paddle_tpu/runtime/master.py``: the same names, signatures, task
states, snapshot documents and ``master_*`` metrics).

Reference: go/master/service.go — a dataset is partitioned into recordio-chunk
tasks held in todo/pending/done queues (:56-131); trainers lease tasks,
leases time out back to todo; tasks failing more than ``failure_max`` times
are discarded; state snapshots to etcd for crash recovery (:99,149-177).
Python client: python/paddle/v2/master/client.py (set_dataset/next_record).

Design: trainers are stateless task consumers (any card-holder can
die and its chunk is re-dispatched), the state store is a JSON snapshot file
(the etcd slot — swap in any kv store), and the wire protocol is
newline-delimited JSON over TCP for multi-host, or direct calls in-process.

High availability (go/master/etcd_client.go leader election +
service.go:99,166 state recovery): the MASTER itself may die. A standby
``HAMaster`` campaigns on a file-based leader lock (the etcd election
slot); on takeover it restores the task queues from the snapshot —
in-flight leases deliberately requeue, their trainers may be gone — and
publishes its address+term in the lock file. ``MasterClient`` given a
``discovery_path`` re-reads the lock on connection failure and retries
against the new leader (lease tokens keep duplicate/stale reports safe).
"""

import dataclasses
import json
import os
import random
import socket
import socketserver
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence

from paddle_tpu_torch.observe import metrics as _metrics
from paddle_tpu_torch.runtime import recordio
from paddle_tpu_torch.utils.logger import get_logger

log = get_logger("master")

# default-registry metrics, labeled by service name so several masters in
# one process (HA standby tests) stay distinguishable
_m_queue = _metrics.gauge(
    "master_task_queue_depth",
    "tasks per queue (labels: service, queue=todo|pending|done|discarded)")
_m_done = _metrics.counter("master_tasks_done_total",
                           "tasks reported done")
_m_failed = _metrics.counter("master_tasks_failed_total",
                             "tasks reported failed")
_m_discarded = _metrics.counter(
    "master_tasks_discarded_total",
    "tasks dropped after failure_max failures")
_m_expired = _metrics.counter("master_lease_expired_total",
                              "leases that timed out and requeued")
_m_passes = _metrics.counter("master_passes_total", "completed passes")
_m_task_wait = _metrics.counter(
    "master_task_wait_seconds_total",
    "client time spent polling for a task (the data-barrier wait)")
_m_fenced = _metrics.counter(
    "master_fenced_requests_total",
    "task RPCs rejected because the worker's coordination epoch is "
    "older than the fence (zombie gang members)")
_m_reconnects = _metrics.counter(
    "master_client_reconnects_total",
    "client reconnect attempts after a connection failure")


@dataclasses.dataclass
class Task:
    """One unit of dispatch: a group of chunks of one file (go/master
    Task holds recordio chunks)."""
    task_id: int
    path: str
    chunks: List[List[int]]            # [[offset, nrecords], ...]
    fail_count: int = 0
    lease: int = 0                     # lease token; stale reports rejected

    @property
    def nrecords(self):
        return sum(c[1] for c in self.chunks)

    def to_dict(self):
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d):
        return cls(**d)


class MasterService:
    """Task queues with leases (thread-safe).

    Lifecycle per epoch (pass): todo → pending(lease) → done; expired leases
    requeue; over-failed tasks are dropped (service.go task lifecycle).
    """

    def __init__(self, lease_seconds: float = 60.0, failure_max: int = 3,
                 num_passes: Optional[int] = None,
                 snapshot_path: Optional[str] = None,
                 time_fn=time.monotonic,
                 snapshot_interval: float = 0.05,
                 name: str = "master"):
        """num_passes: stop refilling after this many completed passes
        (None = refill forever; the reference's pass barriers are
        WaitPassStart/Finish, proto/ParameterService.proto:89-95).
        Snapshots are written by a debounced background thread at most
        every ``snapshot_interval`` seconds — queue mutations mark state
        dirty instead of serializing the whole queue per RPC."""
        self.name = name
        self._lock = threading.Lock()
        self._todo: List[Task] = []
        self._pending: Dict[int, tuple] = {}     # id -> (task, deadline)
        self._done: List[Task] = []
        self._discarded: List[Task] = []
        self.lease_seconds = lease_seconds
        self.failure_max = failure_max
        self.snapshot_path = snapshot_path
        self._time = time_fn
        self.num_passes = num_passes
        self._epoch = 0
        self._lease_counter = 0
        # snapshot plumbing: _version counts mutations (under _lock);
        # _snap_lock + _snap_written make concurrent writers safe and
        # monotonic (an older capture never overwrites a newer file)
        self._version = 0
        self._snap_written = -1
        self._snap_lock = threading.Lock()
        self._dirty = threading.Event()
        self._stop = threading.Event()
        # fencing hook: when set (HA mode), snapshots are written only
        # while this process still holds the leader lock — a deposed
        # zombie must not clobber the new leader's snapshot
        self.fence = None
        self.snapshot_interval = snapshot_interval
        # save-model election state: (holder trainer_id, grant expiry).
        # Deliberately NOT snapshotted — after failover re-electing a
        # saver is harmless (worst case one extra checkpoint), whereas a
        # restored stale grant could block saves for a full window.
        self._save_grant = (None, 0.0)
        # elastic epoch fence: task RPCs carrying a worker_epoch below
        # this are rejected — a zombie from a torn-down gang can never
        # lease work or commit task state (runtime/supervisor.py bumps
        # it on every gang restart). Snapshotted: a failed-over master
        # must keep fencing the same zombies.
        self._epoch_fence = 0
        if snapshot_path and os.path.exists(snapshot_path):
            self._restore()
        if snapshot_path:
            threading.Thread(target=self._snapshot_loop,
                             daemon=True).start()

    def _export_queues_locked(self):
        """Refresh the queue-depth gauges (caller holds self._lock)."""
        for queue, coll in (("todo", self._todo), ("pending", self._pending),
                            ("done", self._done),
                            ("discarded", self._discarded)):
            _m_queue.set(len(coll), service=self.name, queue=queue)

    # -- dataset -----------------------------------------------------------
    def set_dataset(self, paths: Sequence[str], chunks_per_task: int = 1):
        """Partition recordio files into tasks of ``chunks_per_task`` chunks
        each (service.go partition)."""
        tasks, tid = [], 0
        for path in paths:
            buf = []
            for offset, n in recordio.chunk_offsets(path):
                buf.append([offset, n])
                if len(buf) >= chunks_per_task:
                    tasks.append(Task(tid, path, buf))
                    tid += 1
                    buf = []
            if buf:
                tasks.append(Task(tid, path, buf))
                tid += 1
        with self._lock:
            self._todo = tasks
            self._pending.clear()
            self._done.clear()
            self._discarded.clear()
            self._epoch = 0
            self._version += 1
            self._export_queues_locked()
        self._snapshot()
        log.info("master: dataset set, %d tasks", len(tasks))

    # -- elastic epoch fencing ---------------------------------------------
    def set_epoch_fence(self, epoch: int) -> int:
        """Reject task RPCs from workers whose coordination epoch is
        below ``epoch`` (monotonic; returns the active fence). The
        supervisor calls this after every gang teardown so a zombie
        worker that survived the kill can never lease a task or commit
        one as done/failed."""
        with self._lock:
            self._epoch_fence = max(self._epoch_fence, int(epoch))
            self._version += 1
            fence = self._epoch_fence
        self._dirty.set()
        log.info("master: epoch fence now %d", fence)
        return fence

    def _fenced(self, worker_epoch) -> bool:
        """True when this RPC must be rejected. Workers that do not
        declare an epoch (pre-elastic clients) are never fenced — the
        fence is an opt-in contract between supervisor and gang."""
        if worker_epoch is None:
            return False
        with self._lock:
            fenced = int(worker_epoch) < self._epoch_fence
        if fenced:
            _m_fenced.inc(service=self.name)
        return fenced

    # -- task protocol -----------------------------------------------------
    def get_task(self, worker_epoch=None) -> Optional[Task]:
        """Lease one task; None when this pass is drained (caller should
        retry after pending tasks finish, or treat the pass as over when
        num_pending()==0)."""
        if self._fenced(worker_epoch):
            return None
        with self._lock:
            changed = self._requeue_expired_locked()
            if not self._todo:
                task = None
            else:
                task = self._todo.pop(0)
                self._lease_counter += 1
                task.lease = self._lease_counter
                self._pending[task.task_id] = (
                    task, self._time() + self.lease_seconds)
                changed = True
            if changed:
                self._version += 1
                self._export_queues_locked()
        if changed:
            # mark dirty (service.go snapshots queue transitions to etcd)
            # so a standby master can adopt fresh state on takeover;
            # expiry-only mutations count too
            self._dirty.set()
        return task

    def report_done(self, task_id: int, lease: Optional[int] = None,
                    worker_epoch=None) -> bool:
        if self._fenced(worker_epoch):
            return False       # a zombie cannot commit task state
        with self._lock:
            ent = self._pending.get(task_id)
            if ent is None or (lease is not None and ent[0].lease != lease):
                return False       # stale report from a timed-out trainer
            self._pending.pop(task_id)
            self._done.append(ent[0])
            self._maybe_finish_pass_locked()
            self._version += 1
            self._export_queues_locked()
        _m_done.inc(service=self.name)
        self._dirty.set()
        return True

    def report_failed(self, task_id: int, lease: Optional[int] = None,
                      worker_epoch=None):
        """Failed lease: requeue unless over the failure cap
        (service.go failureMax discard)."""
        if self._fenced(worker_epoch):
            return             # a zombie cannot fail a live gang's lease
        with self._lock:
            ent = self._pending.get(task_id)
            if ent is None or (lease is not None and ent[0].lease != lease):
                return             # stale report from a timed-out trainer
            self._pending.pop(task_id)
            task = ent[0]
            task.fail_count += 1
            discarded = task.fail_count >= self.failure_max
            if discarded:
                log.warning("master: task %d discarded after %d failures",
                            task.task_id, task.fail_count)
                self._discarded.append(task)
                self._maybe_finish_pass_locked()
            else:
                self._todo.append(task)
            self._version += 1
            self._export_queues_locked()
        _m_failed.inc(service=self.name)
        if discarded:
            _m_discarded.inc(service=self.name)
        self._dirty.set()

    def _requeue_expired_locked(self) -> bool:
        now = self._time()
        expired = [tid for tid, (_, dl) in self._pending.items() if dl < now]
        for tid in expired:
            task, _ = self._pending.pop(tid)
            task.fail_count += 1
            _m_expired.inc(service=self.name)
            if task.fail_count >= self.failure_max:
                self._discarded.append(task)
                _m_discarded.inc(service=self.name)
                self._maybe_finish_pass_locked()
            else:
                log.info("master: lease expired, requeueing task %d", tid)
                self._todo.append(task)
        if expired:
            self._export_queues_locked()
        return bool(expired)

    def _maybe_finish_pass_locked(self):
        if not self._todo and not self._pending:
            # pass complete: everything done/discarded flows back to todo
            # for the next pass, unless num_passes is exhausted
            self._epoch += 1
            _m_passes.inc(service=self.name)
            finished = self._done + self._discarded
            self._done, self._discarded = [], []
            if self.num_passes is not None and self._epoch >= self.num_passes:
                return                       # terminal: queues stay empty
            self._todo = finished
            for t in self._todo:
                t.fail_count = 0

    # -- save-model election ----------------------------------------------
    def request_save_model(self, trainer_id: str,
                           block_dur: float = 60.0,
                           worker_epoch=None) -> bool:
        """Elect ONE trainer to save the model: the first asker within a
        ``block_dur`` window gets True, everyone else False until the
        window expires (reference: go/master/service.go RequestSaveModel
        / python/paddle/v2/master/client.py:24 request_save_model — the
        mechanism that stops N data-parallel trainers writing N identical
        checkpoints). Re-asking while holding the grant is idempotent, so
        a saver that retries its RPC keeps its election. Epoch-fenced
        like the task RPCs: a zombie must not grab the grant and starve
        the live gang's save windows."""
        if self._fenced(worker_epoch):
            return False
        with self._lock:
            now = self._time()
            holder, expiry = self._save_grant
            if holder is not None and now < expiry and holder != trainer_id:
                return False
            self._save_grant = (trainer_id, now + block_dur)
            return True

    # -- introspection -----------------------------------------------------
    def health(self) -> dict:
        """/healthz document: queue depths + pass progress. A close()d
        master reports unhealthy (HTTP 503) — a retired dispatcher must
        drain its probers rather than keep attracting trainers."""
        with self._lock:
            changed = self._requeue_expired_locked()
            if changed:
                self._version += 1
            doc = {"service": self.name,
                   "todo": len(self._todo),
                   "pending": len(self._pending),
                   "done": len(self._done),
                   "discarded": len(self._discarded),
                   "epoch": self._epoch,
                   "epoch_fence": self._epoch_fence,
                   "healthy": not self._stop.is_set()}
        if changed:
            self._dirty.set()
        return doc

    def num_todo(self):
        with self._lock:
            return len(self._todo)

    def num_pending(self):
        with self._lock:
            changed = self._requeue_expired_locked()
            if changed:
                self._version += 1
            n = len(self._pending)
        if changed:
            self._dirty.set()
        return n

    def epoch(self):
        with self._lock:
            return self._epoch

    # -- persistence (the etcd slot) ---------------------------------------
    def _snapshot(self):
        if not self.snapshot_path:
            return
        if self.fence is not None and not self.fence():
            log.warning("master: snapshot skipped — leadership lost")
            return
        with self._lock:
            version = self._version
            state = {
                "epoch": self._epoch,
                "epoch_fence": self._epoch_fence,
                "lease_counter": self._lease_counter,
                "todo": [t.to_dict() for t in self._todo],
                # pending leases are deliberately snapshotted as todo: after
                # a master restart their trainers may be gone (service.go
                # recover path re-dispatches)
                "pending": [t.to_dict() for t, _ in self._pending.values()],
                "done": [t.to_dict() for t in self._done],
                "discarded": [t.to_dict() for t in self._discarded],
            }
        with self._snap_lock:
            # concurrent captures write in version order only — an older
            # capture must never overwrite a newer snapshot file
            if version <= self._snap_written:
                return
            tmp = (f"{self.snapshot_path}.tmp.{os.getpid()}."
                   f"{threading.get_ident()}")
            with open(tmp, "w") as f:
                json.dump(state, f)
            os.replace(tmp, self.snapshot_path)
            self._snap_written = version

    def snapshot(self):
        """Synchronous flush (set_dataset and tests use this)."""
        self._snapshot()

    def _snapshot_loop(self):
        """Debounced writer: wakes on dirty state, writes at most every
        ``snapshot_interval`` seconds regardless of RPC rate. Exits when
        close() is called (an immortal daemon thread would pin the
        service object and keep writing after shutdown)."""
        while not self._stop.is_set():
            if not self._dirty.wait(timeout=0.2):
                continue
            self._dirty.clear()
            if self._stop.is_set():
                return
            try:
                self._snapshot()
            except OSError as e:
                log.warning("master: snapshot write failed: %s", e)
            time.sleep(self.snapshot_interval)

    def close(self):
        """Stop the background snapshot writer (idempotent)."""
        self._stop.set()
        self._dirty.set()

    def _restore(self):
        with open(self.snapshot_path) as f:
            state = json.load(f)
        with self._lock:
            self._epoch = state["epoch"]
            # persisted lease counter: a failed-over master must not
            # reissue tokens that stale pre-failover reports still hold
            self._lease_counter = max(self._lease_counter,
                                      state.get("lease_counter", 0))
            self._epoch_fence = max(self._epoch_fence,
                                    state.get("epoch_fence", 0))
            self._todo = ([Task.from_dict(d) for d in state["todo"]] +
                          [Task.from_dict(d) for d in state["pending"]])
            self._pending = {}
            self._done = [Task.from_dict(d) for d in state["done"]]
            self._discarded = [Task.from_dict(d)
                               for d in state.get("discarded", [])]
            self._version += 1
            self._export_queues_locked()
        log.info("master: restored %d todo / %d done (epoch %d)",
                 len(self._todo), len(self._done), self._epoch)


# ---------------------------------------------------------------------------
# TCP wire (newline-delimited JSON) — multi-host trainers
# ---------------------------------------------------------------------------

class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        for line in self.rfile:
            try:
                req = json.loads(line)
                method = req["method"]
                svc = self.server.service            # type: ignore
                if method == "get_task":
                    t = svc.get_task(req.get("worker_epoch"))
                    resp = {"task": t.to_dict() if t else None}
                elif method == "report_done":
                    resp = {"ok": svc.report_done(req["task_id"],
                                                  req.get("lease"),
                                                  req.get("worker_epoch"))}
                elif method == "report_failed":
                    svc.report_failed(req["task_id"], req.get("lease"),
                                      req.get("worker_epoch"))
                    resp = {"ok": True}
                elif method == "set_epoch_fence":
                    resp = {"fence": svc.set_epoch_fence(req["epoch"])}
                elif method == "status":
                    resp = {"todo": svc.num_todo(),
                            "pending": svc.num_pending(),
                            "epoch": svc.epoch()}
                elif method == "metrics":
                    # poor-man's scrape endpoint: the master process's
                    # default registry in Prometheus text format
                    resp = {"text":
                            _metrics.default_registry().render_prometheus()}
                elif method == "request_save_model":
                    resp = {"ok": svc.request_save_model(
                        req["trainer_id"], req.get("block_dur", 60.0),
                        req.get("worker_epoch"))}
                else:
                    resp = {"error": f"unknown method {method}"}
            except Exception as e:                   # noqa: BLE001
                resp = {"error": str(e)}
            self.wfile.write((json.dumps(resp) + "\n").encode())
            self.wfile.flush()


class MasterServer:
    """Serve a MasterService over TCP (the ProtoServer/net-rpc slot).

    ``http_port`` (None = off, 0 = ephemeral) additionally starts an
    ``observe.HealthServer`` next to the wire protocol: ``/metrics`` is
    the process default registry (where the master gauges live) in
    Prometheus text, ``/healthz`` is ``service.health()`` — the scrape
    surface a prober hits without speaking the JSON-RPC wire."""

    def __init__(self, service: MasterService, host: str = "127.0.0.1",
                 port: int = 0, http_port: Optional[int] = None):
        self._srv = socketserver.ThreadingTCPServer((host, port), _Handler,
                                                    bind_and_activate=True)
        self._srv.daemon_threads = True
        self._srv.service = service                  # type: ignore
        self.addr = self._srv.server_address
        self.http = None
        if http_port is not None:
            from paddle_tpu_torch.observe.health import HealthServer
            try:
                self.http = HealthServer(health_fn=service.health,
                                         host=host, port=http_port)
            except Exception:
                # a failed http bind must not leak the already-bound RPC
                # socket (a retry on a fixed port would hit EADDRINUSE)
                self._srv.server_close()
                raise
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()

    def shutdown(self):
        if self.http is not None:
            self.http.close()
        self._srv.shutdown()
        self._srv.server_close()


# ---------------------------------------------------------------------------
# leader election (the etcd_client.go slot) + HA master
# ---------------------------------------------------------------------------

class LeaderLock:
    """Directory-based leader lease: the holder heartbeats ``info.json``
    inside the lock DIRECTORY; a candidate takes over only when the
    heartbeat is stale (holder dead). The info file doubles as service
    discovery: the leader publishes ``{"host", "port", "term"}`` there.

    Atomicity (the split-brain guard): acquisition is ``os.mkdir`` —
    atomic, one winner. Takeover of a stale lock first ``os.rename``s the
    dead directory aside; rename is atomic on POSIX, so of N concurrent
    candidates exactly one succeeds and the rest see ENOENT and back off
    — nobody can delete a lock a new winner just created (the unlink+
    create scheme had exactly that hole). (Reference:
    go/master/etcd_client.go campaign/lock.)

    Clock assumption: staleness compares the info file's mtime (stamped
    by the FILESYSTEM) against the candidate's ``time.time()``. On one
    host (the launch.py topology) both come from the same clock and the
    comparison is exact. On a shared filesystem with replicas on
    different hosts, clock skew between the fs server and a candidate
    shifts the perceived age by the skew — keep ``stale_after`` well
    above the worst-case skew (or run candidates on one host). Term
    fencing bounds the damage of a premature takeover to one heartbeat
    interval either way."""

    def __init__(self, path: str, stale_after: float = 3.0,
                 heartbeat_interval: float = 0.5):
        self.path = path
        self.stale_after = stale_after
        self.heartbeat_interval = heartbeat_interval
        self.term = 0
        self._stop = threading.Event()
        self._thread = None

    @property
    def info_path(self):
        return os.path.join(self.path, "info.json")

    def _heartbeat_age(self) -> Optional[float]:
        """Seconds since the holder's last heartbeat; None if no lock.
        A freshly mkdir'd lock whose info.json isn't published yet ages
        from the directory mtime, so a winner mid-publish is 'live'."""
        for p in (self.info_path, self.path):
            try:
                return time.time() - os.path.getmtime(p)
            except OSError:
                continue
        return None

    def _steal_mutex(self):
        """Serialize the check-rename-mkdir critical section among LOCAL
        candidates racing for a STALE lock: an O_EXCL sidecar file with
        its own (short) staleness. Without it, a slow candidate's rename
        could grab a lock a fast winner just re-created (the TOCTOU the
        docstring promises away). The window a dead mutex holder blocks
        others is ``stale_after`` seconds, then the mutex itself is
        steal-able by age."""
        mpath = self.path + ".steal"
        try:
            mage = time.time() - os.path.getmtime(mpath)
            if mage > self.stale_after:
                os.unlink(mpath)            # holder died mid-section
        except OSError:
            pass
        try:
            fd = os.open(mpath, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            os.close(fd)
            return mpath
        except FileExistsError:
            return None

    def try_acquire(self) -> bool:
        """One acquisition attempt. On success the caller OWNS the lock
        directory exclusively but is not yet discoverable — finish setup,
        then call ``publish(info)``."""
        import shutil

        age = self._heartbeat_age()
        if age is not None and age < self.stale_after:
            return False                       # live holder
        mutex = self._steal_mutex()
        if mutex is None:
            return False                       # another candidate mid-steal
        try:
            age = self._heartbeat_age()        # re-check INSIDE the mutex
            if age is not None and age < self.stale_after:
                return False
            if age is not None:                # stale: move the corpse aside
                dead = (f"{self.path}.dead.{os.getpid()}."
                        f"{time.monotonic_ns()}")
                try:
                    os.rename(self.path, dead)
                except OSError:
                    return False
                shutil.rmtree(dead, ignore_errors=True)
            try:
                os.mkdir(self.path)
            except FileExistsError:
                return False
            # term continuity lives in a sidecar file that survives lock
            # generations; read-increment-write is serialized by the mutex
            term_path = self.path + ".term"
            prev_term = 0
            try:
                with open(term_path) as f:
                    prev_term = int(f.read().strip() or 0)
            except (OSError, ValueError):
                pass
            self.term = prev_term + 1
            tmp = f"{term_path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                f.write(str(self.term))
            os.replace(tmp, term_path)
            return True
        finally:
            try:
                os.unlink(mutex)
            except OSError:
                pass

    def publish(self, info: dict):
        """Make this leader discoverable and start heartbeating. Call
        only after ``try_acquire`` returned True and the service is
        ready to serve."""
        tmp = f"{self.info_path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({**info, "term": self.term}, f)
        os.replace(tmp, self.info_path)
        self._stop.clear()
        self._thread = threading.Thread(target=self._beat, daemon=True)
        self._thread.start()

    def still_leader(self) -> bool:
        """Fencing check: does the published lock still carry OUR term?
        A deposed leader (frozen past stale_after, then resumed) sees a
        different term here and must stand down."""
        try:
            with open(self.info_path) as f:
                return json.load(f).get("term") == self.term
        except (OSError, ValueError):
            return False

    def _beat(self):
        while not self._stop.wait(self.heartbeat_interval):
            # fenced heartbeat: NEVER refresh a lock another leader now
            # owns — a zombie utime-ing the new leader's info.json would
            # make the lock look immortally live after that leader dies
            if not self.still_leader():
                self._stop.set()
                return
            try:
                os.utime(self.info_path)
            except OSError:
                pass

    @property
    def deposed(self) -> bool:
        """True once the heartbeat discovered another leader's term."""
        return self._stop.is_set() and self._thread is not None

    def release(self):
        import shutil

        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)
        # only the CURRENT owner may remove the lock; a deposed zombie
        # must not delete the live leader's directory
        if self.still_leader():
            shutil.rmtree(self.path, ignore_errors=True)


class HAMaster:
    """A master replica: standby until it wins the leader lock, then
    serve the task queues restored from the snapshot (in-flight leases
    requeue — their trainers may be gone, service.go recover semantics).

    Run one per replica host. ``dataset`` is only installed by the FIRST
    leader (no snapshot yet); every later leader adopts snapshot state.
    """

    def __init__(self, lock_path: str, snapshot_path: str,
                 host: str = "127.0.0.1", port: int = 0,
                 stale_after: float = 3.0, heartbeat_interval: float = 0.5,
                 lease_seconds: float = 60.0, failure_max: int = 3,
                 num_passes: Optional[int] = None,
                 dataset: Optional[Sequence[str]] = None,
                 chunks_per_task: int = 1):
        self.lock = LeaderLock(lock_path, stale_after, heartbeat_interval)
        self.snapshot_path = snapshot_path
        self.host, self.port = host, port
        self.lease_seconds = lease_seconds
        self.failure_max = failure_max
        self.num_passes = num_passes
        self.dataset = dataset
        self.chunks_per_task = chunks_per_task
        self.service: Optional[MasterService] = None
        self.server: Optional[MasterServer] = None

    def campaign(self, poll_interval: float = 0.2,
                 timeout: Optional[float] = None) -> bool:
        """Block until this replica becomes leader (True) or timeout
        (False). Ordering matters: the lock is won FIRST, then state is
        restored from the snapshot, then the server starts, and only
        then is the address published — clients can never reach a
        leader whose queues are stale or mid-restore."""
        deadline = None if timeout is None else time.time() + timeout
        while True:
            if self.lock.try_acquire():
                break
            if deadline is not None and time.time() > deadline:
                return False
            time.sleep(poll_interval)
        # exclusive owner now: build state before becoming discoverable
        # (the MasterService ctor restores the previous leader's snapshot)
        self.service = MasterService(self.lease_seconds, self.failure_max,
                                     self.num_passes, self.snapshot_path)
        if (not os.path.exists(self.snapshot_path)
                and self.dataset is not None):
            self.service.set_dataset(self.dataset, self.chunks_per_task)
        self.server = MasterServer(self.service, self.host, self.port)
        self.lock.publish({"host": self.server.addr[0],
                           "port": self.server.addr[1]})
        # fence snapshot writes on CURRENT leadership from here on
        self.service.fence = self.lock.still_leader
        log.info("master: leader term %d at %s:%d", self.lock.term,
                 self.server.addr[0], self.server.addr[1])
        return True

    def shutdown(self):
        if self.server:
            self.server.shutdown()
        if self.service:
            self.service.close()
        self.lock.release()


def discover_master(discovery_path: str) -> Optional[tuple]:
    """Resolve the current leader's (host, port) from the lock
    directory's published info."""
    try:
        with open(os.path.join(discovery_path, "info.json")) as f:
            d = json.load(f)
        return (d["host"], d["port"])
    except (OSError, ValueError, KeyError):
        return None


class DecorrelatedBackoff:
    """Exponential backoff with decorrelated jitter (the AWS
    architecture-blog scheme): each delay is uniform on
    [base, 3 x previous], capped — N clients retrying against one
    recovering master spread out instead of stampeding in lockstep,
    and the cap bounds how stale a client can get after recovery."""

    def __init__(self, base: float = 0.05, cap: float = 2.0, rng=None):
        self.base = float(base)
        self.cap = float(cap)
        self._rng = rng or random.Random()
        self._prev = self.base

    def reset(self):
        self._prev = self.base

    def next(self) -> float:
        delay = min(self.cap, self._rng.uniform(self.base,
                                                self._prev * 3.0))
        self._prev = delay
        return delay


class MasterClient:
    """Client for trainers. ``addr=None`` talks to an in-process service
    (reference: python/paddle/v2/master/client.py set_dataset/next_record
    over the C binding; here JSON/TCP or direct calls). With
    ``discovery_path`` the client resolves the leader from the HA lock
    file and transparently re-resolves + retries on connection failure
    (master failover; lease tokens make replayed reports safe).
    Reconnects back off exponentially with decorrelated jitter so N
    workers do not stampede a recovering master, and each connect
    attempt is bounded by ``connect_timeout`` (a black-holed address
    must not eat the whole failover budget in one attempt).

    ``worker_epoch`` (default: the PADDLE_ELASTIC_EPOCH env the
    supervisor stamps on every gang member) rides on every task RPC —
    after a gang restart the master's epoch fence silently retires
    zombies still holding an older epoch."""

    def __init__(self, service: Optional[MasterService] = None,
                 addr: Optional[tuple] = None,
                 discovery_path: Optional[str] = None,
                 failover_timeout: float = 30.0,
                 connect_timeout: float = 5.0,
                 io_timeout: float = 10.0,
                 backoff_base: float = 0.05,
                 backoff_cap: float = 2.0,
                 worker_epoch: Optional[int] = None):
        assert sum(x is not None for x in (service, addr,
                                           discovery_path)) == 1, \
            "pass exactly one of service/addr/discovery_path"
        self._svc = service
        self._addr = addr
        self._discovery = discovery_path
        self._failover_timeout = failover_timeout
        self._connect_timeout = connect_timeout
        self._io_timeout = io_timeout
        self._backoff = DecorrelatedBackoff(backoff_base, backoff_cap)
        if worker_epoch is None and os.environ.get("PADDLE_ELASTIC_EPOCH"):
            try:
                worker_epoch = int(os.environ["PADDLE_ELASTIC_EPOCH"])
            except ValueError:
                pass
        self._worker_epoch = worker_epoch
        self._sock = None

    def _resolve(self):
        if self._discovery is None:
            return self._addr
        return discover_master(self._discovery)

    def _rpc_once(self, method, deadline=None, **kw):
        if self._sock is None:
            addr = self._resolve()
            if addr is None:
                raise ConnectionError("no master leader published")
            timeout = self._connect_timeout
            if deadline is not None:
                timeout = max(0.1, min(timeout, deadline - time.time()))
            self._sock = socket.create_connection(addr, timeout=timeout)
            self._sock.settimeout(self._io_timeout)
            self._file = self._sock.makefile("rwb")
        self._file.write((json.dumps({"method": method, **kw}) + "\n")
                         .encode())
        self._file.flush()
        line = self._file.readline()
        if not line:
            raise ConnectionError("master closed the connection")
        resp = json.loads(line)
        if "error" in resp:
            raise RuntimeError(f"master rpc error: {resp['error']}")
        return resp

    def _rpc(self, method, **kw):
        if self._svc is not None:
            if method == "get_task":
                t = self._svc.get_task(kw.get("worker_epoch"))
                return {"task": t.to_dict() if t else None}
            if method == "report_done":
                return {"ok": self._svc.report_done(
                    kw["task_id"], kw.get("lease"),
                    kw.get("worker_epoch"))}
            if method == "report_failed":
                self._svc.report_failed(kw["task_id"], kw.get("lease"),
                                        kw.get("worker_epoch"))
                return {"ok": True}
            if method == "status":
                return {"todo": self._svc.num_todo(),
                        "pending": self._svc.num_pending(),
                        "epoch": self._svc.epoch()}
            if method == "metrics":
                return {"text":
                        _metrics.default_registry().render_prometheus()}
            if method == "request_save_model":
                return {"ok": self._svc.request_save_model(
                    kw["trainer_id"], kw.get("block_dur", 60.0),
                    kw.get("worker_epoch"))}
            if method == "set_epoch_fence":
                return {"fence": self._svc.set_epoch_fence(kw["epoch"])}
        deadline = time.time() + self._failover_timeout
        self._backoff.reset()
        while True:
            try:
                resp = self._rpc_once(method, deadline=deadline, **kw)
                self._backoff.reset()
                return resp
            # ValueError: a leader SIGKILLed mid-response leaves a partial
            # line — a decode error is a failover signal, not a bug
            except (ConnectionError, OSError, ValueError) as e:
                self.close()
                if self._discovery is None or time.time() > deadline:
                    raise
                delay = self._backoff.next()
                _m_reconnects.inc()
                log.info("master client: %s; re-resolving leader in "
                         "%.2fs", e, delay)
                time.sleep(delay)

    def _epoch_kw(self):
        return ({} if self._worker_epoch is None
                else {"worker_epoch": self._worker_epoch})

    def get_task(self) -> Optional[Task]:
        d = self._rpc("get_task", **self._epoch_kw())["task"]
        return Task.from_dict(d) if d else None

    def report_done(self, task_id: int, lease: Optional[int] = None):
        self._rpc("report_done", task_id=task_id, lease=lease,
                  **self._epoch_kw())

    def report_failed(self, task_id: int, lease: Optional[int] = None):
        self._rpc("report_failed", task_id=task_id, lease=lease,
                  **self._epoch_kw())

    def set_epoch_fence(self, epoch: int) -> int:
        """Supervisor-side: retire every worker whose coordination epoch
        is below ``epoch`` (returns the active fence)."""
        return int(self._rpc("set_epoch_fence", epoch=int(epoch))["fence"])

    def status(self):
        return self._rpc("status")

    def metrics_text(self) -> str:
        """Prometheus text snapshot of the master's registry (local or
        over the wire — the observability scrape path for trainers)."""
        return self._rpc("metrics")["text"]

    def request_save_model(self, trainer_id: str,
                           block_dur: float = 60.0) -> bool:
        """True iff THIS trainer is elected to save the model for the
        next ``block_dur`` window (python/paddle/v2/master/client.py:24).
        Typical use: ``if client.request_save_model(my_id): save()``."""
        return bool(self._rpc("request_save_model", trainer_id=trainer_id,
                              block_dur=block_dur,
                              **self._epoch_kw())["ok"])

    def close(self):
        if self._sock is not None:
            self._sock.close()
            self._sock = None

    def reader(self, poll_interval: float = 0.05, max_epochs: int = 1):
        """A v2 reader(): stream records task-by-task until ``max_epochs``
        passes complete — the trainer.train(reader=...) integration
        (reference: master client next_record consumed by the v2 reader)."""

        def gen():
            start_epoch = self.status()["epoch"]
            while True:
                st = self.status()
                if st["epoch"] >= start_epoch + max_epochs:
                    return
                task = self.get_task()
                if task is None:
                    if st["pending"] == 0 and \
                            self.status()["epoch"] >= start_epoch + max_epochs:
                        return
                    # the stragglers' barrier: this consumer is drained
                    # while others still hold leases (BarrierStat slot)
                    _m_task_wait.inc(poll_interval)
                    time.sleep(poll_interval)
                    continue
                try:
                    for off, _ in task.chunks:
                        yield from recordio.read_chunk(task.path, off)
                except Exception:
                    self.report_failed(task.task_id, task.lease)
                    raise
                self.report_done(task.task_id, task.lease)

        return gen


class ServingFleet:
    """Spawn and tend N ``paddle_tpu_torch serve --port`` replica processes
    from one ``lm_serving`` artifact — the serving counterpart of the
    training gang supervisor, and the fleet glue the ``route`` CLI and
    the multi-process fleet tests stand on.

    Each replica binds an ephemeral TCP port for the JSONL op wire and
    an ephemeral HTTP health port, announcing both as one
    machine-readable ``{"replica_ready": {...}}`` line on stdout;
    :meth:`start` parses the announcements (with a deadline — a replica
    that dies during model load raises instead of hanging the fleet)
    and :meth:`handles` builds ``serving.replica.SocketReplica`` handles
    over them. :meth:`router` assembles a prefix-aware
    ``serving.Router``, reading the placement keying (block size /
    chunk grid) off the first replica's ``/healthz`` so the router's
    digests match the engines' prefix caches exactly. ``prefill=K``
    marks the first K replicas as the disaggregated prefill tier.

    :meth:`kill` SIGKILLs one replica (the chaos hook: the router must
    requeue its in-flight work onto survivors with zero lost requests);
    :meth:`close` tears the fleet down TERM-then-KILL via
    ``runtime.launch.terminate_procs`` — TERM is the replicas' graceful
    drain, so a closing fleet finishes what it accepted.

    Each replica is its own process on the card (its own CUDA context,
    weights, pool and graphs) unless ``args_extra`` passes
    ``--device=cpu``."""

    def __init__(self, model: str, replicas: int = 2, *,
                 prefill: int = 0, args_extra: Sequence[str] = (),
                 env: Optional[dict] = None,
                 startup_timeout_s: float = 240.0,
                 python: Optional[str] = None):
        if replicas < 1:
            raise ValueError(f"need >= 1 replicas, got {replicas}")
        if not 0 <= prefill < replicas:
            raise ValueError(f"prefill {prefill} must leave at least "
                             f"one of {replicas} replicas decoding")
        self.model = str(model)
        self.n = int(replicas)
        self.prefill = int(prefill)
        self.args_extra = list(args_extra)
        self.env = env
        self.startup_timeout_s = float(startup_timeout_s)
        self.python = python or sys.executable
        self.procs: List = []
        self.endpoints: List[dict] = []
        self._handles: List = []
        # name -> live process; names are CLAIMED under the lock
        # before any process exists, so two concurrent replacements
        # can never both launch under one name (and therefore never
        # share a {name}-derived spill directory)
        self._lock = threading.Lock()
        self._by_name: dict = {}
        self._spawning: set = set()

    def start(self) -> "ServingFleet":
        for i in range(self.n):
            self.procs.append(self._launch(f"replica{i}"))
        deadline = time.time() + self.startup_timeout_s
        for i, p in enumerate(self.procs):
            self.endpoints.append(self._await_ready(
                f"replica{i}", p, deadline, close_fleet=True))
            self._by_name[f"replica{i}"] = p
        return self

    def _launch(self, name: str):
        import subprocess
        env = dict(os.environ)
        if self.env:
            env.update(self.env)
        # the replicas run `python -m paddle_tpu_torch`: make THIS package
        # importable regardless of the caller's cwd (the fleet may be
        # launched from anywhere, not just the repo root)
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = pkg_root + os.pathsep + \
            env.get("PYTHONPATH", "") if env.get("PYTHONPATH") \
            else pkg_root
        # "{name}" in an extra arg expands to this replica's name:
        # per-replica state that must not be shared (a --tiers_dir
        # spill directory, say) gets its own path from ONE args_extra
        # template — and a replacement spawned under the SAME name
        # inherits that path, which is how the disk spill tier hands
        # over to the healed process
        extra = [a.replace("{name}", name) for a in self.args_extra]
        return subprocess.Popen(
            [self.python, "-m", "paddle_tpu_torch", "serve",
             f"--model={self.model}", "--port=0", "--health_port=0",
             *extra],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            text=True, env=env)

    def _await_ready(self, name: str, proc, deadline: float,
                     close_fleet: bool = False) -> dict:
        """Parse the replica's ready line off its stdout, bounded by
        ``deadline`` (readline on a watchdog thread: a wedged replica
        must fail the fleet, not hang it). ``close_fleet`` tears the
        whole fleet down on failure (the start() all-or-nothing path);
        a single respawn kills only its own process."""
        box: List[Optional[str]] = [None]

        def _read():
            box[0] = proc.stdout.readline()

        t = threading.Thread(target=_read, daemon=True)
        t.start()
        t.join(max(deadline - time.time(), 0.1))
        line = box[0]
        if not line:
            rc = proc.poll()
            if close_fleet:
                self.close()
            else:
                try:
                    proc.kill()
                except OSError:
                    pass
            raise RuntimeError(
                f"replica {name} never announced readiness "
                f"({'exited rc=' + str(rc) if rc is not None else 'timed out'})")
        doc = json.loads(line)["replica_ready"]
        return {"name": name, "port": int(doc["port"]),
                "health_port": doc.get("health_port")}

    # -- named lifecycle (the fleet controller's surface) ------------------
    def allocate_name(self) -> str:
        """The smallest unclaimed ``replica{k}`` (scale-up names)."""
        with self._lock:
            k = 0
            while (f"replica{k}" in self._by_name
                   or f"replica{k}" in self._spawning):
                k += 1
            return f"replica{k}"

    def spawn(self, name: Optional[str] = None) -> dict:
        """Spawn ONE replica under ``name`` (default: a fresh name)
        and wait for its ready line. The name is claimed atomically
        before the process launches: a second concurrent spawn of the
        same name raises instead of racing it — at most one live
        process ever owns a name (and its spill directory). Replacing
        a dead replica's name is allowed once its process exited."""
        with self._lock:
            if name is None:
                k = 0
                while (f"replica{k}" in self._by_name
                       or f"replica{k}" in self._spawning):
                    k += 1
                name = f"replica{k}"
            name = str(name)
            if name in self._spawning:
                raise RuntimeError(
                    f"replica {name!r} is already being spawned")
            cur = self._by_name.get(name)
            if cur is not None and cur.poll() is None:
                raise RuntimeError(
                    f"replica {name!r} is still running — stop or "
                    f"kill it before respawning")
            self._spawning.add(name)
        try:
            proc = self._launch(name)
            ep = self._await_ready(
                name, proc, time.time() + self.startup_timeout_s)
        finally:
            with self._lock:
                self._spawning.discard(name)
        with self._lock:
            self._by_name[name] = proc
            for i, e in enumerate(self.endpoints):
                if e["name"] == name:
                    self.endpoints[i] = ep
                    self.procs[i] = proc
                    break
            else:
                self.endpoints.append(ep)
                self.procs.append(proc)
        return ep

    def handle(self, name: str):
        """A FRESH SocketReplica handle to the named replica (the
        cached :meth:`handles` list keeps the originals — a healed
        replica needs a new connection to its new process)."""
        from paddle_tpu_torch.serving.replica import SocketReplica
        ep = next((e for e in self.endpoints if e["name"] == name),
                  None)
        if ep is None:
            raise KeyError(f"no replica named {name!r}")
        hp = ep.get("health_port")
        return SocketReplica(
            name, ("127.0.0.1", ep["port"]),
            f"http://127.0.0.1:{hp}" if hp else None)

    def stop(self, name: str):
        """Graceful SIGTERM drain of one replica (scale-down): it
        finishes what it accepted, emits every result, and exits 0."""
        import signal as _signal
        with self._lock:
            proc = self._by_name.get(name)
        if proc is not None and proc.poll() is None:
            proc.send_signal(_signal.SIGTERM)

    def kill_name(self, name: str):
        """SIGKILL by name (the controller's wedge hammer)."""
        with self._lock:
            proc = self._by_name.get(name)
        if proc is not None and proc.poll() is None:
            proc.kill()

    def proc_alive(self, name: str) -> bool:
        with self._lock:
            proc = self._by_name.get(name)
        return proc is not None and proc.poll() is None

    def handles(self) -> List:
        """SocketReplica handles, one per replica (built once)."""
        from paddle_tpu_torch.serving.replica import SocketReplica
        if not self._handles:
            if not self.endpoints:
                raise RuntimeError("start() the fleet first")
            for ep in self.endpoints:
                hp = ep.get("health_port")
                self._handles.append(SocketReplica(
                    ep["name"], ("127.0.0.1", ep["port"]),
                    f"http://127.0.0.1:{hp}" if hp else None))
        return self._handles

    def router(self, **kw):
        """A prefix-aware Router over this fleet; keyword args pass
        through (max_in_flight, slo, ...). Placement keying (block
        size / chunk grid) is read off the first replica's /healthz so
        the router's digests match the engines' prefix caches."""
        from paddle_tpu_torch.serving.router import Router, fleet_keying
        handles = self.handles()
        bs, chunk = fleet_keying(handles)
        prefill = [h.name for h in handles[:self.prefill]]
        kw.setdefault("block_size", bs)
        kw.setdefault("chunk_tokens", chunk)
        return Router(handles, prefill=prefill, **kw)

    def kill(self, i: int):
        """SIGKILL replica ``i`` — the chaos hook (no drain, no
        goodbye; the router discovers the death through the dead
        socket)."""
        self.procs[i].kill()

    def close(self):
        from paddle_tpu_torch.runtime import launch
        for h in self._handles:
            try:
                h.close()
            except Exception:
                pass
        self._handles = []
        if self.procs:
            launch.terminate_procs(self.procs)
            self.procs = []
