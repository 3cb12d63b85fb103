"""The port's runtime against ``paddle_tpu``'s, on the CPU.

Every case runs through both packages with the same inputs:

- recordio: files written by either package, on its native codec or
  its pure-Python path, are byte for byte the other's, and each package
  reads the other's; ``chunk_offsets`` equal; a corrupt CRC raises on
  every path; the port's codec is built from its own copy of
  ``recordio.cc`` into ``build/native/``;
- the data service (``runtime/master.py``): ``tests/test_master_service.py``'s
  cases under one fake clock give equal task ids, leases, queue depths,
  snapshot documents, fence rejections and ``master_*`` counters, over
  direct calls and TCP; a ``LeaderLock`` left stale by one package is
  taken over by the other, term continued;
- ``DecorrelatedBackoff`` and ``RestartBudget`` give equal sequences
  under the same seeded rng; ``terminate_procs`` and the env contract
  of ``spawn_local_procs`` are equal, but for the platform the JAX
  launcher writes and the port's does not (ROADMAP C14);
- the native builds (the kernels' and the codec's) compile once when
  two processes meet a cold build directory together: a stand-in
  compiler logs which process wrote which object.
"""

import json
import os
import random
import signal
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import pytest

from paddle_tpu.runtime import launch as jlaunch
from paddle_tpu.runtime import master as jmaster
from paddle_tpu.runtime import native as jnative
from paddle_tpu.runtime import recordio as jrecordio
from paddle_tpu.runtime import supervisor as jsupervisor
from paddle_tpu_torch.runtime import launch as tlaunch
from paddle_tpu_torch.runtime import master as tmaster
from paddle_tpu_torch.runtime import native as tnative
from paddle_tpu_torch.runtime import recordio as trecordio
from paddle_tpu_torch.runtime import supervisor as tsupervisor

REPO = Path(__file__).resolve().parents[1]
SIDES = ("jax", "port")
RECORDIO = {"jax": jrecordio, "port": trecordio}
NATIVE = {"jax": jnative, "port": tnative}
MASTER = {"jax": jmaster, "port": tmaster}
LAUNCH = {"jax": jlaunch, "port": tlaunch}
SUPERVISOR = {"jax": jsupervisor, "port": tsupervisor}


def _records(n):
    return [{"i": i, "x": list(range(i % 5))} for i in range(n)]


class codec_path:
    """Run one package's recordio on its native codec or its pure-Python
    path (``native._lib`` None after the first ``get()``, as
    ``tests/test_runtime_native.py`` forces it)."""

    def __init__(self, side, path):
        self.native = NATIVE[side]
        self.path = path

    def __enter__(self):
        assert self.native.get() is not None, "native codec did not build"
        self.saved = self.native._lib
        if self.path == "python":
            self.native._lib = None

    def __exit__(self, *exc):
        self.native._lib = self.saved


def write(side, path, fname, records, chunk, raw=False):
    with codec_path(side, path):
        RECORDIO[side].write_records(fname, records, chunk_records=chunk,
                                     raw=raw)
    return Path(fname).read_bytes()


def read(side, path, fname, raw=False):
    rio = RECORDIO[side]
    with codec_path(side, path):
        offsets = rio.chunk_offsets(fname)
        recs = [r for off, _ in offsets
                for r in rio.read_chunk(fname, off, raw=raw)]
    return offsets, recs


# -- recordio ---------------------------------------------------------------

class TestRecordio:
    def test_port_codec_is_built_from_its_own_copy(self):
        lib = tnative.get()
        assert lib is not None
        built = tnative.lib_path()
        assert Path(lib._name) == built and built.exists()
        assert built.parent.parent == REPO / "build" / "native"
        assert tnative.SRC == REPO / "paddle_tpu_torch" / "runtime" \
            / "native" / "recordio.cc"
        assert Path(lib._name) != Path(jnative._SO)
        # the source is the reference's codec, its comment header aside
        ref = Path(jnative._SRC).read_text()
        own = tnative.SRC.read_text()
        assert own[own.index("#include <zlib.h>"):] == \
            ref[ref.index("#include <zlib.h>"):]

    @pytest.mark.parametrize("raw", [False, True])
    @pytest.mark.parametrize("port_path", ["native", "python"])
    @pytest.mark.parametrize("jax_path", ["native", "python"])
    def test_files_byte_equal(self, tmp_path, jax_path, port_path, raw):
        recs = ([b"r%03d" % i * (i % 7) for i in range(53)] if raw
                else _records(53))
        a = write("jax", jax_path, str(tmp_path / "j.rio"), recs, 10, raw)
        b = write("port", port_path, str(tmp_path / "t.rio"), recs, 10,
                  raw)
        assert a == b and len(a) > 0

    @pytest.mark.parametrize("reader_path", ["native", "python"])
    @pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                               ("port", "jax")])
    def test_cross_read(self, tmp_path, writer, reader, reader_path):
        fname = str(tmp_path / "d.rio")
        write(writer, "native", fname, _records(257), 50)
        offsets, recs = read(reader, reader_path, fname)
        want_offsets, want = read(writer, "python", fname)
        assert recs == want == _records(257)
        assert offsets == want_offsets and len(offsets) == 6
        assert list(RECORDIO[reader].read_records(fname)) == want

    @pytest.mark.parametrize("path", ["native", "python"])
    @pytest.mark.parametrize("side", SIDES)
    def test_corrupt_crc_detected(self, tmp_path, side, path):
        fname = str(tmp_path / "d.rio")
        write("jax", "native", fname, _records(20), 8)
        with open(fname, "r+b") as f:
            f.seek(RECORDIO[side].HEADER.size + 10)     # first payload
            f.write(b"\xff\xff")
        with codec_path(side, path), pytest.raises(IOError):
            list(RECORDIO[side].read_chunk(fname, 0))

    @pytest.mark.parametrize("side", SIDES)
    def test_raw_writer_refuses_non_bytes(self, tmp_path, side):
        with pytest.raises(TypeError):
            with RECORDIO[side].Writer(str(tmp_path / "x.rio"),
                                       raw=True) as w:
                w.write(3)


# -- the data service ---------------------------------------------------------

class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def task_view(t):
    return None if t is None else t.to_dict()


def svc_view(svc):
    doc = svc.health()
    doc.pop("service")
    return doc


def counters(side, name):
    """The ``master_*`` counters of ``side``'s default registry for
    service ``name``."""
    reg = MASTER[side]._metrics.default_registry()
    out = {}
    for metric, doc in reg.snapshot().items():
        if not metric.startswith("master_") or doc["kind"] != "counter":
            continue
        for s in doc["series"]:
            if s["labels"].get("service") == name:
                out[metric] = s["value"]
    return out


@pytest.fixture
def rio(tmp_path):
    """One recordio file of 100 records in chunks of 10, shared by both
    sides (tasks name its path)."""
    path = str(tmp_path / "d.rio")
    jrecordio.write_records(path, list(range(100)), chunk_records=10)
    return path


def scenario_drain(m, rio, tmp, name):
    svc = m.MasterService(num_passes=2, name=name)
    svc.set_dataset([rio])
    log = [svc_view(svc)]
    for _ in range(10):
        t = svc.get_task()
        log.append(task_view(t))
        log.append(svc.report_done(t.task_id, t.lease))
    log.append(svc_view(svc))
    return log


def scenario_lease_timeout(m, rio, tmp, name):
    clock = FakeClock()
    svc = m.MasterService(lease_seconds=5, time_fn=clock, name=name)
    svc.set_dataset([rio])
    t = svc.get_task()
    log = [task_view(t), svc.num_pending()]
    clock.t = 6.0
    log += [svc.num_pending(), svc.num_todo()]
    t2 = svc.get_task()
    log += [task_view(t2), svc.report_done(t.task_id, t.lease),
            svc.report_done(t2.task_id, t2.lease), svc_view(svc)]
    return log


def scenario_failure_cap(m, rio, tmp, name):
    svc = m.MasterService(failure_max=2, num_passes=1, name=name)
    svc.set_dataset([rio])
    t = svc.get_task()
    svc.report_failed(t.task_id)
    log = [svc_view(svc)]
    leased = [svc.get_task() for _ in range(10)]
    log.append([task_view(x) for x in leased])
    got = next(x for x in leased if x.task_id == t.task_id)
    svc.report_failed(got.task_id)
    log.append(svc_view(svc))
    for x in leased:
        if x.task_id != t.task_id:
            log.append(svc.report_done(x.task_id))
    log.append(svc_view(svc))
    return log


def scenario_snapshot(m, rio, tmp, name):
    snap = os.path.join(tmp, "master.json")
    svc = m.MasterService(snapshot_path=snap, name=name)
    svc.set_dataset([rio])
    a = svc.get_task()
    svc.report_done(a.task_id)
    b = svc.get_task()
    svc.set_epoch_fence(3)
    svc.snapshot()
    svc.close()
    with open(snap) as f:
        doc = json.load(f)
    svc2 = m.MasterService(num_passes=1, snapshot_path=snap,
                           name=name + "b")
    log = [doc, task_view(b), svc_view(svc2)]
    while (t := svc2.get_task()) is not None:
        log.append([task_view(t), svc2.report_done(t.task_id, t.lease)])
    log.append(svc_view(svc2))
    svc2.close()
    return log


def scenario_fence(m, rio, tmp, name):
    svc = m.MasterService(name=name)
    svc.set_dataset([rio])
    t = svc.get_task(worker_epoch=1)
    log = [task_view(t), svc.set_epoch_fence(2), svc.set_epoch_fence(1)]
    # a zombie of epoch 1 can neither lease, commit, fail nor save
    log += [task_view(svc.get_task(worker_epoch=1)),
            svc.report_done(t.task_id, t.lease, worker_epoch=1),
            svc.request_save_model("zombie", worker_epoch=1)]
    svc.report_failed(t.task_id, t.lease, worker_epoch=1)
    log.append(svc_view(svc))
    # the live gang (epoch 2) and an undeclared client still work
    log += [svc.report_done(t.task_id, t.lease, worker_epoch=2),
            task_view(svc.get_task()), svc_view(svc)]
    return log


def scenario_save_election(m, rio, tmp, name):
    clock = FakeClock()
    svc = m.MasterService(time_fn=clock, name=name)
    log = [svc.request_save_model(f"trainer-{i}", block_dur=60)
           for i in range(4)]
    log += [svc.request_save_model("trainer-0", block_dur=10),
            svc.request_save_model("b", block_dur=10)]
    clock.t = 61.0
    log += [svc.request_save_model("b", block_dur=10),
            svc.request_save_model("trainer-0", block_dur=10)]
    return log


def scenario_chunk_grouping(m, rio, tmp, name):
    svc = m.MasterService(num_passes=1, name=name)
    svc.set_dataset([rio], chunks_per_task=3)
    leased = []
    while (t := svc.get_task()) is not None:
        leased.append(t)
    log = [[task_view(t) for t in leased], [t.nrecords for t in leased]]
    for t in leased:
        svc.report_done(t.task_id)
    return log + [svc_view(svc)]


def scenario_reader(m, rio, tmp, name):
    svc = m.MasterService(num_passes=1, name=name)
    svc.set_dataset([rio])
    client = m.MasterClient(service=svc)
    recs = list(client.reader(max_epochs=1)())
    return [recs, svc_view(svc), client.status()]


def scenario_tcp(m, rio, tmp, name):
    svc = m.MasterService(num_passes=1, name=name)
    svc.set_dataset([rio])
    server = m.MasterServer(svc, port=0)
    try:
        client = m.MasterClient(addr=server.addr, worker_epoch=0)
        log = [client.status()]
        t = client.get_task()
        log += [task_view(t), client.set_epoch_fence(0)]
        client.report_failed(t.task_id, t.lease)
        log.append(client.status())
        recs = list(client.reader(max_epochs=1)())
        log += [sorted(recs), client.status(),
                client.request_save_model("t0"),
                client.request_save_model("t1"),
                "master_tasks_done_total" in client.metrics_text()]
        client.close()
    finally:
        server.shutdown()
    return log


def scenario_lease_counter_failover(m, rio, tmp, name):
    snap = os.path.join(tmp, "snap.json")
    svc = m.MasterService(lease_seconds=60, snapshot_path=snap, name=name)
    svc.set_dataset([rio])
    t1, t2 = svc.get_task(), svc.get_task()
    svc.snapshot()
    svc.close()
    svc2 = m.MasterService(lease_seconds=60, snapshot_path=snap,
                           name=name + "b")
    t3 = svc2.get_task()
    svc2.close()
    return [task_view(t1), task_view(t2), task_view(t3)]


SCENARIOS = {f.__name__[len("scenario_"):]: f for f in (
    scenario_drain, scenario_lease_timeout, scenario_failure_cap,
    scenario_snapshot, scenario_fence, scenario_save_election,
    scenario_chunk_grouping, scenario_reader, scenario_tcp,
    scenario_lease_counter_failover)}


class TestMasterService:
    @pytest.mark.parametrize("case", sorted(SCENARIOS))
    def test_scenario_equal(self, rio, tmp_path, case):
        logs, metrics = {}, {}
        for side in SIDES:
            tmp = tmp_path / side
            tmp.mkdir()
            name = f"svc-{case}-{side}"
            logs[side] = SCENARIOS[case](MASTER[side], rio, str(tmp), name)
            metrics[side] = counters(side, name)
        assert logs["port"] == logs["jax"]
        assert json.dumps(logs["port"]) == json.dumps(logs["jax"])
        assert metrics["port"] == metrics["jax"]

    def test_two_tcp_clients_share_the_work(self, rio):
        svc = tmaster.MasterService(num_passes=1, name="svc-two-clients")
        svc.set_dataset([rio])
        server = tmaster.MasterServer(svc, port=0)
        try:
            c1 = tmaster.MasterClient(addr=server.addr)
            c2 = tmaster.MasterClient(addr=server.addr)
            got1, got2 = [], []
            while True:
                t1, t2 = c1.get_task(), c2.get_task()
                if t1 is None and t2 is None:
                    break
                for c, t, got in ((c1, t1, got1), (c2, t2, got2)):
                    if t:
                        for off, _ in t.chunks:
                            got.extend(trecordio.read_chunk(t.path, off))
                        c.report_done(t.task_id)
            assert sorted(got1 + got2) == list(range(100))
            assert got1 and got2
            c1.close()
            c2.close()
        finally:
            server.shutdown()


class TestLeaderLock:
    @pytest.mark.parametrize("first,second", [("jax", "port"),
                                              ("port", "jax")])
    def test_stale_lock_taken_over_across_packages(self, tmp_path, first,
                                                   second):
        path = str(tmp_path / "lock")
        dead = MASTER[first].LeaderLock(path, stale_after=0.05)
        assert dead.try_acquire()
        dead.publish({"host": "h", "port": 1})
        assert MASTER[second].discover_master(path) == ("h", 1)
        dead._stop.set()                # the holder dies: no heartbeat
        dead._thread.join()
        time.sleep(0.1)
        locks = [MASTER[second].LeaderLock(path, stale_after=0.05)
                 for _ in range(6)]
        results = [None] * len(locks)
        barrier = threading.Barrier(len(locks))

        def campaign(i):
            barrier.wait()
            results[i] = locks[i].try_acquire()

        ts = [threading.Thread(target=campaign, args=(i,))
              for i in range(len(locks))]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert sum(results) == 1, results
        winner = locks[results.index(True)]
        assert winner.term == dead.term + 1
        winner.publish({"host": "h", "port": 2})
        assert MASTER[first].discover_master(path) == ("h", 2)
        assert not dead.still_leader() and winner.still_leader()
        assert not MASTER[first].LeaderLock(
            path, stale_after=5.0).try_acquire()
        winner.release()

    @pytest.mark.parametrize("side", SIDES)
    def test_ha_master_failover_serves_the_snapshot(self, rio, tmp_path,
                                                    side):
        m = MASTER[side]
        lock, snap = str(tmp_path / "lock"), str(tmp_path / "snap.json")
        a = m.HAMaster(lock, snap, stale_after=0.3, heartbeat_interval=0.05,
                       dataset=[rio], num_passes=1)
        assert a.campaign(timeout=5)
        client = m.MasterClient(discovery_path=lock, failover_timeout=10,
                                backoff_base=0.01, backoff_cap=0.05)
        t = client.get_task()
        client.report_done(t.task_id, t.lease)
        a.service.snapshot()
        a.server.shutdown()             # the leader dies (lock goes stale)
        a.lock._stop.set()
        a.lock._thread.join()
        b = m.HAMaster(lock, snap, stale_after=0.3, heartbeat_interval=0.05,
                       num_passes=1)
        assert b.campaign(timeout=5)
        assert b.lock.term == a.lock.term + 1
        client.close()                  # the next call re-resolves
        st = client.status()
        assert client._sock.getpeername()[1] == b.server.addr[1]
        client.close()
        b.shutdown()
        a.service.close()
        assert st == {"todo": 9, "pending": 0, "epoch": 0}


# -- backoff, restart budget, the launcher -----------------------------------

def test_decorrelated_backoff_sequences_equal():
    seqs = {}
    for side in SIDES:
        b = MASTER[side].DecorrelatedBackoff(0.05, 2.0,
                                             rng=random.Random(11))
        seq = [b.next() for _ in range(20)]
        b.reset()
        seqs[side] = seq + [b.next() for _ in range(5)]
    assert seqs["port"] == seqs["jax"]
    assert all(0.05 <= d <= 2.0 for d in seqs["port"])


def test_restart_budget_sequences_equal():
    logs = {}
    for side in SIDES:
        rb = SUPERVISOR[side].RestartBudget(max_restarts=2,
                                            stable_window=10.0,
                                            backoff_base=0.5,
                                            backoff_cap=15.0)
        rb.backoff._rng = random.Random(5)
        log = []
        for stepped, up in [(True, 1.0), (False, 0.0), (True, 3.0),
                            (True, 50.0), (False, 0.0), (False, 0.0),
                            (False, 0.0)]:
            rb.note_failure(stepped=stepped, uptime_s=up)
            log.append((rb.restarts, rb.exhausted, rb.delay()))
        rb.reset()
        log.append((rb.restarts, rb.exhausted, rb.delay()))
        logs[side] = log
    assert logs["port"] == logs["jax"]
    assert [e[1] for e in logs["port"]] == [False, False, True, False, False,
                                            True, True, False]


ENV_DUMP = textwrap.dedent("""
    import json, os, sys
    env = {k: v for k, v in os.environ.items() if k.startswith("PADDLE_")}
    with open(os.path.join(sys.argv[1], env["PADDLE_PROCESS_ID"] + ".json"),
              "w") as f:
        json.dump(env, f)
""")


@pytest.mark.parametrize("cluster", [True, False])
def test_spawn_local_procs_env_contract_equal(tmp_path, cluster,
                                              monkeypatch):
    script = tmp_path / "dump.py"
    script.write_text(ENV_DUMP)
    for k in [k for k in os.environ if k.startswith("PADDLE_")]:
        monkeypatch.delenv(k)
    envs = {}
    for side in SIDES:
        out = tmp_path / side
        out.mkdir()
        procs = LAUNCH[side].spawn_local_procs(
            3, [str(script), str(out)], devices_per_proc=4,
            coordinator_port=23456, env_extra={"PADDLE_PLATFORM": "gpu",
                                               "PADDLE_X": "1"},
            env_per_rank=[{}, {"PADDLE_RANK_TAG": "one"}, {}],
            cluster=cluster)
        assert [p.wait(timeout=60) for p in procs] == [0, 0, 0]
        envs[side] = [json.loads((out / f"{r}.json").read_text())
                      for r in range(3)]
    assert envs["port"] == envs["jax"]
    first = envs["port"][1]
    assert first["PADDLE_PROCESS_ID"] == "1"
    assert first["PADDLE_NUM_PROCESSES"] == "3"
    assert first["PADDLE_PLATFORM"] == "gpu"          # env_extra wins
    assert first["PADDLE_RANK_TAG"] == "one"
    assert ("PADDLE_COORDINATOR" in first) == cluster


def _spawned_envs(tmp_path, side, env_extra=None):
    """The PADDLE_* keys each of 2 workers of ``side``'s launcher sees."""
    script = tmp_path / "dump.py"
    script.write_text(ENV_DUMP)
    out = tmp_path / side
    out.mkdir()
    procs = LAUNCH[side].spawn_local_procs(
        2, [str(script), str(out)], coordinator_port=23457,
        env_extra=env_extra)
    assert [p.wait(timeout=60) for p in procs] == [0, 0]
    return [json.loads((out / f"{r}.json").read_text()) for r in range(2)]


def test_spawn_local_procs_writes_no_platform(tmp_path, monkeypatch):
    """ROADMAP C14: with no platform asked, the JAX launcher writes
    PADDLE_PLATFORM=cpu (its local mode is a CPU simulation) and the
    port's writes none, so its workers join NCCL on the card."""
    for k in [k for k in os.environ if k.startswith("PADDLE_")]:
        monkeypatch.delenv(k)
    envs = {side: _spawned_envs(tmp_path, side) for side in SIDES}
    assert [e.get("PADDLE_PLATFORM") for e in envs["jax"]] == ["cpu", "cpu"]
    assert all("PADDLE_PLATFORM" not in e for e in envs["port"])
    for j, t in zip(envs["jax"], envs["port"]):
        assert {k: v for k, v in j.items() if k != "PADDLE_PLATFORM"} == t


def test_spawn_local_procs_cpu_contract_equals_the_jax_default(
        tmp_path, monkeypatch):
    """A port caller that asks for the CPU gets the JAX launcher's
    default contract, key for key; a platform in the caller's own
    environment reaches the workers too."""
    for k in [k for k in os.environ if k.startswith("PADDLE_")]:
        monkeypatch.delenv(k)
    jax_default = _spawned_envs(tmp_path, "jax")
    (tmp_path / "asked").mkdir()
    assert _spawned_envs(tmp_path / "asked", "port",
                         env_extra={"PADDLE_PLATFORM": "cpu"}) == jax_default
    monkeypatch.setenv("PADDLE_PLATFORM", "cpu")
    (tmp_path / "inherited").mkdir()
    assert _spawned_envs(tmp_path / "inherited", "port") == jax_default


STUBBORN = ("import signal, sys, time; "
            "signal.signal(signal.SIGTERM, signal.SIG_IGN); "
            "print('ready', flush=True); time.sleep(60)")


@pytest.mark.parametrize("side", SIDES)
def test_terminate_procs_term_then_kill(side):
    polite = subprocess.Popen([sys.executable, "-c",
                               "import time; time.sleep(60)"])
    stubborn = subprocess.Popen([sys.executable, "-c", STUBBORN],
                                stdout=subprocess.PIPE, text=True)
    piped = subprocess.Popen([sys.executable, "-c",
                              "import sys; sys.stdin.read()"],
                             stdin=subprocess.PIPE)
    assert stubborn.stdout.readline().strip() == "ready"
    t0 = time.monotonic()
    LAUNCH[side].terminate_procs([polite, stubborn, piped], grace=0.5)
    took = time.monotonic() - t0
    stubborn.stdout.close()
    assert polite.returncode == -signal.SIGTERM
    assert stubborn.returncode == -signal.SIGKILL
    # a closed stdin ends the third before (or as) it is TERMed
    assert piped.returncode in (0, -signal.SIGTERM)
    assert piped.stdin.closed
    assert took < 10


@pytest.mark.parametrize("side", SIDES)
def test_launch_local_and_wait_all_codes(tmp_path, side):
    script = tmp_path / "w.py"
    script.write_text("import os, sys; "
                      "sys.exit(int(os.environ['PADDLE_PROCESS_ID']))")
    assert LAUNCH[side].launch_local(3, [str(script)], timeout=60) == \
        [0, 1, 2]
    slow = tmp_path / "s.py"
    slow.write_text("import time; time.sleep(60)")
    assert LAUNCH[side].launch_local(1, [str(slow)], timeout=1.0) == [-9]


def test_wrap_remote_equal():
    assert tlaunch._wrap_remote("echo hi", grace=2.0) == \
        jlaunch._wrap_remote("echo hi", grace=2.0)


# -- concurrent first builds -------------------------------------------------

STAND_IN = textwrap.dedent("""
    #!{python}
    # A stand-in compiler: logs each call with its caller's pid, writes
    # an object naming that pid (slowly, so an unserialised second build
    # would overlap it), and links by concatenating the objects.
    import os, sys, time
    args = sys.argv[1:]
    out = args[args.index("-o") + 1]
    log = os.environ["STAND_IN_LOG"]
    me = str(os.getppid())
    def note(what):
        with open(log, "a") as f:
            f.write(me + " " + what + " " + os.path.basename(out) + "\\n")
    if "-c" in args or out.split(".tmp")[0].endswith("librecordio.so"):
        note("begin")
        time.sleep(0.3)
        with open(out, "w") as f:
            f.write("object by " + me + "\\n")
        note("end")
    else:
        objs = [a for a in args if a.endswith(".o")]
        note("link")
        with open(out, "w") as f:
            for o in objs:
                f.write(open(o).read())
""").lstrip()

FIRST_USE = {
    "kernels": textwrap.dedent("""
        import json, sys
        from pathlib import Path
        sys.path.insert(0, {repo!r})
        from paddle_tpu_torch.ops.kernels import _build
        _build.BUILD_ROOT = Path({root!r})
        _build.nvcc_path = lambda: {cc!r}
        path, seconds = _build.build()
        print(json.dumps({{"path": str(path), "seconds": seconds}}))
    """),
    "native": textwrap.dedent("""
        import json, sys
        from pathlib import Path
        sys.path.insert(0, {repo!r})
        from paddle_tpu_torch.runtime import native
        native.BUILD_ROOT = Path({root!r})
        native.CXX = {cc!r}
        print(json.dumps({{"path": str(native._build())}}))
    """),
}


@pytest.mark.parametrize("which", ["kernels", "native"])
def test_concurrent_first_builds_compile_once(tmp_path, which):
    cc = tmp_path / "stand_in_cc"
    cc.write_text(STAND_IN.format(python=sys.executable))
    cc.chmod(0o755)
    log = tmp_path / "calls.log"
    root = tmp_path / "build"
    script = FIRST_USE[which].format(repo=str(REPO), root=str(root),
                                     cc=str(cc))
    env = dict(os.environ, STAND_IN_LOG=str(log))
    procs = [subprocess.Popen([sys.executable, "-c", script], env=env,
                              stdout=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [json.loads(p.communicate(timeout=120)[0]) for p in procs]
    assert [p.returncode for p in procs] == [0, 0]
    assert outs[0]["path"] == outs[1]["path"]
    lib = Path(outs[0]["path"])
    calls = [line.split() for line in log.read_text().splitlines()]
    builders = {c[0] for c in calls}
    assert len(builders) == 1, calls        # one process compiled
    assert builders <= {str(p.pid) for p in procs}
    begins = [c for c in calls if c[1] == "begin"]
    if which == "kernels":
        from paddle_tpu_torch.ops.kernels import _build
        assert len(begins) == len(_build.SOURCES)
        assert [c[1] for c in calls].count("link") == 1
        # every object, and so the library, is that one process's
        assert lib.read_text().splitlines() == \
            [f"object by {calls[0][0]}"] * len(_build.SOURCES)
        # the other process waited and found the library: no compile of
        # its own
        assert sorted(o["seconds"] > 0 for o in outs) == [False, True]
    else:
        assert len(begins) == 1
        assert lib.read_text() == f"object by {calls[0][0]}\n"
    assert not [p for p in lib.parent.iterdir() if ".tmp" in p.name]
