"""The port's CLI (``serve``, ``route``, ``top``) and its replica
processes against ``paddle_tpu``'s, on the CPU.

- ``serve`` over one JAX-exported v4 artifact through both packages'
  ``cli.main`` (stdio) gives equal result documents, times aside;
- a ``python -m paddle_tpu_torch serve --port=0 --device=cpu`` process
  prints only its ready line on stdout, answers over TCP, and drains on
  SIGTERM to exit 0 with the accepted request's result;
- ``route --replica`` in front of a ``ReplicaServer`` gives each
  package the same result documents;
- ``_render_top`` / ``_render_gang_top`` frames are equal for the same
  documents (``tests/test_fleet_observability.py``'s ``top`` cases), and
  ``top`` renders one frame of a live router through either ``main``;
- a ``ServingFleet`` of two CPU replica processes loses one to SIGKILL
  mid-trace: the ``FleetController`` respawns it under its name, every
  request completes (0 lost) with the in-process engine's greedy ids.
  Start-up is bounded by ``startup_timeout_s`` and the trace by a router
  deadline.
"""

import io
import json
import re
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from paddle_tpu import cli as jcli
from paddle_tpu.io import lm_serving as jlm
from paddle_tpu_torch import cli as tcli
from paddle_tpu_torch.runtime.master import ServingFleet
from paddle_tpu_torch.serving.autoscale import FleetController
from test_torch_fleet import (REPLICA, ROUTER, SIDES, _model, both, engine,
                              ref_outputs)

REPO = Path(__file__).resolve().parents[1]
CLI = {"jax": jcli, "port": tcli}
# the port's CLI runs on the card unless told otherwise
DEVICE = {"jax": [], "port": ["--device=cpu"]}
TIME_DOC = ("ttft_ms", "latency_ms")


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """A v4 artifact of the shared tiny model, exported by the JAX
    package: batch 2, 64 positions, blocks of 8, chunks of 16 in the
    buckets of ``engine()``'s engines (8 and 16), so a tail chunk pads
    alike in both."""
    jcfg, jp, _, _ = _model()
    path = str(tmp_path_factory.mktemp("cli") / "lm_v4.tar")
    jlm.save_lm_artifact(path, jp, jcfg, batch=2, prompt_len=16,
                         cache_len=64, engine_buckets=(8, 16),
                         engine_paged=True, engine_block_size=8)
    return path


def greedy_lines(ps, max_new):
    return [json.dumps({"prompt": p.tolist(), "max_new": max_new})
            for p in ps]


def docs_view(text):
    docs = [json.loads(line) for line in text.strip().splitlines()]
    return sorted(({k: v for k, v in d.items() if k not in TIME_DOC}
                   for d in docs), key=lambda d: (d.get("id", -1),
                                                  json.dumps(d)))


def run_main(side, argv, stdin_text, monkeypatch, capsys):
    """``cli.main(argv)`` of ``side`` in this process over ``stdin_text``:
    (return code, stdout). The SIGTERM handler a job installs is put
    back."""
    monkeypatch.setattr(sys, "stdin", io.StringIO(stdin_text))
    prev = signal.getsignal(signal.SIGTERM)
    try:
        rc = CLI[side].main(argv)
    finally:
        signal.signal(signal.SIGTERM, prev)
    return rc, capsys.readouterr().out


def test_serve_stdio_equal(artifact, monkeypatch, capsys):
    ps = [np.random.RandomState(i).randint(0, 40, 5 + 7 * i)
          for i in range(3)]
    text = "\n".join(greedy_lines(ps, 6)
                     + [json.dumps({"prompt": [], "max_new": 3})]) + "\n"

    def run(side):
        rc, out = run_main(side, ["serve", f"--model={artifact}",
                                  *DEVICE[side]], text, monkeypatch, capsys)
        assert rc == 0
        return docs_view(out)
    docs = both(run)
    want = ref_outputs(ps, 6)
    results = [d for d in docs if "tokens" in d]
    assert [d["tokens"] for d in results] == \
        [list(w[len(p):]) for p, w in zip(ps, want)]
    assert "empty prompt" in [d for d in docs if "error" in d][0]["error"]


def test_unported_jobs_name_their_roadmap_item(capsys):
    for job in ("train", "test", "time", "infer", "checkgrad", "stats"):
        assert tcli.main([job, "--config=conf.py"]) == 2
        assert "ROADMAP A" in capsys.readouterr().err


def test_serve_port_process_ready_line_and_sigterm_drain(artifact):
    p = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch", "serve",
         f"--model={artifact}", "--port=0", "--health_port=0",
         "--device=cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        cwd=str(REPO))
    try:
        ready = json.loads(p.stdout.readline())["replica_ready"]
        assert set(ready) == {"port", "health_port"}
        conn = socket.create_connection(("127.0.0.1", ready["port"]),
                                        timeout=60)
        f = conn.makefile("rw")
        f.write(json.dumps({"id": 5, "prompt": [1, 2, 3],
                            "max_new": 40}) + "\n")
        f.flush()
        url = f"http://127.0.0.1:{ready['health_port']}/healthz"
        import urllib.request
        deadline = time.time() + 60
        while time.time() < deadline:
            doc = json.loads(urllib.request.urlopen(url, timeout=5).read())
            if doc.get("requests", 0) >= 1:
                break
            time.sleep(0.02)
        p.send_signal(signal.SIGTERM)       # accepted: the drain finishes it
        res = json.loads(f.readline())
        assert p.wait(timeout=60) == 0
        assert res["id"] == 5 and res["finish_reason"] == "max_tokens"
        assert len(res["tokens"]) == 40
        assert p.stdout.read() == ""        # the ready line was all
        conn.close()
    finally:
        p.kill()
        p.stdout.close()


def serve_process(side, artifact):
    """A ``serve --port=0 --health_port=0`` process of ``side`` (the
    package's ``ReplicaServer`` behind its CLI) and its ready line."""
    pkg = {"jax": "paddle_tpu", "port": "paddle_tpu_torch"}[side]
    p = subprocess.Popen(
        [sys.executable, "-m", pkg, "serve", f"--model={artifact}",
         "--port=0", "--health_port=0", *DEVICE[side]],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        cwd=str(REPO))
    line = p.stdout.readline()
    if not line:
        p.kill()
        raise AssertionError(f"{pkg} serve exited rc={p.wait()}")
    return p, json.loads(line)["replica_ready"]


def test_route_to_replica_server_equal(artifact, monkeypatch, capsys):
    """``route --replica HOST:PORT:HEALTH_PORT`` of each package in front
    of its package's replica process: equal result documents, the
    in-process engine's greedy ids."""
    ps = [np.random.RandomState(10 + i).randint(0, 40, 9 + 5 * i)
          for i in range(4)]
    text = "\n".join(greedy_lines(ps, 5)) + "\n"
    procs = {side: serve_process(side, artifact) for side in SIDES}

    def run(side):
        _, ready = procs[side]
        code, out = run_main(
            side, ["route", f"--replica=127.0.0.1:{ready['port']}:"
                            f"{ready['health_port']}"], text, monkeypatch,
            capsys)
        assert code == 0
        return docs_view(out)
    try:
        docs = both(run)
    finally:
        for p, _ in procs.values():
            p.send_signal(signal.SIGTERM)
        rcs = [p.wait(timeout=60) for p, _ in procs.values()]
    want = ref_outputs(ps, 5)
    assert [d["tokens"] for d in docs] == \
        [list(w[len(p):]) for p, w in zip(ps, want)]
    assert {d["replica"] for d in docs} == {"replica0"}
    assert rcs == [0, 0]


TOP_HEALTH = {
    "queue_depth": 2, "requests": 10, "completed": 8, "requeued": 1,
    "placement_hit_rate": 0.75, "shed": 3,
    "window": {"fleet_ttft_p99_s": 0.0123},
    "replicas": {
        "r0": {"state": "ok", "role": "decode", "in_flight": 2,
               "queue_depth": 1, "blocks_in_use": 5, "blocks_total": 16,
               "tiers": {"dram": 3, "disk": 1}, "ttft_p99_s": 0.01,
               "slo_burn": 0.5},
        "r1": {"state": "dead", "role": "decode", "in_flight": 0,
               "queue_depth": None, "blocks_in_use": None,
               "blocks_total": None, "ttft_p99_s": None, "slo_burn": None}},
    "controller": {"live": 2, "min": 1, "max": 8, "heals": 1,
                   "wedge_kills": 0, "scale_events": 2, "spawn_tokens": 4,
                   "draining": ["r2"], "abandoned": ["r3"]}}
TOP_ALERTS = {"firing": [{"rule": "fleet_dead_replicas", "value": 1.0,
                          "op": ">=", "threshold": 1,
                          "description": "a replica died"}]}
GANG_HEALTH = {
    "state": "running", "epoch": 3, "gang_size": 2, "restarts": 1,
    "goodput": {"goodput_fraction": 0.91, "wall_accounted_s": 12.5,
                "totals": {"useful_step": 11.4, "restart": 1.1}},
    "workers": {"0": {"step": 40, "since_step_s": 0.2, "step_p50_s": 0.05,
                      "barrier_p50_s": 0.001, "age": 0.1},
                "1": {"step": 39, "done": True, "since_step_s": 1.5,
                      "step_p50_s": 0.07, "barrier_p50_s": 0.02,
                      "age": 0.3}},
    "straggler": {"skew": {"p50": 0.01, "p99": 0.03},
                  "straggler_rank": 1, "rule": "step_p50"}}


@pytest.mark.parametrize("health,alerts", [
    (TOP_HEALTH, TOP_ALERTS), (TOP_HEALTH, {}),
    ({**TOP_HEALTH, "controller": None, "shed": 0}, {}),
    ({"replicas": {}}, {"firing": []})])
def test_render_top_frames_equal(health, alerts):
    frame = tcli._render_top(health, alerts)
    assert frame == jcli._render_top(health, alerts)
    assert "fleet:" in frame.splitlines()[0]


def test_render_top_frame_contents():
    frame = tcli._render_top(TOP_HEALTH, TOP_ALERTS)
    assert "r0" in frame and "5/16" in frame and "dead" in frame
    assert "fleet_dead_replicas" in frame and "0.0123" in frame
    assert "shed 3" in frame and "controller: live 2 [1..8]" in frame
    assert "draining r2" in frame and "ABANDONED r3" in frame


@pytest.mark.parametrize("alerts", [TOP_ALERTS, {}])
def test_render_gang_top_frames_equal(alerts):
    frame = tcli._render_gang_top(GANG_HEALTH, alerts)
    assert frame == jcli._render_gang_top(GANG_HEALTH, alerts)
    assert "gang: state running  epoch 3" in frame
    assert "straggler rank 1 (step_p50)" in frame


def test_job_top_one_frame_over_http(monkeypatch, capsys):
    def run(side):
        reps = [REPLICA[side].EngineReplica(engine(side), "r0")]
        router = ROUTER[side].Router(reps, block_size=8, chunk_tokens=16,
                                     health_poll_s=0.0)
        router.submit(np.arange(9, dtype=np.int32), 3)
        router.run_until_idle()
        srv = router.serve(port=0)
        try:
            rc, out = run_main(side, ["top", "--url", srv.url,
                                      "--top_iterations", "1",
                                      "--top_interval_s", "0.05"], "",
                               monkeypatch, capsys)
        finally:
            srv.close()
            router.close()
        assert rc == 0
        # the fleet's TTFT p99 is a time: compared as present, not equal
        return re.sub(r"\d+\.\d{4}", "T", out)
    out = both(run)
    assert "REPLICA" in out and "r0" in out


def test_top_unreachable_url_fails(capsys):
    rc = tcli.main(["top", "--url", "http://127.0.0.1:9",
                    "--top_iterations", "1", "--top_interval_s", "0.05"])
    assert rc == 1
    assert "unreachable" in capsys.readouterr().err


def test_process_fleet_sigkill_healed_zero_lost(artifact):
    """Two CPU replica processes behind the router and the controller;
    one is SIGKILLed once both hold work. Its requests requeue onto the
    survivor, the controller respawns it under its name, and every
    request completes with the in-process engine's greedy ids."""
    ps = [np.random.RandomState(20 + i).randint(0, 40, 6 + 4 * i)
          for i in range(6)]
    want = ref_outputs(ps, 8)
    fleet = ServingFleet(artifact, replicas=2, args_extra=["--device=cpu"],
                         startup_timeout_s=120)
    fleet.start()
    router = ctrl = None
    try:
        router = fleet.router(max_in_flight=2, health_poll_s=0.05)
        ctrl = FleetController(router, fleet, backoff_base=0.05,
                               backoff_cap=0.1, scale_up_queue=0,
                               scale_down_idle_s=1e9)
        reqs = [router.submit(p, 8) for p in ps]
        deadline = time.time() + 240
        while not all(st.in_flight for st in router._all):
            router.step()
            assert time.time() < deadline
        old_pid = fleet.procs[0].pid
        fleet.kill(0)
        while not (router.idle and router.replica_states()["replica0"]
                   == "ok"):
            router.step()
            ctrl.step()
            assert time.time() < deadline, router.health()
        assert [r.status for r in reqs] == ["done"] * len(reqs)
        assert [list(r.tokens) for r in reqs] == \
            [list(w[len(p):]) for p, w in zip(ps, want)]
        assert router._m_requeued.value() >= 1
        assert ctrl._m_heals.value(result="healed") == 1
        assert fleet.procs[0].pid != old_pid and fleet.proc_alive("replica0")
        # the healed process serves
        r = router.submit(ps[0], 8)
        while not router.idle:
            router.step()
            assert time.time() < deadline
        assert r.status == "done" and list(r.tokens) == \
            list(want[0][len(ps[0]):])
    finally:
        if router is not None:
            router.close()
        fleet.close()
    assert all(p.poll() is not None for p in fleet.procs) or not fleet.procs
