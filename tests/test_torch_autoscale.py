"""The fleet's control plane against ``paddle_tpu``'s, on the CPU.

Every case runs twice, once through each package: the same
``FakeFleet`` / ``FakeReplica`` / ``Clock`` script of
``tests/test_autoscale.py`` behind the JAX ``Router`` and
``FleetController``, then behind the port's; or ``InProcessFleet`` over
JAX engines (``pallas="off"``) against port engines holding the same
weights. The two runs must agree on:

- the router's states, request outcomes and counters, the controller's
  ``fleet_*`` counters and gauges, its ``summary()`` and ``health()``;
- every decision it wrote to the flight recorder (action, replica and
  detail; the wall time ``t`` aside). Both controllers draw their
  backoff from a ``random.Random(0)`` per restart budget, so their
  jitter is the same;
- the fakes' spawn and stop logs; ``ServingFleet``'s name claims;
- greedy ids after a heal, and the blocks a heal re-warms.

The cases are ``tests/test_autoscale.py``'s ``TestHealing``,
``TestNameClaim``, ``TestScaling`` and ``TestInProcessFleet``, each with
the reference's own assertions kept on the port's run.
"""

import random
import threading
import time
import types

import numpy as np
import pytest

from paddle_tpu.observe import flight as jflight
from paddle_tpu.runtime import master as jmaster
from paddle_tpu.serving import autoscale as jautoscale
from paddle_tpu_torch.observe import flight as tflight
from paddle_tpu_torch.runtime import master as tmaster
from paddle_tpu_torch.serving import autoscale as tautoscale
from test_autoscale import Clock, FakeFleet, _FakeProc
from test_fleet import FakeReplica
from test_torch_fleet import (ROUTER, both, engine, metrics_view,
                              prompts, ref_outputs, req_view)

AUTOSCALE = {"jax": jautoscale, "port": tautoscale}
MASTER = {"jax": jmaster, "port": tmaster}
FLIGHT = {"jax": jflight, "port": tflight}


@pytest.fixture(autouse=True)
def seeded_backoff(monkeypatch):
    """Every DecorrelatedBackoff either package makes draws from its own
    ``random.Random(0)``: equal jitter on both sides."""
    for m in MASTER.values():
        monkeypatch.setattr(m, "random", types.SimpleNamespace(
            Random=lambda: random.Random(0)))


def controller(side, router, fleet, clock, **kw):
    """``tests/test_autoscale.py::_controller`` for either package."""
    kw.setdefault("backoff_base", 0.1)
    kw.setdefault("backoff_cap", 0.2)
    kw.setdefault("scale_up_queue", 0)
    kw.setdefault("scale_up_burn", 0.0)
    kw.setdefault("scale_down_idle_s", 1e9)
    kw.setdefault("hysteresis_s", 0.0)
    FLIGHT[side].default_flight_recorder().clear()
    return AUTOSCALE[side].FleetController(router, fleet, clock=clock, **kw)


def fake_router(side, n=2, caps=4, **kw):
    reps = [FakeReplica(f"r{i}") for i in range(n)]
    kw.setdefault("health_poll_s", 0.0)
    router = ROUTER[side].Router(reps, block_size=4, chunk_tokens=8,
                                 max_in_flight=caps, **kw)
    return reps, router


def decisions(side):
    return [{k: v for k, v in rec.items() if k != "t"}
            for rec in FLIGHT[side].default_flight_recorder().records()
            if rec.get("actor") == "fleet_controller"]


def control_view(side, router, ctrl, fleet=None, reqs=()):
    view = {"states": router.replica_states(),
            "requests": [req_view(r) for r in reqs],
            "metrics": metrics_view(router.metrics),
            "summary": ctrl.summary(), "health": ctrl.health(),
            "router_controller": router.health().get("controller"),
            "decisions": decisions(side)}
    if fleet is not None:
        view["spawn_log"] = list(fleet.spawn_log)
        view["stopped"] = list(fleet.stopped)
    return view


def heal_and_rewarm(side, ps):
    """``TestInProcessFleet``'s heal script over ``ps``: two engines of
    ``side``, the first three prompts served, the prefix's home killed,
    the rest submitted, the controller's heal and re-warm after its
    backoff. Returns the control view with the healed engine's imported
    blocks, and the fleet's exported blocks."""
    fleet = AUTOSCALE[side].InProcessFleet(lambda name: engine(side))
    for i in range(2):
        fleet.spawn(f"replica{i}")
    handles = [fleet.handle(f"replica{i}") for i in range(2)]
    router = ROUTER[side].Router(handles, block_size=8, chunk_tokens=16,
                                 max_in_flight=2, health_poll_s=0.0,
                                 fetch_flops_per_byte=0.0)
    clock = Clock()
    ctrl = controller(side, router, fleet, clock)
    reqs = [router.submit(p, 4) for p in ps[:3]]
    router.run_until_idle()
    home = reqs[0].replica
    fleet.kill_name(home)
    reqs += [router.submit(p, 4) for p in ps[3:]]
    router.step()
    ctrl.step()                             # heal scheduled (backoff)
    clock.advance(1.0)
    ctrl.step()                             # respawned, rewarm issued
    router.run_until_idle()
    assert all(r.status == "done" for r in reqs)
    healed = fleet.handle(home).eng
    view = control_view(side, router, ctrl, reqs=reqs)
    exported = view["metrics"].pop("fleet_engine_kv_blocks_exported_total")
    return {"home": home, "imported": healed.metrics.get(
        "engine_kv_blocks_imported_total").value(), **view}, exported[0][1]


def submit(router, n, base=6, max_new=2, **kw):
    return [router.submit(np.arange(base, dtype=np.int32) + i, max_new, **kw)
            for i in range(n)]


# -- self-healing -----------------------------------------------------------

class TestHealing:
    def test_killed_replica_healed_and_serving_again(self):
        def run(side):
            reps, router = fake_router(side, 2, caps=8)
            fleet = FakeFleet().adopt(reps)
            clock = Clock()
            ctrl = controller(side, router, fleet, clock, rewarm=False)
            first = submit(router, 4)
            router.run_until_idle()
            reps[0].kill()
            router.step()
            assert router.replica_states()["r0"] == "dead"
            ctrl.step()
            assert router.replica_states()["r0"] == "dead"
            clock.advance(1.0)
            ctrl.step()
            assert router.replica_states()["r0"] == "ok"
            assert fleet.spawn_log == ["r0"]
            assert fleet.handles["r0"] is not reps[0]
            assert ctrl._m_heals.value(result="healed") == 1
            reqs = submit(router, 6)
            router.run_until_idle()
            assert all(r.status == "done" for r in reqs)
            return control_view(side, router, ctrl, fleet, first + reqs)
        got = both(run)
        assert [d["action"] for d in got["decisions"]] == \
            ["heal_scheduled", "healed"]

    def test_heal_respects_backoff_delay(self):
        def run(side):
            reps, router = fake_router(side, 2, caps=8)
            fleet = FakeFleet().adopt(reps)
            clock = Clock()
            ctrl = controller(side, router, fleet, clock, rewarm=False,
                              backoff_base=5.0, backoff_cap=10.0)
            reps[0].kill()
            router.step()
            ctrl.step()
            clock.advance(1.0)
            ctrl.step()
            waiting = list(fleet.spawn_log)
            clock.advance(30.0)
            ctrl.step()
            return {"waiting": waiting,
                    **control_view(side, router, ctrl, fleet)}
        got = both(run)
        assert got["waiting"] == [] and got["spawn_log"] == ["r0"]
        assert 5.0 <= got["decisions"][0]["delay_s"] <= 10.0

    def test_exhausted_budget_retires_replica(self):
        def run(side):
            reps, router = fake_router(side, 2, caps=8)
            fleet = FakeFleet().adopt(reps)
            fleet.fail_spawns = 99
            clock = Clock()
            ctrl = controller(side, router, fleet, clock, rewarm=False,
                              max_restarts=2, stable_window=1e9)
            reps[0].kill()
            router.step()
            for _ in range(20):
                ctrl.step()
                clock.advance(5.0)
            assert "r0" not in router.replica_states()
            assert ctrl._m_heals.value(result="failed") >= 1
            assert ctrl._m_abandoned.value() == 1
            assert ctrl.summary()["abandoned"] == ["r0"]
            r = router.submit(np.arange(5, dtype=np.int32), 2)
            router.run_until_idle()
            assert r.status == "done"
            return control_view(side, router, ctrl, fleet, [r])
        got = both(run)
        assert got["decisions"][-1]["action"] == "heal_abandoned"

    def test_rewarm_relays_prefix_from_warm_survivor(self):
        def run(side):
            reps, router = fake_router(side, 2, caps=16)
            fleet = FakeFleet().adopt(reps)
            clock = Clock()
            ctrl = controller(side, router, fleet, clock, rewarm=True)
            shared = np.arange(17, dtype=np.int32)
            reqs = [router.submit(np.concatenate(
                [shared, np.full(2 + i, 30 + i, np.int32)]), 2)
                for i in range(3)]
            router.run_until_idle()
            home = next(st for st in router._all
                        if st.name == reqs[0].replica)
            other = next(st for st in router._all if st is not home)
            other.mark_hot(reqs[0].digests[:4])
            other.handle.export_reply = {
                "op": "export_prefix", "payload": "QUJD", "blocks": 4}
            home.handle.kill()
            router.step()
            ctrl.step()
            clock.advance(1.0)
            ctrl.step()
            router.run_until_idle()
            assert router._m_rewarm.value(result="shipped") == 1
            healed = fleet.handles[home.name]
            assert any(s.get("op") == "import_prefix" for s in healed.seen)
            assert any(e["replica"] == home.name
                       for e in router.directory().values())
            return {"healed_seen": healed.seen,
                    "directory": router.directory(),
                    **control_view(side, router, ctrl, fleet, reqs)}
        got = both(run)
        assert got["decisions"][-1]["rewarm_exports"] == 1

    def test_wedged_replica_killed_then_work_recovers(self):
        def run(side):
            reps = [FakeReplica("r0", delay_steps=10**9),
                    FakeReplica("r1")]
            router = ROUTER[side].Router(reps, block_size=4,
                                         chunk_tokens=8, max_in_flight=4,
                                         health_poll_s=0.0)
            fleet = FakeFleet().adopt(reps)
            clock = Clock()
            ctrl = controller(side, router, fleet, clock, heal=False,
                              wedge_timeout_s=5.0)
            r = router.submit(np.arange(6, dtype=np.int32), 2)
            router.step()
            assert r.replica == "r0"
            ctrl.step()
            clock.advance(6.0)
            ctrl.step()
            assert ctrl._m_wedge.value() == 1
            assert not reps[0].alive()
            router.run_until_idle()
            assert r.status == "done" and r.replica == "r1"
            return control_view(side, router, ctrl, fleet, [r])
        got = both(run)
        assert got["decisions"][0]["action"] == "wedge_kill"


# -- atomic name claims (ServingFleet) --------------------------------------

class TestNameClaim:
    def _fleet(self, side, monkeypatch, launch_delay=0.0):
        fleet = MASTER[side].ServingFleet("model.tar", replicas=1)

        def _launch(name):
            if launch_delay:
                time.sleep(launch_delay)
            return _FakeProc()

        monkeypatch.setattr(fleet, "_launch", _launch)
        monkeypatch.setattr(
            fleet, "_await_ready",
            lambda name, proc, deadline, close_fleet=False: {
                "name": name, "port": 1, "health_port": None})
        return fleet

    def test_concurrent_replacements_cannot_share_a_name(self, monkeypatch):
        def run(side):
            fleet = self._fleet(side, monkeypatch, launch_delay=0.05)
            results = []

            def worker():
                try:
                    results.append(fleet.spawn("replica0"))
                except RuntimeError as e:
                    results.append(str(e))

            ts = [threading.Thread(target=worker) for _ in range(2)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            return {"oks": [r for r in results if isinstance(r, dict)],
                    "errors": sorted(r for r in results
                                     if isinstance(r, str)),
                    "endpoints": fleet.endpoints}
        got = both(run)
        assert len(got["oks"]) == 1 and len(got["errors"]) == 1
        assert len(got["endpoints"]) == 1

    def test_replacement_inherits_name_and_slot(self, monkeypatch):
        def run(side):
            fleet = self._fleet(side, monkeypatch)
            fleet.spawn("replica0")
            fleet._by_name["replica0"].rc = -9
            fleet.spawn("replica0")
            with pytest.raises(RuntimeError) as err:
                fleet.spawn("replica0")
            return {"endpoints": fleet.endpoints, "procs": len(fleet.procs),
                    "error": str(err.value),
                    "alive": fleet.proc_alive("replica0")}
        got = both(run)
        assert [e["name"] for e in got["endpoints"]] == ["replica0"]
        assert got["procs"] == 1

    def test_allocate_name_skips_claimed(self, monkeypatch):
        def run(side):
            fleet = self._fleet(side, monkeypatch)
            fleet.spawn("replica0")
            return [fleet.allocate_name(), fleet.spawn()["name"],
                    fleet.allocate_name()]
        assert both(run) == ["replica1", "replica1", "replica2"]

    def test_fleet_arguments_refused_alike(self):
        def run(side):
            errs = []
            for kw in ({"replicas": 0}, {"replicas": 2, "prefill": 2}):
                with pytest.raises(ValueError) as e:
                    MASTER[side].ServingFleet("m.tar", **kw)
                errs.append(str(e.value))
            return errs
        both(run)


# -- elastic capacity -------------------------------------------------------

class TestScaling:
    def test_scale_up_after_hysteresis_only(self):
        def run(side):
            reps, router = fake_router(side, 1, caps=1)
            reps[0].delay = 10**9
            fleet = FakeFleet().adopt(reps)
            clock = Clock()
            ctrl = controller(side, router, fleet, clock, scale_up_queue=3,
                              hysteresis_s=5.0, max_replicas=4)
            reqs = submit(router, 6, base=5)
            router.step()
            ctrl.step()
            clock.advance(1.0)
            ctrl.step()
            held = len(router._all)
            clock.advance(6.0)
            ctrl.step()
            assert len(router._all) == 2
            assert ctrl._m_scale.value(direction="up") == 1
            reps[0].delay = 1
            reps[0].work[0][1] = 1
            router.run_until_idle()
            assert all(r.status == "done" for r in reqs)
            return {"held": held,
                    **control_view(side, router, ctrl, fleet, reqs)}
        got = both(run)
        assert got["held"] == 1
        assert got["decisions"][0]["action"] == "scale_up"

    def test_spawn_budget_caps_flapping(self):
        def run(side):
            reps, router = fake_router(side, 1, caps=1)
            reps[0].delay = 10**9
            fleet = FakeFleet().adopt(reps)
            clock = Clock()
            ctrl = controller(side, router, fleet, clock, scale_up_queue=2,
                              hysteresis_s=0.0, max_replicas=8,
                              spawn_budget=2, spawn_budget_window_s=300.0)
            submit(router, 40, base=5, tier="latency")
            for _ in range(6):
                router.step()
                ctrl.step()
                clock.advance(1.0)
            assert len(router._all) == 3
            assert ctrl._m_scale_blocked.value(reason="budget") >= 1
            assert ctrl.summary()["spawn_tokens"] == 0
            return control_view(side, router, ctrl, fleet)
        both(run)

    def test_scale_down_drains_newest_to_min(self):
        def run(side):
            reps, router = fake_router(side, 3, caps=8)
            fleet = FakeFleet().adopt(reps)
            clock = Clock()
            ctrl = controller(side, router, fleet, clock, min_replicas=2,
                              scale_down_idle_s=10.0)
            r = router.submit(np.arange(5, dtype=np.int32), 2)
            router.run_until_idle()
            assert r.status == "done"
            ctrl.step()
            clock.advance(11.0)
            ctrl.step()
            for _ in range(3):
                ctrl.step()
            assert "r2" not in router.replica_states()
            assert fleet.stopped == ["r2"]
            assert ctrl._m_scale.value(direction="down") == 1
            clock.advance(11.0)
            for _ in range(3):
                ctrl.step()
            assert len(router._all) == 2
            return control_view(side, router, ctrl, fleet, [r])
        got = both(run)
        assert [d["action"] for d in got["decisions"]] == \
            ["scale_down", "drained"]

    def test_drain_hold_survives_health_repromotion(self):
        def run(side):
            reps, router = fake_router(side, 2, caps=8)
            reps[0].delay = 3
            r = router.submit(np.arange(5, dtype=np.int32), 2)
            router.step()
            assert r.replica == "r0"
            router.begin_drain("r0")
            states = [router.replica_states()["r0"]]
            router.step()
            states.append(router.replica_states()["r0"])
            router.run_until_idle()
            assert r.status == "done" and r.replica == "r0"
            return {"states": states, "request": req_view(r)}
        assert both(run)["states"] == ["unhealthy", "unhealthy"]

    def test_controller_summary_in_router_health(self):
        def run(side):
            reps, router = fake_router(side, 2, caps=8)
            fleet = FakeFleet().adopt(reps)
            ctrl = controller(side, router, fleet, Clock())
            doc = router.health()
            assert doc["controller"]["live"] == 2
            assert doc["controller"]["min"] == 1
            assert ctrl.health()["healthy"]
            return control_view(side, router, ctrl, fleet)
        both(run)

    def test_controller_health_server(self):
        import json
        import urllib.request

        def run(side):
            reps, router = fake_router(side, 2, caps=8)
            ctrl = controller(side, router, FakeFleet().adopt(reps), Clock())
            srv = ctrl.serve(port=0)
            try:
                with urllib.request.urlopen(srv.url + "/healthz",
                                            timeout=5) as r:
                    doc = json.loads(r.read())
                with urllib.request.urlopen(srv.url + "/metrics",
                                            timeout=5) as r:
                    text = r.read().decode()
            finally:
                srv.close()
            return {"healthz": {k: v for k, v in doc.items()},
                    "fleet_series": sorted(
                        line.split("{")[0].split(" ")[0]
                        for line in text.splitlines()
                        if line.startswith("fleet_"))}
        got = both(run)
        assert got["healthz"]["live"] == 2
        assert "fleet_target_replicas" in got["fleet_series"]


# -- in-process fleet over real engines ------------------------------------

class TestInProcessFleet:
    def test_spawn_heal_roundtrip(self):
        ps = [np.arange(9, dtype=np.int32) + i for i in range(4)]
        want = ref_outputs(ps, 3)

        def run(side):
            fleet = AUTOSCALE[side].InProcessFleet(lambda name: engine(side))
            fleet.spawn("replica0")
            fleet.spawn("replica1")
            handles = [fleet.handle(f"replica{i}") for i in range(2)]
            router = ROUTER[side].Router(handles, block_size=8,
                                         chunk_tokens=16, health_poll_s=0.0)
            reqs = [router.submit(p, 3) for p in ps]
            router.run_until_idle()
            assert all(r.status == "done" for r in reqs)
            with pytest.raises(RuntimeError):
                fleet.spawn("replica0")
            fleet.kill_name("replica0")
            router.step()
            fleet.spawn("replica0")
            router.replace_replica("replica0", fleet.handle("replica0"))
            reqs2 = [router.submit(p, 3) for p in ps]
            router.run_until_idle()
            assert all(r.status == "done" for r in reqs2)
            return {"requests": [req_view(r) for r in reqs + reqs2],
                    "states": router.replica_states()}
        got = both(run)
        ids = [r["tokens"] for r in got["requests"]]
        assert ids == [list(w[len(p):]) for p, w in zip(ps, want)] * 2

    def test_controller_heals_and_rewarms_from_survivor(self):
        """Two engines; the shared prefix lands on one, the in-flight cap
        spills a later request onto the other, which fetches the prefix
        warm; the prefix's home dies mid-trace and the controller
        respawns it under its name and re-warms it from the survivor
        over the PTKV wire. Greedy ids equal the single engine's, and
        every decision and counter equals the reference's but for the
        re-warm's size: the port's router keeps one token past a
        prompt's prefix as its rewarm seed, so the survivor exports the
        whole prefix, where the reference's exports one chunk less
        (ROADMAP C7)."""
        ps = prompts(seed=5, n=6, shared_len=32)
        want = ref_outputs(ps, 4)
        per = 16 // 8                       # blocks in a chunk
        (jview, jexported), (tview, texported) = (
            heal_and_rewarm(side, ps) for side in ("jax", "port"))
        assert tview == jview
        assert [r["tokens"] for r in tview["requests"]] == \
            [list(w[len(p):]) for p, w in zip(ps, want)]
        assert [d["action"] for d in tview["decisions"]] == \
            ["heal_scheduled", "healed"]
        assert tview["decisions"][-1]["rewarm_exports"] == 1
        assert tview["imported"] > 0
        # the survivor's rewarm export: the 32-token prefix's 4 blocks
        # from the port, one chunk less from the reference
        assert texported == jexported + per

    def test_reference_rewarm_misses_a_one_chunk_prefix(self):
        """ROADMAP C7 pinned where it bites hardest: a shared prefix of
        exactly one chunk. The reference's rewarm seed is the bare
        prefix, which the survivor counts one chunk short, so it exports
        nothing and the re-warm is a miss; the port's seed exports the
        chunk and ships it. Everything else is the same on both: the
        greedy ids, and the healed engine's imported blocks, which the
        reference's gets later from a directory fetch."""
        ps = prompts(seed=5, n=6, shared_len=16)
        want = ref_outputs(ps, 4)
        per = 16 // 8
        (jview, jexported), (tview, texported) = (
            heal_and_rewarm(side, ps) for side in ("jax", "port"))
        for view in (jview, tview):
            assert [r["tokens"] for r in view["requests"]] == \
                [list(w[len(p):]) for p, w in zip(ps, want)]
            assert [d["action"] for d in view["decisions"]] == \
                ["heal_scheduled", "healed"]
        rewarm = {side: dict((tuple(k), v) for k, v in
                             view["metrics"].pop("router_rewarm_total"))
                  for side, view in (("jax", jview), ("port", tview))}
        assert rewarm["jax"] == {(("result", "miss"),): 1}
        assert rewarm["port"] == {(("result", "shipped"),): 1}
        assert texported == jexported + per
        assert tview == jview
