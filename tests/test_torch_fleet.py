"""The fleet's data plane against ``paddle_tpu``'s, on the CPU.

Every case runs twice, once through each package: the JAX replica loop,
transports and ``Router`` over JAX engines (``paged_step_fns(...,
pallas="off")``, one jitted pair per module, as ``tests/test_fleet.py``
builds them), then the port's over port engines holding the same
weights (``transformer.params_from_numpy``), or both routers over the
same scripted ``FakeReplica`` handles of ``tests/test_fleet.py``. The
two runs must agree:

- the replica loop's JSONL result documents, key order included, equal
  without their two time fields (``ttft_ms``, ``latency_ms``); export
  payloads carry the same PTKV header and digests, block values within
  1e-4, the port's bytes are JAX's wire for its values, and each
  package's payload adopts in the other's loop and exports again byte
  for byte;
- the routers' placements, request states, requeue / P/D / shed /
  fetch counters, replica states, fleet-aggregated counters and gauges,
  the cache directory and the request-log records equal (times and the
  time-valued window series are never compared); greedy ids exactly;
  sampled ids exactly where the placements are equal (the JAX engines
  then sample the Pallas kernel's hashed stream, in interpret mode).

The cases are ``tests/test_fleet.py``'s ``TestEngineLoop``,
``TestReplicaServer``, ``TestRouterPlacement`` and ``TestRouterEngines``,
``tests/test_tiered_cache.py``'s ``TestFleetDirectory`` and
``tests/test_autoscale.py``'s ``TestAdmission``,
``TestFleetTenantFairness`` and ``TestDirectoryInvalidation``, each with
the reference's own assertions kept on the port's run.
"""

import base64
import functools
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import transformer as jt
from paddle_tpu.serving import PagedDecodeEngine as JaxEngine
from paddle_tpu.serving import replica as jreplica
from paddle_tpu.serving import router as jrouter
from paddle_tpu.serving import sampling as jsampling
from paddle_tpu.serving import tiers as jtiers
from paddle_tpu.serving import transfer as jtransfer
from paddle_tpu_torch.models import transformer as tt
from paddle_tpu_torch.serving import PagedDecodeEngine
from paddle_tpu_torch.serving import blocks as tblocks
from paddle_tpu_torch.serving import replica as treplica
from paddle_tpu_torch.serving import router as trouter
from paddle_tpu_torch.serving import tiers as ttiers
from test_fleet import FakeReplica

torch.set_num_threads(1)

SIDES = ("jax", "port")
REPLICA = {"jax": jreplica, "port": treplica}
ROUTER = {"jax": jrouter, "port": trouter}
TIERS = {"jax": jtiers, "port": ttiers}
KW = dict(vocab=40, d_model=16, n_heads=2, n_kv_heads=1, n_layers=2,
          d_ff=32, max_len=64, use_rope=True)
BS = 8
# result-document fields that are times
TIME_DOC = ("ttft_ms", "latency_ms")
# registry series whose values are times or rates over time
TIME_METRICS = ("seconds", "window", "per_sec", "burn", "mfu")
# request-log fields that are times or name the router instance
TIME_RECORD = ("trace_id", "queue_wait_s", "ttft_s", "latency_s")


# -- the two packages' engines ----------------------------------------------

@functools.lru_cache(maxsize=None)
def _model():
    jcfg = jt.TransformerConfig(dtype=jnp.float32, **KW)
    tcfg = tt.TransformerConfig(dtype=torch.float32, **KW)
    jp = jt.init_params(jax.random.PRNGKey(0), jcfg)
    tp = tt.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                              device="cpu")
    return jcfg, jp, tcfg, tp


@functools.lru_cache(maxsize=None)
def _programs(pallas):
    pf, df = jsampling.paged_step_fns(_model()[0], BS, pallas=pallas)
    return jax.jit(pf), jax.jit(df)


def engine(side, *, batch=2, num_blocks=None, kv_dtype=None, tiers=None,
           decode_flops=None, pallas="off"):
    """A paged engine of ``side`` over the shared tiny model: batch 2,
    64 positions, blocks of 8, chunks of 16, seed 0."""
    jcfg, jp, tcfg, tp = _model()
    nb = num_blocks if num_blocks is not None else batch * 8
    common = dict(batch=batch, cache_len=64, block_size=BS, num_blocks=nb,
                  chunk_tokens=16, seed=0, kv_dtype=kv_dtype, tiers=tiers,
                  decode_flops=decode_flops)
    if side == "jax":
        pool = jt.init_block_pool(jcfg, nb, BS, kv_dtype=kv_dtype)
        return JaxEngine(*_programs(pallas), jp, pool, pallas_mode=pallas,
                         **common)
    return PagedDecodeEngine.from_params(tp, tcfg, device="cpu", **common)


def ref_outputs(prompts, max_new):
    """Colocated single-engine greedy outputs (the port's engine; the
    JAX engine gives the same ids, which every fleet case checks again
    through its JAX run)."""
    eng = engine("port")
    out = []
    for p in prompts:
        r = eng.submit(p, max_new)
        eng.run_until_idle()
        out.append([int(t) for t in r.output])
    return out


def prompts(seed=3, n=6, shared_len=24):
    rng = np.random.RandomState(seed)
    shared = rng.randint(0, 40, shared_len).astype(np.int32)
    return [np.concatenate([shared,
                            rng.randint(0, 40, 5 + i).astype(np.int32)])
            for i in range(n)]


def both(run):
    """``run(side)`` through each package; the two results must be equal
    (dicts in the same key order). Returns the port's."""
    want, got = run("jax"), run("port")
    assert got == want
    assert json.dumps(got, default=str) == json.dumps(want, default=str)
    return got


# -- what a run is compared by ----------------------------------------------

def doc_view(doc):
    return {k: v for k, v in doc.items() if k not in TIME_DOC}


def req_view(r):
    return {"xid": r.xid, "status": r.status, "replica": r.replica,
            "prefill_replica": r.prefill_replica,
            "tokens": [int(t) for t in r.tokens],
            "finish_reason": r.finish_reason, "error": r.error,
            "requeues": r.requeues, "placements": r.placements,
            "prefix_score": r.prefix_score, "usable": r.usable,
            "digests": [d.hex() for d in r.digests],
            "payload_blocks": r.payload_blocks,
            "trace": r.trace_id.rsplit(".", 1)[-1]}


def metrics_view(reg):
    """Counters and gauges of a registry, without the time-valued ones."""
    out = {}
    for name, doc in reg.snapshot().items():
        if doc["kind"] == "histogram" or any(t in name
                                             for t in TIME_METRICS):
            continue
        out[name] = [(sorted(s["labels"].items()), s["value"])
                     for s in doc["series"]]
    return out


def health_view(doc):
    doc = {k: v for k, v in doc.items() if k != "window"}
    doc["replicas"] = {
        n: {k: v for k, v in rep.items()
            if k not in ("ttft_p99_s", "slo_burn")}
        for n, rep in doc["replicas"].items()}
    return doc


def router_view(router, reqs=()):
    return {"requests": [req_view(r) for r in reqs],
            "states": router.replica_states(),
            "queue_depth": router.queue_depth,
            "outstanding": router.outstanding,
            "idle": router.idle,
            "metrics": metrics_view(router.metrics),
            "health": health_view(router.health()),
            "directory": router.directory(),
            "log": [{k: v for k, v in rec.items() if k not in TIME_RECORD}
                    for rec in router.request_log.records()]}


def fake_router(side, n=2, caps=4, **kw):
    reps = [FakeReplica(f"r{i}") for i in range(n)]
    kw.setdefault("health_poll_s", 0.0)
    router = ROUTER[side].Router(reps, block_size=4, chunk_tokens=8,
                                 max_in_flight=caps, **kw)
    return reps, router


def loop_docs(sink):
    return [doc_view(d) for d in sink.docs]


def same_payload(jdoc, tdoc):
    """Two export documents: the same keys in the same order, the same
    PTKV header (layout, storage, block size, arrays, digests) and block
    values within the CPU model tolerance (1e-4: the two frameworks'
    fp32 prefills differ in the last bits), and the port's payload is
    the byte string JAX's wire writes for the port's own values."""
    assert list(tdoc) == list(jdoc)
    assert {k: v for k, v in tdoc.items() if k != "payload"} == \
        {k: v for k, v in jdoc.items() if k != "payload"}
    jraw, traw = (base64.b64decode(d["payload"]) for d in (jdoc, tdoc))
    jmeta, jitems = jtransfer.deserialize_blocks(jraw)
    tmeta, titems = jtransfer.deserialize_blocks(traw)
    assert tmeta == jmeta and list(tmeta) == list(jmeta)
    assert len(titems) == len(jitems) == tdoc["blocks"]
    for (jd, ja), (td, ta) in zip(jitems, titems):
        assert td == jd and list(ta) == list(ja)
        for n in ja:
            np.testing.assert_allclose(ta[n], ja[n], rtol=0, atol=1e-4)
    assert jtransfer.serialize_raw_blocks(
        tmeta, titems, trace=tmeta.get("trace")) == traw


# -- the replica loop (drain + ops) -----------------------------------------

class TestEngineLoop:
    def test_drain_finishes_in_flight(self):
        def run(side):
            eng = engine(side)
            mod = REPLICA[side]
            loop, sink = mod.EngineLoop(eng), mod.ListReply()
            loop.feed({"id": 7, "prompt": [1, 2, 3], "max_new": 6}, sink)
            loop.step_once()
            assert not eng.idle
            loop.drain()
            assert loop.run() == 0
            return loop_docs(sink)
        docs = both(run)
        done = [d for d in docs if "tokens" in d]
        assert len(done) == 1 and done[0]["id"] == 7
        assert len(done[0]["tokens"]) == 6
        assert done[0]["finish_reason"] == "max_tokens"

    def test_drain_covers_already_queued_lines(self):
        def run(side):
            mod = REPLICA[side]
            loop, sink = mod.EngineLoop(engine(side)), mod.ListReply()
            loop.feed(json.dumps({"prompt": [4, 5], "max_new": 3}), sink)
            loop.drain()
            assert loop.run() == 0
            return loop_docs(sink)
        docs = both(run)
        assert len([d for d in docs if "tokens" in d]) == 1

    def test_drain_seals_against_streaming_client(self):
        def run(side):
            mod = REPLICA[side]
            loop, sink = mod.EngineLoop(engine(side)), mod.ListReply()
            loop.feed({"id": 1, "prompt": [1, 2, 3], "max_new": 4}, sink)
            loop.drain()
            assert loop.pump()
            loop.feed({"id": 2, "prompt": [4, 5], "max_new": 4}, sink)
            loop.feed(json.dumps({"id": 3, "prompt": [6], "max_new": 2}),
                      sink)
            refused = [d.get("id") for d in sink.docs if "error" in d]
            assert loop.run() == 0
            return {"refused": refused, "docs": loop_docs(sink)}
        got = both(run)
        assert got["refused"] == [2, 3]
        errs = [d for d in got["docs"] if "error" in d]
        assert all(d["error"].startswith("draining") for d in errs)
        done = [d for d in got["docs"] if "tokens" in d]
        assert len(done) == 1 and done[0]["id"] == 1
        assert len(done[0]["tokens"]) == 4

    def test_malformed_lines_error_not_crash(self):
        def run(side):
            mod = REPLICA[side]
            loop, sink = mod.EngineLoop(engine(side)), mod.ListReply()
            loop.feed("not json", sink)
            loop.feed(json.dumps({"id": 3, "prompt": [], "max_new": 2}),
                      sink)
            loop.feed(json.dumps({"id": 4, "op": "wat"}), sink)
            loop.feed_eof()
            assert loop.run() == 0
            return loop_docs(sink)
        docs = both(run)
        errs = [d for d in docs if "error" in d]
        assert len(errs) == 3
        assert any("bad json" in e["error"] for e in errs)
        assert {e.get("id") for e in errs} == {None, 3, 4}

    def test_export_import_ops(self):
        """A cold export warms through the scheduler and serializes at
        completion (``same_payload``); each package's payload adopts in
        either package's loop ahead of the generate on the same
        connection, which then admits as a hit, and the adopted blocks
        export again byte for byte."""
        prompt = np.random.RandomState(4).randint(0, 40, 37).astype(
            np.int32)
        want = ref_outputs([prompt], 6)[0]
        exports = {}
        for side in SIDES:
            mod = REPLICA[side]
            P, ps = mod.EngineLoop(engine(side)), mod.ListReply()
            P.feed({"id": 0, "op": "export_prefix",
                    "prompt": prompt.tolist()}, ps)
            P.feed_eof()
            assert P.run() == 0
            (exp,) = ps.docs
            assert exp["op"] == "export_prefix" and exp["blocks"] == 4
            exports[side] = exp
        same_payload(exports["jax"], exports["port"])
        for src in SIDES:
            def run(side):
                mod = REPLICA[side]
                D, ds = mod.EngineLoop(engine(side)), mod.ListReply()
                D.feed({"id": 1, "op": "import_prefix",
                        "payload": exports[src]["payload"]}, ds)
                D.feed({"id": 2, "prompt": prompt.tolist(), "max_new": 6},
                       ds)
                D.feed({"id": 3, "op": "export_prefix",
                        "prompt": prompt.tolist()}, ds)
                D.feed_eof()
                assert D.run() == 0
                return loop_docs(ds)
            by_id = {d["id"]: d for d in both(run)}
            assert by_id[1]["imported"] == 4
            assert prompt.tolist() + by_id[2]["tokens"] == want
            # adopted blocks export again as the very bytes they came in
            assert by_id[3] == dict(exports[src], id=3)

    def test_export_short_prompt_empty(self):
        def run(side):
            mod = REPLICA[side]
            loop, sink = mod.EngineLoop(engine(side)), mod.ListReply()
            loop.feed({"id": 0, "op": "export_prefix",
                       "prompt": [1, 2, 3]}, sink)
            loop.feed_eof()
            assert loop.run() == 0
            return loop_docs(sink)
        assert both(run) == [{"id": 0, "op": "export_prefix",
                              "payload": None, "blocks": 0}]


class TestReplicaServer:
    def test_socket_roundtrip_and_drain(self):
        """The TCP transport: a SocketReplica submits over the wire, the
        result comes back on the same connection; drain() ends
        serve_forever with rc 0 after in-flight work finishes."""
        prompt = np.random.RandomState(6).randint(0, 40, 21).astype(
            np.int32)
        want = ref_outputs([prompt], 5)[0]

        def run(side):
            mod = REPLICA[side]
            srv = mod.ReplicaServer(engine(side), port=0)
            rcbox = []
            t = threading.Thread(target=lambda: rcbox.append(
                srv.serve_forever()), daemon=True)
            t.start()
            h = mod.SocketReplica("r0", ("127.0.0.1", srv.port))
            h.submit({"id": 11, "prompt": prompt.tolist(), "max_new": 5})
            deadline = time.time() + 60
            docs = []
            while not docs and time.time() < deadline:
                docs = h.poll()
                time.sleep(0.01)
            srv.drain()
            t.join(timeout=30)
            assert not t.is_alive() and rcbox == [0]
            h.close()
            return [doc_view(d) for d in docs]
        docs = both(run)
        assert docs and docs[0]["id"] == 11
        assert prompt.tolist() + docs[0]["tokens"] == want


# -- both routers over the same scripted replicas ---------------------------

class TestRouterPlacement:
    def test_shared_prefix_converges(self):
        def run(side):
            reps, router = fake_router(side, 2, caps=16)
            shared = np.arange(16, dtype=np.int32)
            reqs = [router.submit(np.concatenate(
                [shared, np.full(3 + i, 30 + i, np.int32)]), 4)
                for i in range(5)]
            router.run_until_idle()
            return router_view(router, reqs)
        got = both(run)
        homes = {r["replica"] for r in got["requests"]}
        assert homes == {got["requests"][0]["replica"]}
        hits = got["metrics"]["router_placement_prefix_hits_total"]
        assert hits == [([], 4.0)]
        assert got["health"]["placement_hit_rate"] == pytest.approx(0.8)

    def test_least_loaded_fallback_spreads(self):
        def run(side):
            reps, router = fake_router(side, 2, caps=16)
            rng = np.random.RandomState(0)
            reqs = [router.submit(rng.randint(0, 99, 12).astype(np.int32),
                                  2) for _ in range(6)]
            router._place()
            return router_view(router, reqs)
        got = both(run)
        by = {n: sum(1 for r in got["requests"] if r["replica"] == n)
              for n in ("r0", "r1")}
        assert by == {"r0": 3, "r1": 3}

    def test_in_flight_cap_queues(self):
        def run(side):
            reps, router = fake_router(side, 1, caps=2)
            reps[0].delay = 3
            rng = np.random.RandomState(1)
            reqs = [router.submit(rng.randint(0, 99, 12).astype(np.int32),
                                  2) for _ in range(5)]
            router._place()
            first = router_view(router, reqs)
            router.run_until_idle()
            return {"first": first, "end": router_view(router, reqs)}
        got = both(run)
        assert sum(1 for r in got["first"]["requests"]
                   if r["status"] == "placed") == 2
        assert got["first"]["queue_depth"] == 3
        assert all(r["status"] == "done" for r in got["end"]["requests"])

    def test_degraded_deprioritized(self):
        def run(side):
            reps, router = fake_router(side, 2, caps=16)
            shared = np.arange(16, dtype=np.int32)
            r = router.submit(np.concatenate(
                [shared, np.full(3, 30, np.int32)]), 2)
            router.run_until_idle()
            home = next(rp for rp in reps if rp.name == r.replica)
            other = next(rp for rp in reps if rp.name != r.replica)
            home.health_doc = {"status": "degraded"}
            r2 = router.submit(np.concatenate(
                [shared, np.full(4, 31, np.int32)]), 2)
            router.run_until_idle()
            other.delay = 50
            fill = [router.submit(np.random.RandomState(9).randint(
                0, 99, 12).astype(np.int32), 2) for _ in range(16)]
            r3 = router.submit(np.concatenate(
                [shared, np.full(5, 32, np.int32)]), 2)
            router._poll_health(time.perf_counter())
            router._place()
            mid = router_view(router, [r, r2, r3])
            router.run_until_idle()
            return {"home": home.name, "other": other.name, "mid": mid,
                    "end": router_view(router, [r, r2, r3] + fill)}
        got = both(run)
        r, r2, r3 = got["mid"]["requests"]
        assert r2["replica"] == got["other"]
        assert r3["replica"] == got["home"]
        assert all(x["status"] == "done" for x in got["end"]["requests"])

    def test_unhealthy_drains_without_requeue(self):
        def run(side):
            reps, router = fake_router(side, 2, caps=16)
            reps[0].delay = 4
            rng = np.random.RandomState(2)
            reqs = [router.submit(rng.randint(0, 99, 12).astype(np.int32),
                                  2) for _ in range(4)]
            router._place()
            on_0 = [r.xid for r in reqs if r.replica == "r0"]
            reps[0].health_doc = {"status": "unhealthy"}
            more = [router.submit(rng.randint(0, 99, 12).astype(np.int32),
                                  2) for _ in range(4)]
            router.run_until_idle()
            return {"on_0": on_0, "reqs": router_view(router, reqs),
                    "more": [req_view(r) for r in more]}
        got = both(run)
        assert got["on_0"]
        assert got["reqs"]["metrics"]["router_requeued_total"] == []
        assert all(r["status"] == "done" for r in
                   got["reqs"]["requests"] + got["more"])
        assert all(r["replica"] == "r1" for r in got["more"])
        assert all(r["replica"] == "r0" for r in got["reqs"]["requests"]
                   if r["xid"] in got["on_0"])
        assert got["reqs"]["states"]["r0"] == "unhealthy"

    def test_dead_replica_requeues_all_in_flight(self):
        rng = np.random.RandomState(3)
        ps = [rng.randint(0, 99, 12).astype(np.int32) for _ in range(6)]

        def run(side):
            reps, router = fake_router(side, 2, caps=16)
            reps[0].delay = 1000
            reqs = [router.submit(p, 4) for p in ps]
            router._place()
            n_victim = sum(1 for r in reqs if r.replica == "r0")
            reps[0].kill()
            done = router.run_until_idle()
            return {"victims": n_victim, "done": [r.xid for r in done],
                    "view": router_view(router, reqs)}
        got = both(run)
        assert got["victims"] == 3 and len(got["done"]) == 6
        view = got["view"]
        assert view["metrics"]["router_requeued_total"] == [([], 3.0)]
        assert view["states"] == {"r0": "dead", "r1": "ok"}
        for r, p in zip(view["requests"], ps):
            assert r["status"] == "done" and r["replica"] == "r1"
            assert r["tokens"] == [int(t) % 7 for t in p][:4]
        assert {r["requeues"] for r in view["requests"]} == {0, 1}

    def test_all_replicas_dead_healthz_503(self):
        def run(side):
            reps, router = fake_router(side, 1)
            r = router.submit(np.arange(12, dtype=np.int32), 2)
            router._place()
            reps[0].kill()
            router._poll_health(time.perf_counter())
            return router_view(router, [r])
        got = both(run)
        assert got["health"]["healthy"] is False
        assert got["queue_depth"] == 1
        assert got["requests"][0]["requeues"] == 1

    def test_prefill_tier_death_falls_back_colocated(self):
        def run(side):
            pf, dc = FakeReplica("pf", delay_steps=1000), FakeReplica("dc")
            router = ROUTER[side].Router(
                [pf, dc], block_size=4, chunk_tokens=8, prefill=["pf"],
                max_in_flight=8, health_poll_s=0.0)
            r = router.submit(np.arange(16, dtype=np.int32), 3)
            router.step()
            first = req_view(r)
            pf.kill()
            router.run_until_idle()
            return {"first": first, "end": router_view(router, [r])}
        got = both(run)
        assert got["first"]["status"] == "prefill"
        assert got["first"]["prefill_replica"] == "pf"
        (r,) = got["end"]["requests"]
        assert r["status"] == "done" and r["replica"] == "dc"
        assert r["requeues"] == 1

    def test_replica_error_doc_fails_request(self):
        def run(side):
            reps, router = fake_router(side, 1)

            def bad_pump():
                while reps[0].work:
                    spec, _ = reps[0].work.pop()
                    reps[0].out.append({"id": spec["id"],
                                        "error": "submit: empty prompt"})
            reps[0].pump = bad_pump
            r = router.submit(np.arange(8, dtype=np.int32), 2)
            router.run_until_idle()
            return router_view(router, [r])
        got = both(run)
        (r,) = got["requests"]
        assert r["status"] == "failed" and "empty prompt" in r["error"]
        assert ([("reason", "error")], 1.0) in \
            got["metrics"]["router_requests_completed_total"]

    def test_health_doc_shape(self):
        def run(side):
            reps, router = fake_router(side, 2)
            router.submit(np.arange(12, dtype=np.int32), 2)
            router.run_until_idle()
            view = router_view(router)
            view["text"] = [ln for ln in router.metrics_text().splitlines()
                            if not any(t in ln for t in TIME_METRICS)]
            return view
        got = both(run)
        doc = got["health"]
        assert set(doc["replicas"]) == {"r0", "r1"}
        assert doc["replicas"]["r0"]["role"] == "decode"
        assert doc["completed"] == 1 and doc["requeued"] == 0
        assert "router_placements_total 1" in got["text"]
        assert 'router_replica_state{replica="r0"} 3' in got["text"]

    def test_export_refusal_falls_back_colocated(self):
        def run(side):
            pf, dc = FakeReplica("pf"), FakeReplica("dc")
            pf.export_reply = {"error": "export_prefix needs a paged "
                                        "engine"}
            router = ROUTER[side].Router(
                [pf, dc], block_size=4, chunk_tokens=8, prefill=["pf"],
                max_in_flight=8, health_poll_s=60.0)
            r = router.submit(np.arange(16, dtype=np.int32), 3)
            router.run_until_idle()
            view = router_view(router, [r])
            view["pf_exports"] = sum(1 for s in pf.seen
                                     if s.get("op") == "export_prefix")
            return view
        got = both(run)
        (r,) = got["requests"]
        assert r["status"] == "done" and r["replica"] == "dc"
        assert r["prefill_replica"] == "pf" and got["pf_exports"] == 1
        assert got["metrics"]["router_pd_errors_total"] == \
            [([("op", "export")], 1.0)]
        assert got["metrics"]["router_pd_exports_total"] == []

    def test_import_refusal_counted_not_fatal(self):
        def run(side):
            pf, dc = FakeReplica("pf"), FakeReplica("dc")
            pf.export_reply = {"op": "export_prefix", "payload": "QUJD",
                               "blocks": 2}
            dc.import_error = ("KV payload kv_dtype mismatch: 'int8' vs "
                               "'none'")
            router = ROUTER[side].Router(
                [pf, dc], block_size=4, chunk_tokens=8, prefill=["pf"],
                max_in_flight=8, health_poll_s=60.0)
            r = router.submit(np.arange(16, dtype=np.int32), 3)
            router.run_until_idle()
            return router_view(router, [r])
        got = both(run)
        (r,) = got["requests"]
        assert r["status"] == "done" and r["replica"] == "dc"
        m = got["metrics"]
        assert m["router_pd_exports_total"] == [([], 1.0)]
        assert m["router_pd_errors_total"] == [([("op", "import")], 1.0)]
        assert m["router_pd_blocks_shipped_total"] == []

    def test_draining_refusal_requeues(self):
        def run(side):
            reps, router = fake_router(side, 2, caps=16, health_poll_s=60.0)
            shared = np.arange(16, dtype=np.int32)
            r1 = router.submit(np.concatenate(
                [shared, np.full(3, 30, np.int32)]), 2)
            router.run_until_idle()
            home = next(rp for rp in reps if rp.name == r1.replica)
            home.refuse_generate = "draining: replica not admitting"
            r2 = router.submit(np.concatenate(
                [shared, np.full(4, 31, np.int32)]), 2)
            router.run_until_idle()
            return {"home": home.name, "view": router_view(router, [r1, r2])}
        got = both(run)
        r1, r2 = got["view"]["requests"]
        assert r2["status"] == "done" and r2["replica"] != got["home"]
        assert r2["requeues"] == 1
        assert got["view"]["states"][got["home"]] == "unhealthy"
        m = got["view"]["metrics"]
        assert m["router_requeued_total"] == [([], 1.0)]
        assert ([("reason", "error")], 1.0) not in \
            m["router_requests_completed_total"]


# -- both routers over live engines (in-process fleets) ---------------------

class TestRouterEngines:
    def test_fleet_outputs_bitwise_and_converge(self):
        """A 2-replica fleet serves a shared-prefix trace with greedy ids
        equal to the single-engine run, converging the shared prefix onto
        one warm pool — the same placements, ids and fleet counters in
        both packages."""
        ps = prompts()
        want = ref_outputs(ps, 6)

        def run(side):
            reps = [REPLICA[side].EngineReplica(engine(side), f"r{i}")
                    for i in range(2)]
            router = ROUTER[side].Router(reps, block_size=8,
                                         chunk_tokens=16, health_poll_s=0.0)
            reqs = [router.submit(p, 6) for p in ps]
            done = router.run_until_idle()
            view = router_view(router, reqs)
            view["outputs"] = [[int(t) for t in r.output] for r in reqs]
            view["done"] = len(done)
            return view
        got = both(run)
        assert got["done"] == len(ps) and got["outputs"] == want
        assert len({r["replica"] for r in got["requests"]}) == 1
        assert got["health"]["placement_hit_rate"] > 0.5
        assert got["metrics"]["fleet_engine_requests_total"][0][1] == 6.0

    def test_disaggregated_pd_bitwise(self):
        """Router-level P/D: the prefill tier exports, the decode tier
        adopts; greedy ids equal the colocated run and the decode
        engine's prefix-hit and import counters prove adoption, equal in
        both packages."""
        ps = prompts(seed=8, n=3)
        want = ref_outputs(ps, 6)

        def run(side):
            mod = REPLICA[side]
            pf = mod.EngineReplica(engine(side), "pf")
            dc = mod.EngineReplica(engine(side), "dc")
            router = ROUTER[side].Router([pf, dc], block_size=8,
                                         chunk_tokens=16, prefill=["pf"],
                                         health_poll_s=0.0)
            reqs = [router.submit(p, 6) for p in ps]
            router.run_until_idle()
            view = router_view(router, reqs)
            view["outputs"] = [[int(t) for t in r.output] for r in reqs]
            view["dc"] = {n: dc.eng.metrics.get(n).value() for n in (
                "engine_prefix_cache_hit_blocks_total",
                "engine_kv_blocks_imported_total")}
            return view
        got = both(run)
        assert got["outputs"] == want
        for r in got["requests"]:
            assert r["prefill_replica"] == "pf" or r["prefix_score"] > 0
        m = got["metrics"]
        assert m["router_pd_exports_total"][0][1] >= 1
        assert m["router_pd_blocks_shipped_total"][0][1] >= 2
        assert got["dc"]["engine_prefix_cache_hit_blocks_total"] >= 2 * 3
        assert got["dc"]["engine_kv_blocks_imported_total"] >= 2

    def test_sampled_ids_equal_where_placed_equal(self):
        """Sampled requests through both fleets: the placements are equal
        first, then every sampled id (the JAX engines sample the Pallas
        kernel's hashed stream in interpret mode, the port's its plain
        version of the same stream; both engines seed 0)."""
        ps = prompts(seed=5, n=4)

        def run(side):
            reps = [REPLICA[side].EngineReplica(
                engine(side, pallas="interpret"), f"r{i}") for i in range(2)]
            router = ROUTER[side].Router(reps, block_size=8,
                                         chunk_tokens=16, health_poll_s=0.0)
            reqs = [router.submit(p, 4, temperature=0.8, top_k=20)
                    for p in ps[:2]]
            router.step()
            reqs += [router.submit(p, 4, temperature=0.8, top_k=20)
                     for p in ps[2:]]
            router.run_until_idle()
            return {"placed": [(r.replica, r.placements) for r in reqs],
                    "ids": [[int(t) for t in r.tokens] for r in reqs]}
        want, got = run("jax"), run("port")
        assert got["placed"] == want["placed"]
        assert got["ids"] == want["ids"]
        assert all(len(ids) == 4 for ids in got["ids"])


# -- the router as fleet-global cache directory -----------------------------

def _warm_prompt(seed=7):
    rng = np.random.RandomState(seed)
    return np.concatenate([rng.randint(0, 40, 16),
                           rng.randint(0, 40, 8)]).astype(np.int32)


def _run(eng, prompt, max_new=4):
    r = eng.submit(prompt, max_new)
    eng.run_until_idle()
    return [int(t) for t in r.output]


def _churn(eng, n=6, seed=100):
    for i in range(n):
        _run(eng, np.random.RandomState(seed + i).randint(
            0, 40, 30).astype(np.int32), 2)


def dir_fleet(side, names=("a", "b"), prefill=(), **kw):
    """``tests/test_tiered_cache.py``'s fleet: engines with a DRAM tier
    and a stamped decode cost behind ``EngineReplica``s."""
    engines = {n: engine(side, num_blocks=12,
                         tiers={"dram_bytes": 1 << 20}, decode_flops=1e6)
               for n in names}
    reps = [REPLICA[side].EngineReplica(engines[n], n) for n in names]
    kw.setdefault("health_poll_s", 0.0)
    router = ROUTER[side].Router(reps, block_size=8, chunk_tokens=16,
                                 prefill=list(prefill), **kw)
    return engines, reps, router


def fetches(router):
    return {t: router._m_kv_fetches.value(tier=t)
            for t in ("hbm", "dram", "disk")}


class TestFleetDirectory:
    def test_warm_anywhere_fetches_bitwise(self):
        prompt = _warm_prompt()
        want = ref_outputs([prompt], 6)[0]

        def run(side):
            engines, reps, router = dir_fleet(side, prefill=("a",),
                                              fetch_flops_per_byte=0.0)
            assert _run(engines["a"], prompt, 6) == want
            router.step()
            d = router.directory()
            req = router.submit(prompt, 6)
            router.run_until_idle()
            view = router_view(router, [req])
            view.update(dir0=d, output=[int(t) for t in req.output],
                        fetches=fetches(router), imported=engines["b"]
                        .metrics.get("engine_kv_blocks_imported_total")
                        .value())
            return view
        got = both(run)
        assert got["dir0"] and all(v["replica"] == "a"
                                   for v in got["dir0"].values())
        (req,) = got["requests"]
        assert req["status"] == "done" and req["replica"] == "b"
        assert got["output"] == want
        assert got["fetches"] == {"hbm": 1, "dram": 0, "disk": 0}
        assert got["imported"] >= 2
        assert got["health"]["directory_size"] == len(got["directory"])

    def test_dram_warm_source_fetches_bitwise(self):
        prompt = _warm_prompt()
        want = ref_outputs([prompt], 6)[0]
        hexes = {h.hex() for h in
                 tblocks.prompt_block_hashes(prompt, BS)[:2]}

        def run(side):
            engines, reps, router = dir_fleet(side, prefill=("a",),
                                              fetch_flops_per_byte=0.0)
            _run(engines["a"], prompt, 6)
            _churn(engines["a"])
            router.step()
            tiers = {router.directory()[h]["tier"] for h in hexes}
            req = router.submit(prompt, 6)
            router.run_until_idle()
            view = router_view(router, [req])
            view.update(tiers=sorted(tiers), fetches=fetches(router),
                        output=[int(t) for t in req.output])
            return view
        got = both(run)
        assert got["tiers"] == ["dram"]
        assert got["output"] == want
        assert got["fetches"]["dram"] == 1

    def test_crossover_knob_suppresses_fetch(self):
        prompt = _warm_prompt()
        want = ref_outputs([prompt], 6)[0]

        def run(side):
            engines, reps, router = dir_fleet(side, prefill=("a",),
                                              fetch_flops_per_byte=1e30)
            _run(engines["a"], prompt, 6)
            router.step()
            req = router.submit(prompt, 6)
            router.run_until_idle()
            view = router_view(router, [req])
            view.update(fetches=fetches(router),
                        output=[int(t) for t in req.output])
            return view
        got = both(run)
        assert got["output"] == want
        assert sum(got["fetches"].values()) == 0

    def test_missing_health_rates_fail_toward_recompute(self):
        def run(side):
            engines, reps, router = dir_fleet(side,
                                              fetch_flops_per_byte=8.0)
            st = router._all[0]
            out = []
            for doc in ({"status": "ok"},
                        {"flops_per_token": 1e6, "kv_bytes_per_token": 10.0},
                        {"flops_per_token": 10.0,
                         "kv_bytes_per_token": 1e6}):
                st.last_health = doc
                out.append(router._fetch_pays(st))
            # the engines' own health figures decide alike
            st.last_health = engines["a"].health()
            out.append(router._fetch_pays(st))
            out.append(st.last_health["flops_per_token"])
            return out
        assert both(run)[:3] == [False, True, False]

    def test_dead_source_mid_fetch_falls_back_colocated(self):
        prompt = _warm_prompt()
        want = ref_outputs([prompt], 6)[0]

        def run(side):
            engines, reps, router = dir_fleet(side, prefill=("a",),
                                              fetch_flops_per_byte=0.0)
            _run(engines["a"], prompt, 6)
            router.step()
            before = any(v["replica"] == "a"
                         for v in router.directory().values())
            req = router.submit(prompt, 6)
            router._place()
            src = next(st for st in router._all if st.name == "a")
            in_flight = req.xid in src.outstanding
            reps[0].kill()
            router.run_until_idle()
            view = router_view(router, [req])
            view.update(before=before, in_flight=in_flight,
                        output=[int(t) for t in req.output])
            return view
        got = both(run)
        assert got["before"] and got["in_flight"]
        (req,) = got["requests"]
        assert req["status"] == "done" and req["replica"] == "b"
        assert got["output"] == want and req["requeues"] >= 1
        assert not any(v["replica"] == "a"
                       for v in got["directory"].values())
        assert got["states"]["a"] == "dead"


# -- admission control (the door) -------------------------------------------

def shed_reason(router, call):
    err = ROUTER["jax"].AdmissionError if isinstance(
        router, jrouter.Router) else trouter.AdmissionError
    with pytest.raises(err) as ei:
        call()
    return ei.value.reason


class TestAdmission:
    def test_queue_full_sheds_batch_before_latency(self):
        def run(side):
            reps, router = fake_router(side, 1, caps=1, shed_queue_max=2)
            reps[0].delay = 10**9
            p = np.arange(5, dtype=np.int32)
            router.submit(p, 2)
            router.step()
            router.submit(p, 2)
            router.submit(p, 2)
            reasons = [shed_reason(router, lambda: router.submit(p, 2))]
            router.submit(p, 2, tier="latency")
            router.submit(p, 2, tier="latency")
            reasons.append(shed_reason(router, lambda: router.submit(
                p, 2, tier="latency")))
            return {"reasons": reasons, "view": router_view(router)}
        got = both(run)
        assert got["reasons"] == ["queue_full", "queue_full"]
        assert got["view"]["metrics"]["router_shed_total"] == \
            [([("reason", "queue_full")], 2.0)]
        assert got["view"]["health"]["shed"] == 2

    def test_burn_rate_sheds_batch_keeps_latency(self, monkeypatch):
        def run(side):
            reps, router = fake_router(side, 1, caps=4, shed_burn_max=1.0)
            monkeypatch.setattr(router, "_slo_burn_rate", lambda: 3.0)
            p = np.arange(5, dtype=np.int32)
            reason = shed_reason(router, lambda: router.submit(p, 2))
            r = router.submit(p, 2, tier="latency")
            router.run_until_idle()
            return {"reason": reason, "view": router_view(router, [r])}
        got = both(run)
        assert got["reason"] == "burn_rate"
        assert got["view"]["requests"][0]["status"] == "done"
        assert got["view"]["metrics"]["router_shed_total"] == \
            [([("reason", "burn_rate")], 1.0)]

    def test_impossible_tenant_charge_rejected_at_door(self):
        def run(side):
            reps, router = fake_router(side, 1, caps=4,
                                       tenant_budgets={"a": 10})
            reason = shed_reason(router, lambda: router.submit(
                np.arange(8, dtype=np.int32), 8, tenant="a"))
            r = router.submit(np.arange(4, dtype=np.int32), 2, tenant="a")
            router.run_until_idle()
            return {"reason": reason, "view": router_view(router, [r])}
        got = both(run)
        assert got["reason"] == "tenant_budget"
        assert got["view"]["metrics"]["router_shed_total"] == \
            [([("reason", "tenant_budget")], 1.0)]
        assert got["view"]["requests"][0]["status"] == "done"


# -- fleet-wide tenant fairness ---------------------------------------------

class TestFleetTenantFairness:
    def test_burst_capped_at_fleet_budget_across_replicas(self):
        def run(side):
            reps, router = fake_router(side, 3, caps=8,
                                       tenant_budgets={"burst": 40})
            for r in reps:
                r.delay = 3
            reqs = [router.submit(np.arange(8, dtype=np.int32) + i, 2,
                                  tenant="burst") for i in range(12)]
            used, placed = [], []
            for _ in range(200):
                if router.idle:
                    break
                router.step()
                used.append(router._tenant_used.get("burst", 0))
                placed.append(sum(1 for r in reqs if r.status == "placed"))
            return {"used": used, "placed": placed,
                    "view": router_view(router, reqs)}
        got = both(run)
        assert max(got["placed"]) <= 4
        assert max(got["used"]) == 40
        assert all(r["status"] == "done" for r in got["view"]["requests"])

    def test_latency_tenant_places_through_the_burst(self):
        def run(side):
            reps, router = fake_router(side, 3, caps=8,
                                       tenant_budgets={"burst": 20})
            for r in reps:
                r.delay = 4
            burst = [router.submit(np.arange(8, dtype=np.int32) + i, 2,
                                   tenant="burst") for i in range(10)]
            fg = [router.submit(np.arange(5, dtype=np.int32) + i, 2,
                                tenant="fg", tier="latency")
                  for i in range(4)]
            router.step()
            first = {"burst": [r.status for r in burst],
                     "fg": [r.status for r in fg]}
            router.run_until_idle()
            assert all(r.placed_t - r.submit_t < 1.0 for r in fg)
            return {"first": first, "view": router_view(router, burst + fg)}
        got = both(run)
        assert got["first"]["fg"] == ["placed"] * 4
        assert got["first"]["burst"].count("placed") == 2
        assert all(r["status"] == "done" for r in got["view"]["requests"])

    def test_budget_editable_at_runtime(self):
        def run(side):
            reps, router = fake_router(side, 1, caps=8)
            router.set_tenant_budget("t", 10)
            reason = shed_reason(router, lambda: router.submit(
                np.arange(8, dtype=np.int32), 8, tenant="t"))
            router.set_tenant_budget("t", None)
            r = router.submit(np.arange(8, dtype=np.int32), 8, tenant="t")
            router.run_until_idle()
            return {"reason": reason, "view": router_view(router, [r])}
        got = both(run)
        assert got["reason"] == "tenant_budget"
        assert got["view"]["requests"][0]["status"] == "done"


# -- tier-directory invalidation (sub-cadence eviction) ---------------------

class TestDirectoryInvalidation:
    def test_epoch_bumps_on_full_retirement_not_demotion(self, tmp_path):
        def run(side):
            d = tmp_path / side
            ts = TIERS[side].TieredStore(dram_bytes=64, disk_bytes=4096,
                                         disk_dir=str(d))
            a, b = b"\x01" * 16, b"\x02" * 16
            ts.put(a, b"x" * 48)
            ts.put(b, b"y" * 48)
            got_a = ts.get(a) is not None
            e0 = ts.eviction_epoch
            ts.quarantine(b)
            return [got_a, e0, ts.eviction_epoch,
                    ts.health()["eviction_epoch"]]
        got = both(run)
        assert got[:2] == [True, 0] and got[2] >= 1 and got[3] == got[2]

    def test_epoch_bumps_when_disk_budget_drops_payload(self):
        def run(side):
            ts = TIERS[side].TieredStore(dram_bytes=64, disk_bytes=0)
            ts.put(b"\x01" * 16, b"x" * 48)
            ts.put(b"\x02" * 16, b"y" * 48)
            return ts.eviction_epoch
        assert both(run) == 1

    def test_engine_result_docs_carry_epoch(self):
        def run(side):
            eng = engine(side)
            eng.tiers = TIERS[side].TieredStore(dram_bytes=1 << 16)
            mod = REPLICA[side]
            loop, reply = mod.EngineLoop(eng), mod.ListReply()
            loop.feed({"id": 1, "prompt": [1, 2, 3], "max_new": 2}, reply)
            while not reply.docs:
                loop.step_once()
            eng.tiers.eviction_epoch = 5
            loop.feed({"id": 2, "prompt": [1, 2, 3], "max_new": 2}, reply)
            while len(reply.docs) < 2:
                loop.step_once()
            return loop_docs(reply)
        docs = both(run)
        assert [d["tier_epoch"] for d in docs] == [0, 5]

    def test_router_invalidates_directory_between_scrapes(self):
        hexd = "ab" * 16

        def run(side):
            rep = FakeReplica("r0")
            rep.health_doc = {"status": "ok", "queue_depth": 0,
                              "tiers": {"eviction_epoch": 1,
                                        "digests": {"dram": [hexd]}}}
            router = ROUTER[side].Router([rep], block_size=4,
                                         chunk_tokens=8, health_poll_s=1e9)
            seen = []
            router.step()
            seen.append(sorted(router.directory()))
            rep.out.append({"id": "zz", "tier_epoch": 2})
            router.step()
            seen.append(sorted(router.directory()))
            rep.health_doc["tiers"]["eviction_epoch"] = 2
            rep.health_doc["tiers"]["digests"]["dram"] = [hexd]
            router._all[0].health_t = -1e9
            router.step()
            seen.append(sorted(router.directory()))
            rep.out.append({"id": "zz2", "tier_epoch": 2})
            router.step()
            seen.append(sorted(router.directory()))
            return {"seen": seen, "view": router_view(router)}
        got = both(run)
        assert got["seen"] == [[hexd], [], [hexd], [hexd]]
        assert got["view"]["metrics"][
            "router_directory_invalidations_total"] == [([], 1.0)]
