"""The port's observability modules and engine lifecycle against
``paddle_tpu``'s, on the CPU.

- ``observe/window.py``: the same seeded samples (with explicit times)
  give equal quantiles, ``fraction_over``, burn rates, expiry, bounds,
  exports, absorbs and merges.
- ``observe/requests.py``: the same records give equal ``summary``,
  ``slowest`` and ``attribute``.
- ``observe/health.py``: the status mapping of
  ``tests/test_request_observability.py::TestHealthStatusMapping``, and
  the mapping equal to the JAX server's on the same documents.
- ``observe/chrome_trace.py``, ``observe/trace.py``, ``observe/flight.py``:
  equal export and merge shapes, scope names and timer counts.
- The engines: one trace, greedy and sampled, with a shared prefix, a
  rejection and a latency-tier preemption, through both engines (the
  JAX one's Pallas kernels in interpret mode, as
  ``tests/test_torch_scheduler.py`` drives it) gives equal lifecycle
  events per request (name, phase, args without the two time-valued
  args), equal request-log records without their time fields, equal
  ``health()`` window counts and SLO verdicts, and ``abort_requests`` on
  a loaded engine the same count and the same closed slices. Times are
  never compared.
"""

import functools
import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import transformer as jt
from paddle_tpu.observe import chrome_trace as jchrome
from paddle_tpu.observe import health as jhealth
from paddle_tpu.observe import requests as jreq
from paddle_tpu.observe import trace as jtrace
from paddle_tpu.observe import window as jwin
from paddle_tpu.observe.compile_tracker import CompileTracker
from paddle_tpu.serving import PagedDecodeEngine as JaxEngine
from paddle_tpu.serving import sampling as jsampling
from paddle_tpu.utils import stat as jstat
from paddle_tpu_torch.models import transformer as tt
from paddle_tpu_torch.observe import chrome_trace as tchrome
from paddle_tpu_torch.observe import flight as tflight
from paddle_tpu_torch.observe import health as thealth
from paddle_tpu_torch.observe import metrics as tmetrics
from paddle_tpu_torch.observe import requests as treq
from paddle_tpu_torch.observe import trace as ttrace
from paddle_tpu_torch.observe import window as twin
from paddle_tpu_torch.serving import PagedDecodeEngine
from paddle_tpu_torch.utils import stat as tstat

torch.set_num_threads(1)

KW = dict(vocab=40, d_model=16, n_heads=2, n_kv_heads=1, n_layers=2,
          d_ff=32, max_len=64, use_rope=True)
BS = 8
# event args whose values are times: never compared
TIME_ARGS = ("queue_wait_ms", "ttft_ms")
# request-log fields that are times or name the engine instance
TIME_FIELDS = ("engine", "trace_id", "submit_ts", "queue_wait_s",
               "prefill_own_s", "prefill_stall_s", "decode_s", "ttft_s",
               "latency_s")


# -- windows ----------------------------------------------------------------

def _samples(seed, n=300):
    rng = np.random.RandomState(seed)
    t = np.cumsum(rng.exponential(0.2, n))
    v = rng.lognormal(-3.0, 0.8, n)
    return [(float(a), float(b)) for a, b in zip(t, v)]


def _both_windows(**kw):
    return (jwin.WindowedQuantiles(clock=lambda: 0.0, **kw),
            twin.WindowedQuantiles(clock=lambda: 0.0, **kw))


@pytest.mark.parametrize("window_s,max_samples", [(60.0, 2048), (10.0, 2048),
                                                  (60.0, 50)],
                         ids=["wide", "expiring", "bounded"])
def test_window_quantiles_equal(window_s, max_samples):
    ws = _both_windows(window_s=window_s, max_samples=max_samples)
    samples = _samples(0)
    for t, v in samples:
        for w in ws:
            w.observe(v, t=t)
    now = samples[-1][0]
    qs = (0.0, 0.5, 0.9, 0.95, 0.99, 1.0)
    got = [(w.count(now), w.quantiles(qs, now), w.quantile(0.99, now),
            w.fraction_over(0.05, now), w.samples(now),
            w.export_samples(now)) for w in ws]
    assert got[0] == got[1]
    assert got[1][0] == (min(max_samples, sum(
        1 for t, _ in samples if t > now - window_s)))
    slo = (jwin.SloConfig(ttft_s=0.05, target=0.9, window_s=window_s),
           twin.SloConfig(ttft_s=0.05, target=0.9, window_s=window_s))
    burn = [s.burn_rate(w.fraction_over(0.05, now))
            for s, w in zip(slo, ws)]
    assert burn[0] == burn[1] > 0
    assert [s.exceeded(f) for s, f in zip(slo, (0.05, 0.2))] == \
        [False, True]


def test_window_absorb_merge_and_validation():
    a = _both_windows(window_s=30.0)
    b = _both_windows(window_s=30.0)
    s1, s2 = _samples(1, 80), _samples(2, 80)
    for (t, v), (t2, v2) in zip(s1, s2):
        for w in a:
            w.observe(v, t=t)
        for w in b:
            w.observe(v2, t=t2)
    now = max(s1[-1][0], s2[-1][0])
    for ja, ta, jb, tb in ((a[0], a[1], b[0], b[1]),):
        wire = jb.export_samples(now)
        assert wire == tb.export_samples(now)
        ja.absorb(wire, now=now)
        ta.absorb(wire, now=now)
    assert a[0].samples(now) == a[1].samples(now)
    m = _both_windows(window_s=30.0)
    m[0].merge(b[0], now=now)
    m[1].merge(b[1], now=now)
    assert m[0].quantiles((0.5, 0.99), now) == \
        m[1].quantiles((0.5, 0.99), now)
    for mod in (jwin, twin):
        with pytest.raises(ValueError):
            mod.WindowedQuantiles(window_s=0)
        with pytest.raises(ValueError):
            mod.WindowedQuantiles(max_samples=0)
        with pytest.raises(ValueError):
            mod.SloConfig(ttft_s=0.1, target=1.0)
        assert mod.WindowedQuantiles().quantile(0.99) == 0.0
        assert mod.WindowedQuantiles().fraction_over(1.0) == 0.0


# -- request log ------------------------------------------------------------

def _records(seed, n=40):
    rng = np.random.RandomState(seed)
    recs = []
    for i in range(n):
        if i % 9 == 4:      # a rejection: no measured components
            recs.append({"rid": i, "finish_reason": "rejected:bad_tier",
                         "prompt_tokens": None, "tokens": 0,
                         "queue_wait_s": None, "prefill_own_s": None,
                         "prefill_stall_s": None, "decode_s": None,
                         "ttft_s": None, "latency_s": None,
                         "cache_hit_frac": 0.0})
            continue
        c = rng.exponential([0.01, 0.02, 0.03, 0.05])
        recs.append({"rid": i, "finish_reason": ("eos", "max_tokens")[i % 2],
                     "prompt_tokens": int(rng.randint(4, 200)),
                     "tokens": int(rng.randint(1, 64)),
                     "queue_wait_s": float(c[0]),
                     "prefill_own_s": float(c[1]),
                     "prefill_stall_s": float(c[2]),
                     "decode_s": float(c[3]),
                     "ttft_s": float(c[:3].sum()),
                     "latency_s": float(c.sum()),
                     "cache_hit_frac": float(rng.rand())})
    return recs


@pytest.mark.parametrize("capacity", [512, 16, 0])
def test_request_log_equal(capacity):
    logs = (jreq.RequestLog(capacity), treq.RequestLog(capacity))
    recs = _records(3)
    for r in recs:
        for log in logs:
            log.add(r)
    got = [(log.records(), log.evicted(), len(log), log.summary(),
            log.slowest(5, by="ttft_s"), log.slowest(3, by="latency_s"),
            log.enabled, log.capacity) for log in logs]
    assert got[0] == got[1]
    assert len(logs[1]) == min(capacity, len(recs))
    for r in recs:
        assert jreq.attribute(r) == treq.attribute(r)
    assert treq.attribute(recs[4])["dominant"] == "none"
    assert treq.COMPONENTS == jreq.COMPONENTS
    assert isinstance(treq.default_request_log(), treq.RequestLog)


# -- health server ----------------------------------------------------------

def _get(url):
    try:
        resp = urllib.request.urlopen(url, timeout=10)
        return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


class TestHealthStatusMapping:
    def test_degraded_is_200_with_status(self):
        srv = thealth.HealthServer(
            registry=tmetrics.Registry(),
            health_fn=lambda: {"status": "degraded",
                               "degraded_reason": "test"})
        try:
            code, body = _get(srv.url + "/healthz")
            assert code == 200
            doc = json.loads(body)
            assert doc["status"] == "degraded"
            assert doc["degraded_reason"] == "test"
        finally:
            srv.close()

    def test_status_unhealthy_maps_503(self):
        srv = thealth.HealthServer(
            registry=tmetrics.Registry(),
            health_fn=lambda: {"status": "unhealthy"})
        try:
            assert _get(srv.url + "/healthz")[0] == 503
        finally:
            srv.close()

    def test_requests_route_404_without_fn_and_metrics_render(self):
        reg = tmetrics.Registry()
        reg.counter("x_total", "a counter").inc(3)
        srv = thealth.HealthServer(registry=reg)
        try:
            assert _get(srv.url + "/requests")[0] == 404
            code, body = _get(srv.url + "/metrics")
            assert code == 200 and b"x_total 3" in body
            code, body = _get(srv.url + "/healthz")
            assert code == 200 and json.loads(body) == {"status": "ok"}
        finally:
            srv.close()

    @pytest.mark.parametrize("doc", [
        {}, {"status": "ok"}, {"status": "degraded"},
        {"status": "unhealthy"}, {"healthy": False},
        {"healthy": False, "status": "degraded"}, {"status": "weird"},
        {"x": float("nan"), "y": [float("inf"), 1.0]}],
        ids=["empty", "ok", "degraded", "unhealthy", "healthy-false",
             "bool-wins", "unknown", "non-finite"])
    def test_mapping_equals_jax(self, doc):
        got = []
        for mod, reg in ((jhealth, None), (thealth, tmetrics.Registry())):
            srv = mod.HealthServer(registry=reg or _jax_registry(),
                                   health_fn=lambda: dict(doc))
            try:
                got.append(srv._health())
            finally:
                srv.close()
        assert got[0] == got[1]


def _jax_registry():
    from paddle_tpu.observe.metrics import Registry
    return Registry()


# -- chrome trace, scopes, flight recorder ----------------------------------

def _fill(mod):
    buf = mod.SpanBuffer(capacity=6)
    rng = np.random.RandomState(5)
    for i in range(8):
        buf.add(f"span{i}", 1000.0 + i, float(rng.rand()) * 0.01, tid=7,
                args={"i": i} if i % 2 else None)
    buf.add("request", 1010.0, 0.0, tid=7, ph="b", ev_id="eng0.r0",
            cat="request", args={"rid": 0})
    buf.add("request", 1011.0, 0.0, tid=7, ph="e", ev_id="eng0.r0",
            cat="request")
    return buf


def _shape(trace):
    evs = [{k: v for k, v in e.items()
            if not (e.get("name") == "process_name" and k == "args")}
           for e in trace["traceEvents"]]
    return evs, trace["otherData"], trace["displayTimeUnit"]


def test_chrome_trace_export_and_merge_shape():
    got = []
    for mod in (jchrome, tchrome):
        buf = _fill(mod)
        one = mod.trace_export(buffer=buf, process_index=0,
                               align={"barrier0": 1005.0})
        two = mod.trace_export(buffer=buf, process_index=0,
                               align={"barrier0": 1005.5})
        merged = mod.merge_traces([one, two])
        got.append((_shape(one), _shape(merged), buf.dropped(), len(buf)))
    assert got[0] == got[1]
    assert got[1][2] == 4 and got[1][3] == 6
    pids = {e["pid"] for e in got[1][1][0]}
    assert pids == {0, 1000}             # the colliding pid is remapped
    with pytest.raises(ValueError):
        tchrome.record_event("x", 0.0, "X", "id")


def test_process_index_from_env(monkeypatch):
    monkeypatch.setenv("PADDLE_PROCESS_ID", "3")
    assert tchrome._process_index() == 3
    monkeypatch.setenv("PADDLE_PROCESS_ID", "x")
    assert tchrome._process_index() == 0     # no group initialised


def test_trace_scopes_nest_like_jax():
    got = []
    for trace_mod, stat_mod, chrome_mod in ((jtrace, jstat, jchrome),
                                            (ttrace, tstat, tchrome)):
        stats = stat_mod.StatSet("t")
        before = len(chrome_mod.default_buffer().spans())
        names = []
        with trace_mod.trace_scope("step", stats=stats,
                                   use_profiler=False) as q:
            names.append(q)
            for _ in range(2):
                with trace_mod.trace_scope("fwd", stats=stats,
                                           use_profiler=False) as q2:
                    names.append((q2, trace_mod.current_scope()))
        with trace_mod.step_scope(4, stats=stats, use_profiler=False):
            names.append(trace_mod.current_scope())

        @trace_mod.traced("deco", stats=stats, use_profiler=False)
        def f():
            return trace_mod.current_scope()
        names.append(f())
        spans = chrome_mod.default_buffer().spans()[before:]
        got.append((names, sorted((k, s.count) for k, s in
                                  stats._stats.items()),
                    [(s[0], s[4]) for s in spans]))
    assert got[0] == got[1]
    # the profiler annotation path runs too
    with ttrace.trace_scope("annotated", stats=tstat.StatSet(),
                            use_profiler=True) as q:
        assert q == "annotated"


def test_flight_recorder_dump(tmp_path):
    rec = tflight.FlightRecorder(capacity=3)
    for i in range(5):
        rec.record({"step": i, "loss": float("nan") if i == 4 else 1.0})
    try:
        raise RuntimeError("boom")
    except RuntimeError as e:
        path = rec.dump(str(tmp_path / "f.json"), reason="test", exc=e)
    doc = json.loads(open(path).read())
    jrec = __import__("paddle_tpu.observe.flight",
                      fromlist=["FlightRecorder"]).FlightRecorder()
    want = set(jrec._snapshot("test", None)) | {"exception"}
    # "devices" only once a card is initialised (the JAX side lists its
    # CPU devices)
    assert set(doc) - {"devices"} == want - {"devices"}
    assert "torch" in doc["versions"]
    assert [r["step"] for r in doc["last_steps"]] == [2, 3, 4]
    assert doc["last_steps"][-1]["loss"] == "nan"
    assert doc["exception"]["type"] == "RuntimeError"
    assert set(doc["config"]) == {"profile", "flight_dir", "default_dtype",
                                  "compute_dtype", "seed", "log_period",
                                  "checkpoint_period", "metrics_path",
                                  "debug_nans", "debug_infs"}
    assert rec.dumped_paths == [path]


# -- the engines ------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _model():
    jcfg = jt.TransformerConfig(dtype=jnp.float32, **KW)
    tcfg = tt.TransformerConfig(dtype=torch.float32, **KW)
    jp = jt.init_params(jax.random.PRNGKey(0), jcfg)
    tp = tt.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                              device="cpu")
    pf, df = jsampling.paged_step_fns(jcfg, BS, pallas="interpret")
    return jcfg, jp, tcfg, tp, (jax.jit(pf), jax.jit(df))


def _engines(batch=2, cache_len=32, num_blocks=8):
    jcfg, jp, tcfg, tp, (pf, df) = _model()
    common = dict(batch=batch, cache_len=cache_len, block_size=BS,
                  num_blocks=num_blocks, chunk_tokens=8, seed=0)
    jeng = JaxEngine(pf, df, jp, jt.init_block_pool(jcfg, num_blocks, BS),
                     tracker=CompileTracker(), decode_flops=None, **common)
    teng = PagedDecodeEngine.from_params(tp, tcfg, device="cpu", **common)
    return jeng, teng


def _events(mod, trace_id):
    out = []
    for name, _, _, _, args, ph, ev_id, cat in mod.default_buffer().spans():
        if ev_id != trace_id or cat != "request":
            continue
        args = {k: v for k, v in (args or {}).items()
                if k not in TIME_ARGS}
        out.append((name, ph, args))
    return out


def _balanced(events) -> bool:
    depth = 0
    for _, ph, _ in events:
        depth += {"b": 1, "e": -1}.get(ph, 0)
        if depth < 0:
            return False
    return depth == 0


def _record(rec):
    return {k: v for k, v in rec.items() if k not in TIME_FIELDS}


def _scenario(eng, temperature):
    """A shared-prefix pair, a rejection, then two batch-tier requests
    decoding when a latency-tier arrival preempts one of them."""
    mod = jchrome if isinstance(eng, JaxEngine) else tchrome
    rng = np.random.RandomState(11)
    prefix = rng.randint(0, 40, 16).astype(np.int32)
    kw = dict(temperature=temperature, top_k=20 if temperature else 0)
    reqs = [eng.submit(np.concatenate([prefix, rng.randint(0, 40, 3)]), 4,
                       **kw),
            eng.submit(np.concatenate([prefix, rng.randint(0, 40, 5)]), 3,
                       tenant="t1", **kw)]
    with pytest.raises(ValueError):
        eng.submit(rng.randint(0, 40, 30), 8)          # exceeds cache_len
    eng.run_until_idle()
    va = eng.submit(rng.randint(0, 40, 8), 16, tier="batch", **kw)
    vb = eng.submit(rng.randint(0, 40, 8), 16, tier="batch", **kw)
    for _ in range(4):
        eng.step()
    lat = eng.submit(rng.randint(0, 40, 8), 8, tier="latency", **kw)
    reqs += [va, vb, lat]
    eng.run_until_idle()
    h = eng.health()
    win = h["window"]
    return {
        "events": [_events(mod, r.trace_id) for r in reqs],
        "tokens": [list(map(int, r.tokens)) for r in reqs],
        "preemptions": [r.preemptions for r in reqs],
        "records": [_record(r) for r in eng.request_log.records()],
        "window": (win["requests"], {t: d["requests"] for t, d in
                                     win.get("tiers", {}).items()}),
        "summary": {k: v for k, v in eng.requests_doc().items()
                    if k not in ("slowest_by_ttft", "by_dominant_component")},
        "rejected": int(eng.metrics.get(
            "engine_requests_rejected_total").value(reason="exceeds_cache")),
    }


@pytest.mark.parametrize("temperature", [0.0, 0.8],
                         ids=["greedy", "sampled"])
def test_engine_lifecycle_equal(temperature):
    want, got = (_scenario(eng, temperature) for eng in _engines())
    assert got == want
    assert sum(got["preemptions"]) == 1
    assert got["window"][0] == 5 and got["rejected"] == 1
    assert got["summary"]["by_reason"]["rejected:exceeds_cache"] == 1
    for evs in got["events"]:
        names = [n for n, _, _ in evs]
        assert _balanced(evs), evs
        assert {"request", "queued", "admitted", "prefill",
                "prefill_chunk", "first_token", "finished"} <= set(names)
    assert any(n == "preempted" for evs in got["events"]
               for n, _, _ in evs)
    assert any(n in ("prefix_adopt", "admitted") and a.get("hit_blocks")
               for evs in got["events"] for n, _, a in evs)


def test_engine_slo_health_and_endpoints():
    docs = []
    for eng in _engines():
        eng.configure_slo(jwin.SloConfig(ttft_s=1e-9, target=0.9,
                                         window_s=300.0)
                          if isinstance(eng, JaxEngine) else
                          twin.SloConfig(ttft_s=1e-9, target=0.9,
                                         window_s=300.0))
        eng.submit(np.arange(6, dtype=np.int32), 3)
        eng.run_until_idle()
        h = eng.health()
        docs.append((h["status"], h["slo"], h["window"]["requests"]))
        if isinstance(eng, PagedDecodeEngine):
            assert eng.metrics.get("engine_slo_burn_rate").value() > 1.0
            assert eng.metrics.get(
                "engine_ttft_window_seconds").value(q="p99") > 0
            srv = eng.serve()
            try:
                code, body = _get(srv.url + "/healthz")
                assert code == 200
                assert json.loads(body)["status"] == "degraded"
                code, body = _get(srv.url + "/requests")
                assert code == 200 and json.loads(body)["count"] == 1
                code, body = _get(srv.url + "/metrics")
                assert code == 200 and b"engine_slo_burn_rate" in body
            finally:
                srv.close()
            # the window drains: gauges and status follow on read
            eng._win_ttft.clear()
            eng._win_tps.clear()
            eng.metrics_text()
            assert eng.metrics.get("engine_slo_burn_rate").value() == 0.0
            assert eng.health().get("status") is None
    assert docs[0] == docs[1]
    assert docs[1][0] == "degraded" and docs[1][1]["ttft_burn_rate"] == 10.0


def _abort(eng):
    mod = jchrome if isinstance(eng, JaxEngine) else tchrome
    rng = np.random.RandomState(23)
    va = eng.submit(rng.randint(0, 40, 8), 16, tier="batch")
    vb = eng.submit(rng.randint(0, 40, 8), 16, tier="batch")
    for _ in range(4):
        eng.step()
    lat = eng.submit(rng.randint(0, 40, 8), 8, tier="latency")
    queued = eng.submit(rng.randint(0, 40, 8), 4)
    eng.step()                      # the latency arrival preempts a victim
    state = (eng.preempted_count, [r.status for r in (va, vb, lat, queued)])
    n = eng.abort_requests()
    reqs = (va, vb, lat, queued)
    return (n, state, [r.status for r in reqs],
            [r.finish_reason for r in reqs],
            [_events(mod, r.trace_id) for r in reqs], eng.queue_depth,
            eng.preempted_count)


def test_abort_requests_equal():
    """Equal counts, statuses and events, but for one: the JAX engine
    leaves a preempted request's "queued" slice (opened at preemption,
    ``paddle_tpu/serving/engine.py:1725``) open when it aborts, as its
    abort closes "queued" only for the arrival queue (:524-529). The port
    closes it, so every track balances."""
    want, got = (_abort(eng) for eng in _engines())
    n, state, status, reasons, events = got[:5]
    assert (n, state, status, reasons) == tuple(want[:4])
    assert got[5:] == want[5:] == (0, 0)
    assert n == 4 and state[0] == 1
    assert status == ["aborted"] * 4
    preempted = [i for i, evs in enumerate(want[4])
                 if any(name == "preempted" for name, _, _ in evs)]
    assert len(preempted) == 1
    for i, (jevs, evs) in enumerate(zip(want[4], events)):
        assert _balanced(evs), evs
        assert ("aborted", "n", {"reason": "replica_killed"}) in evs
        assert evs[-1][:2] == ("request", "e")
        if i in preempted:
            k = evs.index(("aborted", "n", {"reason": "replica_killed"}))
            assert evs[k - 1] == ("queued", "e", {})
            assert evs[:k - 1] + evs[k:] == jevs
            assert not _balanced(jevs)
        else:
            assert evs == jevs


def test_submit_trace_id_and_rejection_record():
    _, teng = _engines()
    r = teng.submit(np.arange(5, dtype=np.int32), 2, trace="fleet.42")
    assert r.trace_id == "fleet.42"
    teng.run_until_idle()
    assert _balanced(_events(tchrome, "fleet.42"))
    with pytest.raises(ValueError):
        teng.submit(np.arange(5), 2, tier="nope")
    rec = teng.request_log.records()[-1]
    assert rec["finish_reason"] == "rejected:bad_tier"
    assert treq.attribute(rec)["dominant"] == "none"
    assert treq.default_request_log().records()[-1] == rec
