"""The fleet's observability plane against ``paddle_tpu``'s, on the CPU.

Every case runs through both packages on the same inputs and compares:

- ``observe/metrics.py``: ``parse_prometheus`` both ways — the port's
  exposition parses through JAX's parser into the snapshot JAX's own
  exposition of the same registry gives, and JAX's through the port's —
  with the label unescaping and histogram folding; ``JsonlSink`` writes
  the same records and ``read_jsonl`` reads them back in either package;
  the registry methods the fleet calls (``clear_series``, ``dec``,
  ``quantile``, the module-level ``gauge`` / ``histogram``);
- ``observe/window.py``: the pooled-vs-averaged quantile cases of
  ``tests/test_fleet_observability.py::TestWindowMergePooled``;
- ``observe/fleet.py``: ``FleetAggregator`` (reset-safe counter deltas,
  replica-labelled gauges, pooled TTFT windows across clock domains,
  the state census and its JSONL record) and ``death_postmortem``;
- ``observe/alerts.py``: for-duration debounce, the min-samples gate,
  missing metrics, trace slices, validation, the stock rule sets;
- the router's trace propagation over live engines (in process, across
  a kill and requeue, and over TCP): every request's track holds the
  same events (name, phase, args without their time-valued ones) in
  both packages, one connected tree per request;
- the router's ``serve()``: ``/metrics``, ``/healthz``, ``/requests``
  and ``/alerts`` answer the same documents, times aside;
- the public names and signatures of every module of the slice equal
  the reference's.

The three CLI ``top`` cases of ``tests/test_fleet_observability.py``
wait for the port of the CLI.
"""

import inspect
import json
import math
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from paddle_tpu import observe as jobserve
from paddle_tpu.io import lm_serving as jlm
from paddle_tpu.observe import alerts as jalerts
from paddle_tpu.observe import chrome_trace as jchrome
from paddle_tpu.observe import fleet as jfleet
from paddle_tpu.observe import health as jhealth
from paddle_tpu.observe import metrics as jmetrics
from paddle_tpu.observe import window as jwin
from paddle_tpu.serving import replica as jreplica
from paddle_tpu.serving import router as jrouter
from paddle_tpu_torch.io import lm_serving as tlm
from paddle_tpu_torch.observe import alerts as talerts
from paddle_tpu_torch.observe import chrome_trace as tchrome
from paddle_tpu_torch.observe import fleet as tfleet
from paddle_tpu_torch.observe import flight as tflight
from paddle_tpu_torch.observe import health as thealth
from paddle_tpu_torch.observe import metrics as tmetrics
from paddle_tpu_torch.observe import window as twin
from paddle_tpu_torch.serving import replica as treplica
from paddle_tpu_torch.serving import router as trouter
from test_fleet import FakeReplica
from test_torch_fleet import (REPLICA, ROUTER, TIME_METRICS, both, engine,
                              health_view, metrics_view, prompts)

METRICS = {"jax": jmetrics, "port": tmetrics}
ALERTS = {"jax": jalerts, "port": talerts}
FLEET = {"jax": jfleet, "port": tfleet}
WINDOW = {"jax": jwin, "port": twin}
CHROME = {"jax": jchrome, "port": tchrome}
# lifecycle-event args whose values are times
TIME_ARGS = ("queue_wait_ms", "ttft_ms")
# the events the router records on a request's fleet track
ROUTER_EVENTS = ("route", "queue", "place", "requeue")


@pytest.fixture(autouse=True)
def _reset_observe():
    jobserve.reset()
    tchrome.default_buffer().clear()
    tmetrics.default_registry().clear_series()
    tflight.default_flight_recorder().clear()
    yield
    jobserve.reset()
    tchrome.default_buffer().clear()
    tmetrics.default_registry().clear_series()
    tflight.default_flight_recorder().clear()


def _fill(mod):
    """A registry with every kind, labelled and not, and label values
    that need escaping."""
    reg = mod.Registry()
    c = reg.counter("reqs_total", "requests")
    c.inc(3, tenant="a")
    c.inc(2)
    c.inc(1.5, tenant='q"uo\\te\nnl')
    g = reg.gauge("depth", "queue depth")
    g.set(7.5, replica="r0")
    g.set(-2, replica="r1")
    g.inc(4, replica="r1")
    g.dec(1.5, replica="r1")
    h = reg.histogram("lat_seconds", "latency", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 2.0):
        h.observe(v, route="a")
    h.observe(0.2)
    reg.gauge("bare", "")
    return reg


# -- prometheus text parsing, both ways -------------------------------------

def _parsed_view(parsed):
    return {n: (d["kind"], sorted((sorted(s["labels"].items()),
                                   sorted((k, v) for k, v in s.items()
                                          if k != "labels"))
                                  for s in d["series"]))
            for n, d in parsed.items()}


class TestParsePrometheus:
    def test_render_equal_and_parse_both_ways(self):
        """Both registries render the same text; the port's text parses
        through JAX's parser and JAX's through the port's into the same
        snapshot, label escaping and histogram folding included."""
        jreg, treg = _fill(jmetrics), _fill(tmetrics)
        jtext, ttext = jreg.render_prometheus(), treg.render_prometheus()
        assert ttext == jtext
        want = jmetrics.parse_prometheus(jtext)
        for parse, text in ((jmetrics.parse_prometheus, ttext),
                            (tmetrics.parse_prometheus, jtext),
                            (tmetrics.parse_prometheus, ttext)):
            got = parse(text)
            assert got == want and list(got) == list(want)
        assert [s["labels"] for s in want["reqs_total"]["series"]][2] == \
            {"tenant": 'q"uo\\te\nnl'}
        (s0, s1) = want["lat_seconds"]["series"]
        assert {s0["count"], s1["count"]} == {3.0, 1.0}
        assert "value" not in s0
        # the parsed counters and gauges are the registry's own values
        snap = treg.snapshot()
        for name in ("reqs_total", "depth"):
            assert _parsed_view({name: want[name]}) == _parsed_view(
                {name: {"kind": snap[name]["kind"],
                        "series": [{"labels": s["labels"],
                                    "value": s["value"]}
                                   for s in snap[name]["series"]]}})

    def test_round_trip(self):
        def run(side):
            mod = METRICS[side]
            reg = mod.Registry()
            c = reg.counter("reqs_total", "x")
            c.inc(3, tenant="a")
            c.inc(2)
            reg.gauge("depth", "x").set(7.5, replica="r0")
            return mod.parse_prometheus(reg.render_prometheus())
        parsed = both(run)
        assert parsed["reqs_total"]["kind"] == "counter"
        got = {tuple(sorted(s["labels"].items())): s["value"]
               for s in parsed["reqs_total"]["series"]}
        assert got == {(("tenant", "a"),): 3.0, (): 2.0}
        (s,) = parsed["depth"]["series"]
        assert s == {"labels": {"replica": "r0"}, "value": 7.5}

    def test_histogram_sum_count_folded_buckets_skipped(self):
        def run(side):
            mod = METRICS[side]
            reg = mod.Registry()
            h = reg.histogram("lat", "x", buckets=(0.1, 1.0))
            h.observe(0.5)
            h.observe(2.0)
            return mod.parse_prometheus(reg.render_prometheus())
        parsed = both(run)
        assert parsed["lat"]["kind"] == "histogram"
        (s,) = parsed["lat"]["series"]
        assert s["count"] == 2.0 and s["sum"] == pytest.approx(2.5)
        assert "value" not in s

    def test_malformed_lines_skipped(self):
        text = ("# TYPE ok counter\nok 3\nbroken{ 1\nnot_a_number x\n"
                "trailing\nesc{a=\"x\\\"y\"} 2\nunterminated{a=\"b\" 4\n")
        parsed = both(lambda side: METRICS[side].parse_prometheus(text))
        assert parsed["ok"]["series"][0]["value"] == 3.0
        assert "broken" not in parsed and "unterminated" not in parsed
        assert parsed["esc"]["series"] == [{"labels": {"a": 'x"y'},
                                            "value": 2.0}]

    def test_registry_methods_the_fleet_calls(self):
        def run(side):
            mod = METRICS[side]
            reg = _fill(mod)
            h = reg.get("lat_seconds")
            qs = [h.quantile(q, route="a") for q in (0.0, 0.3, 0.5, 1.0)]
            qs.append(h.quantile(0.5, route="none"))
            g = reg.get("depth")
            vals = [g.value(replica="r1")]
            reg.clear_series()
            vals.append(g.value(replica="r1"))
            vals.append(reg.snapshot()["depth"]["series"])
            m = mod.Registry()
            with h.time(route="t"):
                pass
            return {"qs": qs, "vals": vals, "kinds": [
                type(mod.gauge("fleet_test_gauge", "x")).__name__,
                type(mod.histogram("fleet_test_hist", "x")).__name__,
                m.render_prometheus()],
                "timed": h.snapshot(route="t")["count"]}
        got = both(run)
        assert got["qs"] == [0.1, 0.1, 1.0, 2.0, 0.0]
        assert got["vals"] == [0.5, 0.0, []]
        assert got["kinds"] == ["Gauge", "Histogram", ""]
        assert got["timed"] == 1

    def test_jsonl_sink_both_ways(self, tmp_path):
        """One sink per package writes the same records (non-finite
        floats stringified); each package's ``read_jsonl`` reads either
        file, skipping a torn line."""
        recs = [{"step": 1, "loss": 0.5}, {"step": 2, "loss": math.nan,
                                           "nested": {"x": [math.inf]}}]
        paths = {}
        for side in ("jax", "port"):
            p = tmp_path / side / "m.jsonl"
            mod = METRICS[side]
            with mod.JsonlSink(str(p), flush_every=1) as sink:
                sink.write(recs[0])
                sink.write(dict(recs[1]), extra=3)
                sink.flush()
            sink.write({"after": "close"})      # a closed sink drops it
            with open(p, "a") as f:
                f.write('{"torn": \n')
            paths[side] = p

        def strip(rs):
            return [{k: v for k, v in r.items() if k != "ts"} for r in rs]
        for reader in (jmetrics.read_jsonl, tmetrics.read_jsonl):
            got = {s: strip(reader(str(p))) for s, p in paths.items()}
            assert got["port"] == got["jax"] == [
                {"step": 1, "loss": 0.5},
                {"step": 2, "loss": "nan", "nested": {"x": ["inf"]},
                 "extra": 3}]
            assert strip(reader(str(paths["port"]), last=1)) == \
                got["port"][-1:]


# -- pooled-vs-averaged quantiles -------------------------------------------

def _nearest_rank(sorted_vals, q):
    i = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1) + 0.5))
    return sorted_vals[i]


class TestWindowMergePooled:
    def test_merge_equals_pooled(self):
        rng = np.random.RandomState(0)
        parts = [[float(v) for v in rng.rand(n)] for n in (7, 500, 60)]
        pooled = sorted(v for vals in parts for v in vals)

        def run(side):
            W = WINDOW[side].WindowedQuantiles
            wins = []
            for vals in parts:
                w = W(window_s=60, clock=lambda: 100.0)
                for v in vals:
                    w.observe(v)
                wins.append(w)
            merged = W(window_s=60, clock=lambda: 100.0)
            merged.merge(*wins)
            return [merged.quantile(q) for q in (0.5, 0.9, 0.99)] + \
                [merged.count()]
        got = both(run)
        assert got == [_nearest_rank(pooled, q) for q in (0.5, 0.9, 0.99)] \
            + [len(pooled)]

    def test_averaging_per_replica_p99_loses_the_tail(self):
        rng = np.random.RandomState(1)
        big_vals = [float(v) for v in 0.010 + 0.490 * rng.rand(3000)]
        truth = _nearest_rank(sorted([0.001] * 3 + big_vals), 0.99)

        def run(side):
            W = WINDOW[side].WindowedQuantiles
            small = W(window_s=60, clock=lambda: 100.0)
            big = W(window_s=60, max_samples=4096, clock=lambda: 100.0)
            for v in (0.001, 0.001, 0.001):
                small.observe(v)
            for v in big_vals:
                big.observe(v)
            merged = W(window_s=60, max_samples=8192, clock=lambda: 100.0)
            merged.merge(small, big)
            return [(small.quantile(0.99) + big.quantile(0.99)) / 2,
                    merged.quantile(0.99)]
        averaged, merged = both(run)
        assert merged == truth and averaged < 0.6 * truth

    def test_export_absorb_roundtrip_across_clock_domains(self):
        def run(side):
            W = WINDOW[side].WindowedQuantiles
            src = W(window_s=10.0, clock=lambda: 50.0)
            for v in (0.1, 0.2, 0.3):
                src.observe(v)
            aged = src.export_samples()
            dst = W(window_s=10.0, clock=lambda: 9999.0)
            dst.absorb(aged)
            dst2 = W(window_s=10.0, clock=lambda: 9999.0)
            dst2.absorb([[11.0, 0.9], [1.0, 0.4]])
            return [aged, dst.count(), dst.quantile(0.5), dst2.count(),
                    dst2.quantile(0.5)]
        aged, n, q, n2, q2 = both(run)
        assert all(a == 0.0 for a, _ in aged)
        assert (n, q, n2, q2) == (3, 0.2, 1, 0.4)


# -- the aggregator ---------------------------------------------------------

def _snap(counter=None, gauge=None):
    out = {}
    if counter is not None:
        out["ctr_total"] = {"kind": "counter", "series": [
            {"labels": {}, "value": counter}]}
    if gauge is not None:
        out["depth"] = {"kind": "gauge", "series": [
            {"labels": {}, "value": gauge}]}
    return out


class TestFleetAggregator:
    def test_counters_summed_as_reset_safe_deltas(self):
        def run(side):
            agg = FLEET[side].FleetAggregator(clock=lambda: 0.0)
            total = []
            for name, v in (("a", 10), ("b", 5), ("a", 2), ("a", 6)):
                agg.observe_replica(name, snapshot=_snap(counter=v))
                total.append(agg.registry.get("fleet_ctr_total").value())
            return total
        assert both(run) == [10.0, 15.0, 15.0, 19.0]

    def test_gauges_keep_replica_label(self):
        def run(side):
            agg = FLEET[side].FleetAggregator(clock=lambda: 0.0)
            agg.observe_replica("a", snapshot=_snap(gauge=3))
            agg.observe_replica("b", snapshot=_snap(gauge=1))
            g = agg.registry.get("fleet_depth")
            return [g._peek({"replica": r}).value for r in "ab"]
        assert both(run) == [3.0, 1.0]

    def test_pooled_ttft_with_scrape_drift(self):
        def run(side):
            t = [100.0]
            agg = FLEET[side].FleetAggregator(window_s=60.0,
                                              clock=lambda: t[0])
            agg.observe_replica("a", health={"window": {"ttft_samples": [
                [0.5, 0.010], [1.0, 0.020]]}})
            t[0] = 130.0
            agg.observe_replica("b", health={"window": {"ttft_samples": [
                [0.2, 0.100]]}})
            pool = agg.pooled_ttft()
            out = [pool.count(), pool.quantile(0.99)]
            t[0] = 161.0
            out.append(agg.pooled_ttft().count())
            t[0] = 162.0
            agg.observe_replica("b", health={"window": {"ttft_samples": [
                [0.1, 0.100]]}})
            out.append(agg.pooled_ttft().count())
            return out
        assert both(run) == [3, 0.100, 1, 1]

    def test_finish_scrape_gauges_states_and_jsonl(self, tmp_path):
        def run(side):
            path = tmp_path / side / "fleet.jsonl"
            agg = FLEET[side].FleetAggregator(clock=lambda: 0.0,
                                              jsonl_path=str(path))
            agg.observe_replica("a", state="ok", health={"window": {
                "ttft_samples": [[0.1, 0.05]]}})
            agg.observe_replica("b", state="dead")
            doc = agg.finish_scrape()
            reps = agg.registry.get("fleet_replicas")
            q = agg.registry.get("fleet_ttft_window_seconds")
            out = {"doc": doc, "members": agg.members(),
                   "ok": reps._peek({"state": "ok"}).value,
                   "dead": reps._peek({"state": "dead"}).value,
                   "p99": q._peek({"q": "p99"}).value}
            agg.forget_state("b")
            agg.finish_scrape()
            out["dead_after"] = reps._peek({"state": "dead"}).value
            out["metrics"] = metrics_view(agg.registry)
            agg.close()
            out["records"] = [{k: v for k, v in r.items() if k != "ts"}
                              for r in METRICS[side].read_jsonl(str(path))]
            return out
        got = both(run)
        assert got["doc"]["replicas"] == {"a": "ok", "b": "dead"}
        assert (got["ok"], got["dead"], got["dead_after"]) == (1, 1, 0)
        assert got["p99"] == pytest.approx(0.05)
        assert len(got["records"]) == 2
        assert got["records"][0]["kind"] == "fleet"

    def test_generalized_member_handle(self):
        """The gang form: another prefix, entity label and window keys,
        a partial export keeping the other key's last view."""
        def run(side):
            agg = FLEET[side].FleetAggregator(
                clock=lambda: 0.0, prefix="gang", entity_label="rank",
                window_keys=("step_time", "barrier_wait"),
                count_suffix="_samples")
            agg.observe_replica("0", state="ok", snapshot=_snap(
                counter=4, gauge=2), health={"window": {
                    "step_time_samples": [[0.0, 0.5]],
                    "barrier_wait_samples": [[0.0, 0.1]]}})
            agg.observe_replica("0", health={"window": {
                "step_time_samples": [[0.0, 0.7]]}})
            agg.observe_replica("1", state="done")
            doc = agg.finish_scrape()
            agg.forget_state("0")
            return {"doc": doc, "metrics": metrics_view(agg.registry),
                    "pooled": agg.pooled("barrier_wait").count()}
        got = both(run)
        assert got["doc"]["step_time_p50_s"] == 0.7
        assert got["pooled"] == 1
        assert "gang_members" in got["metrics"]

    def test_death_postmortem_artifact(self, tmp_path):
        def run(side):
            path = tmp_path / f"{side}.json"
            out = FLEET[side].death_postmortem(
                "r1", router_view={"queue_depth": 2},
                last_health={"status": "ok"},
                outstanding=[{"xid": 3, "requeues": 1}],
                alerts=[{"rule": "fleet_dead_replicas"}], path=str(path))
            doc = json.loads(path.read_text())
            rec = doc["last_steps"][-1]
            assert out == str(path)
            return {"reason": doc["reason"],
                    "rec": {k: v for k, v in rec.items() if k != "ts"}}
        got = both(run)
        assert got["reason"] == "replica r1 died"
        assert got["rec"]["kind"] == "replica_death"
        assert got["rec"]["outstanding"] == [{"xid": 3, "requeues": 1}]


# -- alert rules ------------------------------------------------------------

def _reg(side, depth=0.0):
    reg = METRICS[side].Registry()
    reg.gauge("router_queue_depth", "x").set(depth)
    return reg


def _alert_view(ev):
    doc = ev.doc()
    doc["events"] = [{k: v for k, v in e.items() if k != "ts"}
                     for e in doc["events"]]
    return doc


class TestAlerts:
    def test_for_duration_debounce(self):
        def run(side):
            reg = _reg(side, 10)
            ev = ALERTS[side].AlertEvaluator(reg, [ALERTS[side].AlertRule(
                "q", metric="router_queue_depth", op=">", threshold=5,
                for_s=2.0)])
            steps = [ev.evaluate(now=0.0), ev.evaluate(now=1.9)]
            steps.append(ev.evaluate(now=2.0))
            firing = ev.firing()
            reg.get("router_queue_depth").set(0)
            steps.append(ev.evaluate(now=3.0))
            reg.get("router_queue_depth").set(10)
            ev.evaluate(now=4.0)
            reg.get("router_queue_depth").set(0)
            steps.append(ev.evaluate(now=10.0))
            steps = [[{k: v for k, v in e.items() if k != "ts"} for e in s]
                     for s in steps]
            return {"steps": steps, "firing": firing,
                    "doc": _alert_view(ev),
                    "fired": ev._m_transitions.value(rule="q",
                                                     event="firing")}
        got = both(run)
        s = got["steps"]
        assert s[0] == s[1] == s[4] == []
        assert s[2][0]["event"] == "firing" and s[2][0]["value"] == 10.0
        assert got["firing"][0]["rule"] == "q"
        assert s[3][0]["event"] == "resolved"
        assert got["fired"] == 1

    def test_min_samples_gates_ratio_rules(self):
        def run(side):
            reg = _reg(side)
            reg.gauge("hit_rate", "x").set(0.0)
            ctr = reg.counter("placements_total", "x")
            ev = ALERTS[side].AlertEvaluator(reg, [ALERTS[side].AlertRule(
                "cold", metric="hit_rate", op="<", threshold=0.2,
                samples_metric="placements_total", min_samples=20)])
            out = [ev.evaluate(now=0.0)]
            ctr.inc(25)
            out.append([e["event"] for e in ev.evaluate(now=1.0)])
            return out
        assert both(run) == [[], ["firing"]]

    def test_missing_metric_is_not_breached(self):
        def run(side):
            ev = ALERTS[side].AlertEvaluator(METRICS[side].Registry(), [
                ALERTS[side].AlertRule("ghost", metric="does_not_exist",
                                       op=">", threshold=0)])
            return [ev.evaluate(now=0.0), _alert_view(ev)]
        out, doc = both(run)
        assert out == [] and doc["rules"][0]["state"] == "inactive"

    def test_transitions_emit_trace_slices(self):
        def run(side):
            reg = _reg(side, 10)
            ev = ALERTS[side].AlertEvaluator(reg, [ALERTS[side].AlertRule(
                "q", metric="router_queue_depth", op=">", threshold=5)])
            ev.evaluate(now=0.0)
            reg.get("router_queue_depth").set(0)
            ev.evaluate(now=1.0)
            return [(s[0], s[5], s[4]["event"], s[7]) for s in
                    CHROME[side].default_buffer().spans()
                    if s[6] == "alert.q"]
        assert both(run) == [("alert:q", "b", "firing", "alert"),
                             ("alert:q", "e", "resolved", "alert")]

    def test_duplicate_rule_names_rejected(self):
        for side in ("jax", "port"):
            mod = ALERTS[side]
            r = mod.AlertRule("dup", metric="m", op=">", threshold=0)
            with pytest.raises(ValueError, match="duplicate"):
                mod.AlertEvaluator(METRICS[side].Registry(), [r, r])
            with pytest.raises(ValueError, match="op"):
                mod.AlertRule("bad", metric="m", op="!=", threshold=0)
            with pytest.raises(ValueError, match="for_s"):
                mod.AlertRule("bad", metric="m", op=">", threshold=0,
                              for_s=-1)

    def test_stock_rule_sets(self):
        def run(side):
            mod = ALERTS[side]
            return [[(r.name, r.metric, r.op, r.threshold, r.labels, r.for_s,
                      r.samples_metric, r.min_samples, r.description)
                     for r in rules]
                    for rules in (mod.default_fleet_rules(),
                                  mod.default_fleet_rules(
                                      burn_threshold=2.0, for_s=5.0),
                                  mod.default_training_rules(),
                                  mod.default_training_rules(skew_s=0.5))]
        got = both(run)
        assert [r[0] for r in got[0]] == [
            "fleet_ttft_burn_rate", "fleet_queue_depth",
            "fleet_dead_replicas", "fleet_prefix_hit_rate"]


# -- trace propagation over live engines -------------------------------------

def _tracks(side, trace_ids):
    """Each request's events on its fleet track: (name, phase, args
    without the time-valued ones)."""
    by_id = {t: [] for t in trace_ids}
    for name, _, _, _, args, ph, ev_id, cat in \
            CHROME[side].default_buffer().spans():
        if cat == "request" and ev_id in by_id:
            by_id[ev_id].append((name, ph, {
                k: v for k, v in (args or {}).items()
                if k not in TIME_ARGS}))
    return [by_id[t] for t in trace_ids]


def _assert_joined(evs, *, requeued=False):
    names = [n for n, _, _ in evs]
    assert sum(1 for _, ph, _ in evs if ph == "b") == \
        sum(1 for _, ph, _ in evs if ph == "e"), names
    assert sum(1 for n, ph, _ in evs if n == "route" and ph == "b") == 1
    for engine_side in ("queued", "prefill", "decode", "first_token"):
        assert engine_side in names, names
    if requeued:
        assert "requeue" in names and names.count("queued") >= 2, names


def _own_tracks(side):
    return sorted({s[6] for s in CHROME[side].default_buffer().spans()
                   if s[7] == "request" and not s[6].startswith("fleet")})


class TestTracePropagation:
    def test_in_process_lifecycle_joins_router_spans(self):
        def run(side):
            reps = [REPLICA[side].EngineReplica(engine(side), f"r{i}")
                    for i in range(2)]
            router = ROUTER[side].Router(reps, block_size=8,
                                         chunk_tokens=16, health_poll_s=0.0)
            reqs = [router.submit(p, 4) for p in prompts(n=4)]
            router.run_until_idle()
            assert all(r.trace_id.startswith("fleet") for r in reqs)
            return {"status": [r.status for r in reqs],
                    "tracks": _tracks(side, [r.trace_id for r in reqs]),
                    "own": _own_tracks(side)}
        got = both(run)
        assert got["status"] == ["done"] * 4 and got["own"] == []
        for evs in got["tracks"]:
            _assert_joined(evs)

    def test_kill_and_requeue_joins_original_trace(self):
        def run(side):
            reps = [REPLICA[side].EngineReplica(engine(side), f"r{i}")
                    for i in range(2)]
            router = ROUTER[side].Router(reps, block_size=8,
                                         chunk_tokens=16, health_poll_s=0.0)
            reqs = [router.submit(p, 4) for p in prompts(n=4)]
            for _ in range(3):
                router.step()
            victim = next(r.replica for r in reqs if r.replica is not None)
            next(st.handle for st in router._all
                 if st.name == victim).kill()
            router.run_until_idle()
            firing = [a["rule"] for a in router.alerts.firing()]
            router.remove_replica(victim)
            router.step()
            return {"victim": victim,
                    "requeues": [r.requeues for r in reqs],
                    "status": [r.status for r in reqs],
                    "tracks": _tracks(side, [r.trace_id for r in reqs]),
                    "firing": firing,
                    "firing_after": router.alerts.firing(),
                    "events": [(e["rule"], e["event"])
                               for e in router.alerts.events],
                    "alert_doc": _alert_view(router.alerts)}
        got = both(run)
        assert got["status"] == ["done"] * 4
        assert any(got["requeues"])
        for n, evs in zip(got["requeues"], got["tracks"]):
            if n:
                _assert_joined(evs, requeued=True)
                assert any(name == "aborted" for name, _, _ in evs)
        assert "fleet_dead_replicas" in got["firing"]
        assert got["firing_after"] == []
        assert ("fleet_dead_replicas", "firing") in got["events"]
        assert ("fleet_dead_replicas", "resolved") in got["events"]

    def test_tcp_transport_carries_trace(self):
        def run(side):
            mod = REPLICA[side]
            srv = mod.ReplicaServer(engine(side), port=0)
            t = threading.Thread(target=srv.serve_forever, daemon=True)
            t.start()
            h = mod.SocketReplica("r0", ("127.0.0.1", srv.port))
            try:
                router = ROUTER[side].Router([h], block_size=8,
                                             chunk_tokens=16,
                                             health_poll_s=0.0)
                reqs = [router.submit(p, 3) for p in prompts(n=2)]
                deadline = time.time() + 60
                while not router.idle and time.time() < deadline:
                    router.step()
                    time.sleep(0.01)
                tracks = _tracks(side, [r.trace_id for r in reqs])
                for evs in tracks:
                    _assert_joined(evs)
            finally:
                srv.drain()
                t.join(timeout=30)
                h.close()
            assert not t.is_alive()
            # the router's events and the server thread's interleave with
            # the two threads' timing, and so does the server's batching
            # of lines that arrive apart: compare the router's side whole
            # and the engine's by name and phase
            return {"status": [r.status for r in reqs],
                    "tokens": [list(map(int, r.tokens)) for r in reqs],
                    "router": [[e for e in evs if e[0] in ROUTER_EVENTS]
                               for evs in tracks],
                    "engine": [[e[:2] for e in evs
                                if e[0] not in ROUTER_EVENTS]
                               for evs in tracks]}
        got = both(run)
        assert got["status"] == ["done"] * 2

    def test_replica_death_post_mortem_when_configured(self, tmp_path,
                                                       monkeypatch):
        """With a flight directory set, a replica's death writes one
        ``fleet_death_<replica>_*.json`` artifact holding the requeued
        work and the router's view."""
        def run(side):
            d = tmp_path / side
            monkeypatch.setenv("PADDLE_TPU_FLIGHT_DIR", str(d))
            reps = [FakeReplica(f"r{i}") for i in range(2)]
            reps[0].delay = 1000
            router = ROUTER[side].Router(reps, block_size=4, chunk_tokens=8,
                                         health_poll_s=0.0)
            rng = np.random.RandomState(3)
            for _ in range(4):
                router.submit(rng.randint(0, 99, 12).astype(np.int32), 2)
            router._place()
            reps[0].kill()
            router.run_until_idle()
            (path,) = list(d.iterdir())
            rec = json.loads(path.read_text())["last_steps"][-1]
            return {"name": path.name.split("_2")[0],
                    "outstanding": [{k: v for k, v in o.items()
                                     if k != "trace"}
                                    for o in rec["outstanding"]],
                    "router": health_view(rec["router"]),
                    "alerts": rec["alerts"]}
        got = both(run)
        assert got["name"] == "fleet_death_r0"
        assert len(got["outstanding"]) == 2
        assert got["router"]["replicas"]["r0"]["state"] == "dead"


# -- endpoints ---------------------------------------------------------------

def _get(url):
    with urllib.request.urlopen(url, timeout=5) as resp:
        return resp.status, resp.read().decode()


class TestEndpoints:
    def test_router_serve_fleet_surfaces(self):
        """One /metrics scrape answers for the fleet (replica-labelled
        gauges + pooled quantile gauges), /alerts serves the evaluator
        doc, /healthz the per-replica columns, /requests the log — the
        same documents in both packages, times aside."""
        def run(side):
            reps = [REPLICA[side].EngineReplica(engine(side), f"r{i}")
                    for i in range(2)]
            router = ROUTER[side].Router(reps, block_size=8,
                                         chunk_tokens=16, health_poll_s=0.0)
            for p in prompts(n=4):
                router.submit(p, 3)
            router.run_until_idle()
            srv = router.serve(port=0)
            try:
                code_m, text = _get(srv.url + "/metrics")
                code_a, alerts = _get(srv.url + "/alerts")
                code_h, health = _get(srv.url + "/healthz")
                code_r, requests = _get(srv.url + "/requests")
            finally:
                srv.close()
                router.close()
            parsed = METRICS[side].parse_prometheus(text)
            alerts = json.loads(alerts)
            alerts["events"] = [{k: v for k, v in e.items() if k != "ts"}
                                for e in alerts["events"]]
            requests = json.loads(requests)
            return {"codes": [code_m, code_a, code_h, code_r],
                    "text": [ln for ln in text.splitlines()
                             if not any(t in ln for t in TIME_METRICS)],
                    "parsed": {n: d for n, d in parsed.items()
                               if not any(t in n for t in TIME_METRICS)},
                    "series": sorted(parsed),
                    "alerts": alerts,
                    "health": health_view(json.loads(health)),
                    "requests": {k: requests[k] for k in ("count",
                                                          "by_reason")}}
        got = both(run)
        assert got["codes"] == [200] * 4
        text = "\n".join(got["text"])
        assert 'fleet_engine_queue_depth{replica="r0"}' in text
        assert "fleet_ttft_window_seconds" in got["series"]
        assert got["parsed"]["fleet_engine_requests_total"][
            "series"][0]["value"] == 4.0
        assert {r["rule"] for r in got["alerts"]["rules"]} >= {
            "fleet_dead_replicas", "fleet_queue_depth"}
        assert got["health"]["alerts_firing"] == []
        rep = got["health"]["replicas"]["r0"]
        assert {"blocks_in_use", "blocks_total"} <= set(rep)
        assert got["requests"]["count"] == 4

    def test_health_server_alerts_route(self):
        """``alerts_fn`` adds ``/alerts`` (non-finite values cleaned);
        without it the route answers 404, as JAX's server does."""
        doc = {"rules": [], "firing": [{"value": math.inf}], "events": []}

        def run(side):
            mod = {"jax": jhealth, "port": thealth}[side]
            out = []
            for fn in (lambda: doc, None):
                srv = mod.HealthServer(registry=METRICS[side].Registry(),
                                       port=0, alerts_fn=fn)
                try:
                    out.append(_get(srv.url + "/alerts"))
                except urllib.error.HTTPError as e:
                    out.append((e.code, e.read().decode()))
                finally:
                    srv.close()
            return out
        got = both(run)
        assert got[0][0] == 200 and json.loads(got[0][1])["firing"] == [
            {"value": "inf"}]
        assert got[1][0] == 404

    def test_lm_server_serve(self, tmp_path):
        """``LMServer.serve`` over one JAX v1 artifact loaded by each
        package: ``/healthz`` answers ``health()`` and ``/metrics`` the
        server's registry, the same documents in both packages before
        and after a greedy ``generate()`` (times aside)."""
        import jax

        from test_torch_fleet import _model
        jcfg, jp, _, _ = _model()
        path = str(tmp_path / "lm.tar")
        jlm.save_lm_artifact(path, jax.tree_util.tree_map(np.asarray, jp),
                             jcfg, batch=2, prompt_len=8, cache_len=32)
        prompt = np.random.RandomState(0).randint(0, 40, (2, 8)).astype(
            np.int32)

        def run(side):
            mod = {"jax": jlm, "port": tlm}[side]
            srv = mod.load_lm_artifact(path)
            kw = {"device": "cpu"} if side == "port" else {}
            hs = srv.serve(port=0)
            out = []
            try:
                for i in range(2):
                    code_h, health = _get(hs.url + "/healthz")
                    code_m, text = _get(hs.url + "/metrics")
                    health = json.loads(health)
                    assert health == dict(srv.health(),
                                          seconds_since_request=health[
                                              "seconds_since_request"],
                                          status="ok")
                    health.pop("seconds_since_request")
                    out.append({"codes": [code_h, code_m],
                                "health": health,
                                "metrics": metrics_view(srv.metrics),
                                "text": [ln for ln in text.splitlines()
                                         if "seconds" not in ln
                                         and "mfu" not in ln]})
                    if i == 0:
                        out.append([list(map(int, row)) for row in
                                    srv.generate(prompt, 4, **kw)])
            finally:
                hs.close()
            return out
        before, ids, after = both(run)
        assert before["codes"] == after["codes"] == [200, 200]
        assert before["health"]["requests"] == 0
        assert after["health"]["requests"] == 1
        assert after["health"]["tokens_generated"] == 8
        assert "lm_generate_requests_total 1" in after["text"]
        assert len(ids) == 2 and len(ids[0]) == 12


# -- public surface -----------------------------------------------------------

SURFACE = [(jmetrics, tmetrics), (jalerts, talerts), (jfleet, tfleet),
           (jreplica, treplica), (jrouter, trouter)]


def _public(mod):
    out = {}
    for name, obj in vars(mod).items():
        if name.startswith("_") or getattr(obj, "__module__", None) \
                != mod.__name__:
            continue
        if inspect.isclass(obj):
            out[name] = {m: str(inspect.signature(f)) for m, f in
                         vars(obj).items()
                         if inspect.isfunction(f) and (
                             not m.startswith("_") or m == "__init__")}
        elif inspect.isfunction(obj):
            out[name] = str(inspect.signature(obj))
    return out


@pytest.mark.parametrize("jmod,tmod", SURFACE,
                         ids=[m.__name__.split(".")[-1]
                              for m, _ in SURFACE])
def test_public_names_and_signatures(jmod, tmod):
    """Every public function and class of the reference module, with
    every public method, is in the port with the same signature (the
    annotations name the port's own classes)."""
    want = _public(jmod)
    got = _public(tmod)
    norm = {"paddle_tpu_torch.": "paddle_tpu.", "_metrics.Registry":
            "_metrics.Registry"}
    text = json.dumps(got)
    for a, b in norm.items():
        text = text.replace(a, b)
    assert json.loads(text) == want
    assert inspect.signature(thealth.HealthServer.__init__) == \
        inspect.signature(jhealth.HealthServer.__init__)
