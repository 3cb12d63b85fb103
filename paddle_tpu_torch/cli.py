"""The ``paddle_tpu_torch`` command line (counterpart of
``paddle_tpu/cli.py``): the serving jobs ``serve``, ``route`` and
``top``, with the reference's flags, names and defaults.

- ``serve`` — one continuous-batching engine over a v3-v5
  ``lm_serving`` artifact: JSONL requests on stdin, or the fleet
  replica mode with ``--port`` (the ready line is then its only
  stdout);
- ``route`` — the prefix-aware fleet router over ``--replica``
  endpoints, or over a fleet of ``serve --port`` processes it spawns
  (``--model`` + ``--replicas``), with the fleet controller under
  ``--autoscale``;
- ``top`` — a refresh loop over a router's ``/healthz`` + ``/alerts``.

``--device`` (the port's own flag) picks the engine's device: the card
unless it says otherwise, where the JAX CLI reads ``JAX_PLATFORMS``.
The trainer jobs (``train``, ``test``, ``time``, ``infer``,
``checkgrad``) and ``stats`` are not ported yet: they exit 2 naming
their ROADMAP item.

Run: ``python -m paddle_tpu_torch serve --model=lm.tar --device=cpu``.
"""

import argparse
import sys

import numpy as np

# jobs of the reference CLI the port does not run yet, and where they
# stand in ROADMAP.md
UNPORTED = {
    "train": "ROADMAP A7c, the models and the trainer",
    "test": "ROADMAP A7c, the models and the trainer",
    "time": "ROADMAP A7c, the models and the trainer",
    "infer": "ROADMAP A7c, the models and the trainer",
    "checkgrad": "ROADMAP A7c, the models and the trainer",
    "stats": "ROADMAP A8, the data and runtime remainder",
}


def job_serve(args):
    """Continuous-batching LM serving: load an ``lm_serving`` artifact,
    schedule JSONL requests through the decode engine, write one JSONL
    result per request as it completes (NOT in submission order — that
    is the point of continuous batching). The engine runs on the card
    unless ``--device`` names another device. Transport is stdio by
    default; ``--port`` binds a TCP socket instead (the fleet replica
    mode), announcing the bound ports as one machine-readable
    ``{"replica_ready": ...}`` line on stdout.

    Request lines:  {"prompt": [ids...], "max_new": 32,
                     "temperature": 0.8, "top_k": 40, "eos_id": 2,
                     "tenant": "acme", "tier": "latency"}
    Result lines:   {"id": ..., "tokens": [ids...], "finish_reason":
                     "eos"|"max_tokens", "ttft_ms": ..., "latency_ms": ...}

    Paged-engine replicas additionally serve the fleet ops
    ``export_prefix`` / ``import_prefix`` (P/D disaggregation — see
    ``serving/replica.py`` for the wire).

    ``tenant``/``tier`` are optional: tier "latency" admits ahead of
    "batch" (and may preempt batch work's blocks on a paged engine); a
    malformed tier is rejected with a counted reason and an error
    line, never a traceback. ``--tenant-budget acme=4096``
    (repeatable) caps a tenant's in-flight tokens — exhaustion queues.

    SIGTERM drains gracefully in both transports: stop admitting new
    requests, finish everything in flight, emit the results, exit 0 —
    the replica-drain contract the fleet router relies on.

    ``--health_port`` exposes the engine's /metrics + /healthz (queue
    depth, slot occupancy, TTFT histograms, per-tier windows) while
    serving.
    """
    import json

    from paddle_tpu_torch.io import lm_serving
    from paddle_tpu_torch.serving import replica as _replica

    budgets = {}
    for spec in args.tenant_budget:
        tenant, eq, tokens = spec.partition("=")
        try:
            if not eq or not tenant or int(tokens) < 1:
                raise ValueError
            budgets[tenant] = int(tokens)
        except ValueError:
            print(f"serve: --tenant-budget expects TENANT=TOKENS "
                  f"(TOKENS >= 1), got {spec!r}", file=sys.stderr)
            return 1
    tiers = None
    if args.tiers_dram_mb or args.tiers_disk_mb:
        if args.tiers_disk_mb and not args.tiers_dir:
            print("serve: --tiers_disk_mb needs --tiers_dir",
                  file=sys.stderr)
            return 1
        tiers = {"dram_bytes": int(args.tiers_dram_mb * 1e6),
                 "disk_bytes": int(args.tiers_disk_mb * 1e6),
                 "disk_dir": args.tiers_dir}
    srv = lm_serving.load_lm_artifact(args.model)
    try:
        eng = srv.engine(tiers=tiers, device=args.device)
    except ValueError as e:
        print(f"serve: {e}", file=sys.stderr)
        return 1
    if budgets:
        if not hasattr(eng, "set_tenant_budget"):
            print("serve: --tenant-budget needs a paged-engine "
                  "artifact (format v4+)", file=sys.stderr)
            return 1
        for tenant, tokens in budgets.items():
            eng.set_tenant_budget(tenant, tokens)
    if args.ttft_slo_ms:
        from paddle_tpu_torch.observe.window import SloConfig
        eng.configure_slo(SloConfig(
            ttft_s=args.ttft_slo_ms / 1000.0,
            target=args.slo_target,
            window_s=args.slo_window_s))
    health_srv = None
    if args.health_port is not None:
        health_srv = eng.serve(host=args.health_host,
                               port=args.health_port)
        print(f"observability: {health_srv.url}/metrics  "
              f"{health_srv.url}/healthz  {health_srv.url}/requests",
              file=sys.stderr)
    try:
        if args.port is not None:
            tcp = _replica.ReplicaServer(
                eng, host=args.serve_host, port=args.port,
                default_max_new=args.max_new)
            restore = _replica.install_drain_handler(tcp.loop)
            # the ready line is the ONLY stdout in --port mode: fleet
            # launchers (runtime.master.ServingFleet) parse it to learn
            # the ephemeral ports
            print(json.dumps({"replica_ready": {
                "port": tcp.port,
                "health_port": health_srv.port if health_srv else None,
            }}), flush=True)
            try:
                return tcp.serve_forever()
            finally:
                restore()
        return _replica.serve_stdio(eng, default_max_new=args.max_new)
    finally:
        if health_srv is not None:
            health_srv.close()


def job_route(args):
    """Serving-fleet router: front N engine replicas with prefix-aware
    placement, health-driven drain, and optional prefill/decode
    disaggregation (``serving/router.py``). Same stdio wire as
    ``serve`` — JSONL requests in, one JSONL result per request out —
    one tier up: results additionally carry the serving replica.

    Replicas come from either ``--replica HOST:PORT[:HEALTH_PORT]``
    (repeatable; connect to running ``serve --port`` processes) or
    ``--model`` + ``--replicas N`` (spawn the fleet locally via
    ``runtime.master.ServingFleet``; ``--device`` passes on to each
    replica). ``--prefill_replicas K`` marks
    the first K replicas as the disaggregated prefill tier. SIGTERM
    drains: stop admitting, finish in-flight, emit, exit 0."""
    import json
    import queue as _queue
    import signal
    import threading

    from paddle_tpu_torch.serving import replica as _replica
    from paddle_tpu_torch.serving.router import Router, fleet_keying

    fleet = None
    handles = []
    budgets = {}
    for spec in args.tenant_budget:
        tenant, _, tokens = spec.partition("=")
        try:
            budgets[tenant] = int(tokens)
        except ValueError:
            print(f"route: --tenant-budget expects TENANT=TOKENS, "
                  f"got {spec!r}", file=sys.stderr)
            return 1
    router_kw = dict(max_in_flight=args.max_in_flight,
                     fetch_flops_per_byte=args.fetch_flops_per_byte,
                     shed_queue_max=args.shed_queue_max,
                     shed_burn_max=args.shed_burn_max,
                     tenant_budgets=budgets or None)
    if args.ttft_slo_ms:
        from paddle_tpu_torch.observe.window import SloConfig
        router_kw["slo"] = SloConfig(ttft_s=args.ttft_slo_ms / 1000.0,
                                     target=args.slo_target,
                                     window_s=args.slo_window_s)
    try:
        if args.model:
            from paddle_tpu_torch.runtime.master import ServingFleet
            extra = ([f"--device={args.device}"]
                     if args.device is not None else [])
            fleet = ServingFleet(args.model, replicas=args.replicas,
                                 prefill=args.prefill_replicas,
                                 args_extra=extra)
            fleet.start()
            router = fleet.router(**router_kw)
        elif args.replica:
            for i, spec in enumerate(args.replica):
                parts = spec.split(":")
                if len(parts) not in (2, 3):
                    print(f"route: --replica expects "
                          f"HOST:PORT[:HEALTH_PORT], got {spec!r}",
                          file=sys.stderr)
                    return 1
                health_url = (f"http://{parts[0]}:{parts[2]}"
                              if len(parts) == 3 else None)
                handles.append(_replica.SocketReplica(
                    f"replica{i}", (parts[0], int(parts[1])),
                    health_url))
            # placement keying comes from the engines themselves: the
            # paged /healthz reports block_size + chunk_tokens
            bs, chunk = fleet_keying(handles)
            prefill = [h.name for h in
                       handles[:max(args.prefill_replicas, 0)]]
            router = Router(handles, block_size=bs, chunk_tokens=chunk,
                            prefill=prefill, **router_kw)
        else:
            print("route: pass --replica HOST:PORT... or --model + "
                  "--replicas N", file=sys.stderr)
            return 1

        controller = None
        ctrl_srv = None
        if args.autoscale or args.wedge_timeout_s > 0:
            if fleet is None:
                print("route: --autoscale needs --model + --replicas "
                      "(a locally spawned fleet the controller can "
                      "respawn into); --replica endpoints have no "
                      "process lifecycle to drive", file=sys.stderr)
                return 1
            from paddle_tpu_torch.serving.autoscale import FleetController
            controller = FleetController(
                router, fleet,
                min_replicas=args.min_replicas,
                max_replicas=args.max_replicas,
                max_restarts=args.heal_max_restarts,
                scale_up_queue=args.scale_up_queue,
                scale_down_idle_s=args.scale_down_idle_s,
                wedge_timeout_s=args.wedge_timeout_s)
            if args.controller_port is not None:
                ctrl_srv = controller.serve(host=args.health_host,
                                            port=args.controller_port)
                print(f"controller: {ctrl_srv.url}/healthz",
                      file=sys.stderr)

        health_srv = None
        if args.health_port is not None:
            health_srv = router.serve(host=args.health_host,
                                      port=args.health_port)
            print(f"observability: {health_srv.url}/metrics  "
                  f"{health_srv.url}/healthz  "
                  f"{health_srv.url}/requests  "
                  f"{health_srv.url}/alerts  (point `paddle_tpu_torch top "
                  f"--url={health_srv.url}` here)", file=sys.stderr)

        inbox: "_queue.Queue" = _queue.Queue()
        draining = threading.Event()

        def _read_stdin():
            for line in sys.stdin:
                inbox.put(line)
            inbox.put(None)

        threading.Thread(target=_read_stdin, daemon=True,
                         name="route-stdin").start()
        if threading.current_thread() is threading.main_thread():
            signal.signal(signal.SIGTERM, lambda *_: draining.set())

        def emit(req):
            print(json.dumps({
                "id": req.xid, "tokens": req.tokens,
                "finish_reason": req.finish_reason
                if req.error is None else "error",
                "error": req.error,
                "replica": req.replica, "requeues": req.requeues,
                "ttft_ms": round(1000 * req.ttft_s, 3)
                if req.ttft_s is not None else None,
                "latency_ms": round(1000 * req.latency_s, 3)
                if req.latency_s is not None else None}), flush=True)

        def ingest(line):
            from paddle_tpu_torch.serving.router import AdmissionError
            try:
                r = json.loads(line)
                router.submit(
                    np.asarray(r["prompt"], np.int32),
                    int(r.get("max_new", args.max_new)),
                    temperature=float(r.get("temperature", 0.0)),
                    top_k=int(r.get("top_k", 0)),
                    eos_id=r.get("eos_id"),
                    tenant=str(r.get("tenant", "default")),
                    tier=str(r.get("tier", "batch")))
            except AdmissionError as e:
                # a counted rejection, never a timeout: the client
                # learns the door's reason NOW and can back off
                print(json.dumps({
                    "error": f"shed: {e.reason}", "shed": e.reason,
                    "finish_reason": "shed"}), flush=True)
            except (ValueError, KeyError, TypeError) as e:
                print(json.dumps({"error": str(e)}), flush=True)

        eof = False
        sealed = False
        try:
            while True:
                if draining.is_set() and not sealed:
                    # seal (the serve-loop contract): lines already
                    # read were accepted — the drain finishes them;
                    # anything arriving after is refused below, so the
                    # drain converges under a streaming client
                    while True:
                        try:
                            item = inbox.get_nowait()
                        except _queue.Empty:
                            break
                        if item is None:
                            eof = True
                        elif item.strip():
                            ingest(item)
                    sealed = True
                if ((eof or sealed) and inbox.empty()
                        and router.idle):
                    break
                try:
                    line = inbox.get(
                        timeout=0.05 if router.idle else 0.0)
                    if line is None:
                        eof = True
                    elif not line.strip():
                        pass
                    elif sealed:
                        print(json.dumps({"error": "draining: router "
                                          "not admitting"}), flush=True)
                    else:
                        ingest(line)
                except _queue.Empty:
                    pass
                if not router.idle:
                    for d in router.step():
                        emit(d)
                elif controller is not None:
                    router.step()   # liveness + health even while
                    #                 idle: deaths must be SEEN for
                    #                 the heal loop to close
                if controller is not None and not sealed:
                    controller.step()
        finally:
            if ctrl_srv is not None:
                ctrl_srv.close()
            if health_srv is not None:
                health_srv.close()
            router.close()
    finally:
        if fleet is not None:
            fleet.close()
    return 0


def _render_top(health: dict, alerts: dict) -> str:
    """One frame of the `top` view: the fleet summary line, a
    per-replica table, and the firing-alert panel — pure function of
    the two endpoint documents so tests can pin the rendering."""
    def fmt(v, spec="", dash="-"):
        if v is None:
            return dash
        return format(v, spec) if spec else str(v)

    win = health.get("window") or {}
    lines = [
        "fleet: {q} queued  {r} requests  {c} completed  {rq} requeued"
        "  hit_rate {hr}  ttft_p99 {p99}s".format(
            q=health.get("queue_depth", 0),
            r=health.get("requests", 0),
            c=health.get("completed", 0),
            rq=health.get("requeued", 0),
            hr=fmt(health.get("placement_hit_rate"), ".2f"),
            p99=fmt(win.get("fleet_ttft_p99_s",
                            win.get("ttft_p99_s")), ".4f"))]
    if health.get("shed"):
        lines[0] += f"  shed {health['shed']}"
    ctl = health.get("controller")
    if ctl:
        lines.append(
            "controller: live {lv} [{mn}..{mx}]  heals {h}  "
            "wedge_kills {w}  scale {s}  spawn_tokens {t}".format(
                lv=ctl.get("live"), mn=ctl.get("min"),
                mx=ctl.get("max"), h=ctl.get("heals", 0),
                w=ctl.get("wedge_kills", 0),
                s=ctl.get("scale_events", 0),
                t=ctl.get("spawn_tokens")))
        if ctl.get("draining"):
            lines[-1] += "  draining " + ",".join(ctl["draining"])
        if ctl.get("abandoned"):
            lines[-1] += "  ABANDONED " + ",".join(ctl["abandoned"])
    hdr = (f"{'REPLICA':<12} {'ROLE':<8} {'STATE':<10} {'INFL':>4} "
           f"{'QUEUE':>5} {'BLOCKS':>11} {'TIERS':>9} {'TTFT_P99':>9} "
           f"{'BURN':>6}")
    lines.append(hdr)
    for name, rep in sorted((health.get("replicas") or {}).items()):
        used, total = rep.get("blocks_in_use"), rep.get("blocks_total")
        blocks = (f"{used}/{total}" if used is not None
                  and total is not None else "-")
        tiers = rep.get("tiers") or {}
        dram, disk = tiers.get("dram"), tiers.get("disk")
        tier_s = (f"{dram}/{disk}" if dram is not None
                  and disk is not None else "-")
        lines.append(
            f"{name:<12.12} {fmt(rep.get('role')):<8.8} "
            f"{fmt(rep.get('state')):<10.10} "
            f"{fmt(rep.get('in_flight')):>4} "
            f"{fmt(rep.get('queue_depth')):>5} {blocks:>11} "
            f"{tier_s:>9} "
            f"{fmt(rep.get('ttft_p99_s'), '.4f'):>9} "
            f"{fmt(rep.get('slo_burn'), '.2f'):>6}")
    firing = (alerts.get("firing") if alerts
              else health.get("alerts_firing")) or []
    if firing:
        lines.append("ALERTS FIRING:")
        for a in firing:
            lines.append(f"  !! {a.get('rule')}: value "
                         f"{fmt(a.get('value'), '.4f')} {a.get('op')} "
                         f"{a.get('threshold')}  {a.get('description')}")
    else:
        lines.append("alerts: none firing")
    return "\n".join(lines)


def _render_gang_top(health: dict, alerts: dict) -> str:
    """One frame of `top --supervisor`: the gang summary line, a
    per-rank table (state/step/recency/step-p50/barrier-p50), the
    straggler + goodput panel, and the firing alerts — pure function
    of the supervisor's /healthz + /alerts documents."""
    def fmt(v, spec="", dash="-"):
        if v is None:
            return dash
        return format(v, spec) if spec else str(v)

    gp = health.get("goodput") or {}
    lines = [
        "gang: state {st}  epoch {ep}  size {n}  restarts {r}  "
        "goodput {g}".format(
            st=health.get("state", "?"), ep=health.get("epoch", "?"),
            n=health.get("gang_size", "?"),
            r=health.get("restarts", 0),
            g=fmt(gp.get("goodput_fraction"), ".3f"))]
    hdr = (f"{'RANK':<6} {'STATE':<8} {'STEP':>8} {'SINCE':>7} "
           f"{'STEP_P50':>9} {'BARR_P50':>9} {'HB_AGE':>7}")
    lines.append(hdr)
    for rank, w in sorted((health.get("workers") or {}).items(),
                          key=lambda kv: int(kv[0])):
        state = "done" if w.get("done") else "ok"
        lines.append(
            f"{rank:<6.6} {state:<8.8} {fmt(w.get('step')):>8} "
            f"{fmt(w.get('since_step_s'), '.1f'):>7} "
            f"{fmt(w.get('step_p50_s'), '.4f'):>9} "
            f"{fmt(w.get('barrier_p50_s'), '.4f'):>9} "
            f"{fmt(w.get('age'), '.1f'):>7}")
    st = health.get("straggler") or {}
    skew = st.get("skew") or {}
    s_rank = st.get("straggler_rank")
    lines.append(
        "skew p50 {p50}s p99 {p99}s  straggler {who}".format(
            p50=fmt(skew.get("p50"), ".4f"),
            p99=fmt(skew.get("p99"), ".4f"),
            who=(f"rank {s_rank} ({st.get('rule')})"
                 if s_rank is not None else "none")))
    if gp.get("totals"):
        t = gp["totals"]
        overhead = ", ".join(
            f"{k} {v:.1f}s" for k, v in sorted(t.items())
            if k != "useful_step" and v)
        lines.append(f"goodput: useful {t.get('useful_step', 0):.1f}s "
                     f"of {gp.get('wall_accounted_s', 0)}s accounted"
                     + (f"  ({overhead})" if overhead else ""))
    firing = (alerts.get("firing") if alerts
              else health.get("alerts_firing")) or []
    if firing:
        lines.append("ALERTS FIRING:")
        for a in firing:
            lines.append(f"  !! {a.get('rule')}: value "
                         f"{fmt(a.get('value'), '.4f')} {a.get('op')} "
                         f"{a.get('threshold')}  {a.get('description')}")
    else:
        lines.append("alerts: none firing")
    return "\n".join(lines)


def job_top(args):
    """Live fleet status: a refresh loop over a running router's
    ``/healthz`` + ``/alerts`` endpoints (``route --health_port``) —
    per-replica state / in-flight / KV blocks / TTFT p99 / SLO burn,
    plus the firing-alert panel. With ``--supervisor`` (or pointed at
    a Supervisor endpoint — auto-detected from the health document's
    ``workers`` key) the frame is the TRAINING-gang view instead:
    per-rank step progress, step/barrier medians, straggler + goodput.
    ``--top_iterations`` bounds the loop (0 = until interrupted); on a
    TTY each frame repaints in place."""
    import json
    import time as _time
    import urllib.request

    if not args.url:
        print("top: pass --url http://HOST:HEALTH_PORT (a route "
              "--health_port endpoint)", file=sys.stderr)
        return 1
    base = args.url.rstrip("/")
    n = 0
    try:
        while True:
            try:
                with urllib.request.urlopen(base + "/healthz",
                                            timeout=2.0) as r:
                    health = json.loads(r.read().decode())
            except Exception as e:
                health, err = {}, e
                print(f"top: {base}/healthz unreachable: {e}",
                      file=sys.stderr)
            try:
                with urllib.request.urlopen(base + "/alerts",
                                            timeout=2.0) as r:
                    alerts = json.loads(r.read().decode())
            except Exception:
                alerts = {}    # router without an evaluator: panel off
            if health:
                if sys.stdout.isatty():
                    print("\x1b[2J\x1b[H", end="")
                gang = (getattr(args, "supervisor", False)
                        or "workers" in health)
                render = _render_gang_top if gang else _render_top
                print(render(health, alerts), flush=True)
            n += 1
            if args.top_iterations and n >= args.top_iterations:
                return 0 if health else 1
            _time.sleep(max(args.top_interval_s, 0.05))
    except KeyboardInterrupt:
        return 0


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="paddle_tpu_torch",
        description="the port's CLI (reference: paddle_trainer, "
                    "TrainerMain.cpp); serve, route and top run here")
    p.add_argument("job", choices=["train", "test", "time", "checkgrad",
                                   "infer", "stats", "serve", "route",
                                   "top"],
                   help="what to run (TrainerMain.cpp:52-61; serve "
                        "runs the continuous-batching LM engine over "
                        "stdio or --port TCP; route fronts N serve "
                        "replicas with the prefix-aware fleet router; "
                        "top is a live status view over a route "
                        "--health_port; the other jobs are not ported "
                        "yet and exit 2)")
    p.add_argument("--model", default=None,
                   help="lm_serving artifact for job=serve, and for "
                        "the replicas job=route spawns")
    p.add_argument("--max_new", type=int, default=64,
                   help="default max_new for job=serve/route requests "
                        "that omit it")
    p.add_argument("--port", type=int, default=None,
                   help="job=serve: serve the JSONL wire on this TCP "
                        "port instead of stdio (0 = ephemeral; the "
                        "fleet replica mode — bound ports announced "
                        "as a replica_ready line on stdout)")
    p.add_argument("--serve_host", default="127.0.0.1",
                   help="bind address for --port (default loopback)")
    p.add_argument("--replica", action="append", default=[],
                   metavar="HOST:PORT[:HEALTH_PORT]",
                   help="job=route: connect to a running serve --port "
                        "replica (repeatable)")
    p.add_argument("--replicas", type=int, default=2,
                   help="job=route with --model: spawn this many local "
                        "replica processes (runtime.master."
                        "ServingFleet)")
    p.add_argument("--prefill_replicas", type=int, default=0,
                   help="job=route: mark the first K replicas as the "
                        "disaggregated prefill tier (P/D mode; 0 = "
                        "colocated)")
    p.add_argument("--max_in_flight", type=int, default=8,
                   help="job=route: per-replica in-flight cap")
    p.add_argument("--fetch_flops_per_byte", type=float, default=8.0,
                   help="job=route: remote-fetch crossover — ship a "
                        "warm prefix's KV bytes when recomputing them "
                        "costs more than this many FLOPs per byte "
                        "shipped (0 = always fetch, huge = always "
                        "recompute)")
    p.add_argument("--health_port", type=int, default=None,
                   help="serve /metrics + /healthz on this port during "
                        "job=serve or job=route (0 = ephemeral)")
    p.add_argument("--health_host", default="127.0.0.1",
                   help="bind address for --health_port (use 0.0.0.0 "
                        "for out-of-pod probes; default loopback)")
    p.add_argument("--ttft_slo_ms", type=float, default=None,
                   help="job=serve: TTFT SLO in ms — /healthz reports "
                        "degraded when the rolling burn rate exceeds "
                        "the budget (observe.SloConfig)")
    p.add_argument("--slo_target", type=float, default=0.99,
                   help="fraction of requests that must meet the TTFT "
                        "SLO (job=serve; default 0.99)")
    p.add_argument("--slo_window_s", type=float, default=60.0,
                   help="rolling window for SLO evaluation, seconds "
                        "(job=serve)")
    p.add_argument("--url", default=None,
                   help="job=top: the router's observability base URL "
                        "(http://HOST:HEALTH_PORT from route "
                        "--health_port)")
    p.add_argument("--top_interval_s", type=float, default=2.0,
                   help="job=top: refresh interval, seconds")
    p.add_argument("--top_iterations", type=int, default=0,
                   help="job=top: stop after N frames (0 = until "
                        "interrupted; tests use 1)")
    p.add_argument("--supervisor", action="store_true",
                   help="job=top: render the TRAINING-gang view "
                        "(per-rank state/step/step-time/barrier-wait/"
                        "skew + goodput) — point --url at a Supervisor "
                        "http_port endpoint; auto-detected from the "
                        "health document when omitted")
    p.add_argument("--tenant-budget", "--tenant_budget",
                   action="append", default=[], dest="tenant_budget",
                   metavar="TENANT=TOKENS",
                   help="job=serve: cap TENANT's reserved tokens in "
                        "flight (prompt+max_new of live requests); "
                        "repeatable. Exhaustion queues the tenant's "
                        "requests — it never rejects. Paged-engine "
                        "artifacts only.")
    p.add_argument("--tiers_dram_mb", type=float, default=0.0,
                   help="job=serve: host-DRAM spill tier budget in MB "
                        "(0 disables tiered spill). LRU-evicted prefix "
                        "blocks demote here instead of vanishing; "
                        "admissions that miss HBM re-adopt bitwise.")
    p.add_argument("--tiers_disk_mb", type=float, default=0.0,
                   help="job=serve: disk spill tier budget in MB below "
                        "the DRAM tier (needs --tiers_dir; checksummed "
                        "files, atomic publish, corrupt files served "
                        "as misses)")
    p.add_argument("--tiers_dir", default=None,
                   help="job=serve: directory for the disk spill tier "
                        "(re-adopted across restarts)")
    p.add_argument("--shed_queue_max", type=int, default=0,
                   help="job=route: shed batch-tier admits once the "
                        "router queue holds this many requests "
                        "(latency tier rides 2x the headroom; 0 "
                        "disables — the queue grows unbounded)")
    p.add_argument("--shed_burn_max", type=float, default=0.0,
                   help="job=route: shed batch-tier admits while the "
                        "SLO burn rate exceeds this (needs "
                        "--ttft_slo_ms; 0 disables)")
    p.add_argument("--autoscale", action="store_true",
                   help="job=route: run the fleet controller — heal "
                        "dead replicas under their own name (re-warm "
                        "from survivors), scale up on sustained queue "
                        "pressure, drain down when idle. Needs "
                        "--model + --replicas (a local fleet).")
    p.add_argument("--min_replicas", type=int, default=1,
                   help="job=route --autoscale: scale-down floor")
    p.add_argument("--max_replicas", type=int, default=8,
                   help="job=route --autoscale: scale-up ceiling")
    p.add_argument("--scale_up_queue", type=int, default=8,
                   help="job=route --autoscale: queue depth that, "
                        "sustained past the hysteresis window, spawns "
                        "a replica (0 disables scale-up)")
    p.add_argument("--scale_down_idle_s", type=float, default=30.0,
                   help="job=route --autoscale: drain the newest "
                        "replica after this long fully idle (down to "
                        "--min_replicas)")
    p.add_argument("--wedge_timeout_s", type=float, default=0.0,
                   help="job=route: kill a replica that holds work "
                        "but produces no result/ack/error for this "
                        "long — healing then respawns it (0 disables; "
                        "implies the controller)")
    p.add_argument("--heal_max_restarts", type=int, default=3,
                   help="job=route --autoscale: restart budget per "
                        "replica name before its slot is abandoned "
                        "(a long-stable incarnation refills it)")
    p.add_argument("--controller_port", type=int, default=None,
                   help="job=route --autoscale: serve the "
                        "controller's own /healthz (+ shared "
                        "/metrics) on this port")
    p.add_argument("--device", default=None,
                   help="job=serve (and the replicas job=route spawns): "
                        "the device the engine runs on (default: the "
                        "card; 'cpu' runs the plain PyTorch path)")
    # an unported job's own flags are not registered: refuse the job
    # by name before any of them could fail the parse
    args, rest = p.parse_known_args(argv)
    if args.job in UNPORTED:
        print(f"{p.prog}: job={args.job} is not ported yet "
              f"({UNPORTED[args.job]})", file=sys.stderr)
        return 2
    if rest:
        p.error(f"unrecognized arguments: {' '.join(rest)}")
    if args.job == "serve":
        if not args.model:
            p.error("--model=lm.tar is required for job=serve")
        return job_serve(args)
    if args.job == "route":
        return job_route(args)
    return job_top(args)


if __name__ == "__main__":
    sys.exit(main())
