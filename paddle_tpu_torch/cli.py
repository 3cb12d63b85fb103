"""The ``paddle_tpu_torch`` command line (counterpart of
``paddle_tpu/cli.py``): the trainer jobs ``train``, ``test``, ``time``,
``infer`` and ``checkgrad`` over a config file, the observability
snapshot ``stats``, and the serving jobs ``serve``, ``route`` and
``top``, with the reference's flags, names and defaults.

Trainer jobs (reference: paddle/trainer/TrainerMain.cpp:32-64) read a
Python config file that builds its layers with ``paddle_tpu_torch`` and
exposes a few names:
  cost            — required for train/checkgrad/time: the cost LayerOutput
  reader          — callable() -> iterator of data tuples (train/time)
  test_reader     — optional, for --job=test and per-pass testing
  optimizer       — optional port optimizer (default Momentum)
  batch_size      — optional int (default 64)
  feeding         — optional dict name->index
  evaluators      — optional list of evaluator layers
  outputs         — required for job=infer: list of output LayerOutputs

- ``serve`` — one continuous-batching engine over a v3-v5
  ``lm_serving`` artifact: JSONL requests on stdin, or the fleet
  replica mode with ``--port`` (the ready line is then its only
  stdout);
- ``route`` — the prefix-aware fleet router over ``--replica``
  endpoints, or over a fleet of ``serve --port`` processes it spawns
  (``--model`` + ``--replicas``), with the fleet controller under
  ``--autoscale``;
- ``top`` — a refresh loop over a router's ``/healthz`` + ``/alerts``;
- ``stats`` — summarize and tail a JSONL step log (``--metrics_file``,
  ``--last``), export this process's span buffer as Chrome-trace JSON
  (``--trace``) or merge per-rank exports into one (``--merge`` with
  ``--trace``), list the slowest requests of the request log
  (``--requests``), else render the metrics registry (``--format``
  ``pretty`` or ``prom``).

``--device`` (the port's own flag) picks the device every job runs on:
the card unless it says otherwise, where the JAX CLI reads
``JAX_PLATFORMS``.

Run: ``python -m paddle_tpu_torch train --config=conf.py --num_passes=2``,
``python -m paddle_tpu_torch serve --model=lm.tar --device=cpu``,
``python -m paddle_tpu_torch stats --metrics_file=train.jsonl --last=3``.
"""

import argparse
import os
import runpy
import sys
import time as _time

import numpy as np

# jobs of the reference CLI the port does not run yet, and where they
# stand in ROADMAP.md
UNPORTED = {}


def _load_config(path):
    return runpy.run_path(path)


def _build_trainer(cfg, args):
    import paddle_tpu_torch as paddle
    cost = cfg["cost"]
    params = paddle.parameters.create(cost, device=args.device)
    if args.init_model_path:
        with open(args.init_model_path, "rb") as f:
            params.from_tar_into(f)
    opt = cfg.get("optimizer") or paddle.optimizer.Momentum(
        momentum=0.9, learning_rate=0.01)
    trainer = paddle.trainer.SGD(
        cost=cost, parameters=params, update_equation=opt,
        extra_layers=cfg.get("evaluators"))
    return trainer, params


def job_train(cfg, args):
    import paddle_tpu_torch as paddle
    trainer, params = _build_trainer(cfg, args)
    health_srv = None
    if args.health_port is not None:
        health_srv = trainer.attach_observability(
            host=args.health_host, port=args.health_port)
        print(f"observability: {health_srv.url}/metrics  "
              f"{health_srv.url}/healthz")
    batch_size = cfg.get("batch_size", 64)
    reader = paddle.batch(cfg["reader"], batch_size)
    test_reader = cfg.get("test_reader")
    save_dir = args.save_dir

    def handler(ev):
        if isinstance(ev, paddle.event.EndIteration):
            if ev.batch_id % args.log_period == 0:
                print(f"pass {ev.pass_id} batch {ev.batch_id} "
                      f"cost {ev.cost:.5f} {ev.metrics}")
        if isinstance(ev, paddle.event.EndPass):
            if test_reader is not None:
                res = trainer.test(paddle.batch(test_reader, batch_size),
                                   feeding=cfg.get("feeding"))
                print(f"pass {ev.pass_id} test: cost {res.cost:.5f} "
                      f"{res.metrics}")
            if save_dir:
                # per-pass dirs like the reference's save_dir/pass-%05d
                # (trainer/ParamUtil.cpp)
                pdir = os.path.join(save_dir, f"pass-{ev.pass_id:05d}")
                os.makedirs(pdir, exist_ok=True)
                with open(os.path.join(pdir, "params.tar"), "wb") as f:
                    trainer.save_parameter_to_tar(f)

    try:
        trainer.train(reader, num_passes=args.num_passes,
                      event_handler=handler, feeding=cfg.get("feeding"))
    finally:
        if health_srv is not None:
            health_srv.close()
    return 0


def job_test(cfg, args):
    import paddle_tpu_torch as paddle
    trainer, params = _build_trainer(cfg, args)
    reader = paddle.batch(cfg.get("test_reader") or cfg["reader"],
                          cfg.get("batch_size", 64))
    res = trainer.test(reader, feeding=cfg.get("feeding"))
    print(f"test: cost {res.cost:.5f} {res.metrics}")
    return 0


def measure_time(cfg, batch_size=None, time_batches=20, warmup_batches=3,
                 init_model_path=None, device=None):
    """Steady-state train-step timing — the measurement core of job=time
    (reference protocol: `paddle train --job=time`,
    benchmark/paddle/image/run.sh:9-17), on ``device`` (default: the
    card).

    Two batches from the config's reader are fed to the device first and
    cycled over the run, so host→device copies stay out of the timed
    window; the steps run back to back and one ``utils/sync.host_sync``
    ends the window (steps are serial on the device). The step's FLOPs
    are counted once (``SGD.count_step_flops``) before the window.
    Returns ms/batch, examples/s, the counted FLOPs per batch and MFU
    against the device's declared peak (None on the CPU), and the peak
    device memory of the timed window (None on the CPU)."""
    import torch

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import observe
    from paddle_tpu_torch.ops import prng
    from paddle_tpu_torch.utils.sync import host_sync

    class _Args:
        pass

    a = _Args()
    a.init_model_path = init_model_path
    a.device = device
    trainer, params = _build_trainer(cfg, a)
    batch_size = batch_size or cfg.get("batch_size", 64)
    reader = paddle.batch(cfg["reader"], batch_size)
    batches = []
    for i, b in enumerate(reader()):
        if i >= 2:
            break
        batches.append(b)
    if not batches:
        raise ValueError("job=time: reader yielded no batches")
    feeder = trainer._feeder(cfg.get("feeding"))
    step = trainer._train_step
    key = prng.prng_key(0)
    dev = trainer.device
    t_start = _time.perf_counter()
    feeds_list = [feeder.feed(b) for b in batches]
    flops = trainer.count_step_flops(feeds_list[0], key)
    nb = len(feeds_list)
    cost = None
    with observe.trace_scope("time_job/warmup"):
        for i in range(warmup_batches):
            cost, _ = step(feeds_list[i % nb], i, key)
        if cost is not None:
            host_sync(params.values, cost)
    warmup_s = _time.perf_counter() - t_start
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = _time.perf_counter()
    with observe.trace_scope("time_job/timed"):
        for i in range(time_batches):
            cost, _ = step(feeds_list[i % nb], warmup_batches + i, key)
        if cost is not None:
            host_sync(params.values, cost)   # one sync for the run
    elapsed = _time.perf_counter() - t0
    ms = 1000 * elapsed / time_batches if time_batches else float("nan")
    peak = observe.costs.device_peak_flops(dev)
    return {
        "ms_per_batch": ms,
        "examples_per_sec": batch_size / (ms / 1000) if time_batches else
        float("nan"),
        "batch_size": batch_size,
        "timed_batches": time_batches,
        "compile_plus_warmup_s": warmup_s,
        "flops_per_batch": flops,
        "mfu": (observe.costs.mfu(flops, ms / 1000, peak)
                if time_batches else None),
        "peak_memory_bytes": (int(torch.cuda.max_memory_allocated(dev))
                              if dev.type == "cuda" else None),
        "last_cost": float(cost) if cost is not None else None,
    }


def job_time(cfg, args):
    """Steady-state ms/batch (reference: --job=time,
    benchmark/paddle/image/run.sh:9)."""
    r = measure_time(cfg, time_batches=args.time_batches,
                     warmup_batches=args.warmup_batches,
                     init_model_path=args.init_model_path,
                     device=args.device)
    from paddle_tpu_torch import observe
    if observe.has_consumers():
        # --metrics_out promises a JSONL trail for the time job too
        observe.report(dict(r), kind="time_job")
    mfu = f"{r['mfu']:.4f}" if r["mfu"] is not None else "n/a"
    print(f"time job: {r['ms_per_batch']:.2f} ms/batch, "
          f"{r['examples_per_sec']:.1f} examples/sec, MFU {mfu} "
          f"(batch_size={r['batch_size']}, "
          f"{r['timed_batches']} timed batches)")
    return 0


def job_infer(cfg, args):
    """Forward-only inference (reference: paddle.v2.infer, inference.py:111;
    capi serving when --model points at a merged artifact).

    Two sources for the model:
    - --model=artifact.tar  (merged-model file; config only supplies data)
    - config ``outputs`` + --init_model_path weights
    Input comes from config ``infer_reader`` (or ``test_reader``/``reader``),
    yielding the same tuples as training minus the label when ``feeding``
    maps only input fields. Results print as shapes + optionally save to
    --output_path (.npz keyed by output layer name).
    """
    import paddle_tpu_torch as paddle

    batch_size = cfg.get("batch_size", 64)
    reader = cfg.get("infer_reader") or cfg.get("test_reader") \
        or cfg.get("reader")
    if reader is None:
        print("config must define infer_reader/test_reader/reader",
              file=sys.stderr)
        return 1
    rows = []
    for sample in reader():
        rows.append(sample)
        if args.infer_limit and len(rows) >= args.infer_limit:
            break

    if args.model:
        from paddle_tpu_torch.data_feeder import DataFeeder
        from paddle_tpu_torch.data_type import InputType, Kind, SeqLevel
        from paddle_tpu_torch.io import merged
        m = merged.load_inference_model(args.model, device=args.device)
        specs = {name: InputType(d, Kind(k), SeqLevel(s))
                 for name, (d, k, s) in m.meta["data_specs"].items()}
        feeder = DataFeeder(specs, cfg.get("feeding"), device="cpu")
        chunks = []
        for i in range(0, len(rows), batch_size):
            feeds = feeder.feed(rows[i:i + batch_size])
            flat = {}
            for k, v in feeds.items():
                flat[k] = v.array.numpy()
                if v.lengths is not None:
                    flat[f"{k}.lengths"] = v.lengths.numpy()
            chunks.append(m.infer(flat))
        outs = {k: np.concatenate([c[k] for c in chunks], axis=0)
                for k in chunks[0]}
    else:
        outputs = cfg.get("outputs")
        if outputs is None:
            print("config must define `outputs` for job=infer "
                  "(or pass --model)", file=sys.stderr)
            return 1
        if not args.init_model_path:
            print("job=infer needs trained weights: pass "
                  "--init_model_path=params.tar (or --model=artifact.tar)",
                  file=sys.stderr)
            return 1
        outputs = list(outputs) if isinstance(outputs, (list, tuple)) \
            else [outputs]
        params = paddle.parameters.create(outputs, device=args.device)
        with open(args.init_model_path, "rb") as f:
            params.from_tar_into(f)
        res = paddle.infer(output_layer=outputs, parameters=params,
                           input=rows, feeding=cfg.get("feeding"),
                           batch_size=batch_size)
        outs = dict(zip([o.name for o in outputs],
                        res if isinstance(res, list) else [res]))

    for name, arr in outs.items():
        print(f"infer output {name}: shape {np.asarray(arr).shape}")
    if args.output_path:
        np.savez(args.output_path,
                 **{k: np.asarray(v) for k, v in outs.items()})
        print(f"saved outputs to {args.output_path}")
    return 0


def job_checkgrad(cfg, args):
    """Whole-model finite-difference gradient verification (reference:
    Trainer::checkGradient, trainer/Trainer.cpp:299-377): a few sampled
    coordinates of every parameter, the autograd gradient of the mean
    cost against central differences of the cost (fp32 forwards)."""
    import torch

    import paddle_tpu_torch as paddle

    cost = cfg["cost"]
    params = paddle.parameters.create(cost, device=args.device)
    batch = next(iter(paddle.batch(cfg["reader"],
                                   cfg.get("batch_size", 8))()))
    trainer = paddle.trainer.SGD(
        cost=cost, parameters=params,
        update_equation=paddle.optimizer.Momentum(learning_rate=0.0))
    fwd = trainer._forward
    feeds = trainer._feeder(cfg.get("feeding"))(batch)

    def loss(vals):
        outs, _ = fwd(vals, params.state, feeds)
        return outs[cost.name].array.float().mean()

    leaves = {k: v.detach().requires_grad_()
              for k, v in params.values.items()}
    analytic = dict(zip(leaves, torch.autograd.grad(
        loss(leaves), list(leaves.values()), allow_unused=True)))
    eps = args.checkgrad_eps
    rng = np.random.RandomState(0)
    worst = 0.0
    for name, t in params.values.items():
        arr = t.detach().cpu().numpy().astype(np.float64)
        flat = arr.reshape(-1)
        g = (np.zeros(flat.size) if analytic[name] is None else
             analytic[name].detach().cpu().numpy().astype(
                 np.float64).reshape(-1))
        # sample a few coordinates per parameter (reference samples too)
        for idx in rng.choice(flat.size, size=min(4, flat.size),
                              replace=False):
            orig = flat[idx]
            vals = dict(params.values)
            pert = arr.copy().reshape(-1)
            with torch.no_grad():
                pert[idx] = orig + eps
                vals[name] = torch.from_numpy(pert.reshape(arr.shape).astype(
                    np.float32)).to(t.device)
                hi = float(loss(vals))
                pert[idx] = orig - eps
                vals[name] = torch.from_numpy(pert.reshape(arr.shape).astype(
                    np.float32)).to(t.device)
                lo = float(loss(vals))
            numeric = (hi - lo) / (2 * eps)
            denom = max(abs(numeric), abs(g[idx]), 1e-6)
            rel = abs(numeric - g[idx]) / denom
            worst = max(worst, rel)
            status = "OK" if rel < args.checkgrad_tol else "FAIL"
            print(f"checkgrad {name}[{idx}]: analytic {g[idx]:+.6f} "
                  f"numeric {numeric:+.6f} rel_err {rel:.2e} {status}")
    print(f"checkgrad worst rel err: {worst:.2e}")
    return 0 if worst < args.checkgrad_tol else 1


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


def _pct(sorted_vals, q):
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1) + 0.5))
    return sorted_vals[i]


def job_stats(args):
    """Observability snapshot: with --metrics_file, summarize + tail a
    JSONL per-step metrics log written by the trainer/bench
    (`observe.JsonlSink`); with --trace, export the in-process span
    buffer as Chrome-trace JSON; otherwise render the current process's
    default metrics registry (--format=prom gives the Prometheus text
    exposition)."""
    from paddle_tpu_torch import observe

    if args.requests:
        log = observe.default_request_log()
        slow = log.slowest(args.requests, by="ttft_s")
        summary = log.summary()
        print(f"request log: {summary['count']} records "
              f"(capacity {summary['capacity']}, "
              f"{summary['evicted']} evicted) — by dominant component: "
              + (", ".join(f"{k}={v}" for k, v in sorted(
                  summary["by_dominant_component"].items())) or "none"))
        for r in slow:
            a = r["attribution"]
            comps = " ".join(
                f"{c[:-2]} {1000 * a['components'][c]:.1f}ms"
                for c in observe.requests.COMPONENTS)
            ttft_ms = 1000 * (r.get('ttft_s') or 0)
            print(f"  r{r.get('rid')} ttft {ttft_ms:.1f}ms "
                  f"latency {1000 * (r.get('latency_s') or 0):.1f}ms "
                  f"tokens {r.get('tokens')} "
                  f"cache_hit {r.get('cache_hit_frac', 0):.0%} "
                  f"[{comps}] -> dominated by {a['dominant']} "
                  f"({r.get('finish_reason')})")
        if not slow:
            print("  (no completed requests recorded in this process)")
        if not args.trace and not args.metrics_file:
            return 0

    if args.merge:
        import json as _json
        if not args.trace:
            print("stats: --merge needs --trace OUT.json for the "
                  "merged timeline", file=sys.stderr)
            return 1
        docs = []
        for path in args.merge:
            try:
                with open(path) as f:
                    docs.append(_json.load(f))
            except (OSError, ValueError) as e:
                print(f"stats: cannot read trace {path}: {e}",
                      file=sys.stderr)
                return 1
        merged = observe.merge_traces(docs, path=args.trace)
        offs = merged["otherData"]["offsets_s"]
        print(f"merged {len(docs)} traces "
              f"({len(merged['traceEvents'])} events) into {args.trace}"
              f" — clock offsets vs first: "
              + ", ".join(f"{k}={v:+.6f}s" for k, v in offs.items()))
        return 0

    if args.trace:
        trace = observe.trace_export(args.trace)
        n = sum(1 for e in trace["traceEvents"] if e.get("ph") == "X")
        names = {e["name"] for e in trace["traceEvents"]
                 if e.get("ph") == "X"}
        print(f"wrote {n} spans ({len(names)} distinct) to {args.trace} "
              f"— open in chrome://tracing or https://ui.perfetto.dev")
        if not args.metrics_file and args.format == "pretty":
            return 0

    if args.metrics_file:
        try:
            recs = observe.read_jsonl(args.metrics_file)
        except OSError as e:
            print(f"stats: cannot read {args.metrics_file}: {e}",
                  file=sys.stderr)
            return 1
        if not recs:
            print(f"stats: no records in {args.metrics_file}")
            return 1
        steps = [r for r in recs if r.get("kind") == "step"]
        passes = [r for r in recs if r.get("kind") == "pass"]
        other = len(recs) - len(steps) - len(passes)
        print(f"{args.metrics_file}: {len(recs)} records "
              f"({len(steps)} steps, {len(passes)} passes"
              + (f", {other} other" if other else "") + ")")
        if steps:
            walls = sorted(float(r["wall_time_s"]) for r in steps
                           if isinstance(r.get("wall_time_s"), (int, float)))
            eps = [float(r["examples_per_sec"]) for r in steps
                   if isinstance(r.get("examples_per_sec"), (int, float))]
            losses = [float(r["loss"]) for r in steps
                      if isinstance(r.get("loss"), (int, float))]
            recompiles = sum(1 for r in steps if r.get("recompile"))
            print(f"  step wall ms: p50 {_pct(walls, .5)*1e3:.2f}  "
                  f"p90 {_pct(walls, .9)*1e3:.2f}  "
                  f"max {walls[-1]*1e3:.2f}" if walls else "")
            if eps:
                print(f"  examples/sec: last {eps[-1]:.1f}  "
                      f"mean {sum(eps)/len(eps):.1f}")
            if losses:
                print(f"  loss: first {losses[0]:.5f}  last {losses[-1]:.5f}")
            print(f"  recompiles tagged: {recompiles}")
        for r in passes:
            print(f"  pass {r.get('pass_id')}: {r.get('examples')} examples "
                  f"in {r.get('wall_time_s')}s "
                  f"({r.get('examples_per_sec')} ex/s) "
                  f"metrics {r.get('metrics', {})}")
        if args.last:
            print(f"--- last {args.last} records ---")
            import json as _json
            for r in recs[-args.last:]:
                print(_json.dumps(r))
        return 0

    reg = observe.default_registry()
    if args.format == "prom":
        print(reg.render_prometheus(), end="")
        return 0
    snap = reg.snapshot()
    if not snap:
        print("stats: default registry is empty (pass --metrics_file=... "
              "to inspect a JSONL metrics log)")
        return 0
    for name, m in snap.items():
        print(f"{name} ({m['kind']})" + (f" — {m['help']}" if m['help']
                                         else ""))
        for s in m["series"]:
            lbl = ",".join(f"{k}={v}" for k, v in s["labels"].items())
            lbl = f"{{{lbl}}}" if lbl else ""
            if m["kind"] == "histogram":
                print(f"  {lbl} count {s['count']} avg {s['avg']:.6f} "
                      f"min {s['min']:.6f} max {s['max']:.6f}")
            else:
                print(f"  {lbl} {s['value']}")
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="paddle_tpu_torch",
        description="the port's CLI (reference: paddle_trainer, "
                    "TrainerMain.cpp)")
    p.add_argument("job", choices=["train", "test", "time", "checkgrad",
                                   "infer", "stats", "serve", "route",
                                   "top"],
                   help="what to run (TrainerMain.cpp:52-61; serve "
                        "runs the continuous-batching LM engine over "
                        "stdio or --port TCP; route fronts N serve "
                        "replicas with the prefix-aware fleet router; "
                        "top is a live status view over a route "
                        "--health_port; stats renders an observability "
                        "snapshot)")
    p.add_argument("--config", default=None,
                   help="python config file (required for train, test, "
                        "time, infer and checkgrad)")
    p.add_argument("--metrics_file", default=None,
                   help="JSONL metrics log to summarize (job=stats)")
    p.add_argument("--last", type=int, default=0,
                   help="also dump the trailing N raw records (job=stats)")
    p.add_argument("--format", choices=["pretty", "prom"], default="pretty",
                   help="registry render format (job=stats)")
    p.add_argument("--requests", type=int, default=0,
                   help="job=stats: print the N slowest requests of "
                        "this process's request log with attributed "
                        "latency components (0 = off)")
    p.add_argument("--merge", nargs="+", default=None,
                   metavar="TRACE.json",
                   help="job=stats: merge N per-rank Chrome-trace "
                        "exports into ONE aligned gang timeline at "
                        "--trace (clock offsets solved from the "
                        "barrier alignment stamps in each file)")
    p.add_argument("--num_passes", type=int, default=1)
    p.add_argument("--save_dir", default=None)
    p.add_argument("--init_model_path", default=None)
    p.add_argument("--model", default=None,
                   help="merged-model artifact for job=infer; "
                        "lm_serving artifact for job=serve, and for "
                        "the replicas job=route spawns")
    p.add_argument("--output_path", default=None,
                   help="where job=infer saves outputs (.npz)")
    p.add_argument("--infer_limit", type=int, default=0,
                   help="max samples for job=infer (0 = all)")
    p.add_argument("--log_period", type=int, default=10)
    p.add_argument("--time_batches", type=int, default=20)
    p.add_argument("--warmup_batches", type=int, default=3)
    p.add_argument("--checkgrad_eps", type=float, default=1e-3)
    p.add_argument("--checkgrad_tol", type=float, default=2e-2)
    p.add_argument("--metrics_out", default=None,
                   help="write per-step JSONL metrics here (train/time "
                        "jobs; same as PADDLE_TPU_METRICS_PATH)")
    p.add_argument("--trace", default=None,
                   help="export the run's trace-scope spans as Chrome-"
                        "trace JSON to this path when a trainer job "
                        "finishes (job=stats: export the buffer "
                        "immediately)")
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
                        "job=train, job=serve or job=route (0 = "
                        "ephemeral)")
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
                   help="the device the trainer jobs, job=serve's engine "
                        "and the replicas job=route spawns run on "
                        "(default: the card; 'cpu' runs the plain "
                        "PyTorch path)")
    # an unported job's own flags are not registered: refuse the job
    # by name before any of them could fail the parse
    args, rest = p.parse_known_args(argv)
    if args.job in UNPORTED:
        print(f"{p.prog}: job={args.job} is not ported yet "
              f"({UNPORTED[args.job]})", file=sys.stderr)
        return 2
    if rest:
        p.error(f"unrecognized arguments: {' '.join(rest)}")
    if args.job == "stats":
        return job_stats(args)
    if args.job == "serve":
        if not args.model:
            p.error("--model=lm.tar is required for job=serve")
        return job_serve(args)
    if args.job == "route":
        return job_route(args)
    if args.job == "top":
        return job_top(args)
    jobs = {"train": job_train, "test": job_test, "time": job_time,
            "checkgrad": job_checkgrad, "infer": job_infer}
    if not args.config:
        p.error(f"--config is required for job={args.job}")
    if args.metrics_out:
        from paddle_tpu_torch import observe
        observe.configure(args.metrics_out)
    cfg = _load_config(args.config)
    try:
        rc = jobs[args.job](cfg, args)
    finally:
        # export even when the job crashes — a timeline of the steps
        # leading up to the failure is the trace most worth having
        if args.trace:
            from paddle_tpu_torch import observe
            observe.trace_export(args.trace)
            print(f"trace written to {args.trace}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
