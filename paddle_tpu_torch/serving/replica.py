"""Serving replica: the JSONL engine loop behind one fleet endpoint — the
port's own copy of ``paddle_tpu/serving/replica.py``.

One replica = one decode engine + one :class:`EngineLoop` pumping the
fleet's JSONL op wire through it. The wire is the serve request/result
format, with two fleet ops:

- ``{"prompt": [...], "max_new": n, ...}`` (op ``generate``, the
  default) → one result line ``{"id", "tokens", "finish_reason",
  "ttft_ms", "latency_ms"}`` when the request completes (NOT in
  submission order — continuous batching);
- ``{"op": "export_prefix", "prompt": [...]}`` → the prompt's
  transferable KV prefix serialized out of the pool (base64 of the
  PTKV wire, ``serving/transfer.py``; the prefill half of P/D
  disaggregation). A cold prompt rides the ordinary scheduler first —
  its chunks interleave with in-flight decode like any admission — and
  the payload serializes when the warm-up request finishes;
- ``{"op": "import_prefix", "payload": b64}`` → adopt transferred
  blocks via the prefix-cache publish path (the decode half); acked
  with ``{"imported": n}``. Ops on one connection are processed in
  arrival order, so an ``import_prefix`` line followed by a
  ``generate`` line is guaranteed to admit AFTER the blocks landed.

Transports around the loop:

- :func:`serve_stdio` — the stdio loop with graceful drain: SIGTERM
  stops ingesting, every in-flight (and already-read) request finishes
  and emits its result, and the loop returns 0 — the contract the
  fleet router's replica drain relies on;
- :class:`ReplicaServer` — the same loop behind a TCP socket, one
  reader thread per connection, results written back to the submitting
  connection; the engine is stepped on the thread that calls
  ``serve_forever`` (its CUDA graphs are captured and replayed there);
- :class:`EngineReplica` / :class:`SocketReplica` — the Router-facing
  replica HANDLES (``submit / poll / health / alive / pump``): one
  wraps an engine in this process, the other speaks TCP + HTTP
  ``/healthz`` to a replica process. A dead socket flips ``alive()``
  False — the router's signal to requeue that replica's in-flight work
  elsewhere.
"""


import base64
import json
import queue
import signal
import socket
import sys
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np


class _StreamReply:
    """Reply sink over a text stream (stdout): one JSON line per doc."""

    def __init__(self, stream):
        self._stream = stream
        self._lock = threading.Lock()

    def write(self, doc: dict):
        with self._lock:
            print(json.dumps(doc), file=self._stream, flush=True)


class _SocketReply:
    """Reply sink over one TCP connection. A peer that hung up makes
    results undeliverable — swallowed, never a loop crash (the fleet
    router treats the REPLICA dying as the failure mode, not vice
    versa)."""

    def __init__(self, conn: socket.socket):
        self._conn = conn
        self._lock = threading.Lock()

    def write(self, doc: dict):
        data = (json.dumps(doc) + "\n").encode("utf-8")
        with self._lock:
            try:
                self._conn.sendall(data)
            except OSError:
                pass


class ListReply:
    """Collects reply docs in memory — the in-process handle's sink."""

    def __init__(self):
        self.docs: List[dict] = []

    def write(self, doc: dict):
        self.docs.append(doc)


class EngineLoop:
    """Transport-agnostic JSONL op loop around one decode engine.

    Lines (str or pre-parsed dict) arrive via :meth:`feed` from any
    thread, each with the reply sink its results go back to; the loop
    itself runs single-threaded (:meth:`run` on the owner's thread, or
    :meth:`step_once` pumped externally), so the engine never sees
    concurrent calls. Ops are processed in arrival order. Exit
    conditions: EOF (:meth:`feed_eof`) or DRAIN (:meth:`drain`) — both
    finish everything in flight and already queued first, emitting
    every result, which is what makes SIGTERM lossless."""

    def __init__(self, eng, *, default_max_new: int = 64):
        self.eng = eng
        self._inbox: "queue.Queue" = queue.Queue()
        self.draining = threading.Event()
        self._sealed = threading.Event()
        self._eof = False
        self._default_max_new = int(default_max_new)
        self._live: Dict[int, Tuple[object, object]] = {}
        self._exports: Dict[
            int, Tuple[object, object, np.ndarray, object]] = {}

    # -- ingestion (any thread) -------------------------------------------
    def feed(self, line, reply):
        if self._sealed.is_set():
            # draining: lines accepted BEFORE the seal finish and emit;
            # anything arriving after is refused with an error doc (id
            # echoed so a router can requeue it elsewhere) — otherwise
            # a continuously-streaming client would reset ``eng.idle``
            # forever and the drain could never converge
            doc = {"error": "draining: replica not admitting"}
            if isinstance(line, dict):
                if "id" in line:
                    doc["id"] = line["id"]
            else:
                try:
                    doc["id"] = json.loads(line)["id"]
                except (ValueError, KeyError, TypeError):
                    pass
            reply.write(doc)
            return
        self._inbox.put((line, reply))

    def feed_eof(self):
        self._inbox.put(None)

    def drain(self):
        """Graceful-drain trigger (signal-safe: just sets an Event)."""
        self.draining.set()

    @property
    def idle(self) -> bool:
        return self.eng.idle and self._inbox.empty()

    def _stamp(self, doc: dict) -> dict:
        # Every result/ack doc carries the spill tiers' eviction epoch
        # so a router comparing it against the epoch it saw at the last
        # /healthz scrape learns about full-retirement evictions NOW,
        # between health cadences, instead of fetching a stale digest.
        tiers = getattr(self.eng, "tiers", None)
        if tiers is not None:
            doc["tier_epoch"] = int(tiers.eviction_epoch)
        return doc

    # -- op dispatch (loop thread only) -----------------------------------
    def _ingest(self, item):
        if item is None:
            self._eof = True
            return
        line, reply = item
        if isinstance(line, str):
            if not line.strip():
                return
            try:
                r = json.loads(line)
            except json.JSONDecodeError as e:
                reply.write({"error": f"bad json: {e}"})
                return
        else:
            r = dict(line)
        op = r.get("op", "generate")
        try:
            if op == "generate":
                self._op_generate(r, reply)
            elif op == "export_prefix":
                self._op_export(r, reply)
            elif op == "import_prefix":
                self._op_import(r, reply)
            else:
                raise ValueError(f"unknown op {op!r}")
        except (ValueError, KeyError, TypeError) as e:
            err = {"error": str(e)}
            if "id" in r:
                err["id"] = r["id"]
            reply.write(err)

    def _op_generate(self, r: dict, reply):
        req = self.eng.submit(
            np.asarray(r["prompt"], np.int32),
            int(r.get("max_new", self._default_max_new)),
            temperature=float(r.get("temperature", 0.0)),
            top_k=int(r.get("top_k", 0)),
            eos_id=r.get("eos_id"),
            tenant=str(r.get("tenant", "default")),
            tier=str(r.get("tier", "batch")),
            trace=r.get("trace"))
        self._live[req.rid] = (reply, r.get("id", req.rid))

    def _op_export(self, r: dict, reply):
        eng = self.eng
        if not hasattr(eng, "export_prefix"):
            raise ValueError("export_prefix needs a paged engine")
        prompt = np.asarray(r["prompt"], np.int32).reshape(-1)
        xid = r.get("id")
        digests = eng.prefix_digests(prompt)
        if not digests:
            reply.write(self._stamp(
                {"id": xid, "op": "export_prefix",
                 "payload": None, "blocks": 0}))
            return
        if r.get("warm_only"):
            # fleet cache-directory fetch: serve whatever leading run
            # is warm HERE (HBM pool + DRAM/disk spill tiers mixed),
            # never warming the prompt up locally — the requester asked
            # for our cache, not our compute. An empty run is an empty
            # payload; the fetcher falls back to a cold prefill.
            payload = eng.export_prefix(prompt, trace=r.get("trace"),
                                        partial=True)
            if payload is None:
                reply.write(self._stamp(
                    {"id": xid, "op": "export_prefix",
                     "payload": None, "blocks": 0}))
            else:
                from paddle_tpu_torch.serving import transfer as _transfer
                meta, _ = _transfer.deserialize_blocks(payload)
                reply.write(self._stamp(self._export_doc(
                    xid, payload, len(meta["digests"]))))
            return
        payload = eng.export_prefix(prompt, trace=r.get("trace"))
        if payload is not None:      # prefix already hot: serialize now
            reply.write(self._stamp(
                self._export_doc(xid, payload, len(digests))))
            return
        # cold: run the prompt through the ordinary scheduler (its
        # chunks publish into the prefix cache as each one lands, and
        # interleave with in-flight decode like any admission); the
        # payload serializes when the warm-up request finishes. The
        # warm-up request adopts the wire trace id so the prefill half
        # of a disaggregated handoff joins the same fleet timeline as
        # the decode half.
        req = eng.submit(prompt, 1, trace=r.get("trace"))
        self._exports[req.rid] = (reply, xid, prompt, r.get("trace"))

    @staticmethod
    def _export_doc(xid, payload: bytes, blocks: int) -> dict:
        return {"id": xid, "op": "export_prefix",
                "payload": base64.b64encode(payload).decode("ascii"),
                "blocks": int(blocks)}

    def _op_import(self, r: dict, reply):
        eng = self.eng
        if not hasattr(eng, "import_prefix"):
            raise ValueError("import_prefix needs a paged engine")
        n = eng.import_prefix(base64.b64decode(r["payload"]))
        reply.write(self._stamp({"id": r.get("id"), "op": "import_prefix",
                                 "imported": int(n)}))

    def _finish(self, req):
        if req.rid in self._exports:
            reply, xid, prompt, trace = self._exports.pop(req.rid)
            payload = self.eng.export_prefix(prompt, trace=trace)
            if payload is None:
                # evicted under pool pressure before serialization: the
                # requester falls back to a cold prefill (slower, same
                # bits)
                reply.write(self._stamp(
                    {"id": xid, "op": "export_prefix",
                     "payload": None, "blocks": 0}))
            else:
                reply.write(self._stamp(self._export_doc(
                    xid, payload,
                    len(self.eng.prefix_digests(prompt)))))
            return
        reply, xid = self._live.pop(req.rid, (None, None))
        if reply is None:
            return
        reply.write(self._stamp({
            "id": xid, "tokens": [int(t) for t in req.tokens],
            "finish_reason": req.finish_reason,
            "ttft_ms": round(1000 * req.ttft_s, 3)
            if req.ttft_s is not None else None,
            "latency_ms": round(1000 * req.latency_s, 3)
            if req.latency_s is not None else None}))

    # -- pumping -----------------------------------------------------------
    def ingest_all(self):
        while True:
            try:
                self._ingest(self._inbox.get_nowait())
            except queue.Empty:
                return

    def step_once(self):
        """Fleet-handle pump: ingest everything queued, then one engine
        step (results land in their reply sinks)."""
        self.ingest_all()
        if not self.eng.idle:
            for req in self.eng.step():
                self._finish(req)

    def pump(self, block_s: float = 0.05) -> bool:
        """One run-loop iteration. Returns False when the loop should
        exit (EOF or drain, with everything finished and emitted)."""
        if self.draining.is_set():
            # first observation seals the inbox: everything queued up
            # to the seal was accepted and must finish; later feed()
            # calls are refused (see feed) so the drain converges even
            # under a client that never stops streaming
            self.ingest_all()
            self._sealed.set()
            self.ingest_all()   # lines that raced the seal flag
        else:
            try:
                self._ingest(self._inbox.get(
                    timeout=block_s if self.eng.idle else 0.0))
            except queue.Empty:
                pass
        if not self.eng.idle:
            for req in self.eng.step():
                self._finish(req)
        return not ((self._eof or self.draining.is_set())
                    and self.eng.idle and self._inbox.empty())

    def run(self) -> int:
        while self.pump():
            pass
        return 0


def install_drain_handler(loop: EngineLoop,
                          signals_=(signal.SIGTERM,)):
    """SIGTERM → :meth:`EngineLoop.drain`. Returns a ``restore()``
    callable putting the previous handlers back. Signal handlers can
    only be installed from the main thread (the signal-module rule);
    elsewhere this is a documented no-op — embedding callers drive
    ``loop.drain()`` themselves."""
    if (not signals_ or threading.current_thread()
            is not threading.main_thread()):
        return lambda: None
    prev = {}
    for s in signals_:
        prev[s] = signal.signal(s, lambda *_: loop.drain())

    def restore():
        for s, h in prev.items():
            try:
                signal.signal(s, h)
            except (ValueError, OSError):
                pass
    return restore


def serve_stdio(eng, stdin=None, stdout=None, *,
                default_max_new: int = 64,
                drain_signals=(signal.SIGTERM,)) -> int:
    """The stdio serve loop: JSONL requests from
    ``stdin`` through ``eng``, one JSONL result per request on
    ``stdout`` as it completes. Exits 0 at stdin EOF once in-flight
    work drains — or on SIGTERM, which stops reading and finishes
    everything already accepted (results emitted, exit 0): the
    graceful replica-drain contract the fleet router relies on."""
    stdin = stdin if stdin is not None else sys.stdin
    stdout = stdout if stdout is not None else sys.stdout
    loop = EngineLoop(eng, default_max_new=default_max_new)
    reply = _StreamReply(stdout)

    def _read():
        try:
            for line in stdin:
                loop.feed(line, reply)
        except ValueError:          # stdin closed under the reader
            pass
        loop.feed_eof()

    threading.Thread(target=_read, daemon=True,
                     name="serve-stdin").start()
    restore = install_drain_handler(loop, drain_signals)
    try:
        return loop.run()
    finally:
        restore()


class ReplicaServer:
    """TCP JSONL replica endpoint around one engine — the fleet-facing
    transport. Connection reader threads feed the shared
    :class:`EngineLoop`; the engine loop runs on the caller's thread
    (:meth:`serve_forever`) and writes each line's results back to its
    originating connection (keep the connection open to receive them).
    Runs until :meth:`drain`: in-flight requests finish and emit, then
    ``serve_forever``
    returns 0. A client disconnecting is NOT a drain — other clients
    (or a reconnecting router) keep the replica serving."""

    def __init__(self, eng, host: str = "127.0.0.1", port: int = 0,
                 *, default_max_new: int = 64):
        self.loop = EngineLoop(eng, default_max_new=default_max_new)
        self._sock = socket.create_server((host, port))
        self._sock.settimeout(0.2)
        self.addr = self._sock.getsockname()
        self._closed = threading.Event()
        threading.Thread(target=self._accept_loop, daemon=True,
                         name="replica-accept").start()

    @property
    def port(self) -> int:
        return self.addr[1]

    def _accept_loop(self):
        while not self._closed.is_set():
            if self.loop.draining.is_set():
                return      # draining: no new connections either
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._reader, args=(conn,),
                             daemon=True, name="replica-conn").start()

    def _reader(self, conn: socket.socket):
        reply = _SocketReply(conn)
        try:
            with conn, conn.makefile("r", encoding="utf-8") as f:
                for line in f:
                    self.loop.feed(line, reply)
        except (OSError, ValueError):
            pass

    def serve_forever(self) -> int:
        try:
            return self.loop.run()
        finally:
            self.close()

    def drain(self):
        self.loop.drain()

    def close(self):
        self._closed.set()
        try:
            self._sock.close()
        except OSError:
            pass


class EngineReplica:
    """In-process fleet handle: the Router-facing replica protocol
    (``submit / poll / health / alive / pump``) over a live engine in
    THIS process — single-process fleets and the router tests (no
    process/socket overhead in the timed path)."""

    def __init__(self, eng, name: str = "replica0", *,
                 default_max_new: int = 64):
        self.eng = eng
        self.name = str(name)
        self._loop = EngineLoop(eng, default_max_new=default_max_new)
        self._reply = ListReply()
        self._killed = False

    def submit(self, spec: dict):
        if self._killed:
            return
        self._loop.feed(dict(spec), self._reply)

    def pump(self):
        """Advance the wrapped engine by one scheduler step."""
        if not self._killed:
            self._loop.step_once()

    def poll(self) -> List[dict]:
        if self._killed:
            return []
        docs, self._reply.docs = self._reply.docs, []
        return docs

    def health(self) -> Optional[dict]:
        return None if self._killed else self.eng.health()

    def alive(self) -> bool:
        return not self._killed

    def kill(self):
        """Simulate process death (chaos tests, kill injection): the
        handle goes deaf — ``alive()`` False, submits
        dropped, results undeliverable — and the wrapped engine closes
        its live requests' open trace slices (``abort_requests``) the
        way a real SIGKILL loses them with the process's span buffer.
        The router's requeue path sees exactly what a dead socket
        shows it."""
        self._killed = True
        if hasattr(self.eng, "abort_requests"):
            self.eng.abort_requests()

    def metrics_snapshot(self) -> Optional[dict]:
        """The engine registry's snapshot dict — the fleet aggregator's
        in-process scrape source (the TCP handle parses `/metrics`
        text into the same shape)."""
        if self._killed:
            return None
        self.eng._update_window_gauges()
        return self.eng.metrics.snapshot()

    @property
    def idle(self) -> bool:
        return self._loop.idle

    def close(self):
        pass


class SocketReplica:
    """Router-side handle to a replica PROCESS over TCP (the JSONL op
    wire) + its HTTP ``/healthz``. A dead socket (connection EOF,
    refused writes) flips :meth:`alive` False — the router's signal to
    requeue this replica's in-flight work onto survivors. ``health()``
    returns the parsed three-state document, or ``None`` when the
    endpoint is unreachable (state unknown; LIVENESS stays the
    transport's verdict)."""

    def __init__(self, name: str, addr, health_url: Optional[str] = None,
                 *, connect_timeout: float = 10.0):
        self.name = str(name)
        self.addr = tuple(addr)
        self.health_url = health_url
        self._q: "queue.Queue" = queue.Queue()
        self._dead = threading.Event()
        self._wlock = threading.Lock()
        self._sock = socket.create_connection(self.addr,
                                              timeout=connect_timeout)
        self._sock.settimeout(None)
        threading.Thread(target=self._read_loop, daemon=True,
                         name=f"fleet-{self.name}").start()

    def _read_loop(self):
        try:
            with self._sock.makefile("r", encoding="utf-8") as f:
                for line in f:
                    try:
                        self._q.put(json.loads(line))
                    except json.JSONDecodeError:
                        continue
        except (OSError, ValueError):
            pass
        self._dead.set()

    def submit(self, spec: dict):
        data = (json.dumps(spec) + "\n").encode("utf-8")
        try:
            with self._wlock:
                self._sock.sendall(data)
        except OSError:
            self._dead.set()

    def poll(self) -> List[dict]:
        out = []
        while True:
            try:
                out.append(self._q.get_nowait())
            except queue.Empty:
                return out

    def health(self) -> Optional[dict]:
        if self.health_url is None:
            return None
        import urllib.error
        import urllib.request
        url = self.health_url.rstrip("/") + "/healthz"
        try:
            with urllib.request.urlopen(url, timeout=2.0) as resp:
                return json.loads(resp.read())
        except urllib.error.HTTPError as e:
            try:
                return json.loads(e.read())   # 503 carries the
            except (ValueError, OSError):     # unhealthy doc
                return {"status": "unhealthy"}
        except Exception:
            return None

    def metrics_snapshot(self) -> Optional[dict]:
        """Scrape the replica process's `/metrics` into the registry
        snapshot shape (``observe.metrics.parse_prometheus``) — the
        fleet aggregator's TCP scrape source. ``None`` when the
        endpoint is unreachable (the aggregator keeps the last view)."""
        if self.health_url is None:
            return None
        import urllib.request
        from paddle_tpu_torch.observe.metrics import parse_prometheus
        url = self.health_url.rstrip("/") + "/metrics"
        try:
            with urllib.request.urlopen(url, timeout=2.0) as resp:
                return parse_prometheus(resp.read().decode("utf-8"))
        except Exception:
            return None

    def alive(self) -> bool:
        return not self._dead.is_set()

    def pump(self):
        """No-op: the replica process steps its own engine."""

    def close(self):
        self._dead.set()
        try:
            self._sock.close()
        except OSError:
            pass
