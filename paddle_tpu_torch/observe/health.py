"""Health endpoints: a tiny stdlib HTTP server — the port's own copy of
``paddle_tpu/observe/health.py``: ``/metrics``, ``/healthz``,
``/requests`` and ``/alerts``.

- ``/metrics`` — the Prometheus text exposition of a registry (default:
  the process-wide default registry), or of ``metrics_fn()`` when the
  owner refreshes derived gauges per scrape;
- ``/healthz`` — a JSON document from a caller-provided ``health_fn()``.
  Three-state status: ``ok`` and ``degraded`` (an SLO burn-rate breach,
  the reason in the body) answer HTTP 200, so traffic keeps flowing;
  ``unhealthy`` (or a ``"healthy": False`` key, which always wins)
  answers 503;
- ``/requests`` — present when a ``requests_fn`` is supplied (the
  engines pass theirs): the top-k slowest requests with their
  attributed latency components (``observe/requests.py``);
- ``/alerts`` — present when an ``alerts_fn`` is supplied (the fleet
  router passes its evaluator's ``doc``): per-rule state + the recent
  firing/resolved transition log (``observe/alerts.py``).

``port=0`` binds an ephemeral port; the server runs on a daemon thread
and must be ``close()``d. The documents are built on the server's
thread from host state only: nothing here reads the card.
"""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from paddle_tpu_torch.observe.metrics import JsonlSink, default_registry


class HealthServer:
    def __init__(self, registry=None, health_fn: Optional[Callable[[],
                 dict]] = None, host: str = "127.0.0.1", port: int = 0,
                 requests_fn: Optional[Callable[[], dict]] = None,
                 metrics_fn: Optional[Callable[[], str]] = None,
                 alerts_fn: Optional[Callable[[], dict]] = None):
        self.registry = registry if registry is not None \
            else default_registry()
        self.health_fn = health_fn
        self.requests_fn = requests_fn
        self.metrics_fn = metrics_fn
        self.alerts_fn = alerts_fn
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):   # silence per-request spam
                pass

            def _send(self, code, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/metrics":
                        text = (outer.metrics_fn() if outer.metrics_fn
                                else outer.registry.render_prometheus())
                        self._send(200, text.encode(),
                                   "text/plain; version=0.0.4")
                    elif path == "/healthz":
                        code, doc = outer._health()
                        self._send(code, json.dumps(doc).encode(),
                                   "application/json")
                    elif (path == "/requests"
                          and outer.requests_fn is not None):
                        doc = JsonlSink._clean(outer.requests_fn() or {})
                        self._send(200, json.dumps(doc).encode(),
                                   "application/json")
                    elif (path == "/alerts"
                          and outer.alerts_fn is not None):
                        doc = JsonlSink._clean(outer.alerts_fn() or {})
                        self._send(200, json.dumps(doc).encode(),
                                   "application/json")
                    else:
                        self._send(404, b'{"error": "not found"}\n',
                                   "application/json")
                except (ConnectionError, BrokenPipeError, OSError):
                    # the scraper hung up mid-write: nobody to answer
                    pass
                except Exception as e:  # noqa: BLE001 — a broken probe
                    # must answer 500, not kill the handler thread
                    try:
                        self._send(500, json.dumps(
                            {"error": str(e)}).encode(),
                            "application/json")
                    except OSError:
                        pass

        self._srv = ThreadingHTTPServer((host, port), _Handler)
        self._srv.daemon_threads = True
        self.addr = self._srv.server_address
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()

    def _health(self):
        doc = {}
        if self.health_fn is not None:
            doc = dict(self.health_fn() or {})
        healthy = bool(doc.pop("healthy", True))
        status = doc.get("status")
        if not healthy:
            status = "unhealthy"          # the bool always wins
        elif status not in ("ok", "degraded", "unhealthy"):
            status = "ok"
        doc["status"] = status
        return (503 if status == "unhealthy" else 200), \
            JsonlSink._clean(doc)

    @property
    def port(self) -> int:
        return self.addr[1]

    @property
    def url(self) -> str:
        return f"http://{self.addr[0]}:{self.addr[1]}"

    def close(self):
        self._srv.shutdown()
        self._srv.server_close()
