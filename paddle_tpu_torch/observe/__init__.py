"""Observability: the metrics registry, MFU accounting, the compile
tracker, rolling SLO windows (``window``), the request log
(``requests``), chrome-trace spans and lifecycle events
(``chrome_trace``, ``trace``), the health server (``health``) and the
flight recorder (``flight``)."""
