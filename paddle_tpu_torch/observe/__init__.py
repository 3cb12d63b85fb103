"""Observability: the metrics registry, MFU accounting, the compile
tracker, rolling SLO windows (``window``), the request log
(``requests``), chrome-trace spans and lifecycle events
(``chrome_trace``, ``trace``), the health server (``health``), the
flight recorder (``flight``), and the fleet's metrics aggregation
(``fleet``) and alert rules (``alerts``)."""
