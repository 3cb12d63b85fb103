"""Engine scheduler: the 95th percentile of ``EngineRequest.
queue_wait_s`` (submit to admission) over every request that arrived in
the window."""

from perfbench.harness import percentile


def read(ctx):
    waits = [w for w in ctx.get("queue_wait_s", ()) if w is not None]
    p = percentile(waits, 95)
    return None if p is None else 1e3 * p
