"""Decode step: the median of the engine's own per-step decode seconds
(a host clock ended by the step's copy of the ids to the host) over the
window's steps."""

from perfbench.harness import percentile


def read(ctx):
    p = percentile(ctx.get("decode_s", ()), 50)
    return None if p is None else 1e3 * p
