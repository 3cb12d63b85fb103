"""Step bottleneck attribution: input_bound | compute_bound | sync_bound
(counterpart of ``paddle_tpu/observe/bottleneck.py``).

The trainer times ``feed`` / ``train_step/dispatch`` / ``host_sync``
spans; this module classifies a step from those three measurements:

- ``feed_s``      time obtaining the step's feeds (next() on the feed
                  iterator: DataFeeder convert + H2D on the sync path,
                  the blocking staging-ring get on the pipelined path)
- ``dispatch_s``  host-side dispatch of the step (the eager forward,
                  backward and update issue their kernels; on the CPU
                  this is the whole step)
- ``sync_s``      host blocked reading back the loss. Under CUDA's
                  asynchronous launches this is where the DEVICE's
                  execution time surfaces — compute, but also any
                  cross-replica collective / straggler wait.

Because device work hides inside ``sync_s``, naming a sync-dominated
step requires a compute estimate: when the step's counted FLOPs and
the declared peak (``observe/costs.py`` — the MFU machinery) are known,
``est_compute_s = flops / peak`` splits ``sync_s`` into modeled compute
and unexplained excess. A step whose sync wait far exceeds its modeled
compute is *sync_bound* (stragglers, collectives, backpressure); without
a cost model the excess is unknowable and sync-dominated steps report
*compute_bound*.

Classification is by dominant fraction:

- ``input_bound``    feeds dominate — speed up the input pipeline
- ``compute_bound``  dispatch + modeled device compute dominate — the
                     healthy state for a device-saturated step
- ``sync_bound``     sync wait UNEXPLAINED by modeled compute dominates

Pure functions, stdlib-only; the trainer's ``_StepMonitor`` feeds the
result into gauges, step records, and flight-recorder post-mortems.
"""

from typing import Dict, Optional, Tuple

COMPONENTS = ("input", "compute", "sync")


def attribute_step(feed_s: float, dispatch_s: float, sync_s: float,
                   est_compute_s: Optional[float] = None
                   ) -> Tuple[str, Dict[str, float]]:
    """Classify one step; returns ``(label, fractions)`` where
    ``fractions`` maps ``input`` / ``compute`` / ``sync`` to their
    share of the measured step time (they sum to 1, or all-zero for a
    zero-length step labelled ``unknown``)."""
    feed_s = max(float(feed_s), 0.0)
    dispatch_s = max(float(dispatch_s), 0.0)
    sync_s = max(float(sync_s), 0.0)
    total = feed_s + dispatch_s + sync_s
    if total <= 0.0:
        return "unknown", {c: 0.0 for c in COMPONENTS}
    if est_compute_s is None:
        compute_s = dispatch_s + sync_s
        sync_excess = 0.0
    else:
        modeled = min(sync_s, max(float(est_compute_s), 0.0))
        compute_s = dispatch_s + modeled
        sync_excess = sync_s - modeled
    fractions = {"input": feed_s / total, "compute": compute_s / total,
                 "sync": sync_excess / total}
    # ties break toward the earlier pipeline stage (input before
    # compute before sync): the earlier stage is the one a fix targets
    label = max(COMPONENTS, key=lambda c: (fractions[c],
                                           -COMPONENTS.index(c)))
    return f"{label}_bound", fractions
