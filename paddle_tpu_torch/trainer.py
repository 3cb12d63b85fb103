"""The training loop (counterpart of ``paddle_tpu/trainer.py``).

Reference: python/paddle/v2/trainer.py:124 SGD.train — per-pass/per-batch
loop driving GradientMachine.forwardBackward + ParameterUpdater over SWIG,
firing user events; plus the C++ Trainer/TrainerInternal
(paddle/trainer/TrainerInternal.cpp:66 trainOneBatch).

One device: the parameters' (``Parameters.device``, the card unless the
caller made them elsewhere). A batch step runs eagerly: the compiled
forward over leaf tensors that share the parameters' storage, the mean
fp32 cost, ``torch.autograd.grad`` (``.grad`` is never touched), then
``optimizer.update``, which writes the new values into
``parameters.values`` in place — so those tensors are the ones
``save_parameter_to_tar`` writes, and nothing holds a stale copy. Batch
norm's running statistics come back in the forward's ``new_state`` and
replace ``parameters.state``. The Python loop feeds data one batch
ahead and reads back one scalar per step.

Dropout masks are the JAX package's for the same seed: the step key is
``global_key_source().step("dropout", step)`` and the microbatched step
splits it with ``ops/prng.split`` (``jax.random.split``).

``checkpoint_dir=`` writes ``io/checkpoint`` directories on an
``AsyncCheckpointer`` and resumes from the newest intact one;
``prefetch > 0`` or a ``pipeline.Pipeline`` reader feeds through the
input pipeline, whose device stage (``DeviceTransfer``) copies each
batch to the card on a stream of its own ahead of the step.

``parallel=`` (a ``parallel.spmd.DistConfig``) trains SPMD over a mesh,
one process per rank: every rank reads the same global batch and takes
its rows of the batch axes; parameters, optimizer state and gradients
take the config's layouts (TP rules, ZeRO stages 0-3) and the gradient
collectives are explicit (``parallel/spmd.py``). Batch norm layers
normalize over the global batch, as the JAX package's GSPMD step does
(``ops/norm.synced_statistics``: the statistics' sums reduced over the
ranks), and so do ``conv_bn``'s and the q8 blocks' (with the stashes'
absmax). The elastic supervisor contract (``PADDLE_ELASTIC_DIR``) is
ROADMAP A10b and raises ``NotImplementedError``.
"""

import contextlib
import math
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from paddle_tpu_torch import event as events
from paddle_tpu_torch import observe
from paddle_tpu_torch.data_feeder import DataFeeder
from paddle_tpu_torch.evaluator import EvaluatorSet
from paddle_tpu_torch.ops import prng
from paddle_tpu_torch.optimizer import Optimizer
from paddle_tpu_torch.parameters import Parameters
from paddle_tpu_torch.runtime import chaos as _chaos
from paddle_tpu_torch.topology import (FEED_FIELDS, LayerOutput, Topology,
                                       Value)
from paddle_tpu_torch.utils.logger import get_logger
from paddle_tpu_torch.utils.flags import GLOBAL_FLAGS
from paddle_tpu_torch.utils.rng import global_key_source

logger = get_logger("trainer")


def _zeros_like_tree(v, shape):
    """A stand-in of ``v``'s structure with the parameter's global
    shape at every non-scalar leaf (what ``state_shardings`` reads)."""
    if isinstance(v, (tuple, list)):
        return type(v)(_zeros_like_tree(x, shape) for x in v)
    if isinstance(v, dict):
        return {k: _zeros_like_tree(x, shape) for k, x in v.items()}
    if isinstance(v, torch.Tensor) and v.ndim:
        return np.empty(shape, dtype=np.uint8)
    return np.empty((), dtype=np.uint8)


def _feed_tensors(feeds) -> List[torch.Tensor]:
    """Every tensor of a feed dict, in sorted-name then field order."""
    return [getattr(feeds[k], f) for k in sorted(feeds)
            for f in FEED_FIELDS if getattr(feeds[k], f) is not None]


def _feed_signature(feeds):
    """The feeds' (shape, dtype) signature: one entry per tensor."""
    return observe.arg_signature(_feed_tensors(feeds))


def _split_value(v: Value, n: int) -> List[Value]:
    """``v`` cut into ``n`` equal slices along the batch axis."""
    parts = {f: (None if getattr(v, f) is None
                 else torch.chunk(getattr(v, f), n, dim=0))
             for f in FEED_FIELDS}
    return [Value(*(None if parts[f] is None else parts[f][i]
                    for f in FEED_FIELDS)) for i in range(n)]


#: sets of pinned feed buffers that rotate in ``DeviceTransfer``: the
#: pipeline's ``device_depth`` (2) copied batches, the one in the step
#: and the one being filled. A set is refilled only after its copies'
#: event, so the count bears on waiting, never on correctness.
_PINNED_SLOTS = 4


class DeviceFeeds(dict):
    """{slot name: ``Value``} on the device, with ``ready``: the CUDA
    event after its copies (None when nothing was copied)."""

    ready: Optional["torch.cuda.Event"] = None


class DeviceTransfer:
    """The pipeline's device stage on the card (the JAX trainer's
    ``jax.device_put`` transfer): pinned host→device copies of feed
    dicts on a side stream. Runs on the ``pipeline-feed`` thread and,
    per batch,

    1. waits for the copies that last read its next pinned slot, so a
       pinned buffer is never refilled before its copy completes;
    2. fills the slot's pinned host buffers from the converted host feeds;
    3. copies them to the device with ``non_blocking=True`` on a CUDA
       stream of its own, and records an event after the copies.

    The result is a :class:`DeviceFeeds` that the consumer hands to
    :func:`adopt` before its step. A failing copy raises on the feed
    thread and re-raises at the pipeline's ``next()``; there is no
    fallback that feeds from the host."""

    def __init__(self, device):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"DeviceTransfer copies to a CUDA device, "
                             f"got {self.device}")
        self._pinned: List[Dict] = [dict() for _ in range(_PINNED_SLOTS)]
        self._done: List[Optional["torch.cuda.Event"]] = \
            [None] * _PINNED_SLOTS
        self._next = 0
        self._stream: Optional["torch.cuda.Stream"] = None

    def _pin(self, bufs: Dict, key, t: torch.Tensor) -> torch.Tensor:
        buf = bufs.get(key)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = bufs[key] = torch.empty(t.shape, dtype=t.dtype,
                                          pin_memory=True)
        buf.copy_(t)
        return buf

    def __call__(self, feeds: Dict[str, Value]) -> DeviceFeeds:
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        i = self._next
        self._next = (i + 1) % _PINNED_SLOTS
        if self._done[i] is not None:
            # the copies that last read this slot's pinned buffers
            self._done[i].synchronize()
        bufs = self._pinned[i]
        out = DeviceFeeds()
        with torch.cuda.stream(self._stream):
            for name, v in feeds.items():
                fields = []
                for f in FEED_FIELDS:
                    t = getattr(v, f)
                    if t is None:
                        fields.append(None)
                        continue
                    if t.device.type != "cpu":
                        raise ValueError(
                            f"DeviceTransfer: feed {name!r}.{f} is "
                            f"already on {t.device}; convert must give "
                            f"host tensors")
                    pin = self._pin(bufs, (name, f), t)
                    fields.append(pin.to(self.device, non_blocking=True))
                out[name] = Value(*fields)
            ev = torch.cuda.Event()
            ev.record(self._stream)
        self._done[i] = ev
        out.ready = ev
        return out


def adopt(feeds) -> None:
    """Make ``feeds`` (a :class:`DeviceFeeds`) safe to use on the current
    stream of their device: wait for their copies and tie their memory to
    that stream. A no-op for feeds that carry no event (host feeds)."""
    ev = getattr(feeds, "ready", None)
    if ev is None:
        return
    stream = None
    for v in feeds.values():
        for f in FEED_FIELDS:
            t = getattr(v, f)
            if t is None or t.device.type != "cuda":
                continue
            if stream is None:
                stream = torch.cuda.current_stream(t.device)
                stream.wait_event(ev)
            t.record_stream(stream)


def _state_bytes(s) -> int:
    if isinstance(s, torch.Tensor):
        if type(s).__name__ == "DTensor":      # its local shard
            s = s.to_local()
        return s.numel() * s.element_size()
    if isinstance(s, dict):
        return sum(_state_bytes(v) for v in s.values())
    if isinstance(s, (list, tuple)):
        return sum(_state_bytes(v) for v in s)
    return 0


class _StepMonitor:
    """Per-step observability: wall time, examples/sec, loss, recompile
    tagging, MFU, and memory gauges — fanned out through
    ``observe.report()`` (JSONL sink + handlers), the default metrics
    registry, and the flight recorder's last-K ring. All host work is
    O(1) dict/float ops.

    Recompile accounting is two-sided, as in the JAX package: the
    compile tracker's count of feed signatures (``compile_count`` in
    every record; on the port an unseen signature is a new shape set for
    the eager step, the point where cuDNN and cuBLAS pick algorithms),
    plus the wall-time outlier heuristic (a step over ``outlier_factor``
    × the running median of the last ``window`` steps is tagged
    ``recompile``)."""

    def __init__(self, window: int = 64, outlier_factor: float = 4.0,
                 opt_state_bytes: int = 0, grad_bytes: int = 0,
                 param_bytes: int = 0, device=None):
        self._times = []                     # ring buffer of recent steps
        self._window = window
        self._factor = outlier_factor
        self._idx = 0
        self._device = device
        self._opt_bytes = int(opt_state_bytes)
        self._grad_bytes = int(grad_bytes)
        self._param_bytes = int(param_bytes)
        reg = observe.default_registry()
        self.steps = reg.counter(
            "train_steps_total", "optimizer steps taken")
        self.examples = reg.counter(
            "train_examples_total", "training examples consumed")
        self.recompiles = reg.counter(
            "train_recompiles_total",
            "steps tagged as recompiles (step-time outliers)")
        self.step_time = reg.histogram(
            "train_step_seconds", "per-step wall time (dispatch+sync)")
        self.loss_gauge = reg.gauge("train_loss", "last step's mean loss")
        self.mfu_gauge = reg.gauge(
            "train_mfu", "model-FLOPs utilisation of the last step "
            "(counted flops / wall / declared peak; 0 until the step "
            "cost is known)")
        self.hbm_gauge = reg.gauge(
            "device_bytes_in_use", "device memory in use (0 when the "
            "device reports none, e.g. CPU)")
        self.host_gauge = reg.gauge(
            "host_rss_bytes", "host process resident set size")
        self.opt_bytes_gauge = reg.gauge(
            "opt_state_bytes_per_device",
            "optimizer-state bytes resident on ONE device")
        self.grad_bytes_gauge = reg.gauge(
            "grad_bytes_per_device",
            "bytes of the longest-lived gradient object on ONE device "
            "(the fp32 accumulator under grad accumulation, else the "
            "gradient at the update point)")
        self.param_bytes_gauge = reg.gauge(
            "param_bytes_per_device",
            "parameter bytes resident on ONE device between steps")
        self.bottleneck_frac = reg.gauge(
            "train_bottleneck_fraction",
            "last step's time split by component (label component = "
            "input|compute|sync; observe/bottleneck.py semantics)")
        self.bottleneck_steps = reg.counter(
            "train_steps_bottleneck_total",
            "steps by bottleneck classification (label bottleneck = "
            "input_bound|compute_bound|sync_bound)")
        # set unconditionally: a stateless-optimizer run must overwrite
        # a previous run's value on the shared registry, not expose it
        self.opt_bytes_gauge.set(self._opt_bytes)
        self.grad_bytes_gauge.set(self._grad_bytes)
        self.param_bytes_gauge.set(self._param_bytes)
        # peak FLOP/s is constant for the process: resolve once
        self._peak_flops = observe.costs.device_peak_flops(device)
        # raw step walls for the gang plane (pooled across ranks by a
        # supervisor; the histogram above has already binned them away)
        self.step_window = observe.WindowedQuantiles(window_s=120.0,
                                                     max_samples=512)

    def median(self):
        """Running median step wall over the ring (None before the
        first step) — the goodput accountant's useful-vs-recompile
        split point."""
        if not self._times:
            return None
        return sorted(self._times)[len(self._times) // 2]

    def tag_recompile(self, dt: float) -> bool:
        """Record one step time; True when it is a compile-shaped outlier."""
        times = self._times
        first = not times
        if len(times) < self._window:
            times.append(dt)
        else:
            times[self._idx] = dt
            self._idx = (self._idx + 1) % self._window
        if first:
            return True
        med = sorted(times)[len(times) // 2]
        return dt > self._factor * med and dt > med + 0.01

    def update_memory_gauges(self):
        """Refresh host/device memory gauges (called every log_period,
        not per step)."""
        from paddle_tpu_torch.utils import memory as mem
        dev = mem.device_memory_stats(self._device)
        if dev.get("bytes_in_use"):
            self.hbm_gauge.set(dev["bytes_in_use"])
        host = mem.host_memory_stats()
        if host.get("rss_bytes"):
            self.host_gauge.set(host["rss_bytes"])

    def step(self, *, step, pass_id, batch_id, cost, batch_size, dt,
             flops=None, compile_count=0, feed_s=0.0, dispatch_s=0.0,
             sync_s=0.0):
        """One trained batch: update registry, ring the flight recorder,
        and emit the JSONL record. ``flops`` is the step's counted cost
        when known (None → MFU reports 0). ``feed_s`` / ``dispatch_s`` /
        ``sync_s`` are the step's span components; together with the
        modeled compute time (flops / peak) they classify the step
        input|compute|sync-bound (observe/bottleneck.py)."""
        recompile = self.tag_recompile(dt)
        self.steps.inc()
        self.examples.inc(batch_size)
        self.step_time.observe(dt)
        self.step_window.observe(dt)
        self.loss_gauge.set(cost)
        if recompile:
            self.recompiles.inc()
        eps = batch_size / dt if dt > 0 else 0.0
        mfu = (observe.costs.mfu(flops, dt, self._peak_flops)
               if self._peak_flops else None)
        if mfu is not None:
            self.mfu_gauge.set(mfu)
        est_compute = (flops / self._peak_flops
                       if flops and self._peak_flops else None)
        label, frac = observe.attribute_step(feed_s, dispatch_s, sync_s,
                                             est_compute)
        for comp, f in frac.items():
            self.bottleneck_frac.set(round(f, 6), component=comp)
        if label != "unknown":
            self.bottleneck_steps.inc(bottleneck=label)
        rec = dict(kind="step", step=step, pass_id=pass_id,
                   batch_id=batch_id, loss=round(cost, 6),
                   wall_time_s=round(dt, 6),
                   examples_per_sec=round(eps, 2),
                   mfu=round(mfu, 6) if mfu is not None else 0.0,
                   compile_count=int(compile_count),
                   opt_state_bytes=self._opt_bytes,
                   grad_bytes=self._grad_bytes,
                   param_bytes=self._param_bytes,
                   recompile=recompile,
                   bottleneck=label,
                   feed_s=round(feed_s, 6),
                   dispatch_s=round(dispatch_s, 6),
                   sync_s=round(sync_s, 6),
                   frac_input=round(frac["input"], 4),
                   frac_compute=round(frac["compute"], 4),
                   frac_sync=round(frac["sync"], 4))
        # the flight ring ALWAYS sees the step — a post-mortem must not
        # depend on a metrics sink having been configured
        observe.default_flight_recorder().record(rec)
        if observe.has_consumers():
            observe.report(rec)
        return recompile, eps


class SGD:
    """paddle.trainer.SGD (reference: python/paddle/v2/trainer.py:48) on
    the parameters' device."""

    def __init__(self, cost: LayerOutput, parameters: Parameters,
                 update_equation: Optimizer,
                 extra_layers: Optional[List[LayerOutput]] = None,
                 is_local: bool = True, parallel=None,
                 grad_accum_steps: int = 1):
        """parallel: an optional ``parallel.spmd.DistConfig`` — shards
        parameters per its rules and zero stage, the batch across its
        batch axes, and reduces gradients over them (replacing the
        pserver round-trip, reference: trainer/RemoteParameterUpdater.cpp).

        grad_accum_steps: split every batch into this many microbatches:
        activations live for one microbatch at a time while fp32
        gradients accumulate and the optimizer sees the full-batch mean
        gradient. Batch norm normalizes per MICROBATCH (ghost-BN
        statistics, threaded through the slices in order) and dropout
        draws one mask per microbatch (the step key split n ways).
        Ragged final batches (drop_last=False) fall back to the
        unaccumulated step."""
        if grad_accum_steps < 1:
            raise ValueError(f"grad_accum_steps must be >= 1, "
                             f"got {grad_accum_steps}")
        self.grad_accum_steps = int(grad_accum_steps)
        self.cost = cost
        self.parameters = parameters
        self.device = parameters.device
        self.optimizer = update_equation
        self.extra_layers = list(extra_layers or [])
        self.topology = Topology([cost] + self.extra_layers)
        self.optimizer.bind(self.topology.param_specs())
        self._forward = self.topology.compile()
        self._feeder_cache: Dict = {}
        self.opt_state = self.optimizer.init_state(parameters.values)
        self._step = 0
        self.parallel = parallel
        if parallel is not None:
            self._init_parallel()
        self._metric_names = [l.name for l in self.topology.layers
                              if hasattr(l, "metric_finalize")]
        self._train_step = (self._accum_train_step
                            if self.grad_accum_steps > 1
                            else self._plain_train_step)
        # (step kind, feed signature) -> counted flops (or None when no
        # consumer wanted them); filled lazily, once per signature
        self._step_flops: Dict = {}
        self._last_step_wall = None          # healthz progress probes
        self._last_cost = None
        self.evaluators = EvaluatorSet(self.topology.layers)
        if self.grad_accum_steps > 1 and any(
                getattr(l, "layer_type", "") == "pnpair"
                for l in self.topology.layers):
            logger.warning(
                "grad_accum_steps>1 with a positive_negative_pair "
                "evaluator: pairs spanning microbatch boundaries are not "
                "counted — the metric differs from unaccumulated training")

    # -- steps -------------------------------------------------------------
    def _init_parallel(self):
        """Place parameters and optimizer state in the config's stored
        layouts (DTensors where sharded) and log the ZeRO decisions."""
        from paddle_tpu_torch.parallel import spmd
        par = self.parallel
        values = self.parameters.values
        self._shapes = {k: tuple(v.shape) for k, v in values.items()}
        self._update_layouts = par.zero_update_shardings(values)
        self._store_layouts = par.store_shardings(values)
        self.opt_state = spmd.shard_state(par, self.opt_state)
        self.parameters.values = par.shard_params(values)
        if par.zero_stage >= 1:
            rep = par.zero_report(values)
            logger.debug(
                "zero=%d over %s=%d: %d param states sharded, %d "
                "replicated (%s)", rep["zero_stage"], rep["axis"],
                rep["axis_size"], len(rep["sharded"]),
                len(rep["replicated"]),
                ", ".join(f"{k}: {v}" for k, v in rep["replicated"].items())
                or "none")

    def _leaves(self) -> Dict[str, torch.Tensor]:
        """Leaf tensors sharing storage with ``parameters.values`` for
        autograd to differentiate against (the optimizer then writes the
        values in place, after the graph is gone). Under ``parallel=`` a
        sharded stored leaf is all-gathered to its compute layout first
        (the ZeRO-3 / TP gather on use)."""
        if self.parallel is None:
            return {k: v.detach().requires_grad_()
                    for k, v in self.parameters.values.items()}
        from paddle_tpu_torch.parallel import spmd
        out = {k: spmd.full(self.parameters.values[k], tag="on_use")
               .detach().requires_grad_()
               for k in sorted(self.parameters.values)}
        return {k: out[k] for k in self.parameters.values}

    def _batch_ranks(self, feeds) -> int:
        """The number of ranks the batch axes split ``feeds`` over; a
        ValueError when a feed's rows do not divide by it."""
        from paddle_tpu_torch.parallel import spmd
        par = self.parallel
        n = spmd.axis_size(par.mesh, par.batch_axes())
        bad = sorted({t.shape[0] for t in _feed_tensors(feeds)
                      if t.shape[0] % n})
        if bad:
            raise ValueError(
                f"a batch of {bad[0]} rows does not divide over the batch "
                f"axes {par.batch_axes()} of {n} ranks: use a batch size "
                f"(and, under grad accumulation, a microbatch) that is a "
                f"multiple of {n}, or drop_last=True")
        return n

    def _rank_rows(self, feeds):
        """This rank's rows of a global batch (the batch axes' split).
        A batch whose rows do not divide over the batch axes raises
        ValueError on every rank alike, before any collective (the JAX
        trainer's ``device_put`` refuses it too): each rank's mean is
        weighted 1/N in the gradient and the cost."""
        from paddle_tpu_torch.parallel import spmd
        par = self.parallel
        axes = par.batch_axes()
        n = self._batch_ranks(feeds)
        if n == 1:
            return feeds
        i = spmd.axis_index(par.mesh, axes)
        return {k: _split_value(v, n)[i] for k, v in feeds.items()}

    def _loss_and_grads(self, feeds, state, dropout_key):
        """Forward in training mode on ``feeds``: (mean fp32 cost, the
        outputs, the new state, {name: gradient}). Under ``parallel=``
        the feeds are the global batch: the forward runs on this rank's
        rows, the returned cost is the global mean, and each gradient is
        of this rank's share of it (``_reduce`` sums them)."""
        leaves = self._leaves()
        scale, sync = 1.0, contextlib.nullcontext()
        if self.parallel is not None:
            from paddle_tpu_torch.ops import norm as ops_norm
            from paddle_tpu_torch.parallel import spmd
            par = self.parallel
            feeds = self._rank_rows(feeds)
            nb = spmd.axis_size(par.mesh, par.batch_axes())
            scale = 1.0 / nb
            if nb > 1:
                # batch norm over the global batch, as the GSPMD step
                sync = ops_norm.synced_statistics(
                    lambda t: spmd.all_reduce(t, par.mesh, par.batch_axes(),
                                              tag="bn"),
                    lambda t: spmd.all_reduce(t, par.mesh, par.batch_axes(),
                                              op="max", tag="bn"))
        with sync:
            outs, new_state = self._forward(leaves, state, feeds,
                                            is_training=True,
                                            dropout_key=dropout_key)
            loss = outs[self.cost.name].array.float().mean()
            got = torch.autograd.grad(loss * scale, list(leaves.values()),
                                      allow_unused=True)
        grads = {k: (g if g is not None else torch.zeros_like(v))
                 for (k, v), g in zip(leaves.items(), got)}
        new_state = {k: v.detach() for k, v in new_state.items()}
        loss = loss.detach()
        if self.parallel is not None:
            from paddle_tpu_torch.parallel import spmd
            par = self.parallel
            loss = spmd.all_reduce(loss, par.mesh, par.batch_axes(),
                                   op="mean", tag="cost")
            for m in self._metric_names:
                if m in outs and outs[m].array.is_floating_point():
                    outs[m] = Value(spmd.all_reduce(
                        outs[m].array.detach(), par.mesh,
                        par.batch_axes(), tag="metric"))
        return loss, outs, new_state, grads

    def _reduce(self, grads, accum: bool = False):
        """Gradients of the rank's share -> the global batch's, in the
        update layout: all-reduced whole (stage 0), or reduce-scattered
        into the ZeRO shard (stage >= 2, and the accumulation carry from
        stage 1); TP-stored leaves keep their own shard."""
        from paddle_tpu_torch.parallel import spmd
        par = self.parallel
        sharded = par.zero_stage >= 2 or (accum and par.zero_stage >= 1)
        out = spmd.reduce_grads(par, grads, self._update_layouts, sharded)
        for k, g in out.items():
            lay = self._store_layouts[k]
            if not lay.is_fully_replicated and g.shape == self._shapes[k]:
                out[k] = lay.shard(g)
        return out

    def _note_resident(self):
        """Each stored parameter's resident bytes into the active
        collective record (``spmd.record_collectives``), as the JAX
        package's HLO shows the step's parameter arguments."""
        if self.parallel is not None:
            from paddle_tpu_torch.parallel import spmd
            for k in sorted(self.parameters.values):
                spmd.note_resident(spmd.param_bytes(
                    self.parameters.values[k]))

    def _update(self, step, grads):
        """The optimizer step: ``optimizer.update`` in place, or under
        ``parallel=`` the ZeRO update (``spmd.zero_constrained_update``)
        with the state re-wrapped in its stored layout."""
        if self.parallel is None:
            _, self.opt_state = self.optimizer.update(
                step, grads, self.parameters.values, self.opt_state)
            return
        from paddle_tpu_torch.parallel import spmd
        par = self.parallel
        if par.zero_stage >= 1:
            grads = {k: (g if g.shape != self._shapes[k]
                         or spmd._zero_dim_of(self._update_layouts[k].spec,
                                              par.batch_axis) is None
                         else self._update_layouts[k].shard(g))
                     for k, g in grads.items()}
            _, new = spmd.zero_constrained_update(
                par, self.optimizer, step, grads, self.parameters.values,
                spmd.local_tree(self.opt_state),
                update_shardings=self._update_layouts)
        else:
            work = {k: spmd.local(v) for k, v in
                    self.parameters.values.items()}
            _, new = self.optimizer.update(step, grads, work,
                                           spmd.local_tree(self.opt_state))
        self.opt_state = self._wrap_state(new)

    def _wrap_state(self, new):
        """The optimizer's new (local) state in its stored layout."""
        from paddle_tpu_torch.parallel import spmd

        def wrap(v, lay, shape):
            if isinstance(v, (tuple, list)):
                return type(v)(wrap(x, l, shape) for x, l in zip(v, lay))
            if isinstance(v, dict):
                return {kk: wrap(x, lay[kk], shape) for kk, x in v.items()}
            if not isinstance(v, torch.Tensor) or v.ndim == 0:
                return v
            spec = lay.spec
            if all(spmd.axis_size(lay.mesh, e) == 1 for e in spec) \
                    or tuple(v.shape) == tuple(shape):
                return v
            return spmd.as_dtensor(v, lay, shape)

        # the layouts follow the parameters' GLOBAL shapes
        glays = self.parallel.state_shardings(
            {k: _zeros_like_tree(v, self._shapes[k])
             for k, v in new.items()})
        return {k: wrap(v, glays[k], self._shapes[k])
                for k, v in new.items()}

    def _plain_train_step(self, feeds, step, dropout_key):
        """One step on the whole batch: returns (loss, outputs); the
        parameters, the optimizer state and the model state advance."""
        self._note_resident()
        loss, outs, new_state, grads = self._loss_and_grads(
            feeds, self.parameters.state, dropout_key)
        if self.parallel is not None:
            grads = self._reduce(grads)
        self._update(step, grads)
        self.parameters.state = new_state
        return loss, outs

    def _accum_train_step(self, feeds, step, dropout_key):
        """Microbatched step: ``grad_accum_steps`` slices of the batch,
        in order; fp32 gradients summed and divided by n, the model state
        (BN running stats) threaded from slice to slice, the slices'
        metric accumulables summed (additive by contract,
        evaluator.MetricAccumulator — except the batch-local pnpair
        counts, warned about in __init__). Returns (mean loss, metric
        outputs). Under ``parallel=`` each slice of the global batch is
        split over the ranks and reduced into the accumulator in its
        update layout (the ZeRO shard from stage 1)."""
        n = self.grad_accum_steps
        if self.parallel is not None:
            self._batch_ranks(feeds)
        self._note_resident()
        parts = {k: _split_value(v, n) for k, v in feeds.items()}
        keys = prng.split(dropout_key, n)
        values = self.parameters.values
        acc = None
        state, losses, mets = self.parameters.state, [], {}
        for i in range(n):
            loss, outs, state, g = self._loss_and_grads(
                {k: p[i] for k, p in parts.items()}, state, keys[i])
            if self.parallel is not None:
                g = self._reduce(g, accum=True)
            if acc is None:
                acc = {k: torch.zeros(v.shape, dtype=torch.float32,
                                      device=v.device)
                       for k, v in g.items()}
            for k in acc:
                acc[k] += g[k].float()
            for m in self._metric_names:
                if m in outs:
                    a = outs[m].array.detach().float()
                    mets[m] = a if m not in mets else mets[m] + a
            losses.append(loss)
        from paddle_tpu_torch.parallel import spmd
        grads = {k: (acc[k] / n).to(spmd.local(values[k]).dtype)
                 for k in acc}
        self._update(step, grads)
        self.parameters.state = state
        return (torch.stack(losses).mean(),
                {m: Value(v) for m, v in mets.items()})

    @torch.no_grad()
    def _eval_step(self, feeds):
        values = self.parameters.values
        if self.parallel is not None:
            from paddle_tpu_torch.parallel import spmd
            values = {k: spmd.full(values[k]) for k in sorted(values)}
        outs, _ = self._forward(values, self.parameters.state, feeds,
                                is_training=False)
        return outs[self.cost.name].array.float().mean(), outs

    def _pick_train_step(self, feeds):
        """Accumulated step when the batch divides by grad_accum_steps;
        otherwise (ragged drop_last=False tail) the plain step — crashing
        at the end of a pass over a remainder batch is not acceptable."""
        if self.grad_accum_steps == 1:
            return self._plain_train_step
        leaves = _feed_tensors(feeds)
        # every leaf must share the batch dim AND divide evenly; a
        # non-batched auxiliary input falls back to the plain step
        if (leaves
                and all(l.ndim >= 1 and l.shape[0] == leaves[0].shape[0]
                        for l in leaves)
                and leaves[0].shape[0] % self.grad_accum_steps == 0):
            return self._accum_train_step
        return self._plain_train_step

    # -- resident bytes ----------------------------------------------------
    def opt_state_bytes_per_device(self) -> int:
        """Optimizer-state bytes resident on the device."""
        return _state_bytes(self.opt_state)

    def param_bytes_per_device(self) -> int:
        """Parameter bytes resident on the device between steps."""
        return _state_bytes(self.parameters.values)

    def grad_bytes_per_device(self) -> int:
        """Bytes of the longest-lived gradient object: the fp32
        accumulator under grad accumulation, else the gradients at the
        update point (the parameters' dtype) — in the config's gradient
        layout under ``parallel=`` (1/N shards from ZeRO stage 2, and
        for the accumulator from stage 1)."""
        accum = self.grad_accum_steps > 1
        total = 0
        for k, v in self.parameters.values.items():
            n = v.numel()
            if self.parallel is not None:
                from paddle_tpu_torch.parallel import spmd
                par = self.parallel
                spec = par.grad_spec(k, self._shapes[k], accum)
                n = int(np.prod(self._shapes[k] or (1,)))
                for e in spec:
                    n //= spmd.axis_size(par.mesh, e)
            total += n * (4 if accum else v.element_size())
        return total

    def _feeder(self, feeding, device=None):
        """The DataFeeder for ``feeding``, placing on ``device`` (default:
        the trainer's; the pipeline's host-side convert asks for the
        CPU)."""
        device = self.device if device is None else torch.device(device)
        key = (tuple(sorted(feeding.items())) if feeding else None,
               str(device))
        if key not in self._feeder_cache:
            dtypes = {l.name: l.data_spec for l in self.topology.data_layers}
            self._feeder_cache[key] = DataFeeder(dtypes, feeding,
                                                 device=device)
        return self._feeder_cache[key]

    def count_step_flops(self, feeds, dropout_key=None) -> float:
        """FLOPs of one forward + backward on ``feeds`` as
        ``FlopCounterMode`` counts them (``observe.costs.counted_flops``).
        Gradients come from ``torch.autograd.grad`` and are dropped: the
        parameters, their ``.grad``, the optimizer state, the model state
        and the compile tracker are left as they were. Under
        ``parallel=`` it counts this rank's share of the step on stand-in
        parameters of the compute shapes, so it issues no collective
        (a rank may count where its peers do not)."""
        if self.parallel is None:
            leaves = self._leaves()
        else:
            leaves = {k: torch.zeros(self._shapes[k],
                                     dtype=v.dtype, device=v.device)
                      .requires_grad_()
                      for k, v in self.parameters.values.items()}
            feeds = self._rank_rows(feeds)

        def run():
            outs, _ = self._forward(leaves, self.parameters.state, feeds,
                                    is_training=True,
                                    dropout_key=dropout_key)
            loss = outs[self.cost.name].array.float().mean()
            torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
        return observe.costs.counted_flops(run)

    def _flops_for(self, sig, feeds, dropout_key):
        """The MFU numerator of this step signature, counted once per
        signature, and only when an observability consumer exists
        (metrics sink or handler): the count runs a forward and backward
        under the FLOP counter, which nobody would read otherwise."""
        if sig in self._step_flops:
            return self._step_flops[sig]
        if not observe.has_consumers():
            return None
        flops = self.count_step_flops(feeds, dropout_key)
        self._step_flops[sig] = flops
        return flops

    def attach_observability(self, host: str = "127.0.0.1",
                             port: int = 0):
        """Serve ``/metrics`` (default registry, Prometheus text) and
        ``/healthz`` (step progress: step count, last loss, seconds
        since the last finished step, compile count) for this trainer.
        Returns the started ``observe.HealthServer`` — callers own its
        ``close()``. ``port=0`` binds an ephemeral port."""

        def health():
            since = (round(time.perf_counter() - self._last_step_wall, 3)
                     if self._last_step_wall is not None else None)
            return {
                "step": self._step,
                "last_loss": self._last_cost,
                "seconds_since_step": since,
                "compile_count":
                    observe.default_compile_tracker().count("train_step"),
            }

        return observe.HealthServer(health_fn=health, host=host, port=port)

    def _telemetry_doc(self) -> dict:
        """The per-beat gang telemetry payload: this rank's registry
        snapshot (counters + gauges; histograms don't aggregate), its
        raw step window for the pooled gang quantiles, and the goodput
        accountant's buckets. All O(registry) dict work, no device
        sync. (The distributed barrier window joins with the gang
        supervisor, ROADMAP A10b.)"""
        snap = {name: doc for name, doc in
                observe.default_registry().snapshot().items()
                if doc.get("kind") in ("counter", "gauge")}
        window = {}
        mon = getattr(self, "_monitor", None)
        if mon is not None:
            window["step_time_samples"] = \
                mon.step_window.export_samples()
        doc = {"snapshot": snap, "window": window}
        acct = getattr(self, "_acct", None)
        if acct is not None:
            gp = acct.snapshot()
            doc["goodput"] = {"buckets": gp["buckets"],
                              "t_start_wall": gp["t_start_wall"]}
        return doc

    # -- public API --------------------------------------------------------
    def train(self, reader, num_passes=1,
              event_handler: Optional[Callable] = None,
              feeding: Optional[Dict[str, int]] = None,
              checkpoint_dir: Optional[str] = None,
              prefetch: int = 0):
        """Train ``num_passes`` passes over ``reader`` (a zero-arg
        callable yielding batches), firing the v2 events.

        checkpoint_dir: when set, checkpoints (params + optimizer state +
        model state, and the pipeline's stream position) are written
        asynchronously every ``checkpoint_period`` batches (flag; 0 = once
        per pass), and training resumes from the latest intact checkpoint
        found there (reference: ParamUtil per-pass dirs +
        --init_model_path/--start_pass, trainer/ParamUtil.cpp).

        prefetch: >0 feeds through the async input pipeline
        (``paddle_tpu_torch.pipeline``) with a staging ring of that many
        batches — conversion and the host→device copy run on pipeline
        threads, so step N+1's feeds are on the device while step N
        executes. ``reader`` may also BE a ``pipeline.Pipeline``
        (prefetch implied), which makes resume exact: the pipeline's
        stream position rides inside every checkpoint, and a restore
        continues mid-epoch on the exact next batch. 0 keeps the
        synchronous one-batch-lookahead path.

        The chaos knob (PADDLE_TPU_CHAOS, site ``step``) is honored at
        the top of every batch. The elastic supervisor contract
        (PADDLE_ELASTIC_DIR) needs the gang supervisor (ROADMAP A10b) and
        raises ``NotImplementedError``."""
        if os.environ.get("PADDLE_ELASTIC_DIR"):
            raise NotImplementedError(
                "PADDLE_ELASTIC_DIR is set: the elastic supervisor "
                "contract (runtime/supervisor.py heartbeats and fencing) "
                "is not ported yet — ROADMAP A10b")
        event_handler = event_handler or (lambda e: None)
        feeder = self._feeder(feeding)
        from paddle_tpu_torch.pipeline import Pipeline
        pipe, own_pipe = None, False
        if isinstance(reader, Pipeline):
            pipe = reader
        elif prefetch and int(prefetch) > 0:
            # without a checkpoint dir the wrapped pipeline's state can
            # never be consumed — skip the per-batch snapshot entirely
            pipe = Pipeline(reader, prefetch=int(prefetch),
                            track_state=checkpoint_dir is not None)
            own_pipe = True
        if pipe is not None:
            if self.device.type == "cuda":
                # convert on the host, copy on the feed thread's stream
                pipe.attach(convert=self._feeder(feeding, "cpu").feed,
                            transfer=DeviceTransfer(self.device))
            else:
                pipe.attach(convert=feeder.feed)
        try:
            self._train_with(reader, num_passes, event_handler, feeder,
                             checkpoint_dir, pipe)
        finally:
            if own_pipe:
                pipe.close()   # user-passed pipelines stay open: their
                               # state_dict/resume lifecycle is theirs

    def _train_with(self, reader, num_passes, event_handler, feeder,
                    checkpoint_dir, pipe):
        ks = global_key_source()
        log_period = GLOBAL_FLAGS.get("log_period", 100)
        # flag-driven JSONL metrics sink (PADDLE_TPU_METRICS_PATH or
        # paddle.init(metrics_path=...)); an explicitly observe.configure()d
        # sink wins, but the flag — which paddle.init may have (re)set to a
        # DIFFERENT path — beats the env-autoconfigured sink and an
        # earlier value of itself
        mpath = GLOBAL_FLAGS.get("metrics_path")
        if mpath and not observe.explicitly_disabled() and (
                observe.sink() is None
                or (observe.sink_source() in ("env", "flag")
                    and observe.sink().path != mpath)):
            observe.configure(mpath, _source="flag")
        self._check_finite = (GLOBAL_FLAGS.get("debug_nans") or
                              GLOBAL_FLAGS.get("debug_infs"))
        # goodput accounting for this run: the accountant's birth is the
        # "startup ends here" mark
        self._acct = observe.StepAccountant()
        ckpt = None
        if checkpoint_dir is not None:
            from paddle_tpu_torch.io import checkpoint as ckpt_io
            t_restore0 = time.perf_counter()
            latest = ckpt_io.latest_checkpoint(checkpoint_dir)
            if latest:
                self._restore(ckpt_io, latest)
                if pipe is not None and pipe.track_state:
                    ps = ckpt_io.load_pipeline_state(latest)
                    if ps is not None:
                        # continue the data stream mid-epoch on the
                        # exact next batch (shuffle RNG, shard cursor,
                        # in-flight samples all restored)
                        pipe.load_state_dict(ps)
                logger.info("resumed from %s (step %d)", latest, self._step)
                self._acct.add("restore",
                               time.perf_counter() - t_restore0)
            ckpt = ckpt_io.AsyncCheckpointer(checkpoint_dir,
                                             **self._ckpt_processes())
        # the run's writer stays readable after it closes (write_seconds)
        self.last_checkpointer = ckpt
        recorder = observe.default_flight_recorder()
        dumps_before = len(recorder.dumped_paths)
        try:
            self._train_passes(reader, num_passes, event_handler, feeder,
                               ks, log_period, ckpt,
                               GLOBAL_FLAGS.get("checkpoint_period", 0),
                               pipe=pipe)
        except Exception as e:
            # post-mortem for any crash escaping the loop — but only
            # when a flight dir is explicitly configured, and not when
            # the NaN tripwire already dumped
            from paddle_tpu_torch.observe import flight as _flight
            if (_flight.configured()
                    and len(recorder.dumped_paths) == dumps_before):
                recorder.dump(reason="exception in training loop", exc=e)
            raise
        finally:
            if ckpt is not None:
                ckpt.close()

    def _ckpt_processes(self) -> dict:
        """Each rank of a parallel trainer writes its own shards (the
        ``@@i`` layout, one file set per process)."""
        if self.parallel is None:
            return {}
        from paddle_tpu_torch import distributed
        return {"process_index": distributed.process_index(),
                "process_count": distributed.process_count()}

    def _zero_meta(self):
        """The opt-state layout this trainer runs under, for checkpoint
        manifests (None for local / zero=0 training)."""
        par = self.parallel
        if par is None or par.zero_stage < 1:
            return None
        return {"zero_stage": int(par.zero_stage), "axis": par.batch_axis,
                "axis_size": par.zero_axis_size()}

    def _ckpt_meta(self):
        z = self._zero_meta()
        return {"zero": z} if z is not None else None

    def _restore(self, ckpt_io, path):
        """Adopt the checkpoint at ``path``: the step counter, the
        parameters (copied into the existing tensors, in place), the
        optimizer state and the model state, on this trainer's device in
        its dtypes. Under ``parallel=`` the checkpoint's shards merge
        into whole arrays at load, which this trainer's layouts then
        shard again: a restore onto another mesh size or zero stage IS
        the reshard."""
        if self.parallel is not None:
            from paddle_tpu_torch.parallel import spmd
            saved = (ckpt_io.checkpoint_meta(path) or {}).get("zero")
            if saved != self._zero_meta():
                logger.info("checkpoint opt-state layout %s -> restoring "
                            "into %s (resharding)", saved,
                            self._zero_meta())
            step, values, opt_state, state = ckpt_io.load_checkpoint(
                path, spmd.full_tree(self.parameters.values),
                spmd.full_tree(self.opt_state), self.parameters.state)
            values = {k: values[k] for k in self.parameters.values}
            self.parameters.values = self.parallel.shard_params(values)
            self.opt_state = spmd.shard_state(self.parallel, opt_state)
            self._step = int(step)
            self.parameters.state = state
            return
        step, values, opt_state, state = ckpt_io.load_checkpoint(
            path, self.parameters.values, self.opt_state,
            self.parameters.state)
        with torch.no_grad():
            for k, v in values.items():
                self.parameters.values[k].copy_(v)
        self._step = int(step)
        self.opt_state = opt_state
        self.parameters.state = state

    def _save_checkpoint(self, ckpt, pipe, acct):
        """Hand the current state to the async writer; only the
        synchronous part (the pipeline's state, the snapshot + enqueue)
        is checkpoint overhead — the write overlaps the next steps. The
        save's entry in ``ckpt.save_parts`` gains ``state_dict_s``, the
        seconds taken by the pipeline's ``state_dict()``."""
        save_t0 = time.perf_counter()
        state = (pipe.state_dict() if pipe is not None and pipe.track_state
                 else None)
        state_s = time.perf_counter() - save_t0
        parts = ckpt.save(self._step, self.parameters.values,
                          self.opt_state, self.parameters.state,
                          pipeline_state=state, meta=self._ckpt_meta())
        parts["state_dict_s"] = state_s
        acct.add("checkpoint_save", time.perf_counter() - save_t0)

    def _prefetch_feeds(self, reader, feeder):
        """One-batch-lookahead feed pipeline: batch N+1 is fed (converted
        and copied to the device) BEFORE batch N is yielded, so on the
        card its copy is queued behind batch N's launches instead of
        after the step's host sync (the reference's data providers
        double-buffer the same way — PyDataProvider2.cpp:195)."""
        prev = None
        it = iter(reader())
        while True:
            try:
                data_batch = next(it)
                with observe.trace_scope("feed"):
                    with observe.trace_scope("convert"):
                        feeds = feeder.feed(data_batch)
            except StopIteration:
                break
            except Exception:
                # batch N is already fed; train it before surfacing
                # batch N+1's failure, or the crash would both lose N
                # and point at the wrong batch index
                if prev is not None:
                    yield prev
                    prev = None
                raise
            if prev is not None:
                yield prev
            prev = feeds
        if prev is not None:
            yield prev

    def _train_passes(self, reader, num_passes, event_handler, feeder, ks,
                      log_period, ckpt=None, period=0, pipe=None):
        monitor = _StepMonitor(
            opt_state_bytes=self.opt_state_bytes_per_device(),
            grad_bytes=self.grad_bytes_per_device(),
            param_bytes=self.param_bytes_per_device(),
            device=self.device)
        # published so a telemetry thread can export the raw step window
        self._monitor = monitor
        acct = getattr(self, "_acct", None)
        if acct is None:
            acct = self._acct = observe.StepAccountant()
        for pass_id in range(num_passes):
            event_handler(events.BeginPass(pass_id))
            self.evaluators.reset()
            pass_t0 = time.perf_counter()
            pass_examples = 0
            # pipelined mode: one iter() == one epoch, resuming mid-epoch
            # after a restore; feeds arrive converted and on the device
            feed_iter = (iter(pipe) if pipe is not None
                         else self._prefetch_feeds(reader, feeder))
            batch_id = -1
            while True:
                # feed wait timed explicitly: the input component of the
                # step's bottleneck attribution (sync path: convert + H2D
                # of the NEXT batch; pipelined: the staging-ring get)
                feed_t0 = time.perf_counter()
                try:
                    feeds = next(feed_iter)
                except StopIteration:
                    break
                # the step's stream waits for the feeds' side-stream copy
                adopt(feeds)
                feed_s = time.perf_counter() - feed_t0
                batch_id += 1
                # chaos site 'step': kill/hang/crash BEFORE the step
                # executes, so "kill at step k" means exactly k steps
                # are committed (runtime/chaos.py; no-op without the
                # PADDLE_TPU_CHAOS env knob)
                _chaos.maybe_trigger("step", step=self._step)
                event_handler(events.BeginIteration(pass_id, batch_id))
                step_fn = self._pick_train_step(feeds)
                # feed-shape signature: params/opt/state shapes are fixed
                # per run, so the feeds (plus which step) key the step
                sig = (step_fn.__name__,) + _feed_signature(feeds)
                dropout_key = ks.step("dropout", self._step)
                # the one-time FLOP count stays OUTSIDE the timed window
                flops = self._flops_for(sig, feeds, dropout_key)
                step_t0 = time.perf_counter()
                with observe.step_scope(self._step, "train_step"):
                    with observe.trace_scope("dispatch"):
                        loss, outs = step_fn(feeds, self._step, dropout_key)
                dispatch_s = time.perf_counter() - step_t0
                self._step += 1
                # float(loss) is the host sync — per-step wall time must
                # include it or asynchronous launches hide the real step
                sync_t0 = time.perf_counter()
                with observe.trace_scope("host_sync"):
                    cost = float(loss)
                sync_s = time.perf_counter() - sync_t0
                step_dt = time.perf_counter() - step_t0
                # the accumulables' host read follows the sync, so the
                # device's time lands in sync_s
                self.evaluators.add_batch(outs)
                tracker = observe.default_compile_tracker()
                n0 = tracker.count("train_step")
                tracker.record("train_step", sig, step_dt)
                # goodput split: an unseen signature is a new program —
                # the steady median stays useful, the excess is recompile
                acct.step(step_dt, feed_s=feed_s,
                          compile_miss=tracker.count("train_step") > n0,
                          median_s=monitor.median())
                self._last_step_wall = time.perf_counter()
                self._last_cost = cost
                bs = int(next(iter(feeds.values())).array.shape[0])
                pass_examples += bs
                _, eps = monitor.step(
                    step=self._step - 1, pass_id=pass_id, batch_id=batch_id,
                    cost=cost, batch_size=bs, dt=step_dt, flops=flops,
                    compile_count=tracker.count("train_step"),
                    feed_s=feed_s, dispatch_s=dispatch_s, sync_s=sync_s)
                if self._check_finite and not math.isfinite(cost):
                    from paddle_tpu_torch.utils import enforce
                    try:
                        enforce.check_numerics(self.parameters.values,
                                               "param")
                        raise enforce.EnforceError(
                            f"non-finite cost {cost} at pass {pass_id} "
                            f"batch {batch_id} (params are finite — check "
                            f"inputs/loss)")
                    except enforce.EnforceError as e:
                        # the NaN tripwire is a flight-recorder trigger:
                        # leave the post-mortem before the raise unwinds
                        observe.default_flight_recorder().dump(
                            reason=f"non-finite cost {cost} (debug_nans "
                                   f"tripwire)", exc=e)
                        raise
                if log_period and batch_id % log_period == 0:
                    monitor.update_memory_gauges()
                    logger.info("pass %d batch %d cost %.5f %s "
                                "(%.1f ex/s)", pass_id, batch_id, cost,
                                self.evaluators.result(), eps)
                event_handler(events.EndIteration(
                    pass_id, batch_id, cost, self.evaluators,
                    wall_time_s=step_dt, examples_per_sec=eps))
                if ckpt is not None and period and self._step % period == 0:
                    self._save_checkpoint(ckpt, pipe, acct)
            if ckpt is not None and not period:
                self._save_checkpoint(ckpt, pipe, acct)
            monitor.update_memory_gauges()
            pass_dt = time.perf_counter() - pass_t0
            if observe.has_consumers():
                mets = {}
                for k, v in (self.evaluators.result() or {}).items():
                    try:
                        mets[k] = float(v)
                    except (TypeError, ValueError):
                        pass
                observe.report(
                    kind="pass", pass_id=pass_id, step=self._step,
                    wall_time_s=round(pass_dt, 6), examples=pass_examples,
                    examples_per_sec=round(
                        pass_examples / pass_dt if pass_dt > 0 else 0.0, 2),
                    recompiles=int(monitor.recompiles.value()),
                    metrics=mets)
                s = observe.sink()
                if s is not None:
                    s.flush()      # a finished pass must be tail-able
            event_handler(events.EndPass(pass_id, self.evaluators))

    def test(self, reader, feeding: Optional[Dict[str, int]] = None):
        """One evaluation sweep (reference: trainer.py:204 SGD.test)."""
        feeder = self._feeder(feeding)
        self.evaluators.reset()
        total, n = 0.0, 0
        for data_batch in reader():
            feeds = feeder.feed(data_batch)
            loss, outs = self._eval_step(feeds)
            self.evaluators.add_batch(outs)
            # record count: pre-batched column tuples carry it in the
            # leading axis; sample lists in their length
            if isinstance(data_batch, tuple):
                bs = int(next(iter(feeds.values())).array.shape[0])
            else:
                bs = len(data_batch)
            total += float(loss) * bs
            n += bs
        return events.TestResult(self.evaluators,
                                 cost=total / max(n, 1))

    def save_parameter_to_tar(self, f):
        if self.parallel is None:
            self.parameters.to_tar(f)
            return
        from paddle_tpu_torch.parallel import spmd
        stored = self.parameters.values
        self.parameters.values = {k: spmd.full(stored[k]) for k in stored}
        try:
            self.parameters.to_tar(f)
        finally:
            self.parameters.values = stored
