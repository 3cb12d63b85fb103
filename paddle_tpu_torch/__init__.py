"""PyTorch + CUDA port of ``paddle_tpu`` for one NVIDIA H100.

The package mirrors ``paddle_tpu``'s module paths where a counterpart
exists, so a reader can put the two side by side:

- ``core/``            device placement, dtype names, length buckets,
                       and the step programs that capture and replay
                       CUDA graphs (``core/graphs.py``)
- ``ops/norm.py``, ``ops/loss.py``  layer norm, softmax cross-entropy
- ``ops/q8.py``        int8 weights and int8/int4 KV rows for serving
- ``io/lm_serving.py`` the serving artifact (formats v1-v5, no
                       compiled modules), ``LMServer.generate`` and
                       ``quantize_lm_params``: the int8-weight tree
- ``ops/kernels/``     the hand-written Hopper kernels (CUDA C++ under
                       ``csrc/``) that replace ``paddle_tpu/ops/pallas/``,
                       each beside its plain PyTorch version
- ``parallel/ring.py`` the plain single-device attention reference
- ``models/transformer.py``  the decoder-only LM's serving (paged and
                       arena steps, ``generate``, ``beam_search``) and
                       training paths
- ``optimizer.py``     schedules, regularization, clipping and the
                       per-array update rules over parameter trees
- ``serving/``         sampling, the block pool, the row-arena slot
                       engine and the paged engine with its tiers, tenant budgets and preemption,
                       the PTKV block wire (``transfer.py``), the
                       DRAM/disk spill store (``tiers.py``), and the
                       fleet: replicas, router and control plane
                       (``replica.py``, ``router.py``, ``autoscale.py``)
- ``runtime/``         record IO and its native codec, the data-dispatch
                       master and the fleet's replica processes
                       (``master.ServingFleet``), the launcher, the
                       restart budget
- ``layer.py``, ``networks.py``, ``recurrent.py``, ``projection.py``
                       the v2 layer API, compiled by ``topology.py`` into
                       one forward function, with ``parameters.py``,
                       ``data_feeder.py``, ``evaluator.py``,
                       ``inference.py`` and ``io/merged.py`` (the
                       merged-model artifact, replayable in both
                       packages)
- ``cli.py``           ``python -m paddle_tpu_torch serve|route|top``
- ``observe/``         metrics registry, MFU accounting, the compile
                       tracker, SLO windows, the request log, chrome
                       traces, the health server, the flight recorder
- ``utils/``           timers, the runtime flags the port reads, logging

Entry points run on the card unless the caller passes ``device="cpu"``;
``core.place.default_device()`` raises where there is no card.
"""

import importlib

__version__ = "0.1.0"

# Submodules exposed lazily (PEP 562), as ``paddle_tpu`` does, so
# ``import paddle_tpu_torch`` stays fast and builds no kernel.
_SUBMODULES = (
    "utils", "core", "ops", "layer", "activation", "attr", "data_type",
    "initializer", "networks", "optimizer", "parameters", "pooling",
    "topology", "event", "inference", "evaluator", "parallel", "models",
    "io", "runtime", "recurrent", "projection", "observe", "serving",
    "record", "data_feeder",
)

# names of ``paddle_tpu``'s surface still to port, with the ROADMAP item
# that brings each
_PENDING = {
    "trainer": "A7c", "reader": "A8", "dataset": "A8", "batch": "A8",
    "image": "A8", "plot": "A8", "pipeline": "A8", "distributed": "A9",
}


def __getattr__(name):
    if name in _SUBMODULES:
        mod = importlib.import_module(f"paddle_tpu_torch.{name}")
        globals()[name] = mod
        return mod
    if name == "infer":
        from paddle_tpu_torch.inference import infer
        return infer
    if name in _PENDING:
        raise AttributeError(
            f"paddle_tpu_torch.{name} is not ported yet (ROADMAP "
            f"{_PENDING[name]})")
    raise AttributeError(
        f"module 'paddle_tpu_torch' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_SUBMODULES) + ["infer"])
