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
- ``distributed.py``   joining the process group (NCCL on the card,
                       gloo on the CPU), barriers, hybrid meshes
- ``parallel/``        the multi-rank tier: ``spmd.py`` (sharding
                       rules, ZeRO 0-3, the explicit collectives),
                       ``compat.shard_map``, ring and all-to-all
                       attention (``ring.py``), the MoE's expert
                       parallelism (``moe.py``), GPipe and interleaved
                       pipelines (``pipeline.py``)
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
- ``trainer.py``       ``SGD``: the v2 training loop on one device
                       (plain and microbatched steps, evaluators,
                       events, the step monitor's metrics)
- ``models/``          the model zoo (AlexNet, VGG, GoogLeNet, ResNet,
                       smallnet, the text models, seq2seq, CTR), GAN
                       and VAE with their trainers, and the
                       transformer LM
- ``reader/``          ``minibatch.batch`` (``paddle_tpu_torch.batch``),
                       the reader creators and decorators
- ``dataset/``         the v2 datasets (mnist, cifar, uci_housing, imdb,
                       imikolov, sentiment, movielens, conll05, wmt14,
                       mq2007, voc2012, flowers): local files under
                       ``PADDLE_TPU_DATA_HOME``, else seeded synthetic
                       data of the same schema; nothing downloads
- ``image.py``, ``plot.py``, ``version.py``  host-side image transforms,
                       the cost-curve plotter, the version fields
- ``cli.py``           ``python -m paddle_tpu_torch train|test|time|
                       infer|checkgrad|stats|serve|route|top
- ``observe/``         metrics registry and the ``report()`` funnel,
                       MFU accounting, the compile tracker, SLO
                       windows, the request log, chrome traces, the
                       health server, the flight recorder, goodput and
                       the step bottleneck attribution
- ``utils/``           timers, the runtime flags the port reads, logging,
                       memory stats and the timing sync

Entry points run on the card unless the caller passes ``device="cpu"``;
``core.place.default_device()`` raises where there is no card.
"""

import importlib

from paddle_tpu_torch.version import __version__  # noqa: F401

# Submodules exposed lazily (PEP 562), as ``paddle_tpu`` does, so
# ``import paddle_tpu_torch`` stays fast and builds no kernel.
_SUBMODULES = (
    "utils", "core", "ops", "layer", "activation", "attr", "data_type",
    "initializer", "networks", "optimizer", "parameters", "pooling",
    "topology", "event", "inference", "evaluator", "parallel", "models",
    "io", "runtime", "recurrent", "projection", "observe", "serving",
    "record", "data_feeder", "trainer", "reader", "pipeline", "dataset",
    "image", "plot", "version", "distributed",
)

# names of ``paddle_tpu``'s surface still to port, with the ROADMAP item
# that brings each
_PENDING = {}


def __getattr__(name):
    if name in _SUBMODULES:
        mod = importlib.import_module(f"paddle_tpu_torch.{name}")
        globals()[name] = mod
        return mod
    if name == "infer":
        from paddle_tpu_torch.inference import infer
        return infer
    if name == "batch":
        from paddle_tpu_torch.reader.minibatch import batch
        return batch
    if name in _PENDING:
        raise AttributeError(
            f"paddle_tpu_torch.{name} is not ported yet (ROADMAP "
            f"{_PENDING[name]})")
    raise AttributeError(
        f"module 'paddle_tpu_torch' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_SUBMODULES) + ["infer", "batch"])


def init(**kwargs):
    """Global initialisation (counterpart of ``paddle_tpu.init``;
    reference: paddle.init / initMain, paddle/utils/Flags.cpp,
    python/paddle/v2/__init__.py:123).

    Sets the flags the port knows (``seed``, ``log_period``,
    ``metrics_path``, ``debug_nans``, ...) and ignores the rest, as the
    reference's init did; ``seed`` re-seeds the global key source
    (``utils/rng.reset_global_seed``). ``debug_nans`` / ``debug_infs``
    arm the trainer's non-finite-cost tripwire. There is no
    ``platform`` flag: every entry point takes its device."""
    from paddle_tpu_torch.utils import flags as _flags
    from paddle_tpu_torch.utils import rng as _rng
    for k, v in kwargs.items():
        _flags.GLOBAL_FLAGS.set_if_known(k, v)
    if kwargs.get("seed"):
        _rng.reset_global_seed(int(kwargs["seed"]))
    return _flags.GLOBAL_FLAGS
