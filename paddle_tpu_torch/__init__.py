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
                       the PTKV block wire (``transfer.py``) and the
                       DRAM/disk spill store (``tiers.py``)
- ``observe/``         metrics registry, MFU accounting, the compile
                       tracker, SLO windows, the request log, chrome
                       traces, the health server, the flight recorder
- ``utils/``           timers, the runtime flags the port reads, logging

Entry points run on the card unless the caller passes ``device="cpu"``;
``core.place.default_device()`` raises where there is no card.
"""

__version__ = "0.1.0"
