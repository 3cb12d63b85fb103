"""PyTorch + CUDA port of ``paddle_tpu`` for one NVIDIA H100.

The package mirrors ``paddle_tpu``'s module paths where a counterpart
exists, so a reader can put the two side by side:

- ``core/``            device placement, dtype names, length buckets
- ``ops/norm.py``      layer norm
- ``ops/kernels/``     the hand-written Hopper kernels (CUDA C++ under
                       ``csrc/``) that replace ``paddle_tpu/ops/pallas/``,
                       each beside its plain PyTorch version
- ``models/transformer.py``  the decoder-only LM's serving path
- ``serving/``         sampling, the block pool and the paged engine
- ``observe/``         metrics registry and MFU accounting

Entry points run on the card unless the caller passes ``device="cpu"``;
``core.place.default_device()`` raises where there is no card.
"""

__version__ = "0.1.0"
