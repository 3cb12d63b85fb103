"""Serving: sampling, the block pool, the row-arena slot engine, the
paged decode engine and its speculative-decoding variant, the KV block
wire and the spill tiers."""

from paddle_tpu_torch.serving.engine import (DecodeEngine, EngineRequest,
                                             PagedDecodeEngine,
                                             SpecDecodeEngine)

__all__ = ["DecodeEngine", "EngineRequest", "PagedDecodeEngine",
           "SpecDecodeEngine"]
