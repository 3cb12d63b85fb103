"""Serving: sampling, the block pool, the paged decode engine and its
speculative-decoding variant, the KV block wire and the spill tiers."""

from paddle_tpu_torch.serving.engine import (EngineRequest,
                                             PagedDecodeEngine,
                                             SpecDecodeEngine)

__all__ = ["EngineRequest", "PagedDecodeEngine", "SpecDecodeEngine"]
