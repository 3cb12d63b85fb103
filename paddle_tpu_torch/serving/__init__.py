"""Serving: sampling, the block pool, the paged decode engine, the KV
block wire and the spill tiers."""

from paddle_tpu_torch.serving.engine import (EngineRequest,
                                             PagedDecodeEngine)

__all__ = ["EngineRequest", "PagedDecodeEngine"]
