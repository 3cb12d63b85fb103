"""Serving: sampling, the block pool and the paged decode engine."""

from paddle_tpu_torch.serving.engine import (EngineRequest,
                                             PagedDecodeEngine)

__all__ = ["EngineRequest", "PagedDecodeEngine"]
