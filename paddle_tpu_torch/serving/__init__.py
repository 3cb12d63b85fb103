"""Serving: sampling, the block pool, the row-arena slot engine, the
paged decode engine and its speculative-decoding variant, the KV block
wire, the spill tiers, the fleet's data plane: the replica handles
and JSONL transports (``replica``) and the prefix-aware router with
P/D disaggregation (``router``), and its control plane: healing,
wedge kills and elastic capacity (``autoscale``)."""

from paddle_tpu_torch.serving.engine import (DecodeEngine, EngineRequest,
                                             PagedDecodeEngine,
                                             SpecDecodeEngine)
from paddle_tpu_torch.serving.replica import (EngineLoop, EngineReplica,
                                              ReplicaServer, SocketReplica,
                                              serve_stdio)
from paddle_tpu_torch.serving.router import Router, RouterRequest

__all__ = ["DecodeEngine", "EngineLoop", "EngineReplica", "EngineRequest",
           "PagedDecodeEngine", "ReplicaServer", "Router", "RouterRequest",
           "SocketReplica", "SpecDecodeEngine", "serve_stdio"]
