"""Serving stack: KV caching and continuous batching (counterpart of
``repro.serve``). The decode hot path is the ``swa_decode`` op, which
launches the CUDA flash-decode kernel on the card."""

from repro_torch.serve.cache import cache_bytes, ring_capacity
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.scheduler import ContinuousBatcher, Request

__all__ = ["ServeConfig", "ContinuousBatcher", "Request", "cache_bytes",
           "ring_capacity"]
