"""Ring-buffer KV cache layout helpers (counterpart of
``repro/serve/cache.py``).

Per layer, batch b, capacity C: payload ``k``/``v`` (L, b, C, KV, hd) in
fp8 or f32; scales ``k_scale``/``v_scale`` (L, b, C, KV) f32 for fp8
payloads; ``len`` (b,) i32, each sequence's absolute decode position.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.quant import quant


def ring_capacity(window: int, max_len: int) -> int:
    """Slots the ring needs: the window, capped by the sequence budget."""
    if window <= 0:
        raise ValueError("ring cache needs window > 0 (window=0 is full "
                         "causal: use the dense layout)")
    return min(window, max_len)


def encode_rows(x: torch.Tensor, fmt: str | None, scale_mode: str):
    """Quantize cache rows (..., hd) to (payload, scale (...,)); ``fmt=None``
    stores f32 with no scale."""
    if fmt is None:
        return x.float(), None
    return quant.quantize_rows(x.float(), fmt, scale_mode)


def write_slot(cache: torch.Tensor, new: torch.Tensor,
               slot: torch.Tensor) -> torch.Tensor:
    """Write one decode step into per-sequence slots, IN PLACE.

    cache (b, C, ...), new (b, 1, ...), slot (b,) -- an indexed scatter over
    the batch axis (the JAX package's vmapped dynamic_update_slice), done in
    place so a decode step never copies the cache. Returns ``cache``."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, slot.long()] = new[:, 0].to(cache.dtype)
    return cache


def prefill_gather_index(seq_len: int, capacity: int) -> np.ndarray:
    """Source position feeding each ring slot after prefilling ``seq_len``
    tokens: the latest p <= seq_len - 1 with ``p % capacity == s``. Slots no
    position maps to come out NEGATIVE (the caller zero-fills them)."""
    s = np.arange(capacity)
    return s + capacity * ((seq_len - 1 - s) // capacity)


def cache_bytes(cache: dict) -> int:
    """Total KV-cache bytes (payload + scales)."""
    return sum(cache[key].numel() * cache[key].element_size()
               for key in ("k", "v", "k_scale", "v_scale") if key in cache)
