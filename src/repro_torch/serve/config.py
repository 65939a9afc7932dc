"""Serving configuration (counterpart of ``repro/serve/config.py``)."""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import check_backend

KV_CACHES = ("dense", "ring")
KV_DTYPES = ("f32", "fp8_e4m3", "fp8_e5m2")

# kv_dtype knob -> repro_torch.quant format name (None = no quantization)
_QUANT_FMT = {"f32": None, "fp8_e4m3": "e4m3", "fp8_e5m2": "e5m2"}


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Decode-path serving knobs (``DecoderLM.init_cache/prefill/decode_step``).

    kv_cache: ``"ring"`` sizes the per-layer KV cache to the attention window
      (capacity ``min(window, max_len)``, token at position p in slot
      ``p % capacity``); with ``window == 0`` it falls back to the dense f32
      cache of ``max_len`` slots. ``"dense"`` is that dense cache.
    kv_dtype: ``"fp8_e4m3"``/``"fp8_e5m2"`` store an fp8 payload plus one f32
      scale per (token, KV head) row, which the decode kernel dequantizes on
      read; ``"f32"`` stores f32. fp8 requires the ring cache.
    scale_mode: per-row scale representation (``"fp32"`` | ``"pow2"``).
    window: sliding-window override; None inherits ``ArchConfig.sliding_window``,
      0 forces full causal (and thereby the dense cache).
    backend: ``"ref"`` | ``"cuda"`` | ``"auto"``; None inherits
      ``ArchConfig.backend``.
    """

    kv_cache: str = "ring"
    kv_dtype: str = "fp8_e4m3"
    scale_mode: str = "fp32"
    window: int | None = None
    backend: str | None = None

    def __post_init__(self):
        if self.kv_cache not in KV_CACHES:
            raise ValueError(f"unknown kv_cache {self.kv_cache!r}; expected "
                             f"{KV_CACHES}")
        if self.kv_dtype not in KV_DTYPES:
            raise ValueError(f"unknown kv_dtype {self.kv_dtype!r}; expected "
                             f"{KV_DTYPES}")
        if self.kv_dtype != "f32" and self.kv_cache != "ring":
            raise ValueError("fp8 KV payloads need kv_cache='ring' (the "
                             "dense path has no dequant-on-read hook)")
        check_backend(self.backend)

    @property
    def quant_fmt(self) -> str | None:
        return _QUANT_FMT[self.kv_dtype]

    def resolved_window(self, cfg) -> int:
        return cfg.sliding_window if self.window is None else self.window

    def is_ring(self, cfg) -> bool:
        """Whether the ring layout is actually in effect (window > 0)."""
        return self.kv_cache == "ring" and self.resolved_window(cfg) > 0
