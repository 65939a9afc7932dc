"""fp8 rows codec (counterpart of ``repro/quant/quant.py:49-117``): the part
the serving KV cache uses. One scale per trailing row; the arithmetic is
the JAX package's, step for step, so scales and payload bits match it.

* ``scale = amax * FMT_INV_MAX`` (a multiply by the reciprocal constant),
  optionally rounded up to a power of two (``scale_mode="pow2"``);
* all-zero rows get scale 1;
* ``x / scale`` (a divide), then a clip to +-FMT_MAX before the cast:
  ``float8_e4m3fn`` has no inf and would turn an overflow into NaN.
"""

from __future__ import annotations

import torch

FORMATS: dict[str, torch.dtype] = {
    "e4m3": torch.float8_e4m3fn,
    "e5m2": torch.float8_e5m2,
}

# largest finite magnitude per format (e4m3fn has no inf: 448 then NaN)
FMT_MAX: dict[str, float] = {"e4m3": 448.0, "e5m2": 57344.0}

FMT_INV_MAX: dict[str, float] = {k: 1.0 / v for k, v in FMT_MAX.items()}


def compute_scale(amax: torch.Tensor, fmt: str,
                  scale_mode: str = "fp32") -> torch.Tensor:
    """Per-row scale mapping |x| <= amax onto the format's finite range."""
    if fmt not in FMT_MAX:
        raise ValueError(f"unknown fp8 format {fmt!r}; expected "
                         f"{sorted(FMT_MAX)}")
    s = amax.float() * torch.tensor(FMT_INV_MAX[fmt], dtype=torch.float32,
                                    device=amax.device)
    if scale_mode == "pow2":
        s = torch.exp2(torch.ceil(torch.log2(torch.clamp(s, min=2.0 ** -126))))
    elif scale_mode != "fp32":
        raise ValueError(f"unknown scale_mode {scale_mode!r}; "
                         f"expected 'fp32' | 'pow2'")
    return torch.where(amax > 0, s, torch.ones_like(s)).float()


def quantize_rows(x: torch.Tensor, fmt: str = "e4m3",
                  scale_mode: str = "fp32"
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., t) -> (payload fp8 (..., t), scale f32 (...,))."""
    x = x.float()
    amax = x.abs().amax(dim=-1)
    scale = compute_scale(amax, fmt, scale_mode)
    m = FMT_MAX[fmt]
    q = torch.clamp(x / scale[..., None], -m, m)
    return q.to(FORMATS[fmt]), scale


def dequantize_rows(payload: torch.Tensor, scale: torch.Tensor
                    ) -> torch.Tensor:
    """Inverse of :func:`quantize_rows` up to fp8 rounding; returns f32."""
    return payload.float() * scale[..., None]
