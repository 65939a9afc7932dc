"""fp8 factor-history / wire payload quantization with per-block scales
(counterpart of ``repro/quant/quant.py``): the rows codec the serving KV
cache uses, and the optimizer-facing stat encode/decode.

Rows codec -- one scale per trailing row; the arithmetic is the JAX
package's, step for step, so scales and payload bits match it:

* ``scale = amax * FMT_INV_MAX`` (a multiply by the reciprocal constant),
  optionally rounded up to a power of two (``scale_mode="pow2"``) from the
  exponent bits, which is exact on every device;
* all-zero rows get scale 1;
* ``x / scale`` (a divide), then a clip to +-FMT_MAX before the cast:
  ``float8_e4m3fn`` has no inf and would turn an overflow into NaN.

Stats -- a symmetric blocked factor ``(lead..., nb, b, b)`` is stored
sym-packed, ``t = b(b+1)/2`` values per block and ONE scale per block, as
``{"payload": fp8 (lead..., nb, t), "scale": f32 (lead..., nb)}``; its
encode/decode go through the dispatch ops ``fp8_pack``/``fp8_unpack``
(the kernels on the card). Non-symmetric stats quantize over their last
axis with the plain rows codec, as the JAX package does. Decode always
returns f32.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch

FORMATS: dict[str, torch.dtype] = {
    "e4m3": torch.float8_e4m3fn,
    "e5m2": torch.float8_e5m2,
}

# largest finite magnitude per format (e4m3fn has no inf: 448 then NaN)
FMT_MAX: dict[str, float] = {"e4m3": 448.0, "e5m2": 57344.0}

FMT_INV_MAX: dict[str, float] = {k: 1.0 / v for k, v in FMT_MAX.items()}

# bytes per payload element / per-block scale (f32)
PAYLOAD_BYTES = 1
SCALE_BYTES = 4

# CLI spelling -> NGDConfig.factor_dtype value (--factor-dtype)
FACTOR_DTYPES: dict[str, Any] = {
    "f32": torch.float32,
    "bf16": torch.bfloat16,
    "fp8_e4m3": "fp8_e4m3",
    "fp8_e5m2": "fp8_e5m2",
}

# the smallest normal f32, the floor of a pow2 scale
_MIN_NORMAL = 2.0 ** -126


def parse_factor_dtype(factor_dtype: Any) -> Optional[str]:
    """``NGDConfig.factor_dtype`` -> fp8 format key, or None for plain
    dtypes (f32 / bf16 history stays a dense ``.to``)."""
    if isinstance(factor_dtype, str):
        if factor_dtype in ("fp8_e4m3", "fp8_e5m2"):
            return factor_dtype[4:]
        raise ValueError(f"unknown factor_dtype {factor_dtype!r}; expected "
                         f"'fp8_e4m3' | 'fp8_e5m2' or a torch dtype")
    return None


def pow2_ceil(s: torch.Tensor) -> torch.Tensor:
    """Round positive normal f32 values up to a power of two from their
    exponent bits: a nonzero mantissa carries one into the exponent."""
    bits = s.contiguous().view(torch.int32)
    up = (bits & 0x7FFFFF) != 0
    return ((bits & ~0x7FFFFF) + up.to(torch.int32) * 0x800000).view(
        torch.float32)


def compute_scale(amax: torch.Tensor, fmt: str,
                  scale_mode: str = "fp32") -> torch.Tensor:
    """Per-row scale mapping |x| <= amax onto the format's finite range."""
    if fmt not in FMT_MAX:
        raise ValueError(f"unknown fp8 format {fmt!r}; expected "
                         f"{sorted(FMT_MAX)}")
    s = amax.float() * torch.tensor(FMT_INV_MAX[fmt], dtype=torch.float32,
                                    device=amax.device)
    if scale_mode == "pow2":
        s = pow2_ceil(torch.clamp(s, min=_MIN_NORMAL))
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


# ---------------------------------------------------------------------------
# Stat-level encode/decode (the optimizer-facing API)
# ---------------------------------------------------------------------------

def _is_square(shape) -> bool:
    return len(shape) >= 2 and shape[-1] == shape[-2]


def encode_stat(x: torch.Tensor, fmt: str, *,
                symmetric: Optional[bool] = None,
                backend: Optional[str] = None) -> dict:
    """Encode one statistic to ``{"payload": fp8, "scale": f32}``.
    ``symmetric=True`` sym-packs the trailing (b, b) axes first; the
    default sniffs square trailing axes (callers that know the stat kind
    pass it)."""
    if symmetric is None:
        symmetric = _is_square(x.shape)
    if symmetric:
        from repro_torch.kernels import dispatch
        payload, scale = dispatch.fp8_pack(x, fmt=fmt, backend=backend)
    else:
        payload, scale = quantize_rows(x, fmt)
    return {"payload": payload, "scale": scale}


def decode_stat(entry: dict, shape: tuple, *,
                symmetric: Optional[bool] = None,
                backend: Optional[str] = None) -> torch.Tensor:
    """Dequantize-on-read: encoded dict -> dense f32 of ``shape``."""
    if symmetric is None:
        symmetric = _is_square(shape)
    if symmetric:
        from repro_torch.kernels import dispatch
        return dispatch.fp8_unpack(entry["payload"], entry["scale"],
                                   shape[-1], backend=backend)
    return dequantize_rows(entry["payload"], entry["scale"])


def is_wire(x: Any) -> bool:
    """Whether ``x`` is a wire-format stat: the ``{"payload", "scale"}``
    dict the fused capture (``factor_sum_wire``) emits."""
    return isinstance(x, dict) and "payload" in x and "scale" in x


def tri_rows(t: int) -> int:
    """Inverse of the triangle count: ``t = b(b+1)/2 -> b``."""
    b = (math.isqrt(8 * t + 1) - 1) // 2
    if b * (b + 1) // 2 != t:
        raise ValueError(f"{t} is not a triangular number (not a sym-packed "
                         "row length)")
    return b


def wire_dense_shape(entry: dict) -> tuple:
    """Dense f32 shape a wire-format stat decodes to:
    payload (lead..., nb, t) -> (lead..., nb, b, b)."""
    p = entry["payload"]
    b = tri_rows(p.shape[-1])
    return tuple(p.shape[:-1]) + (b, b)


def decode_wire_stat(entry: dict, backend: Optional[str] = None
                     ) -> torch.Tensor:
    """Wire-format stat -> dense symmetric f32 blocks: one dequantize and
    unpack (``dispatch.fp8_unpack``; the kernel on the card)."""
    from repro_torch.kernels import dispatch
    b = tri_rows(entry["payload"].shape[-1])
    return dispatch.fp8_unpack(entry["payload"], entry["scale"], b,
                               backend=backend)


def encoded_nbytes(shape: tuple, symmetric: Optional[bool] = None) -> int:
    """Resident bytes of the encoded form of a stat of ``shape`` (fp8
    payload + f32 per-block scales; sym-packed when symmetric)."""
    if symmetric is None:
        symmetric = _is_square(shape)
    if symmetric:
        b = shape[-1]
        blocks = math.prod(shape[:-2])
        return (blocks * (b * (b + 1) // 2) * PAYLOAD_BYTES
                + blocks * SCALE_BYTES)
    n = math.prod(shape)
    rows = math.prod(shape[:-1]) if len(shape) > 1 else 1
    return n * PAYLOAD_BYTES + rows * SCALE_BYTES
