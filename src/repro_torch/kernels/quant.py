"""Wrappers of the three hand-written fp8 kernels.

* :func:`quant_rows` (``csrc/quant_pack.cu``) replaces the TPU kernel
  ``repro/kernels/quant_pack.py::quant_rows``: per row of a (g, t) f32
  matrix, amax, the scale, the clip and the fp8 cast, as two launches (a
  max pass over row chunks, then a quantize pass). Bound by bytes.
* :func:`dequant_rows` (``csrc/quant_pack.cu``) replaces
  ``::dequant_rows``: ``payload.f32 * scale`` per row. Bound by bytes.
* :func:`factor_syrk_wire` (``csrc/kfac_factor.cu``) replaces
  ``repro/kernels/kfac_factor.py::factor_syrk_wire``: the blocked factor
  sum with the fp8 wire epilogue, emitting the sym-packed payload
  ``(nb, b(b+1)/2)`` and one scale per block: quant_rows' payload and
  scale of the sym-packed f32 sums the kernel leaves in its scratch, bit
  for bit. Bound by operations.

The scale arithmetic is the JAX package's (``quant.compute_scale``): the
f32 value of ``FMT_INV_MAX`` is passed to the kernels, the pow2 mode rounds
up from the exponent bits. Each wrapper takes CUDA tensors only (the plain
versions for the CPU are in :mod:`repro_torch.kernels.ref`, chosen by
:mod:`repro_torch.kernels.dispatch`), checks device, dtype, shape and
layout, allocates outputs and scratch with ``torch.empty``, launches on the
current stream and counts the launch in :data:`LAUNCHES`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import on_card, require, stream
from repro_torch.kernels.kfac import SYRK_DTYPES, syrk_buffers
from repro_torch.quant import quant as q

# kernel name -> number of launches since the last reset_launches()
LAUNCHES: dict[str, int] = {"quant_rows": 0, "dequant_rows": 0,
                            "factor_syrk_wire": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _fmt_args(name: str, fmt: str, scale_mode: str) -> tuple[int, int, float]:
    """(dtype code of the payload, pow2 flag, FMT_INV_MAX)."""
    require(fmt in q.FORMATS, f"{name}: unknown fp8 format {fmt!r}")
    require(scale_mode in ("fp32", "pow2"),
            f"{name}: unknown scale_mode {scale_mode!r}")
    return (build.DTYPE_CODES[q.FORMATS[fmt]], int(scale_mode == "pow2"),
            q.FMT_INV_MAX[fmt])


def quant_rows(x: torch.Tensor, fmt: str = "e4m3",
               scale_mode: str = "fp32") -> tuple[torch.Tensor, torch.Tensor]:
    """x (g, t) f32 contiguous -> (payload (g, t) fp8, scale (g,) f32)."""
    name = "quant_rows"
    on_card(name, x)
    require(x.dim() == 2 and x.is_contiguous() and x.dtype == torch.float32,
            f"{name}: x must be a contiguous (g, t) f32, got "
            f"{tuple(x.shape)} {x.dtype}")
    code, pow2, inv_max = _fmt_args(name, fmt, scale_mode)
    g, t = x.shape
    payload = torch.empty((g, t), dtype=q.FORMATS[fmt], device=x.device)
    scale = torch.empty((g,), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return payload, scale.fill_(1.0)
    amax = torch.empty((g,), dtype=torch.int32, device=x.device)
    lib = build.load()["quant_pack"]
    with torch.cuda.device(x.device):
        rc = lib.quant_rows(x.data_ptr(), payload.data_ptr(), scale.data_ptr(),
                            amax.data_ptr(), g, t, code, pow2, inv_max,
                            stream(x))
    build.check(rc, name)
    LAUNCHES[name] += 1
    return payload, scale


def dequant_rows(payload: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """payload (g, t) e4m3fn | e5m2 contiguous, scale (g,) f32 -> (g, t)
    f32."""
    name = "dequant_rows"
    on_card(name, payload, scale)
    require(payload.dim() == 2 and payload.is_contiguous()
            and payload.dtype in q.FORMATS.values(),
            f"{name}: payload must be a contiguous (g, t) fp8, got "
            f"{tuple(payload.shape)} {payload.dtype}")
    g, t = payload.shape
    require(scale.shape == (g,) and scale.dtype == torch.float32
            and scale.is_contiguous(),
            f"{name}: scale must be a contiguous ({g},) f32, got "
            f"{tuple(scale.shape)} {scale.dtype}")
    out = torch.empty((g, t), dtype=torch.float32, device=payload.device)
    if out.numel() == 0:
        return out
    lib = build.load()["quant_pack"]
    with torch.cuda.device(payload.device):
        rc = lib.dequant_rows(payload.data_ptr(), scale.data_ptr(),
                              out.data_ptr(), g, t,
                              build.DTYPE_CODES[payload.dtype],
                              stream(payload))
    build.check(rc, name)
    LAUNCHES[name] += 1
    return out


def factor_syrk_wire(x: torch.Tensor, max_dim: int, fmt: str = "e4m3",
                     scale_mode: str = "fp32"
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (n, d) bf16 | f32, rows contiguous -> (payload (nb, b(b+1)/2)
    fp8, scale (nb,) f32) with nb, b = num_blocks(d, max_dim),
    block_size(d, max_dim)."""
    from repro_torch.core import kfac
    on_card("factor_syrk_wire", x)
    d = x.shape[-1]
    b = kfac.block_size(d, max_dim)
    scratch = torch.empty((kfac.num_blocks(d, max_dim), b, b),
                          dtype=torch.float32, device=x.device)
    return _factor_syrk_wire(x, max_dim, fmt, scale_mode, scratch)


def _factor_syrk_wire(x: torch.Tensor, max_dim: int, fmt: str,
                      scale_mode: str, scratch: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`factor_syrk_wire` with the caller's (nb, b, b) f32 scratch,
    which holds the kernel's own f32 sums after the call (the payload and
    scale are quant_rows' of its sym-pack, bit for bit)."""
    from repro_torch.core import kfac
    name = "factor_syrk_wire"
    on_card(name, x, scratch)
    require(x.dim() == 2, f"{name}: x must be (n, d), got {tuple(x.shape)}")
    require(x.dtype in SYRK_DTYPES, f"{name}: dtype {x.dtype} not in "
                                     f"{SYRK_DTYPES}")
    require(x.stride(1) == 1 or x.shape[1] == 1,
            f"{name}: rows must be contiguous")
    code, pow2, inv_max = _fmt_args(name, fmt, scale_mode)
    n, d = x.shape
    nb, b = kfac.num_blocks(d, max_dim), kfac.block_size(d, max_dim)
    require(scratch.shape == (nb, b, b) and scratch.dtype == torch.float32
            and scratch.is_contiguous(),
            f"{name}: scratch must be a contiguous ({nb}, {b}, {b}) f32, got "
            f"{tuple(scratch.shape)} {scratch.dtype}")
    t = b * (b + 1) // 2
    payload = torch.empty((nb, t), dtype=q.FORMATS[fmt], device=x.device)
    scale = torch.empty((nb,), dtype=torch.float32, device=x.device)
    lib = build.load()["kfac_factor"]
    with torch.cuda.device(x.device):
        ctas, ws, flags = syrk_buffers(x, b, nb, zeroed=nb)
        rc = lib.factor_syrk_wire(x.data_ptr(), scratch.data_ptr(),
                                  flags.data_ptr(), ws.data_ptr(),
                                  flags[nb:].data_ptr(), payload.data_ptr(),
                                  scale.data_ptr(), n, max(x.stride(0), d), d,
                                  nb, b, build.DTYPE_CODES[x.dtype], ctas,
                                  code, pow2, inv_max, stream(x))
    build.check(rc, name)
    LAUNCHES[name] += 1
    return payload, scale
