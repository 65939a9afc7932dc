"""Wrappers of the two hand-written K-FAC kernels.

* :func:`factor_syrk` (``csrc/kfac_factor.cu``) replaces the TPU kernel
  ``repro/kernels/kfac_factor.py::factor_syrk``: every diagonal block's
  ``X_k^T X_k`` of a token matrix in one launch, f32 sums from bf16 or f32,
  the ragged last block masked. Bound by operations at the training path's
  shapes.
* :func:`block_precond` (``csrc/kfac_precond.cu``) replaces
  ``repro/kernels/kfac_precond.py::block_precond``: ``Binv[k] @ W[k]`` over
  the row blocks of W (left) or ``W[:, k] @ Binv[k]`` over its column
  blocks (right), f32 without TF32, W read in place. Bound by operations.

Each wrapper takes CUDA tensors only (the plain versions for the CPU are in
:mod:`repro_torch.kernels.ref`, chosen by :mod:`repro_torch.kernels
.dispatch`), checks device, dtype, shape and layout, allocates its output
with ``torch.empty``, launches on the current stream and counts the launch
in :data:`LAUNCHES`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import on_card, require, stream

# kernel name -> number of launches since the last reset_launches()
LAUNCHES: dict[str, int] = {"factor_syrk": 0, "block_precond": 0}

SYRK_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def factor_syrk(x: torch.Tensor, max_dim: int) -> torch.Tensor:
    """x (n, d) bf16 | f32, rows contiguous -> (nb, b, b) f32 with
    nb, b = num_blocks(d, max_dim), block_size(d, max_dim)."""
    from repro_torch.core import kfac
    name = "factor_syrk"
    on_card(name, x)
    require(x.dim() == 2, f"{name}: x must be (n, d), got {tuple(x.shape)}")
    require(x.dtype in SYRK_DTYPES, f"{name}: dtype {x.dtype} not in "
                                     f"{SYRK_DTYPES}")
    require(x.stride(1) == 1 or x.shape[1] == 1,
            f"{name}: rows must be contiguous")
    n, d = x.shape
    nb, b = kfac.num_blocks(d, max_dim), kfac.block_size(d, max_dim)
    out = torch.empty((nb, b, b), dtype=torch.float32, device=x.device)
    lib = build.load()["kfac_factor"]
    with torch.cuda.device(x.device):
        rc = lib.factor_syrk(x.data_ptr(), out.data_ptr(), n,
                             max(x.stride(0), d), d, nb, b,
                             build.DTYPE_CODES[x.dtype], stream(x))
    build.check(rc, name)
    LAUNCHES[name] += 1
    return out


def block_precond(binv: torch.Tensor, w: torch.Tensor, *,
                  right: bool = False) -> torch.Tensor:
    """binv (nb, b, b) f32 contiguous. Left: w (dim, m) -> Binv applied to
    each b-row block of w; right: w (m, dim) -> each b-column block of w
    times Binv. dim <= nb*b (the last block may be ragged); w f32 with
    contiguous rows. Returns f32 of w's shape."""
    name = "block_precond"
    on_card(name, binv, w)
    require(binv.dim() == 3 and binv.shape[1] == binv.shape[2]
            and binv.is_contiguous(),
            f"{name}: binv must be a contiguous (nb, b, b), got "
            f"{tuple(binv.shape)}")
    require(w.dim() == 2 and w.stride(1) == 1,
            f"{name}: w must be 2-D with contiguous rows")
    require(binv.dtype == torch.float32 and w.dtype == torch.float32,
            f"{name}: f32 only (got {binv.dtype}, {w.dtype})")
    nb, b = binv.shape[0], binv.shape[-1]
    dim, other = (w.shape[1], w.shape[0]) if right else w.shape
    require((nb - 1) * b < dim <= nb * b,
            f"{name}: {nb} blocks of {b} do not cover dim {dim}")
    out = torch.empty(w.shape, dtype=torch.float32, device=w.device)
    if w.numel() == 0:
        return out
    lib = build.load()["kfac_precond"]
    with torch.cuda.device(w.device):
        rc = lib.block_precond(binv.data_ptr(), w.data_ptr(), out.data_ptr(),
                               b, dim, other, w.stride(0), out.stride(0), nb,
                               int(right), stream(w))
    build.check(rc, name)
    LAUNCHES[name] += 1
    return out
