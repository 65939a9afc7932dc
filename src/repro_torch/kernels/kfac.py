"""Wrappers of the two hand-written K-FAC kernels.

* :func:`factor_syrk` (``csrc/kfac_factor.cu``) replaces the TPU kernel
  ``repro/kernels/kfac_factor.py::factor_syrk``: every diagonal block's
  ``X_k^T X_k`` of a token matrix in one launch, f32 sums from bf16 or f32,
  the ragged last block masked. Bound by operations at the training path's
  shapes. bf16 runs on the tensor cores (``wgmma``, 128 x 128 tiles, the
  work shared out evenly over the SMs: :func:`syrk_geometry`); f32 stays
  on the CUDA cores.
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

import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import on_card, require, stream

# kernel name -> number of launches since the last reset_launches()
LAUNCHES: dict[str, int] = {"factor_syrk": 0, "block_precond": 0}

SYRK_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# csrc/kfac_factor.cu: the tensor-core body's output tile (tc::TILE) and
# tokens per pipeline stage (tc::BK)
TC_TILE, TC_SLICE = 128, 64
# syrk_geometry's cost model, in slices of 64 tokens of one tile on one SM:
# what a block adds when a tile it works on is shared (its partial written
# and fenced), and what the last block to arrive adds per partial it sums
_PARTIAL_COST, _REDUCE_COST = 2, 1
# from this many tiles per SM on, one block per tile (several waves) beats
# sharing the work out (each extra tile a block takes costs an epilogue)
_WAVES_UNSHARED = 2


def syrk_sharers(q: int, slices: int, per: int) -> range:
    """The blocks of threads that sum tile ``q`` (the kernel's
    ``Work::first`` .. ``Work::last``)."""
    return range(q * slices // per, ((q + 1) * slices - 1) // per + 1)


@functools.lru_cache(maxsize=None)
def syrk_geometry(n: int, b: int, nb: int, sms: int
                  ) -> tuple[int, int, int, int]:
    """(tiles along a block's edge, slices of 64 tokens per tile, blocks of
    threads, slices per block) of one bf16 factor_syrk launch over n tokens
    and nb blocks of b on ``sms`` SMs.

    The work is nb * tiles(tiles+1)/2 upper tiles of 128 x 128 times
    ``slices`` slices, tile-major; block w sums [w * per, (w + 1) * per) of
    it. At _WAVES_UNSHARED tiles per SM or more, one block per tile;
    below, at most one block per SM (the body's 193 KB of shared memory),
    the count that minimizes per + the cost of sharing: the partial's
    write and the last block's sum over the most blocks any tile has
    (stream-K)."""
    tiles = -(-b // TC_TILE)
    slices = max(-(-n // TC_SLICE), 1)
    ntiles = nb * tiles * (tiles + 1) // 2
    total = ntiles * slices
    if ntiles >= _WAVES_UNSHARED * sms:
        return tiles, slices, ntiles, slices
    best = None
    for want in range(1, min(sms, total) + 1):
        per = -(-total // want)
        cost = per
        if per % slices:
            most = max(len(syrk_sharers(q, slices, per))
                       for q in range(ntiles))
            cost += _PARTIAL_COST + _REDUCE_COST * most
        if best is None or cost < best[0]:
            best = (cost, -(-total // per), per)
    return tiles, slices, best[1], best[2]


def syrk_buffers(x: torch.Tensor, b: int, nb: int, zeroed: int = 0):
    """Launch geometry and scratch of one factor_syrk launch on x: (blocks
    of threads, workspace, flags), the workspace holding the partials of
    shared tiles and flags zeroed: flags[:zeroed] for the caller (the wire
    kernel's amax), then one arrival counter per tile. f32 takes no
    workspace and no counters (its CUDA-core body has one block per tile
    pair)."""
    ws = torch.empty((0,), dtype=torch.float32, device=x.device)
    if x.dtype != torch.bfloat16:
        return 1, ws, torch.zeros((zeroed,), dtype=torch.int32,
                                  device=x.device)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    tiles, slices, ctas, per = syrk_geometry(x.shape[0], b, nb, sms)
    counters = 0
    if per % slices:
        ws = torch.empty((2 * ctas * TC_TILE * TC_TILE,), dtype=torch.float32,
                         device=x.device)
        counters = nb * tiles * (tiles + 1) // 2
    return ctas, ws, torch.zeros((zeroed + counters,), dtype=torch.int32,
                                 device=x.device)


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
        ctas, ws, flags = syrk_buffers(x, b, nb)
        rc = lib.factor_syrk(x.data_ptr(), out.data_ptr(), ws.data_ptr(),
                             flags.data_ptr(), n, max(x.stride(0), d), d, nb,
                             b, build.DTYPE_CODES[x.dtype], ctas, stream(x))
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
