"""Wrappers of the three hand-written Newton-Schulz kernels (Stage 4) and
the tiled path's trip loop; the counterpart of ``repro/kernels/ops.py``
``ns_inverse`` and ``ns_inverse_tiled``.

* :func:`ns_inverse_blocks` (``csrc/newton_schulz.cu``) replaces the TPU
  kernel ``repro/kernels/newton_schulz.py::ns_inverse_blocks``: the whole
  iteration of each block in one launch, one cluster of up to 8 blocks of
  threads per factor block, the iterates in scratch in device memory
  (:func:`resident_tiles`).
* :func:`ns_tiled_residual` and :func:`ns_tiled_update` replace
  ``::ns_tiled_residual`` and ``::ns_tiled_update``: ``R = I - M X`` with
  ``||R||_F^2`` and ``X + X R``, persistent blocks of threads, one per SM,
  over every (factor block, 128 x 128 output tile) item
  (:func:`tiled_geometry`, :func:`tiled_item`), frozen factor blocks
  skipped on the device.
* :func:`ns_inverse_tiled` is ``ops.ns_inverse_tiled``'s trip loop, and
  :func:`ns_inverse` routes by block size as the JAX package does.

All are bound by f32-accurate operations (4 b^3 a block and trip), and
all run them as f32-accurate split TF32 products (3xTF32) on the tensor
cores, on the 128 x 128 tile of ``csrc/f32_split_gemm.cuh``. Every input
is an already-damped, already-symmetrized ``M = F + lambda I`` block
(g, b, b) f32 (``kernels/dispatch.py`` owns that prep); a ragged b is
masked in the kernels, not padded with a scaled identity as on the TPU, so
the residual is that of the unpadded block. Each wrapper takes CUDA
tensors only (the plain versions for the CPU are in
:mod:`repro_torch.kernels.ref`), checks dtype, shape and layout, allocates
outputs and scratch with ``torch.empty``, launches on the current stream
and counts the launch in :data:`LAUNCHES`.
"""

from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import on_card, require, stream
from repro_torch.kernels.ref import ns_x0

# kernel name -> number of launches since the last reset_launches()
LAUNCHES: dict[str, int] = {"ns_inverse_blocks": 0, "ns_tiled_residual": 0,
                            "ns_tiled_update": 0}

# Largest block the one-launch resident kernel takes; larger blocks run the
# tiled pair. The TPU sized this cap by VMEM (3 b^2 f32 per block); on the
# H100 the resident kernel keeps its iterates in device memory whatever b
# is, so the cap is kept at the JAX package's value (ops.NS_KERNEL_MAX_DIM)
# for parity only: the same blocks take the same kernel in both packages.
# It was not chosen by timing the two routes on this card; chip_smoke.py
# time_ns_kernels times both on the path's (16, 512, 512) blocks, and
# PERF.md records which is faster. At the training path's shapes the 512
# blocks (wk.G, wv.G) run resident and the 2048 blocks tiled.
NS_RESIDENT_MAX_DIM = 1024

# the resident kernel's output tile (res::TN rows x f32g::TM columns) and
# its largest cluster (MAX_CLUSTER)
RESIDENT_TILE = (128, 128)
MAX_CLUSTER = 8
# the tiled pair's output tile edge (tiled::TN = f32g::TM)
TILED_TILE = 128


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def route(b: int) -> str:
    """Which kernel a block of size ``b`` takes: ``"resident"`` or
    ``"tiled"``."""
    return "resident" if b <= NS_RESIDENT_MAX_DIM else "tiled"


def _blocks(name: str, *ts: torch.Tensor) -> tuple[int, int]:
    on_card(name, *ts)
    for t in ts:
        require(t.dim() == 3 and t.shape[1] == t.shape[2]
                and t.shape == ts[0].shape,
                f"{name}: blocks must be (g, b, b) of one shape, got "
                f"{[tuple(x.shape) for x in ts]}")
        require(t.dtype == torch.float32, f"{name}: f32 only, got {t.dtype}")
        require(t.is_contiguous(), f"{name}: blocks must be contiguous")
    g, b = ts[0].shape[0], ts[0].shape[-1]
    require(g >= 1 and b >= 1, f"{name}: empty blocks {tuple(ts[0].shape)}")
    return g, b


def _active_ptr(active: torch.Tensor | None, g: int, dev) -> int:
    if active is None:
        return 0
    require(active.shape == (g,) and active.dtype == torch.int32
            and active.device == dev and active.is_contiguous(),
            f"active must be a contiguous (g,) int32 tensor on {dev}")
    return active.data_ptr()


def ns_inverse_blocks(m: torch.Tensor, iters: int, tol: float):
    """m (g, b, b) -> (x (g, b, b) ~ M^-1, res (g,) relative residual
    ``||I - M x||_F / sqrt(b)`` of the returned iterate, trips (g,) int32
    updates applied), one launch."""
    name = "ns_inverse_blocks"
    g, b = _blocks(name, m)
    require(iters >= 0, f"{name}: iters must be >= 0")
    x = torch.empty_like(m)
    alt, r = torch.empty_like(m), torch.empty_like(m)     # scratch
    res = torch.empty(g, dtype=torch.float32, device=m.device)
    trips = torch.empty(g, dtype=torch.int32, device=m.device)
    lib = build.load()["newton_schulz"]
    with torch.cuda.device(m.device):
        rc = lib.ns_inverse_blocks(m.data_ptr(), x.data_ptr(), alt.data_ptr(),
                                   r.data_ptr(), res.data_ptr(),
                                   trips.data_ptr(), g, b, int(iters),
                                   float(tol), stream(m))
    build.check(rc, name)
    LAUNCHES[name] += 1
    return x, res, trips


def resident_tiles(b: int, csize: int, rank: int) -> list[tuple[int, int]]:
    """The output tiles (first row, first column) that block ``rank`` of a
    cluster of ``csize`` takes in each product of the resident kernel on
    blocks of b (``res::product``): tiles rank, rank + csize, ... of the
    row-major (b / 128) x (b / 128) grid."""
    tn, tm = RESIDENT_TILE
    nc = -(-b // tm)
    tiles = -(-b // tn) * nc
    return [((t // nc) * tn, (t % nc) * tm) for t in range(rank, tiles, csize)]


def resident_cluster(g: int, b: int) -> int:
    """How many blocks of threads the resident kernel gives each of g factor
    blocks of size b on the current card (1 to MAX_CLUSTER, the card's own
    occupancy decides; see ``pick_cluster`` in csrc/newton_schulz.cu)."""
    rc = build.load()["newton_schulz"].ns_resident_cluster(int(g), int(b))
    build.check(-rc if rc < 0 else 0, "ns_resident_cluster")
    return rc


@functools.lru_cache(maxsize=None)
def tiled_geometry(g: int, b: int, sms: int) -> tuple[int, int, int, int]:
    """(tiles along a block's edge, tiles per factor block, work items,
    blocks of threads) of one launch of the tiled pair on ``sms`` SMs: the
    items are g x tiles (:func:`tiled_item`), one persistent block of
    threads per SM (the ring's 193 KB of shared memory), block w taking
    items w, w + blocks, ..."""
    nc = -(-b // TILED_TILE)
    items = g * nc * nc
    return nc, nc * nc, items, min(items, sms)


def tiled_item(i: int, g: int, b: int) -> tuple[int, int, int]:
    """The kernel's item i (``tiled::item_tile``): (factor block, first
    row, first column) of its output tile. Block-major, the tiles of a
    block row-major."""
    nc, tiles, _, _ = tiled_geometry(g, b, 1)
    gi, t = divmod(i, tiles)
    return gi, (t // nc) * TILED_TILE, (t % nc) * TILED_TILE


def _tiled_launch(g: int, b: int, dev) -> tuple[int, int]:
    """(tiles per factor block, blocks of threads) of a launch on dev."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    _, tiles, _, blocks = tiled_geometry(g, b, sms)
    return tiles, blocks


def ns_tiled_residual(m: torch.Tensor, x: torch.Tensor,
                      active: torch.Tensor | None = None):
    """R = I - M X and ss = ||R||_F^2 per block: m, x (g, b, b) ->
    (r (g, b, b), ss (g,)). With ``active`` ((g,) int32), a block whose
    flag is 0 is skipped: its r is left unwritten and its ss is 0."""
    name = "ns_tiled_residual"
    g, b = _blocks(name, m, x)
    act = _active_ptr(active, g, m.device)
    r = torch.empty_like(m)
    ss = torch.zeros(g, dtype=torch.float32, device=m.device)
    lib = build.load()["newton_schulz"]
    with torch.cuda.device(m.device):
        tiles, blocks = _tiled_launch(g, b, m.device)
        partials = torch.empty((g, tiles), dtype=torch.float32,
                               device=m.device)
        counter = torch.zeros(g, dtype=torch.int32, device=m.device)
        rc = lib.ns_tiled_residual(m.data_ptr(), x.data_ptr(), act,
                                   r.data_ptr(), partials.data_ptr(),
                                   counter.data_ptr(), ss.data_ptr(), g, b,
                                   blocks, stream(m))
    build.check(rc, name)
    LAUNCHES[name] += 1
    return r, ss


def ns_tiled_update(x: torch.Tensor, r: torch.Tensor,
                    active: torch.Tensor | None = None) -> torch.Tensor:
    """X' = X + X R out of place: x, r (g, b, b) -> (g, b, b). With
    ``active``, a block whose flag is 0 comes back as x, bit for bit."""
    name = "ns_tiled_update"
    g, b = _blocks(name, x, r)
    act = _active_ptr(active, g, x.device)
    out = torch.empty_like(x)
    lib = build.load()["newton_schulz"]
    with torch.cuda.device(x.device):
        _, blocks = _tiled_launch(g, b, x.device)
        rc = lib.ns_tiled_update(x.data_ptr(), r.data_ptr(), act,
                                 out.data_ptr(), g, b, blocks, stream(x))
    build.check(rc, name)
    LAUNCHES[name] += 1
    return out


def ns_inverse_tiled(m: torch.Tensor, iters: int, tol: float):
    """The tiled Newton-Schulz inverse, same contract as
    :func:`ns_inverse_blocks`. Each trip launches one residual and one
    update; the initial iterate, the residual ``sqrt(ss) / sqrt(b)`` and
    the per-block freeze are plain tensor code. The loop stops issuing
    trips once every block is frozen (one host read a trip), which gives
    the output of running all ``iters``: a frozen iterate never changes.
    Launches: trips.max() + 1 residuals and trips.max() updates."""
    _blocks("ns_inverse_tiled", m)
    g, b = m.shape[0], m.shape[-1]
    x = ns_x0(m)
    rnorm = 1.0 / math.sqrt(b)
    active = torch.ones(g, dtype=torch.int32, device=m.device)
    res = torch.zeros(g, dtype=torch.float32, device=m.device)
    trips = torch.zeros(g, dtype=torch.int32, device=m.device)
    for _ in range(iters):
        r, ss = ns_tiled_residual(m, x, active)
        live = active.bool()
        res = torch.where(live, torch.sqrt(ss) * rnorm, res)
        active = (live & (res > tol)).to(torch.int32)
        if not bool(active.any()):
            return x, res, trips
        x = ns_tiled_update(x, r, active)
        trips += active
        del r               # before the next trip allocates its own

    # the cap was reached with blocks still active: the residual of the
    # returned iterate for those (the frozen ones' is already in res)
    _, ss = ns_tiled_residual(m, x, active)
    res = torch.where(active.bool(), torch.sqrt(ss) * rnorm, res)
    return x, res, trips


def ns_inverse(m: torch.Tensor, iters: int, tol: float):
    """Newton-Schulz inverse of damped symmetric blocks m (g, b, b) f32 on
    the card, routed by b (:func:`route`): (x, res, trips)."""
    if route(m.shape[-1]) == "resident":
        return ns_inverse_blocks(m, iters, tol)
    return ns_inverse_tiled(m, iters, tol)
