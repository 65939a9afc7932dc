"""Wrappers of the three hand-written fp8 kernels.

* :func:`quant_rows` (``csrc/quant_pack.cu``) replaces the TPU kernel
  ``repro/kernels/quant_pack.py::quant_rows``: per row of a (g, t) f32
  matrix, amax, the scale, the clip and the fp8 cast. Bound by bytes. One
  cooperative launch of blocks all resident (:func:`resident_grid`) reads
  x from HBM once: rows cut into items of :func:`quant_slice` elements,
  dealt to the blocks in waves of whole rows (:func:`quant_items`), each
  item held in shared memory until its row's amax is complete. A row with
  more items than blocks takes the long-row route (a max pass, then a
  quantize pass that reads x again), chosen here by size.
* :func:`dequant_rows` (``csrc/quant_pack.cu``) replaces
  ``::dequant_rows``: ``payload.f32 * scale`` per row. Bound by bytes. One
  block per (row, tile) (:func:`dequant_geometry`); a warp's loads and
  stores are contiguous, a row's unaligned head and tail go element by
  element (:func:`dequant_items` lists who writes what).
* :func:`factor_syrk_wire` (``csrc/kfac_factor.cu``) replaces
  ``repro/kernels/kfac_factor.py::factor_syrk_wire``: the blocked factor
  sum with the fp8 wire epilogue, emitting the sym-packed payload
  ``(..., nb, b(b+1)/2)`` and one scale per block: quant_rows' payload and
  scale of the sym-packed f32 sums the kernel leaves in its scratch, bit
  for bit. Its leading axes (an MoE site's experts) go into the same one
  SYRK launch and one pack launch. Bound by operations.

The scale arithmetic is the JAX package's (``quant.compute_scale``): the
f32 value of ``FMT_INV_MAX`` is passed to the kernels, the pow2 mode rounds
up from the exponent bits. Each wrapper takes CUDA tensors only (the plain
versions for the CPU are in :mod:`repro_torch.kernels.ref`, chosen by
:mod:`repro_torch.kernels.dispatch`), checks device, dtype, shape and
layout, allocates outputs and scratch with ``torch.empty``, launches on the
current stream and counts the launch in :data:`LAUNCHES`.
"""

from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (counters, on_card, require,
                                        sm_count, stream)
from repro_torch.kernels.kfac import SYRK_DTYPES, syrk_buffers
from repro_torch.quant import quant as q

# kernel name -> number of launches since the last reset_launches()
LAUNCHES: dict[str, int] = {"quant_rows": 0, "dequant_rows": 0,
                            "factor_syrk_wire": 0}


# csrc/quant_pack.cu: the most elements of one work item of the resident
# route (three buffers of it fill an SM's shared memory) and the granule
# of an item's length
QUANT_SLICE_MAX = 18432
QUANT_SLICE_ALIGN = 64
# the fixed cost of an item (its barrier, publish and wait), in elements
# moved: the slice choice weighs it against the items' length
QUANT_ITEM_COST = 4096


# csrc/quant_pack.cu rows_dequant_kernel: threads a block, words (4
# elements) a thread per tile
DEQUANT_THREADS = 256
DEQUANT_UNROLL = 8
DEQUANT_TILE = DEQUANT_THREADS * DEQUANT_UNROLL


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def _resident_grid(index: int) -> int:
    lib = build.load()["quant_pack"]
    with torch.cuda.device(index):
        grid = lib.quant_rows_grid()
    build.check(-min(grid, 0), "quant_rows_grid")
    return grid


def resident_grid(device: torch.device) -> int:
    """Blocks of quant_rows' resident route that ``device`` holds at once
    (the occupancy API's count an SM times the SMs): its cooperative
    launch's grid."""
    return _resident_grid(torch.device(device).index or 0)


@functools.lru_cache(maxsize=None)
def quant_slice(g: int, t: int, grid: int) -> int:
    """Elements per work item of quant_rows' resident route on ``grid``
    co-resident blocks, or 0 for the long-row route. The (g, t) rows are
    cut into items of ``slice`` elements, P = ceil(t / slice) a row, and a
    wave of the grid holds floor(grid / P) whole rows (:func:`quant_items`).
    Of the slices up to QUANT_SLICE_MAX (a multiple of the granule), the
    one with the least work per block is taken, waves x (slice +
    QUANT_ITEM_COST), the fewer waves and then the fewer items a row
    breaking ties. A row of more than grid x QUANT_SLICE_MAX elements takes
    the two-pass body."""
    a = QUANT_SLICE_ALIGN
    if -(-t // QUANT_SLICE_MAX) > grid:
        return 0
    best = None
    for p in range(-(-t // QUANT_SLICE_MAX), grid + 1):
        share = -(-t // p)
        sl = -(-share // a) * a
        waves = -(-g // (grid // -(-t // sl)))
        cost = (waves * (sl + QUANT_ITEM_COST), waves)
        if best is None or cost < best[0]:
            best = (cost, sl)
    return best[1]


def quant_items(g: int, t: int, grid: int, slice_: int
                ) -> list[tuple[int, int, int, int, int]]:
    """The resident route's schedule, row by row: (block, wave, row, first
    element, end) of each item (elements counted in the row). Slice s of
    row r goes to block ``(r % R) * P + s`` in wave ``r // R``, R =
    floor(grid / P) rows a wave: every block takes at most one item a wave,
    and a row lies in one wave."""
    per_row = -(-t // slice_)
    rows = grid // per_row
    out = []
    for r in range(g):
        for s in range(per_row):
            lo = s * slice_
            out.append(((r % rows) * per_row + s, r // rows, r, lo,
                        min(lo + slice_, t)))
    return out


def dequant_geometry(t: int) -> int:
    """Tiles a row of dequant_rows' grid (one block each): the row's whole
    words (4 elements) cut into tiles of DEQUANT_TILE, at least one."""
    return max(1, -(-(t // 4) // DEQUANT_TILE))


def dequant_items(g: int, t: int) -> list[tuple[int, int, str, int, int]]:
    """dequant_rows' partition, as the kernel walks it: (block, thread,
    kind, first element, end) of every write, elements counted in the row.
    Block ``b`` takes tile ``b % P`` of row ``b // P``. The row's first
    ``head`` elements (up to the first flat index that is a multiple of 4,
    where the f32 output is 16-byte aligned) go one a thread in the first
    tile ("head"), the elements after its last whole word one a thread in
    the last tile ("tail"); each word between is one thread's 4 elements
    ("word"): word ``w0 + i * DEQUANT_THREADS + thread`` in step ``i`` of
    the tile starting at word ``w0``."""
    tiles = dequant_geometry(t)
    nt = DEQUANT_THREADS
    out = []
    for b in range(g * tiles):
        row, tile = divmod(b, tiles)
        head = min(-(row * t) % 4, t)
        words = (t - head) // 4
        if tile == 0:
            out += [(b, i, "head", i, i + 1) for i in range(head)]
        w0 = tile * DEQUANT_TILE
        w1 = min(w0 + DEQUANT_TILE, words)
        for i in range(DEQUANT_UNROLL):
            for th in range(nt):
                j = w0 + i * nt + th
                if j < w1:
                    e = head + 4 * j
                    out.append((b, th, "word", e, e + 4))
        if tile == tiles - 1:
            out += [(b, e - head - 4 * words, "tail", e, e + 1)
                    for e in range(head + 4 * words, t)]
    return out


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
    grid = resident_grid(x.device)
    slice_ = quant_slice(g, t, grid)
    # the resident route's amax and arrival counters (2g, left zero), or
    # the long-row route's amax (g, zeroed by the kernel)
    scratch = (counters(x, 2 * g) if slice_ else
               torch.empty((g,), dtype=torch.int32, device=x.device))
    lib = build.load()["quant_pack"]
    with torch.cuda.device(x.device):
        rc = lib.quant_rows(x.data_ptr(), payload.data_ptr(), scale.data_ptr(),
                            scratch.data_ptr(), g, t, code, pow2, inv_max,
                            grid, slice_, sm_count(x.device.index),
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
    require(t < 2 ** 31, f"{name}: rows of {t} elements: the kernel's "
                         f"offsets within a row are 32-bit")
    out = torch.empty((g, t), dtype=torch.float32, device=payload.device)
    if out.numel() == 0:
        return out
    lib = build.load()["quant_pack"]
    with torch.cuda.device(payload.device):
        rc = lib.dequant_rows(payload.data_ptr(), scale.data_ptr(),
                              out.data_ptr(), g, t,
                              build.DTYPE_CODES[payload.dtype],
                              dequant_geometry(t), stream(payload))
    build.check(rc, name)
    LAUNCHES[name] += 1
    return out


def dequant_attrs(device: torch.device) -> dict[str, tuple[int, int]]:
    """Registers and local bytes (stack frame, spills included) a thread of
    each dequant_rows instance on ``device`` (cudaFuncGetAttributes):
    {"e4m3 aligned" | "e4m3 bytes" | "e5m2 aligned" | "e5m2 bytes": (regs,
    local bytes)}."""
    import ctypes
    lib = build.load()["quant_pack"]
    a = (ctypes.c_int * 8)()
    with torch.cuda.device(device):
        build.check(lib.dequant_rows_attrs(ctypes.addressof(a)),
                    "dequant_rows_attrs")
    names = ("e4m3 aligned", "e4m3 bytes", "e5m2 aligned", "e5m2 bytes")
    return {n: (a[2 * i], a[2 * i + 1]) for i, n in enumerate(names)}


def factor_syrk_wire(x: torch.Tensor, max_dim: int, fmt: str = "e4m3",
                     scale_mode: str = "fp32"
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (..., n, d) bf16 | f32, rows contiguous -> (payload (..., nb,
    b(b+1)/2) fp8, scale (..., nb) f32) with nb, b = num_blocks(d,
    max_dim), block_size(d, max_dim): every matrix over the leading axes
    (an MoE site's experts) in one launch."""
    from repro_torch.core import kfac
    on_card("factor_syrk_wire", x)
    d = x.shape[-1]
    b = kfac.block_size(d, max_dim)
    scratch = torch.empty((*x.shape[:-2], kfac.num_blocks(d, max_dim), b, b),
                          dtype=torch.float32, device=x.device)
    return _factor_syrk_wire(x, max_dim, fmt, scale_mode, scratch)


# launch_syrk's guard (csrc/kfac_factor.cu): lead * nb is a grid's y
SYRK_MAX_BLOCKS = 65535


def _factor_syrk_wire(x: torch.Tensor, max_dim: int, fmt: str,
                      scale_mode: str, scratch: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`factor_syrk_wire` with the caller's (..., nb, b, b) f32
    scratch, which holds the kernel's own f32 sums after the call (the
    payload and scale are quant_rows' of its sym-pack, bit for bit)."""
    from repro_torch.core import kfac
    name = "factor_syrk_wire"
    on_card(name, x, scratch)
    require(x.dim() >= 2, f"{name}: x must be (..., n, d), got "
                          f"{tuple(x.shape)}")
    require(x.dtype in SYRK_DTYPES, f"{name}: dtype {x.dtype} not in "
                                     f"{SYRK_DTYPES}")
    require(x.stride(-1) == 1 or x.shape[-1] == 1,
            f"{name}: rows must be contiguous")
    code, pow2, inv_max = _fmt_args(name, fmt, scale_mode)
    *lead_shape, n, d = x.shape
    lead = math.prod(lead_shape)
    nb, b = kfac.num_blocks(d, max_dim), kfac.block_size(d, max_dim)
    require(tuple(scratch.shape) == (*lead_shape, nb, b, b)
            and scratch.dtype == torch.float32 and scratch.is_contiguous(),
            f"{name}: scratch must be a contiguous {(*lead_shape, nb, b, b)} "
            f"f32, got {tuple(scratch.shape)} {scratch.dtype}")
    require(lead * nb <= SYRK_MAX_BLOCKS,
            f"{name}: {lead} matrices x {nb} blocks exceed the launch's "
            f"{SYRK_MAX_BLOCKS} (grid y); no loop over the lead")
    t = b * (b + 1) // 2
    payload = torch.empty((*lead_shape, nb, t), dtype=q.FORMATS[fmt],
                          device=x.device)
    scale = torch.empty((*lead_shape, nb), dtype=torch.float32,
                        device=x.device)
    if lead == 0:
        return payload, scale
    x3 = x.reshape(lead, n, d)        # a view unless the lead is strided
    ld = max(x3.stride(1), d)
    lstride = x3.stride(0) if lead > 1 else n * ld
    lib = build.load()["kfac_factor"]
    with torch.cuda.device(x.device):
        ctas, ws, flags = syrk_buffers(x3, b, nb, zeroed=lead * nb, lead=lead)
        rc = lib.factor_syrk_wire(x3.data_ptr(), scratch.data_ptr(),
                                  flags.data_ptr(), ws.data_ptr(),
                                  flags[lead * nb:].data_ptr(),
                                  payload.data_ptr(), scale.data_ptr(), lead,
                                  lstride, n, ld, d, nb, b,
                                  build.DTYPE_CODES[x.dtype], ctas, code,
                                  pow2, inv_max, stream(x))
    build.check(rc, name)
    LAUNCHES[name] += 1
    return payload, scale
