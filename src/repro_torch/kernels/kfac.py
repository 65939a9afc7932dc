"""Wrappers of the two hand-written K-FAC kernels.

* :func:`factor_syrk` (``csrc/kfac_factor.cu``) replaces the TPU kernel
  ``repro/kernels/kfac_factor.py::factor_syrk``: every diagonal block's
  ``X_k^T X_k`` of a token matrix in one launch, f32 sums from bf16 or f32,
  the ragged last block masked. Bound by operations at the dense sites'
  shapes, by bytes (its f32 output) at an MoE site's few tokens per
  expert. bf16 runs on the tensor cores (``wgmma``, 128 x 128 tiles, the
  work shared out evenly over the SMs: :func:`syrk_geometry`). f32
  (:func:`syrk_f32_route`) keeps the one-accumulator CUDA-core tile below
  F32_SPLIT_ROWS rows (its order is the plain f32 product's at n 4096);
  from there its tokens split into chunks (:func:`syrk_f32_split`) whose
  partials a second launch sums in a fixed order: blocks up to
  F32_NARROW_MAX wide stream x once on the CUDA cores, bound by bytes
  (:func:`narrow_stage_rows`, :func:`narrow_patches`); wider ones take
  split TF32 products on the tensor cores over lower tile pairs, the last
  row tile cut to fit b or, at 16 rows or fewer, joined to the one before
  (:func:`wide_pairs`, :func:`wide_tile_rows`).
* :func:`block_precond` (``csrc/kfac_precond.cu``) replaces
  ``repro/kernels/kfac_precond.py::block_precond``: ``Binv[k] @ W[k]`` over
  the row blocks of W (left) or ``W[:, k] @ Binv[k]`` over its column
  blocks (right), W read in place. Bound by operations: f32-accurate split
  TF32 products (3xTF32) on the tensor cores, 128 x 128 tiles, persistent
  blocks over all (block, tile) items (:func:`precond_geometry`).

Both take leading axes (the experts of an MoE site: x (E, n, d), binv
(E, nb, b, b), w (E, d, m)) in the same one launch: the work items run
over every (matrix, block) pair, and no Python loop runs over the lead.

Each wrapper takes CUDA tensors only (the plain versions for the CPU are in
:mod:`repro_torch.kernels.ref`, chosen by :mod:`repro_torch.kernels
.dispatch`), checks device, dtype, shape and layout, allocates its output
with ``torch.empty``, launches on the current stream and counts the launch
in :data:`LAUNCHES`.
"""

from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import on_card, require, stream

# kernel name -> number of launches since the last reset_launches()
LAUNCHES: dict[str, int] = {"factor_syrk": 0, "block_precond": 0}

SYRK_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    F32_ROUTES.clear()


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
def syrk_geometry(n: int, b: int, nb: int, sms: int, lead: int = 1
                  ) -> tuple[int, int, int, int]:
    """(tiles along a block's edge, slices of 64 tokens per tile, blocks of
    threads, slices per block) of one bf16 factor_syrk launch over ``lead``
    matrices of n tokens, each in nb blocks of b, on ``sms`` SMs.

    The work is lead * nb * tiles(tiles+1)/2 upper tiles of 128 x 128
    times ``slices`` slices, tile-major (tile q of (matrix, block) q //
    pairs, in the flattened order e * nb + k); block w sums [w * per,
    (w + 1) * per) of
    it. At _WAVES_UNSHARED tiles per SM or more, one block per tile;
    below, at most one block per SM (the body's 193 KB of shared memory),
    the count that minimizes per + the cost of sharing: the partial's
    write and the last block's sum over the most blocks any tile has
    (stream-K)."""
    tiles = -(-b // TC_TILE)
    slices = max(-(-n // TC_SLICE), 1)
    ntiles = lead * nb * tiles * (tiles + 1) // 2
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


# csrc/simt_tile.cuh: the f32 body's output tile and slice depth below
# F32_SPLIT_ROWS rows (one block of threads a tile pair, one accumulator)
SIMT_TILE, SIMT_BK = 64, 16
# csrc/kfac_factor.cu: from F32_SPLIT_ROWS rows on the f32 tokens split into
# chunks whose partials a second launch sums; blocks up to F32_NARROW_MAX
# wide stream x once on the CUDA cores ("narrow"), wider ones take split
# TF32 products on the tensor cores ("wide")
F32_SPLIT_ROWS, F32_NARROW_MAX = 16384, 64
# a chunk's rows at most: the length of one accumulation
F32_MAX_CHUNK = 16384
# narrow: floats a ring stage holds (narrow::STAGE_FLOATS), blocks of
# threads asked an SM
NARROW_STAGE_FLOATS, NARROW_CTAS_PER_SM = 4096, 2
# wide: C tile edge and tokens a stage (wide::TILE, f32g::BK); chunks asked
# for this many waves of blocks of threads (the items differ in cost, so
# many waves balance the SMs), each chunk at least WIDE_MIN_CHUNK rows
WIDE_TILE, WIDE_BK, WIDE_WAVES, WIDE_MIN_CHUNK = 128, 32, 6, 1024
# the reduce: chunk z in group z mod SYRK_REDUCE_GROUPS (RED_GROUPS)
SYRK_REDUCE_GROUPS = 8

# f32 launches by (route, n, b) since the last reset_launches()
F32_ROUTES: dict[tuple[str, int, int], int] = {}


def syrk_f32_route(n: int, b: int) -> str:
    """The body an f32 factor_syrk launch over n tokens in blocks of b
    takes: "simt" below F32_SPLIT_ROWS rows, then "narrow" up to
    F32_NARROW_MAX, else "wide"."""
    if n < F32_SPLIT_ROWS:
        return "simt"
    return "narrow" if b <= F32_NARROW_MAX else "wide"


def count_f32_route(n: int, b: int) -> None:
    """Count one f32 launch (made) in :data:`F32_ROUTES`."""
    key = (syrk_f32_route(n, b), n, b)
    F32_ROUTES[key] = F32_ROUTES.get(key, 0) + 1


def narrow_stage_rows(b: int) -> int:
    """Rows of a narrow ring stage (narrow::stage_rows): about
    NARROW_STAGE_FLOATS floats, a multiple of 4 (a flat stage starts on a
    16-byte boundary)."""
    return max(4, NARROW_STAGE_FLOATS // b // 4 * 4)


def narrow_patches(b: int) -> list[tuple[int, int]]:
    """The narrow body's lower 4 x 4 patches (pi >= pj) in the kernel's
    order (narrow::patch_of): thread q of a slot keeps patch q."""
    p4 = -(-b // 4)
    return [(pi, pj) for pi in range(p4) for pj in range(pi + 1)]


def _wide_absorbs(b: int) -> bool:
    """wide::absorbs: b leaves 16 rows or fewer after its last full
    128-row tile, and they join the tile before."""
    return b > WIDE_TILE and b - (b - 1) // WIDE_TILE * WIDE_TILE <= 16


def wide_pairs(b: int) -> list[tuple[int, int]]:
    """The wide body's lower tile pairs (row tile r >= column tile c) in
    the kernel's order (wide::pair_of); when the last row tile is
    absorbed, only its diagonal pair stays, last."""
    tiles = -(-b // WIDE_TILE)
    if _wide_absorbs(b):
        return [(r, c) for r in range(tiles - 1) for c in range(r + 1)] + [
            (tiles - 1, tiles - 1)]
    return [(r, c) for r in range(tiles) for c in range(r + 1)]


def wide_tile_rows(r: int, b: int) -> int:
    """C rows of row tile r (wide::tile_rows): 128; 144 for the tile that
    absorbs the last rows; the last tile the least of 16, 32, 64, 128 that
    covers what is left of b."""
    rest = b - r * WIDE_TILE
    if rest > WIDE_TILE:
        return 144 if _wide_absorbs(b) and rest <= WIDE_TILE + 16 else 128
    return 128 if rest > 64 else 64 if rest > 32 else 32 if rest > 16 else 16


def _chunks(n: int, asked: int, unit: int) -> tuple[int, int]:
    """(rows per chunk, chunks) from the chunks asked: the kernel's
    chunk_rows, a multiple of the route's unit, and the chunks covering n."""
    rows = -(-(-(-n // asked)) // unit) * unit
    return rows, -(-n // rows)


@functools.lru_cache(maxsize=None)
def syrk_f32_split(n: int, b: int, nb: int, sms: int, lead: int = 1
                   ) -> tuple[int, int, int]:
    """(chunks asked, rows per chunk, chunks launched) of one f32
    factor_syrk launch over ``lead`` matrices of n tokens, each in nb
    blocks of b, on ``sms`` SMs. "simt": one chunk of every row. From
    F32_SPLIT_ROWS rows each chunk holds at most F32_MAX_CHUNK rows, a
    multiple of the route's stage. "narrow": enough chunks for
    NARROW_CTAS_PER_SM blocks of threads an SM, one per (chunk, matrix
    block). "wide": one block of threads per (chunk, matrix block, lower
    tile pair), chunks for WIDE_WAVES waves of them, each at least
    WIDE_MIN_CHUNK rows. Chunk z holds rows [z rows, (z + 1) rows)."""
    route = syrk_f32_route(n, b)
    if route == "simt":
        return 1, max(SIMT_BK, -(-n // SIMT_BK) * SIMT_BK), 1
    blocks = lead * nb
    lo = max(1, -(-n // F32_MAX_CHUNK))
    if route == "narrow":
        asked = max(lo, -(-NARROW_CTAS_PER_SM * sms // blocks))
        return (asked, *_chunks(n, asked, narrow_stage_rows(b)))
    items = blocks * len(wide_pairs(b))
    asked = max(lo, min(-(-WIDE_WAVES * sms // items),
                        max(1, n // WIDE_MIN_CHUNK)))
    return (asked, *_chunks(n, asked, WIDE_BK))


def syrk_buffers(x: torch.Tensor, b: int, nb: int, zeroed: int = 0,
                 lead: int = 1):
    """Launch geometry and scratch of one factor_syrk launch on x (lead
    matrices of x.shape[-2] tokens): (blocks of threads, or f32's chunks
    asked, workspace, flags), flags zeroed: flags[:zeroed] for the caller
    (the wire kernel's amax), then (bf16) one arrival counter per tile of
    every matrix. The workspace holds bf16's partials of shared tiles, or
    f32's per-chunk partials of every block (:func:`syrk_f32_split`)."""
    ws = torch.empty((0,), dtype=torch.float32, device=x.device)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    n = x.shape[-2]
    if x.dtype != torch.bfloat16:
        asked, _, chunks = syrk_f32_split(n, b, nb, sms, lead)
        if syrk_f32_route(n, b) != "simt":
            ws = torch.empty((chunks * lead * nb * b * b,),
                             dtype=torch.float32, device=x.device)
        return asked, ws, torch.zeros((zeroed,), dtype=torch.int32,
                                      device=x.device)
    tiles, slices, ctas, per = syrk_geometry(n, b, nb, sms, lead)
    counters = 0
    if per % slices:
        ws = torch.empty((2 * ctas * TC_TILE * TC_TILE,), dtype=torch.float32,
                         device=x.device)
        counters = lead * nb * tiles * (tiles + 1) // 2
    return ctas, ws, torch.zeros((zeroed + counters,), dtype=torch.int32,
                                 device=x.device)


def factor_syrk(x: torch.Tensor, max_dim: int) -> torch.Tensor:
    """x (..., n, d) bf16 | f32, rows contiguous -> (..., nb, b, b) f32
    with nb, b = num_blocks(d, max_dim), block_size(d, max_dim): every
    matrix over the leading axes (an MoE site's experts) in one launch."""
    from repro_torch.core import kfac
    name = "factor_syrk"
    on_card(name, x)
    require(x.dim() >= 2, f"{name}: x must be (..., n, d), got "
                          f"{tuple(x.shape)}")
    require(x.dtype in SYRK_DTYPES, f"{name}: dtype {x.dtype} not in "
                                     f"{SYRK_DTYPES}")
    require(x.stride(-1) == 1 or x.shape[-1] == 1,
            f"{name}: rows must be contiguous")
    *lead_shape, n, d = x.shape
    nb, b = kfac.num_blocks(d, max_dim), kfac.block_size(d, max_dim)
    out = torch.empty((*lead_shape, nb, b, b), dtype=torch.float32,
                      device=x.device)
    lead = math.prod(lead_shape)
    if out.numel() == 0:
        return out
    x3 = x.reshape(lead, n, d)        # a view unless the lead is strided
    ld = max(x3.stride(1), d)
    lstride = x3.stride(0) if lead > 1 else n * ld
    lib = build.load()["kfac_factor"]
    with torch.cuda.device(x.device):
        ctas, ws, flags = syrk_buffers(x3, b, nb, lead=lead)
        rc = lib.factor_syrk(x3.data_ptr(), out.data_ptr(), ws.data_ptr(),
                             flags.data_ptr(), lead, lstride, n, ld, d, nb, b,
                             build.DTYPE_CODES[x.dtype], ctas, stream(x))
    build.check(rc, name)
    LAUNCHES[name] += 1
    if x.dtype == torch.float32:
        count_f32_route(n, b)
    return out


# csrc/kfac_precond.cu: output tile (TN x TM of f32_split_gemm.cuh)
PRECOND_TILE = 128


@functools.lru_cache(maxsize=None)
def precond_geometry(nb: int, b: int, dim: int, other: int, right: bool,
                     sms: int, lead: int = 1) -> tuple[int, int, int, int]:
    """(tiles along a block's output rows, tiles along its columns, work
    items, blocks of threads) of one block_precond launch over ``lead``
    matrices on ``sms`` SMs.

    Block k's output is (valid, other) on the left and (other, valid) on
    the right, valid = min(b, dim - k b), cut into 128 x 128 tiles; the
    items are lead x nb x tiles_r x tiles_c (:func:`precond_item`), one
    persistent block of threads per SM (the ring's 193 KB of shared
    memory), block w taking items w, w + blocks, ...
    (:func:`precond_block_items`)."""
    tiles_r = -(-(other if right else b) // PRECOND_TILE)
    tiles_c = -(-(b if right else other) // PRECOND_TILE)
    items = lead * nb * tiles_r * tiles_c
    return tiles_r, tiles_c, items, min(items, sms)


def precond_item(i: int, nb: int, b: int, dim: int, other: int, right: bool
                 ) -> tuple[int, int, int, int] | None:
    """The kernel's item i (``item_tile``): (block k, first output row,
    first output column, valid) of its tile within block k's output, or
    None for a tile past the ragged last block's valid rows (left) or
    columns (right). The tile index along binv's side runs fastest. Over
    leading axes k counts on across the matrices: matrix k // nb, its
    block k % nb (the kernel's e and k)."""
    tiles_r, tiles_c, _, _ = precond_geometry(nb, b, dim, other, right, 1)
    per = tiles_r * tiles_c
    k, t = divmod(i, per)
    if right:
        tr, tc = divmod(t, tiles_c)
    else:
        tc, tr = divmod(t, tiles_r)
    valid = min(b, dim - k % nb * b)
    if (tc if right else tr) * PRECOND_TILE >= valid:
        return None
    return k, tr * PRECOND_TILE, tc * PRECOND_TILE, valid


def precond_block_items(w: int, blocks: int, items: int) -> range:
    """The items block of threads w takes."""
    return range(w, items, blocks)


def block_precond(binv: torch.Tensor, w: torch.Tensor, *,
                  right: bool = False) -> torch.Tensor:
    """binv (..., nb, b, b) f32 contiguous. Left: w (..., dim, m) -> Binv
    applied to each b-row block of w; right: w (..., m, dim) -> each
    b-column block of w times Binv. dim <= nb*b (the last block may be
    ragged); w f32 with contiguous rows; the leading axes of binv and w
    equal (an MoE site's experts), all their matrices in one launch.
    Returns f32 of w's shape."""
    name = "block_precond"
    on_card(name, binv, w)
    require(binv.dim() >= 3 and binv.shape[-2] == binv.shape[-1]
            and binv.is_contiguous(),
            f"{name}: binv must be a contiguous (..., nb, b, b), got "
            f"{tuple(binv.shape)}")
    require(w.dim() == binv.dim() - 1 and w.shape[:-2] == binv.shape[:-3]
            and w.stride(-1) == 1,
            f"{name}: w must be (..., rows, cols) with binv's leading axes "
            f"{tuple(binv.shape[:-3])} and contiguous rows, got "
            f"{tuple(w.shape)}")
    require(binv.dtype == torch.float32 and w.dtype == torch.float32,
            f"{name}: f32 only (got {binv.dtype}, {w.dtype})")
    nb, b = binv.shape[-3], binv.shape[-1]
    rows, cols = w.shape[-2:]
    dim, other = (cols, rows) if right else (rows, cols)
    require((nb - 1) * b < dim <= nb * b,
            f"{name}: {nb} blocks of {b} do not cover dim {dim}")
    out = torch.empty(w.shape, dtype=torch.float32, device=w.device)
    if w.numel() == 0:
        return out
    w3 = w.reshape(-1, rows, cols)    # a view unless the lead is strided
    lead = w3.shape[0]
    ldw = w3.stride(1) if rows > 1 else cols
    lw = w3.stride(0) if lead > 1 else rows * ldw
    lib = build.load()["kfac_precond"]
    with torch.cuda.device(w.device):
        sms = torch.cuda.get_device_properties(w.device).multi_processor_count
        blocks = precond_geometry(nb, b, dim, other, right, sms, lead)[3]
        rc = lib.block_precond(binv.data_ptr(), w3.data_ptr(), out.data_ptr(),
                               lead, nb * b * b, lw, rows * cols, b, dim,
                               other, ldw, cols, nb, int(right), blocks,
                               stream(w))
    build.check(rc, name)
    LAUNCHES[name] += 1
    return out
