"""Wrappers of the hand-written Hopper attention kernels.

* :func:`swa_flash` (``csrc/swa_flash.cu``) replaces the TPU kernel
  ``repro/kernels/swa_attention.py::swa_flash``: the causal(-window)
  forward in the ``(BH, S, hd)`` layout, heads flattened into the batch
  axis, no logsumexp. Bound by bytes causal at S 1024, by operations at a
  long window.
* :func:`swa_flash_fwd` (``csrc/swa_flash_fwd.cu``) replaces the TPU kernel
  ``repro/kernels/swa_attention.py::swa_flash_fwd``: the GQA causal(-window)
  prefill forward with the logsumexp residual. Bound by operations at the
  serving path's prefill shapes.
* Both run bf16 on the tensor cores (``csrc/swa_flash_wgmma.cuh``:
  persistent blocks taking 128-row query tiles, ``wgmma`` fed by TMA) and
  f32 on the CUDA cores (``csrc/swa_flash_tile.cuh``), at head dim 64, 128
  or 192 (every kernel here; another head dim raises). :func:`walk_geometry`,
  :func:`key_tiles`, :func:`tile_masked`, :func:`walk_blocks` and
  :func:`block_items` mirror the walk; the launch passes its geometry to
  the kernel, which refuses any other.
* :func:`swa_flash_decode` (``csrc/swa_flash_decode.cu``) replaces
  ``repro/kernels/swa_attention.py::swa_flash_decode``: single-query flash
  decode over a dense or ring cache in its stored dtype, fp8 dequantized on
  read. Bound by the bytes of the visible cache rows. Split-K: the cache's
  slots are cut into :func:`decode_splits`, a block each, and the last
  block of a row to arrive merges the partials in split order, in the same
  launch.
* :func:`swa_flash_bwd` (``csrc/swa_flash_bwd.cu``) replaces
  ``repro/kernels/swa_attention.py::swa_flash_bwd_dq`` and
  ``::swa_flash_bwd_dkdv``: the training backward from the forward's
  (o, lse), two kernels, dk/dv summed per KV head in registers. Bound by
  operations at the training path's shapes. bf16 runs both on the tensor
  cores (``csrc/swa_flash_bwd_wgmma.cuh``: persistent blocks, ``wgmma`` fed
  by TMA, P and dS each split in two bf16 terms): dq walks the forward's
  items (:func:`dq_geometry`), dk/dv takes 128-key items (64 at hd 192,
  :func:`tc_bkey`) and streams 64-query stages (:func:`dkdv_geometry`,
  :func:`query_tiles`, :func:`stage_kind`). f32 keeps the CUDA-core
  bodies.

Each wrapper takes CUDA tensors only (the plain versions for the CPU are in
:mod:`repro_torch.kernels.ref`, chosen by :mod:`repro_torch.kernels
.dispatch`), checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on the current stream and counts the
launch in :data:`LAUNCHES`.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (counters, on_card, require,
                                        sm_count, stream)

# kernel name -> number of launches since the last reset_launches()
LAUNCHES: dict[str, int] = {"swa_flash": 0, "swa_flash_fwd": 0,
                            "swa_flash_decode": 0, "swa_flash_bwd_dq": 0,
                            "swa_flash_bwd_dkdv": 0}
# (kernel name, head dim) -> the same launches, by the head dim they ran at
LAUNCHES_HD: dict[tuple[str, int], int] = {}

_FWD_DTYPES = (torch.float32, torch.bfloat16)
_CACHE_DTYPES = _FWD_DTYPES + (torch.float8_e4m3fn, torch.float8_e5m2)
_HEAD_DIMS = (64, 128, 192)
MAX_GROUP = 16      # csrc/swa_flash_decode.cu MAX_G
MAX_HEADS = 65535   # csrc/swa_flash.cu MAX_GRID_Y
# the decode's split-K (csrc/swa_flash_decode.cu MAX_SPLITS): blocks an SM
# it aims for, and the most splits one merge reads
DECODE_BLOCKS_PER_SM = 4
DECODE_MAX_SPLITS = 64

# the forward walks' query rows per block and keys per tile: bf16 on the
# tensor cores (csrc/swa_flash_wgmma.cuh BQ and Geo<hd>::BK), f32 on the
# CUDA cores (csrc/swa_flash_tile.cuh Geo<hd>::BQ, BK: 2 threads a row, 4
# at hd 192, and 16-key tiles there to stay in 48 KB of shared memory)
TC_BQ, TC_BK = 128, {64: 128, 128: 64, 192: 64}
SIMT_BQ, SIMT_BK = {64: 64, 128: 64, 192: 32}, {64: 32, 128: 32, 192: 16}


@functools.lru_cache(maxsize=None)
def walk_geometry(s: int, hd: int, dtype: torch.dtype
                  ) -> tuple[int, int, tuple[int, ...]]:
    """(query rows per block, keys per tile, query tiles in launch order)
    of one forward launch over S rows of head dim ``hd``. The tensor-core
    walk (bf16) launches its query tiles longest first, the last tile
    first; the CUDA-core walk (f32) in order."""
    if dtype == torch.bfloat16:
        bq, bk = TC_BQ, TC_BK[hd]
        return bq, bk, tuple(reversed(range(-(-s // bq))))
    bq = SIMT_BQ[hd]
    return bq, SIMT_BK[hd], tuple(range(-(-s // bq)))


def key_tiles(qt: int, s: int, window: int, bq: int, bk: int
              ) -> tuple[int, int]:
    """First and last key tile that query tile ``qt`` visits: from the
    tile holding its first row's first visible key to the tile holding its
    last row (the kernels' ``key_tiles``)."""
    q0 = qt * bq
    k_lo = max(0, q0 - window + 1) if window > 0 else 0
    return k_lo // bk, min(q0 + bq - 1, s - 1) // bk


def tile_masked(qt: int, kt: int, window: int, bq: int, bk: int) -> bool:
    """Whether key tile ``kt`` of query tile ``qt`` evaluates the mask: not
    every key of it is visible to every row of the query tile (the
    tensor-core walk's ``interior``, negated)."""
    q0, k0 = qt * bq, kt * bk
    return not (k0 + bk - 1 <= q0
                and (window <= 0 or k0 > q0 + bq - 1 - window))


# the backward's tiles. bf16: dq the forward walk's; dk/dv items of
# TC_BKEY keys (two consumer warpgroups of 64) streaming stages of TC_BQS
# query rows (csrc/swa_flash_bwd_wgmma.cuh BwdGeo<hd>::BKEY, BQS); at hd
# 192 an item is TC_BKEY_SPLIT keys, one warpgroup summing their dV and
# the other their dK. f32 on the CUDA cores: 128 / TPR rows (dq) or keys
# (dk/dv) a block, TPR = hd / 32 threads a row (8 at hd 192), 32-row tiles
# (16 at hd 192) (csrc/swa_flash_bwd.cu Simt<hd>).
TC_BKEY, TC_BQS = 128, 64
TC_BKEY_SPLIT = 64
SIMT_BWD_ROWS = {64: 64, 128: 32, 192: 16}
SIMT_BWD_TILE = {64: 32, 128: 32, 192: 16}


def tc_bkey(hd: int) -> int:
    """Keys per item of the bf16 dk/dv launch at head dim ``hd``."""
    return TC_BKEY_SPLIT if hd == 192 else TC_BKEY


def dq_geometry(s: int, hd: int, dtype: torch.dtype
                ) -> tuple[int, int, tuple[int, ...]]:
    """(query rows per item, keys per tile, query tiles in launch order) of
    one dq launch: bf16 walks the forward's tiles longest first
    (:func:`walk_geometry`), f32 its own blocks in order."""
    if dtype == torch.bfloat16:
        return walk_geometry(s, hd, dtype)
    bq = SIMT_BWD_ROWS[hd]
    return bq, SIMT_BWD_TILE[hd], tuple(range(-(-s // bq)))


def dkdv_geometry(s: int, hd: int, dtype: torch.dtype
                  ) -> tuple[int, int, tuple[int, ...]]:
    """(keys per item, query rows per stage, key tiles in launch order) of
    one dk/dv launch. Under causal attention key tile 0 sees every query
    tile, so the bf16 launch takes key tiles in order: longest first."""
    if dtype == torch.bfloat16:
        bkey = tc_bkey(hd)
        return bkey, TC_BQS, tuple(range(-(-s // bkey)))
    bkey = SIMT_BWD_ROWS[hd]
    return bkey, SIMT_BWD_TILE[hd], tuple(range(-(-s // bkey)))


def query_tiles(kt: int, s: int, window: int, bkey: int, bqs: int
                ) -> tuple[int, int]:
    """First and last query tile (``bqs`` rows) that key tile ``kt`` visits,
    for each query head of its group: from the tile holding its first key
    to the tile holding the last query that sees its last key (the
    kernel's ``query_tiles``)."""
    k0 = kt * bkey
    k_hi = min(k0 + bkey - 1, s - 1)
    q_end = min(s, k_hi + window) if window > 0 else s
    return k0 // bqs, (q_end - 1) // bqs


def stage_kind(kc: int, qt: int, s: int, window: int, bqs: int,
               keys: int = TC_BKEY // 2) -> str:
    """What a dk/dv consumer owning ``keys`` keys from ``kc`` does with
    query tile ``qt``: ``"skip"`` when none of the pairs is visible,
    ``"interior"`` when every one is (no mask), else ``"masked"`` (the
    kernel's ``stage_kind``)."""
    q0, q1, k1 = qt * bqs, qt * bqs + bqs - 1, kc + keys - 1
    if kc >= s or kc > q1 or (window > 0 and k1 <= q0 - window):
        return "skip"
    if k1 <= q0 and q1 < s and (window <= 0 or kc > q1 - window):
        return "interior"
    return "masked"


def walk_blocks(items: int, sms: int) -> int:
    """Persistent blocks of one tensor-core launch over ``items`` work
    items (query tile, query head): one per SM, at most one per item."""
    return max(1, min(items, sms))


def block_items(b: int, blocks: int, items: int) -> list[int]:
    """The work items block ``b`` of ``blocks`` takes, in its order: b,
    2 blocks - 1 - b, 2 blocks + b, ... below ``items`` (the kernel's
    ``item_of``). Item i is query tile ``order[i // heads]`` of
    :func:`walk_geometry` (longest first) and query head ``i % heads``."""
    out, r = [], 0
    while (i := r * blocks + (blocks - 1 - b if r & 1 else b)) < items:
        out.append(i)
        r += 1
    return out


def decode_tile(hd: int) -> int:
    """Cache slots a decode block stages in shared memory at a time
    (``csrc/swa_flash_decode.cu`` Tile<HD>::T): 16 KB of f32 K rows."""
    return 4096 // hd


def decode_splits(n: int, c: int, hd: int, sms: int) -> tuple[int, int]:
    """(splits S, slots per split) of one decode launch over ``n`` (lane,
    KV head) rows of a ``c``-slot cache: split s takes slots [s * per,
    (s + 1) * per), ``per`` a whole number of tiles. The launch is n x S
    blocks; S is chosen so that n * S reaches DECODE_BLOCKS_PER_SM blocks
    an SM where the cache has tiles for it, at most DECODE_MAX_SPLITS, and
    no split is empty of slots. It depends on shapes only: the host never
    reads ``pos``."""
    tile = decode_tile(hd)
    tiles = -(-c // tile)
    want = -(-DECODE_BLOCKS_PER_SM * sms // max(n, 1))
    s = max(1, min(tiles, want, DECODE_MAX_SPLITS))
    per = -(-tiles // s)
    return -(-tiles // per), per * tile


def _blocks(q: torch.Tensor, heads: int, tiles: int) -> int:
    """Persistent blocks of a bf16 launch over ``heads`` x ``tiles`` work
    items (0 for f32, whose bodies launch a block per tile and head)."""
    if q.dtype != torch.bfloat16:
        return 0
    return walk_blocks(heads * tiles, sm_count(q.device.index))


def _check_aligned(name: str, *ts: torch.Tensor) -> None:
    """The tensor-core walk's TMA loads read bf16 data from 16-byte
    boundaries (every fresh allocation starts on one)."""
    if ts[0].dtype == torch.bfloat16:
        require(all(t.data_ptr() % 16 == 0 for t in ts),
                f"{name}: bf16 inputs must start on 16-byte boundaries")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LAUNCHES_HD.clear()


def _count(name: str, hd: int) -> None:
    LAUNCHES[name] += 1
    LAUNCHES_HD[name, hd] = LAUNCHES_HD.get((name, hd), 0) + 1


def _check_cuda(name: str, *ts: torch.Tensor) -> None:
    on_card(name, *ts)
    for t in ts:
        require(t.is_contiguous(), f"{name}: inputs must be contiguous")


def swa_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              window: int = 0) -> torch.Tensor:
    """q, k, v (BH, S, hd) -> out (BH, S, hd) in q's dtype: key j is
    visible to query i iff ``i - window < j <= i`` (window 0: causal)."""
    name = "swa_flash"
    _check_cuda(name, q, k, v)
    require(q.dim() == 3 and k.shape == q.shape and v.shape == q.shape,
            f"{name}: q, k, v must share one (BH, S, hd) shape, got "
            f"q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    bh, s, hd = q.shape
    require(q.dtype in _FWD_DTYPES and k.dtype == q.dtype
            and v.dtype == q.dtype,
            f"{name}: dtypes {q.dtype}/{k.dtype}/{v.dtype}")
    require(hd in _HEAD_DIMS, f"{name}: head dim {hd} not in {_HEAD_DIMS}")
    require(window >= 0, f"{name}: window must be >= 0")
    require(bh <= MAX_HEADS, f"{name}: BH {bh} > {MAX_HEADS}")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    _check_aligned(name, q, k, v)
    bq, bk, order = walk_geometry(s, hd, q.dtype)
    blocks = _blocks(q, bh, len(order))
    lib = build.load()[name]
    with torch.cuda.device(q.device):
        rc = lib.swa_flash(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           out.data_ptr(), bh, s, hd, int(window), bq, bk,
                           blocks, build.DTYPE_CODES[q.dtype], hd ** -0.5,
                           stream(q))
    build.check(rc, name)
    _count(name, hd)
    return out


def swa_flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """q (BKV, G, S, hd); k, v (BKV, S, hd) -> (out (BKV, G, S, hd) in q's
    dtype, lse (BKV, G, S) f32)."""
    _check_cuda("swa_flash_fwd", q, k, v)
    require(q.dim() == 4 and k.dim() == 3 and v.shape == k.shape,
            f"swa_flash_fwd: bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
            f"v{tuple(v.shape)}")
    bkv, g, s, hd = q.shape
    require(k.shape == (bkv, s, hd), "swa_flash_fwd: k/v must be (BKV, S, hd)"
            " matching q (BKV, G, S, hd)")
    require(q.dtype in _FWD_DTYPES and k.dtype == q.dtype
            and v.dtype == q.dtype,
            f"swa_flash_fwd: dtypes {q.dtype}/{k.dtype}/{v.dtype}")
    require(hd in _HEAD_DIMS, f"swa_flash_fwd: head dim {hd} not in "
                              f"{_HEAD_DIMS}")
    require(window >= 0, "swa_flash_fwd: window must be >= 0")
    out = torch.empty_like(q)
    lse = torch.empty((bkv, g, s), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return out, lse
    _check_aligned("swa_flash_fwd", q, k, v)
    bq, bk, order = walk_geometry(s, hd, q.dtype)
    blocks = _blocks(q, bkv * g, len(order))
    lib = build.load()["swa_flash_fwd"]
    with torch.cuda.device(q.device):
        rc = lib.swa_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               out.data_ptr(), lse.data_ptr(), bkv, g, s, hd,
                               int(window), bq, bk, blocks,
                               build.DTYPE_CODES[q.dtype], hd ** -0.5,
                               stream(q))
    build.check(rc, "swa_flash_fwd")
    _count("swa_flash_fwd", hd)
    return out, lse


def _cache_strides(name: str, t: torch.Tensor, n: int, c: int, hd: int):
    """(kvh, stride_b, stride_h, stride_c) of a cache operand: (N, C[, hd])
    contiguous, or a (B, KV, C[, hd]) view with any strides (the serving
    cache read in place), N = B * KV."""
    rank = 3 if hd else 2
    tail = (c, hd) if hd else (c,)
    if hd:
        require(t.stride(-1) == 1, f"{name}: rows must be contiguous")
    if t.dim() == rank:
        require(tuple(t.shape) == (n,) + tail and t.is_contiguous(),
                f"{name}: expected a contiguous {(n,) + tail}, got "
                f"{tuple(t.shape)}")
        return 1, t.stride(0), 0, t.stride(1)
    require(t.dim() == rank + 1 and t.shape[0] * t.shape[1] == n
            and tuple(t.shape[2:]) == tail,
            f"{name}: expected (B, KV) + {tail} with B*KV == {n}, got "
            f"{tuple(t.shape)}")
    return t.shape[1], t.stride(0), t.stride(1), t.stride(2)


def swa_flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: torch.Tensor, *, window: int = 0,
                     k_scale: torch.Tensor | None = None,
                     v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """q (N, G, hd); k/v (N, C, hd) or a (B, KV, C, hd) view of the serving
    cache (N = B * KV), stored dtype; pos (N,) i32; optional k_scale/v_scale
    (N, C) or (B, KV, C) f32. ``window > 0`` is the ring with C == window,
    0 the dense cache. Returns (N, G, hd) f32."""
    name = "swa_flash_decode"
    scales = [t for t in (k_scale, v_scale) if t is not None]
    for t in (q, k, v, pos, *scales):
        require(t.is_cuda, f"{name} runs on CUDA tensors only (got one on "
                           f"{t.device}); CPU tensors take the plain version "
                           "through repro_torch.kernels.dispatch")
        require(t.device == q.device, f"{name}: tensors on different devices")
    require(q.dim() == 3 and q.is_contiguous() and pos.is_contiguous(),
            f"{name}: q must be a contiguous (N, G, hd)")
    n, g, hd = q.shape
    require(k.dim() in (3, 4) and v.shape == k.shape
            and v.stride() == k.stride(),
            f"{name}: k/v shapes {tuple(k.shape)}/{tuple(v.shape)} and "
            "strides must match")
    c = k.shape[-2]
    kvh, s_b, s_h, s_c = _cache_strides(name, k, n, c, hd)
    sc = (1, 0, 0, 0)
    if scales:
        require(k_scale is not None and v_scale is not None
                and k_scale.shape == v_scale.shape
                and k_scale.stride() == v_scale.stride(),
                f"{name}: k_scale and v_scale come together, alike")
        require(k_scale.dtype == torch.float32 and v_scale.dtype == torch.float32,
                f"{name}: scales must be float32")
        sc = _cache_strides(name, k_scale, n, c, 0)
        require(sc[0] == kvh, f"{name}: scales and cache differ in layout")
    require(pos.shape == (n,) and pos.dtype == torch.int32,
            f"{name}: pos must be (N,) int32")
    require(q.dtype in _FWD_DTYPES, f"{name}: q dtype {q.dtype}")
    require(k.dtype in _CACHE_DTYPES and v.dtype == k.dtype,
            f"{name}: cache dtypes {k.dtype}/{v.dtype}")
    require(hd in _HEAD_DIMS, f"{name}: head dim {hd} not in {_HEAD_DIMS}")
    require(1 <= g <= MAX_GROUP, f"{name}: group {g} not in [1, {MAX_GROUP}]")
    require(window >= 0, f"{name}: window must be >= 0")
    if window:
        require(c == window, f"ring decode needs k.shape[-2] == window; got "
                             f"{c} vs {window}")
    out = torch.empty((n, g, hd), dtype=torch.float32, device=q.device)
    if n == 0:
        return out
    require(c > 0, f"{name}: empty cache")
    splits, per = decode_splits(n, c, hd, sm_count(q.device.index))
    # each block's partial (acc, m, d), and the merge's arrival counters
    part = torch.empty((n, splits, g * hd + 2 * g), dtype=torch.float32,
                       device=q.device)
    arrived = counters(q, n)
    lib = build.load()["swa_flash_decode"]
    with torch.cuda.device(q.device):
        rc = lib.swa_flash_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            k_scale.data_ptr() if k_scale is not None else None,
            v_scale.data_ptr() if v_scale is not None else None,
            pos.data_ptr(), out.data_ptr(), part.data_ptr(),
            arrived.data_ptr(), n, g, c, hd, int(window),
            build.DTYPE_CODES[q.dtype], build.DTYPE_CODES[k.dtype], splits,
            per, hd ** -0.5, kvh, s_b, s_h, s_c, sc[1], sc[2], sc[3],
            stream(q))
    build.check(rc, name)
    _count(name, hd)
    return out


def swa_flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                  window: int = 0):
    """Backward of :func:`swa_flash_fwd` from its residuals: q, o, do
    (BKV, G, S, hd); k, v (BKV, S, hd); lse (BKV, G, S) f32. Returns (dq
    (BKV, G, S, hd), dk (BKV, S, hd), dv (BKV, S, hd)), all f32. ``delta =
    rowsum(do * o)`` is taken here in f32, outside the kernels."""
    name = "swa_flash_bwd"
    _check_cuda(name, q, k, v, o, lse, do)
    require(q.dim() == 4 and k.dim() == 3 and v.shape == k.shape,
            f"{name}: bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
            f"v{tuple(v.shape)}")
    bkv, g, s, hd = q.shape
    require(k.shape == (bkv, s, hd) and o.shape == q.shape
            and do.shape == q.shape and lse.shape == (bkv, g, s),
            f"{name}: shapes do not match q (BKV, G, S, hd)")
    require(q.dtype in _FWD_DTYPES and k.dtype == q.dtype
            and v.dtype == q.dtype and do.dtype == q.dtype,
            f"{name}: dtypes {q.dtype}/{k.dtype}/{v.dtype}/{do.dtype}")
    require(lse.dtype == torch.float32, f"{name}: lse must be float32")
    require(hd in _HEAD_DIMS, f"{name}: head dim {hd} not in {_HEAD_DIMS}")
    require(window >= 0, f"{name}: window must be >= 0")
    delta = (do.float() * o.float()).sum(-1)
    return (swa_flash_bwd_dq(q, k, v, lse, delta, do, window=window),
            *swa_flash_bwd_dkdv(q, k, v, lse, delta, do, window=window))


def _bwd_args(q, k, v, lse, delta, do):
    require(delta.shape == lse.shape and delta.dtype == torch.float32
            and delta.is_cuda and delta.is_contiguous(),
            "swa_flash_bwd: delta must be a contiguous f32 (BKV, G, S)")
    _check_aligned("swa_flash_bwd", q, k, v, do)
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), do.data_ptr())


def swa_flash_bwd_dq(q, k, v, lse, delta, do, *, window: int = 0):
    """dq (BKV, G, S, hd) f32 from the residuals and ``delta`` (the dq
    kernel alone; :func:`swa_flash_bwd` checks the operands)."""
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return dq
    bkv, g, s, hd = q.shape
    head = _bwd_args(q, k, v, lse, delta, do)
    bq, bk, order = dq_geometry(s, hd, q.dtype)
    blocks = _blocks(q, bkv * g, len(order))
    with torch.cuda.device(q.device):
        rc = build.load()["swa_flash_bwd"].swa_flash_bwd_dq(
            *head, dq.data_ptr(), bkv, g, s, hd, int(window), bq, bk, blocks,
            build.DTYPE_CODES[q.dtype], hd ** -0.5, stream(q))
    build.check(rc, "swa_flash_bwd_dq")
    _count("swa_flash_bwd_dq", hd)
    return dq


def swa_flash_bwd_dkdv(q, k, v, lse, delta, do, *, window: int = 0):
    """(dk, dv) (BKV, S, hd) f32, summed over each KV head's query group
    (the dkdv kernel alone)."""
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return dk, dv
    bkv, g, s, hd = q.shape
    head = _bwd_args(q, k, v, lse, delta, do)
    bkey, bqs, order = dkdv_geometry(s, hd, q.dtype)
    blocks = _blocks(q, bkv, len(order))
    with torch.cuda.device(q.device):
        rc = build.load()["swa_flash_bwd"].swa_flash_bwd_dkdv(
            *head, dk.data_ptr(), dv.data_ptr(), bkv, g, s, hd, int(window),
            bkey, bqs, blocks, build.DTYPE_CODES[q.dtype], hd ** -0.5,
            stream(q))
    build.check(rc, "swa_flash_bwd_dkdv")
    _count("swa_flash_bwd_dkdv", hd)
    return dk, dv
