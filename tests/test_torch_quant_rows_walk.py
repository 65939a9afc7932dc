"""quant_rows' resident route (``csrc/quant_pack.cu`` rows_resident_kernel)
on the CPU.

The kernel runs only on the card (``chip_smoke.py``). Here its schedule and
its arithmetic are checked through two mirrors:

* the schedule as ``kernels/quant.py`` gives it to the launch
  (``quant_slice``, ``quant_items``): every element of every row lies in
  exactly one item, a row's items all lie in one wave, a block takes at
  most one item a wave and its items in row order, and a run of the
  kernel's protocol on blocks that all progress (publish the item of the
  next wave, then wait on the current row) ends without a deadlock; a row
  longer than grid x QUANT_SLICE_MAX takes the long-row (two-pass) route;
* an emulation of the kernel's arithmetic item by item (each item's amax
  from the bits of |x|, the row's amax as their max, ``fp8_quant.cuh``'s
  scale, ``x / s`` clipped and cast), held bit for bit against ``repro``'s
  ``quant_rows`` in interpret mode and the port's plain version
  (``ref.quant_rows_ref``): fp32 and pow2 scales (pow2 inside the range
  where XLA's exp2 is exact), zero rows; rows holding a NaN against the
  port's plain version only (``repro``'s NaN handling is no oracle here,
  ROADMAP Queue 3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypothesis_compat import given, settings, st
from repro.kernels import ops as jops
from repro_torch.kernels import quant as qk
from repro_torch.kernels import ref
from repro_torch.quant import quant

H100_GRID = 132          # one resident block an SM on an H100 SXM
MIN_NORMAL = np.float32(2.0 ** -126)    # csrc/fp8_quant.cuh kMinNormal


def _check_schedule(g, t, grid, slice_):
    per_row = -(-t // slice_)
    assert slice_ % qk.QUANT_SLICE_ALIGN == 0
    assert 0 < slice_ <= qk.QUANT_SLICE_MAX and per_row <= grid
    items = qk.quant_items(g, t, grid, slice_)
    assert len(items) == g * per_row
    cover = {}
    waves = {}
    taken = set()
    for block, wave, row, lo, hi in items:
        assert 0 <= block < grid and lo < hi
        cover.setdefault(row, []).append((lo, hi))
        waves.setdefault(row, set()).add(wave)
        assert (block, wave) not in taken, "a block takes one item a wave"
        taken.add((block, wave))
    assert sorted(cover) == list(range(g))
    for row, spans in cover.items():
        spans.sort()
        assert spans[0][0] == 0 and spans[-1][1] == t
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
        assert len(waves[row]) == 1, "a row's items lie in one wave"
    # a block's items come in wave order with rising rows
    by_block = {}
    for block, wave, row, _, _ in sorted(items, key=lambda i: (i[0], i[1])):
        by_block.setdefault(block, []).append(row)
    assert all(rows == sorted(rows) for rows in by_block.values())
    return items


def _run_protocol(items, per_row):
    """Every block runs the kernel's order: publish its first item; then
    for each item k, publish item k + 1, wait until item k's row has
    per_row arrivals, quantize. Blocks advance in rounds as far as they
    can; returns the rounds, and fails if a round moves no block."""
    progs = {}
    for block, wave, row, _, _ in sorted(items, key=lambda i: (i[0], i[1])):
        progs.setdefault(block, []).append(row)
    arrivals = {}
    # state: (items published, items quantized)
    state = {b: [0, 0] for b in progs}

    def publish(b):
        rows, st_ = progs[b], state[b]
        arrivals[rows[st_[0]]] = arrivals.get(rows[st_[0]], 0) + 1
        st_[0] += 1

    for b in progs:
        publish(b)
    rounds = 0
    while any(st_[1] < len(progs[b]) for b, st_ in state.items()):
        rounds += 1
        moved = False
        for b, rows in progs.items():
            st_ = state[b]
            while st_[1] < len(rows):
                k = st_[1]
                if st_[0] == k + 1 and k + 1 < len(rows):
                    publish(b)
                    moved = True
                if arrivals.get(rows[k], 0) < per_row:
                    break
                st_[1] += 1
                moved = True
        assert moved, "deadlock: no block can move"
    return rounds


@settings(deadline=None)
@given(g=st.integers(1, 70), t=st.integers(1, 3_000_000),
       grid=st.integers(1, 140))
def test_schedule_covers_every_element_once_in_one_wave(g, t, grid):
    slice_ = qk.quant_slice(g, t, grid)
    if -(-t // qk.QUANT_SLICE_MAX) > grid:
        assert slice_ == 0, "a row longer than grid x QUANT_SLICE_MAX " \
                            "takes the long-row route"
        return
    assert slice_ > 0
    items = _check_schedule(g, t, grid, slice_)
    rounds = _run_protocol(items, -(-t // slice_))
    waves = 1 + max(w for _, w, _, _, _ in items)
    assert rounds <= waves + 1


@settings(deadline=None)
@given(g=st.integers(1, 40), t=st.integers(1, 5000),
       grid=st.integers(1, 40), align=st.integers(1, 8))
def test_any_admissible_slice_schedules_and_runs(g, t, grid, align):
    """Not only the slice the wrapper picks: every multiple of the granule
    with at most ``grid`` items a row gives a covering one-wave schedule
    that the protocol runs to its end."""
    slice_ = align * qk.QUANT_SLICE_ALIGN
    if -(-t // slice_) > grid:
        return
    items = _check_schedule(g, t, grid, slice_)
    _run_protocol(items, -(-t // slice_))


@pytest.mark.parametrize("g,t,slice_,waves", [
    (64, 2098176, 15936, 64),    # mlp up/gate G history: 132 items a row
    (1, 2098176, 15936, 1),      # the wire route, one block of 2048
    (4, 2098176, 15936, 4),      # the wire route, d 8192
    (16, 131328, 16448, 1),      # a b 512 family: 8 items a row
    (32, 131328, 16448, 2),
])
def test_slice_at_the_path_shapes(g, t, slice_, waves):
    """The schedule the H100 gets at the training path's shapes: the
    largest rows fill the grid exactly, one row a wave."""
    assert qk.quant_slice(g, t, H100_GRID) == slice_
    items = qk.quant_items(g, t, H100_GRID, slice_)
    assert 1 + max(w for _, w, _, _, _ in items) == waves


def test_long_row_route_starts_past_grid_times_slice_max():
    edge = H100_GRID * qk.QUANT_SLICE_MAX
    assert qk.quant_slice(1, edge, H100_GRID) == qk.QUANT_SLICE_MAX
    assert qk.quant_slice(1, edge + 1, H100_GRID) == 0
    assert qk.quant_slice(2, 2_600_000, H100_GRID) == 0


# ---------------------------------------------------------------------------
# the kernel's arithmetic, item by item
# ---------------------------------------------------------------------------

def _scale_of(amax_bits: np.ndarray, fmt: str, mode: str) -> np.ndarray:
    """csrc/fp8_quant.cuh scale_of on the u32 bits of the row amax."""
    amax = amax_bits.view(np.float32)
    s = (amax * np.float32(quant.FMT_INV_MAX[fmt])).astype(np.float32)
    if mode == "pow2":
        s = np.where(s < MIN_NORMAL, MIN_NORMAL, s).astype(np.float32)
        bits = s.view(np.uint32).copy()
        up = (bits & 0x7FFFFF) != 0
        bits[up] = (bits[up] & 0xFF800000) + 0x800000
        s = bits.view(np.float32)
    with np.errstate(invalid="ignore"):
        return np.where(amax > 0, s, np.float32(1.0)).astype(np.float32)


def _emulate(x: np.ndarray, fmt: str, mode: str, grid: int, slice_: int):
    """The resident kernel's arithmetic on the CPU: every item's amax over
    its own elements, the row's amax their max (atomicMax on the bits),
    then each item quantized with its row's scale."""
    g, t = x.shape
    items = qk.quant_items(g, t, grid, slice_)
    bits = x.view(np.uint32) & np.uint32(0x7FFFFFFF)
    amax = np.zeros(g, np.uint32)
    for _, _, row, lo, hi in items:
        amax[row] = max(amax[row], bits[row, lo:hi].max())
    scale = _scale_of(amax, fmt, mode)
    m = np.float32(quant.FMT_MAX[fmt])
    payload = torch.empty((g, t), dtype=quant.FORMATS[fmt])
    for _, _, row, lo, hi in items:
        with np.errstate(invalid="ignore"):
            q = (x[row, lo:hi] / scale[row]).astype(np.float32)
            q = np.where(q < -m, -m, np.where(q > m, m, q))
        payload[row, lo:hi] = torch.from_numpy(q).to(quant.FORMATS[fmt])
    return payload, torch.from_numpy(scale)


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.view(torch.uint8 if a.element_size() == 1 else torch.int32)
        a = a.numpy()
    a = np.asarray(a)
    return a.view({1: np.uint8, 4: np.uint32}[a.dtype.itemsize])


def _rows(rng, g, t, fmt, mode):
    """fp32: magnitudes over six decades across the rows; pow2: rows that
    scale with the format's range, so that every scale lies where XLA's
    exp2 is exact. Row 0 is zero (scale 1)."""
    x = rng.randn(g, t).astype(np.float32)
    if mode == "pow2":
        x *= np.float32(quant.FMT_MAX[fmt] / 448.0)
    else:
        x *= np.logspace(-3, 3, g, dtype=np.float32)[:, None]
    x[0] = 0.0
    return x


@pytest.mark.parametrize("mode", ["fp32", "pow2"])
@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
@pytest.mark.parametrize("g,t,grid,slice_", [
    (3, 1000, 7, 0),          # the wrapper's own slice
    (4, 701, 12, 64),         # ragged items, several a row
    (5, 4099, 3, 2048),       # three items a row, one row a wave
])
def test_item_emulation_matches_repro_and_plain(g, t, grid, slice_, fmt,
                                                mode):
    slice_ = slice_ or qk.quant_slice(g, t, grid)
    rng = np.random.RandomState(g * 1000 + t)
    x = _rows(rng, g, t, fmt, mode)
    ep, es = _emulate(x, fmt, mode, grid, slice_)
    assert (es[0] == 1.0).item()
    rp, rs = ref.quant_rows_ref(torch.from_numpy(x), fmt, mode)
    np.testing.assert_array_equal(_bits(ep), _bits(rp))
    np.testing.assert_array_equal(_bits(es), _bits(rs))
    jp, js = jops.fp8_quant_rows(jnp.asarray(x), fmt=fmt, scale_mode=mode,
                                 interpret=True)
    np.testing.assert_array_equal(_bits(ep), _bits(np.asarray(jp)))
    np.testing.assert_array_equal(_bits(es), _bits(np.asarray(js)))


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_item_emulation_nan_rows_match_plain(fmt):
    """A NaN in one item of a row: its amax is NaN (the bits of NaN lie
    above inf's), the scale 1, the row passes through the clip and cast
    as the plain version does; other rows are untouched."""
    rng = np.random.RandomState(7)
    x = _rows(rng, 4, 900, fmt, "fp32")
    x[2, 613] = np.nan
    x[3, 5] = -np.nan
    ep, es = _emulate(x, fmt, "fp32", 12, 128)
    rp, rs = ref.quant_rows_ref(torch.from_numpy(x), fmt, "fp32")
    np.testing.assert_array_equal(_bits(ep), _bits(rp))
    np.testing.assert_array_equal(_bits(es), _bits(rs))
    assert es[2].item() == 1.0 and es[3].item() == 1.0
