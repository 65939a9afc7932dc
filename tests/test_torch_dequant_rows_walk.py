"""dequant_rows (``csrc/quant_pack.cu`` rows_dequant_kernel) on the CPU.

The kernel runs only on the card (``chip_smoke.py``). Here its partition
and its arithmetic are checked through two mirrors:

* the partition as ``kernels/quant.py`` gives it to the launch
  (``dequant_geometry``: tiles a row, one block each; ``dequant_items``:
  who writes what): every element of every row written exactly once, rows
  whose start is off a multiple of 4 (a head written element by element)
  and rows whose length leaves a tail, t below 4, several tiles a row; a
  warp's word loads and float4 stores contiguous, the stores on 16-byte
  boundaries of the output;
* an emulation of the arithmetic write by write (each word as two pairs
  converted fp8 -> f16 -> f32, as ``cvt.rn.f16x2.e4m3x2`` / ``.e5m2x2``
  and ``__half22float2`` do, then one f32 product with the row's scale),
  held bit for bit against ``repro``'s ``dequant_rows`` in interpret mode
  and the port's plain version (``ref.dequant_rows_ref``), e4m3 and e5m2,
  fp32 and pow2 scales (pow2 inside the range where XLA's exp2 is exact,
  ROADMAP Queue 3); NaN payload codes against the plain version, NaN
  equal to NaN.
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypothesis_compat import given, settings, st
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.kernels import quant as qk
from repro_torch.kernels import ref
from repro_torch.quant import quant

NT = qk.DEQUANT_THREADS


def _writes(g, t):
    """{(row, element): number of writes}, and the items by block."""
    tiles = qk.dequant_geometry(t)
    count = collections.Counter()
    by_block = collections.defaultdict(list)
    for b, th, kind, lo, hi in qk.dequant_items(g, t):
        assert 0 <= b < g * tiles and 0 <= th < NT and 0 <= lo < hi <= t
        assert hi - lo == (4 if kind == "word" else 1)
        row = b // tiles
        for e in range(lo, hi):
            count[(row, e)] += 1
        by_block[b].append((th, kind, lo, hi))
    return count, by_block


def _check_partition(g, t):
    count, by_block = _writes(g, t)
    assert len(count) == g * t and set(count.values()) == {1}
    tiles = qk.dequant_geometry(t)
    for b, items in by_block.items():
        row, tile = divmod(b, tiles)
        base = row * t
        words = [(th, lo) for th, kind, lo, _ in items if kind == "word"]
        # a float4 store lands on a 16-byte boundary of the f32 output
        assert all((base + lo) % 4 == 0 for _, lo in words)
        # the scalar head and tail: only in the row's first / last tile,
        # fewer than 4 each
        for kind, first in (("head", 0), ("tail", tiles - 1)):
            mine = [lo for _, k, lo, _ in items if k == kind]
            assert len(mine) < 4 and (not mine or tile == first)
        # step i of a tile: thread th takes word w0 + i NT + th, so the
        # lanes of a warp take consecutive words (128 payload bytes, 512
        # output bytes)
        for n, (th, lo) in enumerate(words):
            assert th == n % NT
            if n % 32:
                assert lo == words[n - 1][1] + 4
    return count


@pytest.mark.parametrize("g,t", [
    (3, 561),          # rows start at flat 0, 561, 1122: heads 0, 3, 2
    (5, 4099),         # tails of 3; one tile a row
    (7, 3), (9, 2), (4, 1),     # rows shorter than a word
    (2, 4 * (3 * 2048 + 100) + 1),   # 4 tiles a row, the last one short
    (3, 4 * 2 * 2048 + 3),      # two whole tiles of words, heads and tails
])
def test_partition_writes_every_element_once(g, t):
    _check_partition(g, t)


@settings(deadline=None, max_examples=40)
@given(g=st.integers(1, 6), t=st.integers(1, 20000))
def test_partition_any_shape(g, t):
    _check_partition(g, t)


@pytest.mark.parametrize("t,tiles", [(2098176, 257), (131328, 17),
                                     (500500, 62), (561, 1), (3, 1),
                                     (4 * qk.DEQUANT_TILE, 1),
                                     (4 * qk.DEQUANT_TILE + 4, 2)])
def test_geometry_at_the_path_shapes(t, tiles):
    """Tiles a row at the fp8 history's rows (b 2048, 512, 1000) and at
    the edges of a tile."""
    assert qk.DEQUANT_TILE == 2048
    assert qk.dequant_geometry(t) == tiles


# ---------------------------------------------------------------------------
# the kernel's arithmetic, write by write
# ---------------------------------------------------------------------------

def _pair_to_f32(codes: np.ndarray, fmt: str) -> np.ndarray:
    """fp8 codes -> f16 (exact) -> f32 (exact), as the paired cvt and
    ``__half22float2``."""
    t = torch.from_numpy(np.ascontiguousarray(codes)).view(quant.FORMATS[fmt])
    return t.to(torch.float16).float().numpy()


def _emulate(payload: np.ndarray, scale: np.ndarray, fmt: str) -> np.ndarray:
    g, t = payload.shape
    tiles = qk.dequant_geometry(t)
    out = np.full((g, t), np.float32(-7.0), np.float32)
    for b, _, kind, lo, hi in qk.dequant_items(g, t):
        row = b // tiles
        codes = payload[row, lo:hi]
        if kind == "word":
            vals = np.concatenate([_pair_to_f32(codes[0:2], fmt),
                                   _pair_to_f32(codes[2:4], fmt)])
        else:                          # the pair (code, 0), its .x
            vals = _pair_to_f32(np.array([codes[0], 0], np.uint8), fmt)[:1]
        with np.errstate(invalid="ignore"):
            out[row, lo:hi] = vals * scale[row]
    return out


def _case(rng, g, t, fmt, mode):
    """A payload and scales from quantized rows (row 0 zero), plus a few
    bytes set to every finite code of the format."""
    x = rng.randn(g, t).astype(np.float32)
    if mode == "pow2":
        x *= np.float32(quant.FMT_MAX[fmt] / 448.0)
    else:
        x *= np.logspace(-3, 3, g, dtype=np.float32)[:, None]
    x[0] = 0.0
    p, s = ref.quant_rows_ref(torch.from_numpy(x), fmt, mode)
    pb = p.view(torch.uint8).numpy().copy()
    codes = np.arange(256, dtype=np.uint8)
    finite = codes[np.isfinite(_pair_to_f32(codes, fmt))]
    n = min(len(finite), pb[1:].size)
    flat = pb[1:].reshape(-1)
    flat[rng.choice(flat.size, n, replace=False)] = finite[:n]
    return pb, s.numpy()


@pytest.mark.parametrize("mode", ["fp32", "pow2"])
@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
@pytest.mark.parametrize("g,t", [(3, 561), (5, 4099), (7, 3),
                                 (2, 4 * 2 * 2048 + 3)])
def test_emulation_matches_repro_and_plain(g, t, fmt, mode):
    rng = np.random.RandomState(g * 100 + t)
    pb, s = _case(rng, g, t, fmt, mode)
    got = _emulate(pb, s, fmt)
    payload = torch.from_numpy(pb).view(quant.FORMATS[fmt])
    want = ref.dequant_rows_ref(payload, torch.from_numpy(s)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    jp = jnp.asarray(convert.to_numpy(payload))
    jout = np.asarray(jops.fp8_dequant_rows(jp, jnp.asarray(s),
                                            interpret=True))
    np.testing.assert_array_equal(got.view(np.uint32), jout.view(np.uint32))


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_emulation_nan_codes_match_plain(fmt):
    """Every NaN code of the format (and e5m2's infinities) in a head, a
    word and a tail: NaN (inf) where the plain version has it, every other
    element bit for bit."""
    rng = np.random.RandomState(5)
    g, t = 3, 561
    pb, s = _case(rng, g, t, fmt, "fp32")
    codes = np.arange(256, dtype=np.uint8)
    special = codes[~np.isfinite(_pair_to_f32(codes, fmt))]
    assert len(special) == {"e4m3": 2, "e5m2": 8}[fmt]
    # heads of rows 1 and 2 (3 and 2 elements), words, tails (559, 560)
    spots = [(1, 0), (1, 2), (2, 0), (2, 9), (2, 557), (1, 560), (0, 1),
             (2, 560)]
    for (r, e), c in zip(spots, np.resize(special, len(spots))):
        pb[r, e] = c
    got = _emulate(pb, s, fmt)
    payload = torch.from_numpy(pb).view(quant.FORMATS[fmt])
    want = ref.dequant_rows_ref(payload, torch.from_numpy(s)).numpy()
    assert np.isnan(want).sum() >= 2
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    torch.testing.assert_close(torch.from_numpy(got), torch.from_numpy(want),
                               rtol=0, atol=0, equal_nan=True)
