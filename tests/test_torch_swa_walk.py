"""The tensor-core attention walk of repro_torch (``csrc/swa_flash_wgmma.cuh``,
the bf16 body of ``swa_flash_fwd`` and ``swa_flash``) on the CPU.

The kernel runs only on the card (``chip_smoke.py``). Here its geometry
and its arithmetic are checked through two mirrors:

* the walk's geometry, as ``kernels/swa_attention.py`` gives it to the
  launch (``walk_geometry``, ``key_tiles``, ``tile_masked``): every visible
  (query, key) pair is visited exactly once, no key tile outside the band
  is visited, the tiles that skip the mask need none, the query tiles
  launch longest first, and the persistent blocks take every work item
  exactly once (``walk_blocks``, ``block_items``);
* an emulation of the kernel's bf16 arithmetic, tile by tile at its tile
  sizes (bf16 products summed in f32, the online softmax in f32 with the
  scale applied to the f32 score, P split as ``P_hi`` = P cut to its top
  16 bits and ``P_lo = bf16(P - P_hi)``), held against ``repro``'s
  ``swa_flash_fwd`` and ``swa_flash`` in interpret mode and the port's
  plain versions, on the same bf16 inputs upcast to f32, at
  ``chip_smoke.py``'s bounds: the bf16 output within ``SWA_BF16_TOL``
  (one bf16 rounding of the f32 result) and lse within ``LSE_TOL``.
  Without ``P_lo`` the same emulation exceeds that bound, which is why the
  kernel pays for the second product.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ref, swa_attention

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

# the bounds the card holds the kernel to (chip_smoke.py)
SWA_BF16_TOL = chip_smoke.SWA_BF16_TOL
LSE_TOL = chip_smoke.LSE_TOL
NEG_INF, MASKED = -1e30, -5e29           # csrc/common.cuh REPRO_NEG_INF, REPRO_MASKED
LOG2E = 1.4426950408889634               # csrc/swa_flash_wgmma.cuh LOG2E


def _visible(rows, keys, window):
    """(len(rows), len(keys)) mask: key j visible to query i iff
    i - window < j <= i (window 0: causal)."""
    i, j = rows[:, None], keys[None, :]
    vis = j <= i
    if window > 0:
        vis &= j > i - window
    return vis


# ---------------------------------------------------------------------------
# (a) the walk's geometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd", [64, 128, 192])
@pytest.mark.parametrize("window_of", [lambda s: 0, lambda s: 1, lambda s: 7,
                                       lambda s: 256, lambda s: s + 5],
                         ids=["causal", "w1", "w7", "w256", "w_past_s"])
@pytest.mark.parametrize("s", [50, 517, 1000, 1024, 4096])
def test_walk_visits_every_visible_pair_once(s, window_of, hd):
    window = window_of(s)
    bq, bk, order = swa_attention.walk_geometry(s, hd, torch.bfloat16)
    assert (bq, bk) == (128, {64: 128, 128: 64, 192: 64}[hd])
    qtiles = -(-s // bq)
    assert sorted(order) == list(range(qtiles))
    visits = np.zeros((s, s), np.int16)
    work = []
    for qt in order:
        lo, hi = swa_attention.key_tiles(qt, s, window, bq, bk)
        work.append(hi - lo + 1)
        rows = np.arange(qt * bq, min(qt * bq + bq, s))
        for kt in range(lo, hi + 1):
            keys = np.arange(kt * bk, min(kt * bk + bk, s))
            vis = _visible(rows, keys, window)
            assert vis.any(), f"tile ({qt}, {kt}) lies outside the band"
            if not swa_attention.tile_masked(qt, kt, window, bq, bk):
                # every row of the block, those past S too, sees every key
                # of the tile, all of them before S
                full_rows = np.arange(qt * bq, qt * bq + bq)
                full_keys = np.arange(kt * bk, kt * bk + bk)
                assert full_keys[-1] < s
                assert _visible(full_rows, full_keys, window).all()
            visits[rows[0]:rows[-1] + 1, keys[0]:keys[-1] + 1] += vis
    want = _visible(np.arange(s), np.arange(s), window)
    np.testing.assert_array_equal(visits, want.astype(np.int16))
    # longest first: the tiles after the first (the ragged last one) in
    # launch order never gain work, and the longest launches first or second
    assert all(a >= b for a, b in zip(work[1:], work[2:]))
    assert max(work) in work[:2]


@pytest.mark.parametrize("s,hd,window,heads", [
    (1024, 64, 0, 32),      # serving prefill, swa_flash (a)
    (1024, 64, 0, 128),     # training call
    (32768, 64, 8192, 32),  # swa_path
    (1000, 128, 7, 3),
    (50, 64, 0, 1),         # fewer items than SMs
    (4096, 192, 0, 96),     # nemotron_4_340b's attention, batch 1
])
def test_persistent_blocks_take_every_item_once(s, hd, window, heads):
    """Item i is query tile order[i // heads], head i % heads; block b of
    walk_blocks(items, 132) takes block_items(b, ...), the snake over rounds
    of one item per block. Every item is taken once, and no block's work
    (its key tiles) exceeds the mean by more than the longest item."""
    bq, bk, order = swa_attention.walk_geometry(s, hd, torch.bfloat16)
    items = heads * len(order)
    blocks = swa_attention.walk_blocks(items, 132)
    assert blocks == min(items, 132)
    tiles = [(lambda lo, hi: hi - lo + 1)(*swa_attention.key_tiles(
        order[i // heads], s, window, bq, bk)) for i in range(items)]
    taken, loads = [], []
    for b in range(blocks):
        mine = swa_attention.block_items(b, blocks, items)
        assert mine == sorted(mine) and mine[0] == b
        taken += mine
        loads.append(sum(tiles[i] for i in mine))
    assert sorted(taken) == list(range(items))
    assert max(loads) <= sum(tiles) / blocks + max(tiles)


def test_walk_geometry_of_the_cuda_core_body():
    """f32 keeps the CUDA-core walk: 64 query rows, 32-key tiles, query
    tiles in order."""
    assert swa_attention.walk_geometry(1000, 64, torch.float32) == (
        64, 32, tuple(range(16)))
    assert swa_attention.walk_geometry(1000, 128, torch.bfloat16)[2] == (
        7, 6, 5, 4, 3, 2, 1, 0)


def test_walk_geometry_of_the_cuda_core_body_at_hd_192():
    """At hd 192 the f32 walk has 4 threads a row, so 32 query rows a
    block, and 16-key tiles (two f32 tiles of 32 rows of 192 would fill the
    whole 48 KB of static shared memory)."""
    assert swa_attention.walk_geometry(1000, 192, torch.float32) == (
        32, 16, tuple(range(32)))
    assert swa_attention.walk_geometry(1000, 192, torch.bfloat16) == (
        128, 64, (7, 6, 5, 4, 3, 2, 1, 0))


# ---------------------------------------------------------------------------
# (b) the kernel's bf16 arithmetic, emulated tile by tile
# ---------------------------------------------------------------------------

def _emulate(q, k, v, window, split=True):
    """The tensor-core walk on (H, S, hd) bf16 q and (H // G, S, hd) bf16
    k, v: returns (out (H, S, hd) bf16, lse (H, S) f32)."""
    h, s, hd = q.shape
    g = h // k.shape[0]
    bq, bk, order = swa_attention.walk_geometry(s, hd, torch.bfloat16)
    scale = torch.tensor(hd ** -0.5, dtype=torch.float32)
    c = scale * torch.tensor(LOG2E, dtype=torch.float32)
    qf = q.float()
    kf = k.float().repeat_interleave(g, 0)
    vf = v.float().repeat_interleave(g, 0)
    out = torch.empty(q.shape, dtype=torch.bfloat16)
    lse = torch.empty((h, s), dtype=torch.float32)
    for qt in order:
        r0, r1 = qt * bq, min(qt * bq + bq, s)
        rows = np.arange(r0, r1)
        m = torch.full((h, r1 - r0), NEG_INF)
        d = torch.zeros((h, r1 - r0))
        o = torch.zeros((h, r1 - r0, hd))
        lo, hi = swa_attention.key_tiles(qt, s, window, bq, bk)
        for kt in range(lo, hi + 1):
            k0, k1 = kt * bk, min(kt * bk + bk, s)
            sc = qf[:, r0:r1] @ kf[:, k0:k1].transpose(1, 2)
            masked = swa_attention.tile_masked(qt, kt, window, bq, bk)
            if masked:
                vis = torch.from_numpy(_visible(rows, np.arange(k0, k1),
                                                window))
                sc = torch.where(vis, sc, torch.tensor(NEG_INF))
            m_new = torch.maximum(m, sc.amax(-1))
            corr = torch.exp2((m - m_new) * c)
            p = torch.exp2(sc * c - (m_new * c)[..., None])
            if masked:
                p = torch.where(sc > MASKED, p, torch.zeros(()))
            d = d * corr + p.sum(-1)
            o = o * corr[..., None]
            # P_hi: P cut to its top 16 bits (the kernel's byte permute)
            p_hi = (p.view(torch.int32) & -65536).view(torch.float32)
            o = o + p_hi @ vf[:, k0:k1]
            if split:
                o = o + (p - p_hi).bfloat16().float() @ vf[:, k0:k1]
            m = m_new
        den = torch.clamp(d, min=1e-30)
        out[:, r0:r1] = (o * (1.0 / den)[..., None]).bfloat16()
        lse[:, r0:r1] = m * scale + torch.log(den)
    return out, lse


def _bf16_inputs(bkv, g, s, hd, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .bfloat16() for shape in ((bkv * g, s, hd), (bkv, s, hd),
                                         (bkv, s, hd)))
    return q, k, v


def _jax(x):
    return jnp.asarray(x.float().numpy())


def _fwd_refs(q, k, v, window, g):
    """(out, lse) of repro's interpret-mode swa_flash_fwd and the port's
    plain version, on the bf16 inputs upcast to f32, (H, S, hd) layout."""
    h, s, hd = q.shape
    q4 = q.float().reshape(h // g, g, s, hd)
    jo, jl = jops.swa_attention_fwd_res(_jax(q4), _jax(k), _jax(v),
                                        window=window, bq=32, bk=32,
                                        interpret=True)
    po, pl = ref.swa_attention_fwd_res_ref(q4, k.float(), v.float(),
                                           window=window)
    return [("repro swa_flash_fwd (interpret)",
             torch.from_numpy(np.asarray(jo)).reshape(h, s, hd),
             torch.from_numpy(np.asarray(jl)).reshape(h, s)),
            ("port plain", po.reshape(h, s, hd), pl.reshape(h, s))]


def _flash_refs(q, k, v, window):
    """repro's interpret-mode swa_flash and the port's plain version, on
    the bf16 inputs upcast to f32, (BH, S, hd) layout."""
    jo = jops.swa_attention(_jax(q), _jax(k), _jax(v), window=window,
                            bq=32, bk=32, interpret=True)
    return [("repro swa_flash (interpret)", torch.from_numpy(np.asarray(jo))),
            ("port plain", ref.swa_attention_ref(q.float(), k.float(),
                                                 v.float(), window=window))]


_CASES = [(s, hd, w) for s in (40, 160) for hd in (64, 128, 192)
          for w in (0, 7, 50)]


@pytest.mark.parametrize("s,hd,window", _CASES)
def test_walk_arithmetic_matches_swa_flash_fwd(s, hd, window):
    """BKV 2, G 2: the emulated bf16 output within SWA_BF16_TOL (one bf16
    rounding of the f32 attention) and lse within LSE_TOL of repro's
    swa_flash_fwd and the port's plain version."""
    q, k, v = _bf16_inputs(2, 2, s, hd, seed=s * 7 + hd + window)
    out, lse = _emulate(q, k, v, window)
    for label, want_o, want_l in _fwd_refs(q, k, v, window, g=2):
        torch.testing.assert_close(out.float(), want_o, **SWA_BF16_TOL,
                                   msg=lambda m: f"{label}: {m}")
        torch.testing.assert_close(lse, want_l, **LSE_TOL,
                                   msg=lambda m: f"{label}: {m}")


@pytest.mark.parametrize("s,hd,window", _CASES)
def test_walk_arithmetic_matches_swa_flash(s, hd, window):
    """BH 4, KV already expanded (G 1): the emulated bf16 output within
    SWA_BF16_TOL of repro's swa_flash and the port's plain version."""
    q, k, v = _bf16_inputs(4, 1, s, hd, seed=s * 11 + hd + window)
    out, _ = _emulate(q, k, v, window)
    for label, want in _flash_refs(q, k, v, window):
        torch.testing.assert_close(out.float(), want, **SWA_BF16_TOL,
                                   msg=lambda m: f"{label}: {m}")


def test_walk_arithmetic_needs_p_lo():
    """With P_hi alone (P cut to a bf16, a relative error of up to 2^-7
    in each term) the emulation leaves SWA_BF16_TOL on these inputs, while the
    split stays inside it."""
    over = 0
    for s, hd, window in _CASES:
        q, k, v = _bf16_inputs(4, 1, s, hd, seed=s * 11 + hd + window)
        want = ref.swa_attention_ref(q.float(), k.float(), v.float(),
                                     window=window)
        limit = SWA_BF16_TOL["atol"] + SWA_BF16_TOL["rtol"] * want.abs()
        one = _emulate(q, k, v, window, split=False)[0].float()
        two = _emulate(q, k, v, window)[0].float()
        assert bool(((two - want).abs() <= limit).all())
        over += int(((one - want).abs() > limit).any())
    assert over > 0
