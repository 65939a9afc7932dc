"""The tensor-core attention backward of repro_torch
(``csrc/swa_flash_bwd_wgmma.cuh``, the bf16 bodies of ``swa_flash_bwd_dq``
and ``swa_flash_bwd_dkdv``) on the CPU.

The kernels run only on the card (``chip_smoke.py``). Here their geometry
and their arithmetic are checked through two mirrors:

* the geometry, as ``kernels/swa_attention.py`` gives it to the launches:
  dq walks the forward's tiles (``dq_geometry`` is ``walk_geometry``, whose
  walk ``tests/test_torch_swa_walk.py`` checks); dk/dv takes 128-key items
  in order and streams 64-query stages of every query head of the group
  (``dkdv_geometry``, ``query_tiles``, ``stage_kind``): every visible
  (query, key) pair of every query head is visited exactly once, no stage
  outside the band is visited, the stages that skip the mask need none and
  the skipped ones hold no visible pair, and the persistent blocks take
  every item exactly once (``walk_blocks``, ``block_items``); other head
  dims walk as their instance (80, 96, 100 as 128; 256 with 64-key dk/dv
  items, as 192, and dq stages of 32 keys);
* an emulation of both kernels' bf16 arithmetic at their tile sizes (bf16
  products summed in f32, the scale on the f32 score, ``exp2`` with log2e,
  P and dS each split as ``hi`` = the value cut to its top 16 bits and
  ``lo = bf16(value - hi)``, each half its own product), held at
  ``chip_smoke.py``'s ``BWD_REL_TOL`` against ``repro``'s
  ``ops.swa_attention_bwd`` in interpret mode and the port's
  ``ref.swa_attention_bwd_ref``, on the same bf16 inputs upcast to f32.
  With P or dS as one bf16 (rounded to nearest) the same emulation leaves
  that bound, which is why the kernels pay for the second products.
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

# the bound the card holds the kernels to (chip_smoke.py)
BWD_REL_TOL = chip_smoke.BWD_REL_TOL
LOG2E = 1.4426950408889634               # csrc/swa_flash_wgmma.cuh LOG2E
HALF = swa_attention.TC_BKEY // 2        # keys of one dk/dv consumer
# a dk/dv item's consumers with keys of their own: two of 64 at hd 64 and
# 128; at hd 192 both take the item's 64 keys (one sums dV, the other dK)


def _consumer_keys(bkey):
    return range(bkey // HALF)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the emulations' many small products: the
    test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _visible(rows, keys, window):
    """(len(rows), len(keys)) mask: key j visible to query i iff
    i - window < j <= i (window 0: causal)."""
    i, j = rows[:, None], keys[None, :]
    vis = j <= i
    if window > 0:
        vis &= j > i - window
    return vis


# ---------------------------------------------------------------------------
# (a) the geometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd", [64, 128, 192])
@pytest.mark.parametrize("window_of", [lambda s: 0, lambda s: 1, lambda s: 7,
                                       lambda s: 127, lambda s: 130,
                                       lambda s: 256, lambda s: s + 5],
                         ids=["causal", "w1", "w7", "w127", "w130", "w256",
                              "w_past_s"])
@pytest.mark.parametrize("s", [50, 517, 1000, 1024, 4096])
def test_dkdv_walk_visits_every_visible_pair_once(s, window_of, hd):
    """Each key tile, consumer half and query tile of the dk/dv launch, as
    the kernel walks them for every query head of the group (the walk is
    the same for each head, so one head's visits stand for all). Windows
    127 and 130 put the band's edges on 64-row boundaries: a consumer's
    first key one short of a stage's last query's window, a band's last
    query and a consumer's last visible key at a tile's first row."""
    _dkdv_visits(s, window_of(s), hd)


@pytest.mark.parametrize("hd", [80, 96, 100, 256])
@pytest.mark.parametrize("s,window", [(517, 0), (1000, 130), (1024, 127)])
def test_dkdv_walk_visits_every_visible_pair_once_at_other_widths(s, window,
                                                                   hd):
    """hd 80, 96 and 100 walk as 128 (two consumers of 64 keys), 256 as
    192 (one 64-key item whose consumers split dV and dK)."""
    _dkdv_visits(s, window, hd)


def _dkdv_visits(s, window, hd):
    """Every visible pair of the bf16 dk/dv walk at (S, window, hd) once."""
    bkey, bqs, order = swa_attention.dkdv_geometry(s, hd, torch.bfloat16)
    inst = swa_attention.head_dim_instance(hd)
    assert (bkey, bqs) == ({64: 128, 128: 128, 192: 64, 256: 64}[inst], 64)
    assert order == tuple(range(-(-s // bkey)))
    visits = np.zeros((s, s), np.int16)
    work = []
    for kt in order:
        lo, hi = swa_attention.query_tiles(kt, s, window, bkey, bqs)
        work.append(hi - lo + 1)
        block_keys = np.arange(kt * bkey, min(kt * bkey + bkey, s))
        for qt in range(lo, hi + 1):
            rows = np.arange(qt * bqs, min(qt * bqs + bqs, s))
            assert _visible(rows, block_keys, window).any(), \
                f"stage ({kt}, {qt}) lies outside the band"
            for w in _consumer_keys(bkey):
                kc = kt * bkey + w * HALF
                keys = np.arange(kc, min(kc + HALF, s))
                kind = swa_attention.stage_kind(kc, qt, s, window, bqs)
                vis = _visible(rows, keys, window)
                if kind == "skip":
                    assert not vis.any()
                    continue
                if kind == "interior":
                    # every query of the stage, those past S too, sees every
                    # key of the consumer, and none lies past S
                    full_rows = np.arange(qt * bqs, qt * bqs + bqs)
                    full_keys = np.arange(kc, kc + HALF)
                    assert full_rows[-1] < s
                    assert _visible(full_rows, full_keys, window).all()
                visits[rows[0]:rows[-1] + 1, keys[0]:keys[-1] + 1] += vis
    want = _visible(np.arange(s), np.arange(s), window)
    np.testing.assert_array_equal(visits, want.astype(np.int16))
    # longest first: no key tile has more stages than the one before it
    assert all(a >= b for a, b in zip(work, work[1:]))


@pytest.mark.parametrize("s,hd,window,kv_heads", [
    (1024, 64, 0, 32),      # training call
    (1024, 64, 256, 32),
    (4096, 64, 256, 8),
    (1000, 128, 7, 3),
    (517, 64, 0, 4),
    (50, 64, 0, 1),         # fewer items than SMs
    (4096, 192, 0, 8),      # nemotron_4_340b's attention, batch 1
    (4096, 256, 0, 16),     # gemma-7b's, batch 1
    (4096, 256, 0, 1),      # gemma-2b's (one KV head): fewer items than SMs
    (4096, 80, 0, 32),      # phi-2's
])
def test_dkdv_persistent_blocks_take_every_item_once(s, hd, window,
                                                     kv_heads):
    """Item i is key tile order[i // kv_heads], KV head i % kv_heads; block
    b of walk_blocks(items, 132) takes block_items(b, ...). Every item is
    taken once, and no block's work (its stages) exceeds the mean by more
    than the longest item."""
    bkey, bqs, order = swa_attention.dkdv_geometry(s, hd, torch.bfloat16)
    items = kv_heads * len(order)
    blocks = swa_attention.walk_blocks(items, 132)
    assert blocks == min(items, 132)
    stages = [(lambda lo, hi: hi - lo + 1)(*swa_attention.query_tiles(
        order[i // kv_heads], s, window, bkey, bqs)) for i in range(items)]
    taken, loads = [], []
    for b in range(blocks):
        mine = swa_attention.block_items(b, blocks, items)
        assert mine == sorted(mine) and mine[0] == b
        taken += mine
        loads.append(sum(stages[i] for i in mine))
    assert sorted(taken) == list(range(items))
    assert max(loads) <= sum(stages) / blocks + max(stages)


@pytest.mark.parametrize("s", [50, 517, 1024])
@pytest.mark.parametrize("hd", [64, 128])
def test_bwd_geometry_of_each_body(s, hd):
    """bf16 dq launches the forward walk's items; f32 keeps the CUDA-core
    bodies' blocks: 128 / (hd / 32) query rows (dq) or keys (dk/dv) a
    block, 32-row tiles, in order."""
    assert swa_attention.dq_geometry(s, hd, torch.bfloat16) == \
        swa_attention.walk_geometry(s, hd, torch.bfloat16)
    rows = 128 // (hd // 32)
    blocks = tuple(range(-(-s // rows)))
    assert swa_attention.dq_geometry(s, hd, torch.float32) == (rows, 32,
                                                               blocks)
    assert swa_attention.dkdv_geometry(s, hd, torch.float32) == (rows, 32,
                                                                 blocks)


@pytest.mark.parametrize("s", [50, 517, 4096])
def test_bwd_geometry_of_each_body_at_hd_192(s):
    """hd 192: bf16 dq the forward walk's items, dk/dv 64-key items; f32
    8 threads a row (6 would not divide a warp), so 16 query rows (dq) or
    keys (dk/dv) a block, and 16-row tiles."""
    assert swa_attention.dq_geometry(s, 192, torch.bfloat16) == \
        swa_attention.walk_geometry(s, 192, torch.bfloat16)
    assert swa_attention.dkdv_geometry(s, 192, torch.bfloat16) == (
        64, 64, tuple(range(-(-s // 64))))
    blocks = tuple(range(-(-s // 16)))
    assert swa_attention.dq_geometry(s, 192, torch.float32) == (16, 16,
                                                                blocks)
    assert swa_attention.dkdv_geometry(s, 192, torch.float32) == (16, 16,
                                                                  blocks)


@pytest.mark.parametrize("s", [50, 517, 4096])
def test_bwd_geometry_of_each_body_at_hd_256(s):
    """hd 256: bf16 dq the forward walk's items in 32-key stages (Q and dO
    of 128 rows take 128 KB), dk/dv 64-key items; f32 8 threads a row, 16
    query rows (dq) or keys (dk/dv) a block, and 16-row tiles. hd 80, 96
    and 100 take the 128 instance's geometry, in both bodies."""
    bq, _, order = swa_attention.walk_geometry(s, 256, torch.bfloat16)
    assert swa_attention.dq_geometry(s, 256, torch.bfloat16) == (bq, 32,
                                                                 order)
    assert swa_attention.dkdv_geometry(s, 256, torch.bfloat16) == (
        64, 64, tuple(range(-(-s // 64))))
    blocks = tuple(range(-(-s // 16)))
    for geo in (swa_attention.dq_geometry, swa_attention.dkdv_geometry):
        assert geo(s, 256, torch.float32) == (16, 16, blocks)
        for hd in (80, 96, 100):
            for dt in (torch.bfloat16, torch.float32):
                assert geo(s, hd, dt) == geo(s, 128, dt)


# ---------------------------------------------------------------------------
# (b) the kernels' bf16 arithmetic, emulated tile by tile
# ---------------------------------------------------------------------------

def _parts(x, mode):
    """The bf16 operands a product takes for x: ``"split"`` hi (x cut to
    its top 16 bits, the kernel's byte permute) and lo = bf16(x - hi);
    ``"one"`` x rounded to nearest."""
    if mode == "one":
        return [x.bfloat16().float()]
    hi = (x.view(torch.int32) & -65536).view(torch.float32)
    return [hi, (x - hi).bfloat16().float()]


def _consts(hd):
    scale = torch.tensor(hd ** -0.5, dtype=torch.float32)
    log2e = torch.tensor(LOG2E, dtype=torch.float32)
    return scale, scale * log2e, log2e


def _emulate_dq(q, k, v, do, lse, delta, window, ds="split"):
    """The dq kernel on (H, S, hd) bf16 q, do and (H // G, S, hd) bf16 k,
    v, with (H, S) f32 lse and delta: dq (H, S, hd) f32."""
    h, s, hd = q.shape
    g = h // k.shape[0]
    bq, bk, order = swa_attention.dq_geometry(s, hd, torch.bfloat16)
    scale, c, log2e = _consts(hd)
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(g, 0)
    vf = v.float().repeat_interleave(g, 0)
    l2 = lse * log2e
    dq = torch.empty(h, s, hd)
    for qt in order:
        r0, r1 = qt * bq, min(qt * bq + bq, s)
        acc = torch.zeros(h, r1 - r0, hd)
        lo, hi = swa_attention.key_tiles(qt, s, window, bq, bk)
        for kt in range(lo, hi + 1):
            k0, k1 = kt * bk, min(kt * bk + bk, s)
            sc = qf[:, r0:r1] @ kf[:, k0:k1].transpose(1, 2)
            dp = dof[:, r0:r1] @ vf[:, k0:k1].transpose(1, 2)
            p = torch.exp2(sc * c - l2[:, r0:r1, None])
            if swa_attention.tile_masked(qt, kt, window, bq, bk):
                vis = _visible(np.arange(r0, r1), np.arange(k0, k1), window)
                p = torch.where(torch.from_numpy(vis), p, torch.zeros(()))
            d_s = p * (dp - delta[:, r0:r1, None])
            for part in _parts(d_s, ds):
                acc = acc + part @ kf[:, k0:k1]
        dq[:, r0:r1] = acc * scale
    return dq


def _emulate_dkdv(q, k, v, do, lse, delta, window, p="split", ds="split"):
    """The dk/dv kernel on the same operands: (dk, dv) (H // G, S, hd) f32,
    each consumer's 64 keys summed over the group's heads, then the query
    tiles, in the kernel's order."""
    h, s, hd = q.shape
    kv = k.shape[0]
    g = h // kv
    bkey, bqs, order = swa_attention.dkdv_geometry(s, hd, torch.bfloat16)
    scale, c, log2e = _consts(hd)
    qf = q.float().reshape(kv, g, s, hd)
    dof = do.float().reshape(kv, g, s, hd)
    kf, vf = k.float(), v.float()
    l2 = (lse * log2e).reshape(kv, g, s)
    dl = delta.reshape(kv, g, s)
    dk, dv = torch.empty(kv, s, hd), torch.empty(kv, s, hd)
    for kt in order:
        lo, hi = swa_attention.query_tiles(kt, s, window, bkey, bqs)
        for w in _consumer_keys(bkey):
            kc = kt * bkey + w * HALF
            if kc >= s:
                continue
            ke = min(kc + HALF, s)
            dka, dva = torch.zeros(kv, ke - kc, hd), torch.zeros(kv, ke - kc, hd)
            for gi in range(g):
                for qt in range(lo, hi + 1):
                    kind = swa_attention.stage_kind(kc, qt, s, window, bqs)
                    if kind == "skip":
                        continue
                    q0, q1 = qt * bqs, min(qt * bqs + bqs, s)
                    qs, dos = qf[:, gi, q0:q1], dof[:, gi, q0:q1]
                    st = kf[:, kc:ke] @ qs.transpose(1, 2)
                    dpt = vf[:, kc:ke] @ dos.transpose(1, 2)
                    pt = torch.exp2(st * c - l2[:, gi, None, q0:q1])
                    if kind == "masked":
                        vis = _visible(np.arange(q0, q1), np.arange(kc, ke),
                                       window).T
                        pt = torch.where(torch.from_numpy(vis), pt,
                                         torch.zeros(()))
                    dst = pt * (dpt - dl[:, gi, None, q0:q1])
                    for part in _parts(pt, p):
                        dva = dva + part @ dos
                    for part in _parts(dst, ds):
                        dka = dka + part @ qs
            dk[:, kc:ke] = dka * scale
            dv[:, kc:ke] = dva
    return dk, dv


def _emulate(q, k, v, do, window, p="split", ds="split"):
    """Both kernels on (BKV, G, S, hd) bf16 q, do and (BKV, S, hd) bf16 k,
    v, from the f32 forward's (o, lse) of the upcast inputs and the
    wrapper's delta; returns (dq, dk, dv) and the residuals."""
    bkv, g, s, hd = q.shape
    o, lse = ref.swa_attention_fwd_res_ref(q.float(), k.float(), v.float(),
                                           window=window)
    delta = (do.float() * o).sum(-1)
    h = bkv * g
    args = (q.reshape(h, s, hd), k, v, do.reshape(h, s, hd),
            lse.reshape(h, s), delta.reshape(h, s), window)
    dq = _emulate_dq(*args, ds=ds).reshape(q.shape)
    dk, dv = _emulate_dkdv(*args, p=p, ds=ds)
    return (dq, dk, dv), (o, lse)


def _bf16_inputs(bkv, g, s, hd, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .bfloat16() for shape in ((bkv, g, s, hd), (bkv, s, hd),
                                      (bkv, s, hd), (bkv, g, s, hd))]


def _rel(got, want):
    """max |err| / max |grad| (chip_smoke.py's _rel_err)."""
    return float((got - want).abs().max() / want.abs().max())


_CASES = [(s, hd, w) for s in (40, 160) for hd in (64, 128, 192)
          for w in (0, 7, 50)]
# widths on another instance's tiles (zero columns add nothing to an f32
# sum, so the emulation runs at the true hd)
_OTHER_WIDTHS = [(40, 96, 7), (40, 100, 50), (40, 256, 0)]


@pytest.mark.parametrize("s,hd,window", _CASES + _OTHER_WIDTHS)
def test_bwd_arithmetic_matches_swa_attention_bwd(s, hd, window):
    """BKV 2, G 2: the emulated dq, dk and dv within BWD_REL_TOL of
    repro's ops.swa_attention_bwd (interpret mode, bq = bk = 8) and of the
    port's plain version, from the same (o, lse)."""
    q, k, v, do = _bf16_inputs(2, 2, s, hd, seed=s * 13 + hd + window)
    got, (o, lse) = _emulate(q, k, v, do, window)
    jax_in = [jnp.asarray(x.float().numpy()) for x in (q, k, v)]
    jgrads = jops.swa_attention_bwd(*jax_in, jnp.asarray(o.numpy()),
                                    jnp.asarray(lse.numpy()),
                                    jnp.asarray(do.float().numpy()),
                                    window=window, bq=8, bk=8,
                                    interpret=True)
    oracles = [("repro swa_attention_bwd (interpret)",
                [torch.from_numpy(np.array(x)) for x in jgrads]),
               ("port plain", ref.swa_attention_bwd_ref(
                   q.float(), k.float(), v.float(), o, lse, do.float(),
                   window=window))]
    for label, want in oracles:
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            err = _rel(a, b)
            assert err <= BWD_REL_TOL, f"{label} {name}: {err:.3e}"


@pytest.mark.parametrize("bkv,g,s,seed", [(2, 4, 512, 0), (1, 8, 1024, 1)])
def test_bwd_arithmetic_needs_both_splits(bkv, g, s, seed):
    """hd 64, causal, against the port's plain version: with P as one bf16
    dv leaves BWD_REL_TOL, with dS as one bf16 dq and dk do, while the two
    splits keep all three well inside it."""
    q, k, v, do = _bf16_inputs(bkv, g, s, 64, seed)
    o, lse = ref.swa_attention_fwd_res_ref(q.float(), k.float(), v.float())
    want = ref.swa_attention_bwd_ref(q.float(), k.float(), v.float(), o,
                                     lse, do.float())
    errs = {}
    for p, ds in (("split", "split"), ("one", "split"), ("split", "one")):
        got = _emulate(q, k, v, do, 0, p=p, ds=ds)[0]
        errs[p, ds] = [_rel(a, b) for a, b in zip(got, want)]
    assert max(errs["split", "split"]) <= BWD_REL_TOL / 20, errs
    assert errs["one", "split"][2] > BWD_REL_TOL, errs
    assert min(errs["split", "one"][:2]) > BWD_REL_TOL, errs
