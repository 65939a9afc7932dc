"""swa_flash_decode's split-K (``csrc/swa_flash_decode.cu``) on the CPU.

The kernel runs only on the card (``chip_smoke.py``). Here its geometry and
its arithmetic are checked through two mirrors:

* the split geometry as ``kernels/swa_attention.py`` gives it to the launch
  (``decode_splits``): the splits cover the cache's C slots with none
  empty of slots, each a whole number of tiles, at most
  ``DECODE_MAX_SPLITS``, reaching the blocks an SM it aims for where the
  cache has tiles for them, from shapes alone;
* an emulation of the kernel's arithmetic: per split, tiles of
  ``decode_tile(hd)`` slots with the f32 online softmax, the splits past
  min(C, pos + 1) dead (no partial, no arrival), a single live split
  writing its output itself, and the merge of the live splits' partials in
  split order (online, a partial with d = 0 taking no weight), held
  against ``repro``'s ``swa_flash_decode`` in interpret mode and the
  port's ``ref.swa_decode_ref`` at ``chip_smoke.py``'s ``DEC_TOL``. Cases:
  pos 0, pos on both sides of every split boundary, pos C - 1, splits with
  nothing visible, a ring unwrapped and wrapped, G 1 to 71 (past 16 the
  query rows go in chunks of ``DECODE_CHUNK`` against each staged tile,
  ``decode_chunks``, each chunk's state kept between tiles), hd 64, 128,
  192 and the widths on another instance's tiles (80, 96, 100, 256), one
  tile a split and several. ``repro``'s side of the emulation cases runs in
  a one-CPU child (``tests/jax_side_jobs.py decode_cases``), started when
  the module's tests start: XLA's pools stall in a loaded test worker.
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hypothesis_compat import given, settings, st
from repro_torch.kernels import ref, swa_attention
from repro_torch.quant import quant

sys.path.insert(0, str(Path(__file__).resolve().parent))
import jax_one_cpu  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

DEC_TOL = chip_smoke.DEC_TOL
NEG_INF, MASKED = -1e30, -5e29           # csrc/common.cuh REPRO_NEG_INF, REPRO_MASKED
H100_SMS = 132


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the emulations' many small products: the
    test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@settings(deadline=None)
@given(n=st.integers(1, 600), c=st.integers(1, 70000),
       hd=st.sampled_from([64, 128, 80, 96, 100, 256]),
       sms=st.integers(1, 200))
def test_splits_cover_the_cache(n, c, hd, sms):
    splits, per = swa_attention.decode_splits(n, c, hd, sms)
    tile = swa_attention.decode_tile(hd)
    tiles = -(-c // tile)
    assert per % tile == 0 and per >= tile
    assert 1 <= splits <= swa_attention.DECODE_MAX_SPLITS
    assert (splits - 1) * per < c <= splits * per, "no split empty of slots"
    want = -(-swa_attention.DECODE_BLOCKS_PER_SM * sms // n)
    assert splits >= min(tiles, want, swa_attention.DECODE_MAX_SPLITS) // 2
    assert splits <= max(1, min(tiles, want))


@settings(deadline=None)
@given(n=st.integers(1, 600), c=st.integers(1, 70000),
       sms=st.integers(1, 200))
def test_splits_cover_the_cache_at_hd_192(n, c, sms):
    """hd 192: tiles of 4096 // 192 = 21 slots, not a power of two."""
    assert swa_attention.decode_tile(192) == 21
    splits, per = swa_attention.decode_splits(n, c, 192, sms)
    tiles = -(-c // 21)
    assert per % 21 == 0 and per >= 21
    assert 1 <= splits <= swa_attention.DECODE_MAX_SPLITS
    assert (splits - 1) * per < c <= splits * per, "no split empty of slots"
    want = -(-swa_attention.DECODE_BLOCKS_PER_SM * sms // n)
    assert splits >= min(tiles, want, swa_attention.DECODE_MAX_SPLITS) // 2
    assert splits <= max(1, min(tiles, want))


@pytest.mark.parametrize("g", [1, 15, 16, 17, 48, 71, 200])
def test_decode_chunks_cover_every_row_once(g):
    """A block's G query rows in chunks of DECODE_CHUNK, in order: every
    row in exactly one chunk, only the last one short; one chunk up to 16
    (whose accumulators stay in registers)."""
    chunks = swa_attention.decode_chunks(g)
    rows = [r for g0, n in chunks for r in range(g0, g0 + n)]
    assert rows == list(range(g))
    assert all(n == swa_attention.DECODE_CHUNK for _, n in chunks[:-1])
    assert 1 <= chunks[-1][1] <= swa_attention.DECODE_CHUNK
    assert (len(chunks) == 1) == (g <= 16)


@pytest.mark.parametrize("hd,inst", [(1, 64), (64, 64), (80, 128),
                                     (96, 128), (100, 128), (128, 128),
                                     (136, 192), (200, 256), (256, 256)])
def test_decode_tiles_are_the_instances(hd, inst):
    """Rows of hd run on the smallest instance that holds them, in its
    tiles of 4096 // instance slots; above 256 the decode raises."""
    assert swa_attention.head_dim_instance(hd) == inst
    assert swa_attention.decode_tile(hd) == 4096 // inst
    with pytest.raises(ValueError, match="head dim 264"):
        swa_attention.decode_tile(264)


def test_splits_at_nemotron_shapes():
    """nemotron_4_340b's decode: a lane's 8 KV heads over a 4096-slot
    cache at hd 192 on an H100."""
    assert swa_attention.decode_splits(8, 4096, 192, H100_SMS) == (49, 84)


def test_splits_at_the_serving_shapes():
    """The main path (8 lanes x 8 KV heads over the dense cache of 1024
    slots, hd 64) and the fp8 ring (4 lanes, C 256) on an H100."""
    assert swa_attention.decode_splits(64, 1024, 64, H100_SMS) == (8, 128)
    assert swa_attention.decode_splits(32, 256, 64, H100_SMS) == (4, 64)


def _visible(slots, p, c, window):
    if window:
        r = p % window
        base = p - r
        pp = np.where(slots <= r, base + slots, base - window + slots)
        return (slots < c) & (pp >= 0) & (pp <= p) & (pp > p - window)
    return slots < min(c, p + 1)


def _emulate(q, k, v, pos, window=0, k_scale=None, v_scale=None,
             sms=H100_SMS):
    """The kernel's split-K on the CPU, in f32: (N, G, hd) out."""
    n, g, hd = q.shape
    c = k.shape[1]
    splits, per = swa_attention.decode_splits(n, c, hd, sms)
    tile = swa_attention.decode_tile(hd)
    kf = k.float() * (k_scale[..., None] if k_scale is not None else 1.0)
    vf = v.float() * (v_scale[..., None] if v_scale is not None else 1.0)
    qs = q.float() * hd ** -0.5
    out = torch.empty((n, g, hd))
    for row in range(n):
        p = int(pos[row])
        v_end = min(c, p + 1)
        live = max(1, -(-v_end // per))
        assert live <= splits
        parts = []
        for s in range(live):
            c0, c1 = s * per, min(s * per + per, v_end)
            m = torch.full((g,), NEG_INF)
            d = torch.zeros(g)
            acc = torch.zeros(g, hd)
            for t0 in range(c0, c1, tile):
                slots = np.arange(t0, t0 + tile)
                vis = torch.from_numpy((slots < c1)
                                       & _visible(slots, p, c, window))
                idx = torch.from_numpy(np.minimum(slots, c - 1))
                kt = torch.where(vis[:, None], kf[row, idx], 0.0)
                vt = torch.where(vis[:, None], vf[row, idx], 0.0)
                # the staged tile serves each chunk of query rows in turn,
                # each chunk's (m, d, acc) kept from the tile before
                for g0, gn in swa_attention.decode_chunks(g):
                    r = slice(g0, g0 + gn)
                    sc = torch.where(vis[None, :], qs[row, r] @ kt.T,
                                     torch.tensor(NEG_INF))
                    m_new = torch.maximum(m[r], sc.max(-1).values)
                    pv = torch.where(sc > MASKED,
                                     torch.exp(sc - m_new[:, None]),
                                     torch.tensor(0.0))
                    corr = torch.exp(m[r] - m_new)
                    d[r] = d[r] * corr + pv.sum(-1)
                    acc[r] = acc[r] * corr[:, None] + pv @ vt
                    m[r] = m_new
            parts.append((m, d, acc))
        if live == 1:
            m, d, acc = parts[0]
            out[row] = acc / torch.clamp(d, min=1e-30)[:, None]
            continue
        m = torch.full((g,), NEG_INF)
        d = torch.zeros(g)
        o = torch.zeros(g, hd)
        for ms, ds, accs in parts:          # split order, online
            keep = ds != 0
            m_new = torch.where(keep, torch.maximum(m, ms), m)
            a = torch.exp(m - m_new)
            b = torch.where(keep, torch.exp(ms - m_new), torch.tensor(0.0))
            d = d * a + ds * b
            o = o * a[:, None] + accs * b[:, None]
            m = m_new
        out[row] = o / torch.clamp(d, min=1e-30)[:, None]
    return out


def _boundary_positions(c, per, window, rng, n):
    edges = [0, c - 1] + [e for b in range(per, c, per) for e in (b - 1, b)]
    if window:
        edges += [c + e for e in edges]
    assert len(edges) <= n
    pos = rng.randint(0, 3 * c, n)
    pos[:len(edges)] = edges
    return torch.from_numpy(pos.astype(np.int32))


def _cache(rng, n, c, hd, kind):
    k = torch.from_numpy(rng.randn(n, c, hd).astype(np.float32))
    v = torch.from_numpy(rng.randn(n, c, hd).astype(np.float32))
    if kind == "bf16":
        return k.bfloat16(), v.bfloat16(), None, None
    if kind == "f32":
        return k, v, None, None
    (kp, ks), (vp, vs) = quant.quantize_rows(k, kind), \
        quant.quantize_rows(v, kind)
    return kp, vp, ks, vs


def _np(t):
    """A cache operand for repro's side: (numpy array, its dtype's name),
    bf16 upcast to f32 and fp8 as its bytes (the child rebuilds both)."""
    if t is None:
        return None
    if t.dtype == torch.bfloat16:
        return t.float().numpy(), "bfloat16"
    if t.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        return t.view(torch.uint8).numpy(), {
            torch.float8_e4m3fn: "float8_e4m3fn",
            torch.float8_e5m2: "float8_e5m2"}[t.dtype]
    return t.numpy(), "float32"


def _case_inputs(g, hd, c, window, kind, sms):
    """The case's (n, q, k, v, pos, k_scale, v_scale), from its seed."""
    rng = np.random.RandomState(g * 131 + hd + c + sms)
    n = 36
    splits, per = swa_attention.decode_splits(n, c, hd, sms)
    assert splits > 1
    pos = _boundary_positions(c, per, window, rng, n)
    q = torch.from_numpy(rng.randn(n, g, hd).astype(np.float32))
    k, v, ks, vs = _cache(rng, n, c, hd, kind)
    return n, q, k, v, pos, ks, vs


_CASES = [
    (4, 64, 256, 0, "f32", H100_SMS),        # one tile a split
    (1, 64, 256, 256, "e4m3", H100_SMS),     # ring, G 1
    (16, 128, 128, 128, "e5m2", H100_SMS),   # ring, G 16, hd 128
    (16, 64, 512, 0, "bf16", H100_SMS),      # dense bf16, G 16
    (4, 128, 256, 0, "f32", 20),             # several tiles a split
    (2, 64, 512, 512, "bf16", 30),           # ring, several tiles a split
    (12, 192, 420, 0, "bf16", H100_SMS),     # hd 192, G 12, 21-slot tiles
    (12, 192, 256, 256, "e4m3", 40),         # ring, hd 192, a ragged tile,
                                             # several tiles a split
    (48, 128, 256, 0, "f32", H100_SMS),      # starcoder's G 48: 3 chunks
    (71, 64, 256, 256, "e4m3", 40),          # falcon's G 71: 5 chunks, ring,
                                             # several tiles a split
    (71, 128, 128, 0, "bf16", H100_SMS),
    (48, 64, 512, 512, "bf16", 30),
    (8, 80, 256, 0, "e4m3", H100_SMS),       # hd 80 on the 128 instance
    (8, 96, 256, 0, "bf16", 40),
    (4, 100, 256, 0, "f32", H100_SMS),       # hd 100: element loads
    (17, 256, 256, 256, "e4m3", H100_SMS),   # hd 256, 16-slot tiles
]
_children: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _repro_decodes():
    """repro's interpret-mode swa_flash_decode on every case's inputs, in
    one child started before the module's tests."""
    jobs = []
    for g, hd, c, window, kind, sms in _CASES:
        _, q, k, v, pos, ks, vs = _case_inputs(g, hd, c, window, kind, sms)
        jobs.append((q.numpy(), _np(k), _np(v), pos.numpy(), window, _np(ks),
                     _np(vs)))
    _children["decode"] = jax_one_cpu.start("jax_side_jobs", "decode_cases",
                                            jobs)
    yield
    for child in _children.values():
        child.close()


_results: dict = {}


def _repro(i):
    if "decode" not in _results:
        _results["decode"] = _children["decode"].result()
    return torch.from_numpy(_results["decode"][i])


@pytest.mark.parametrize("g,hd,c,window,kind,sms", _CASES)
def test_split_emulation_matches_repro_and_plain(g, hd, c, window, kind,
                                                 sms):
    n, q, k, v, pos, ks, vs = _case_inputs(g, hd, c, window, kind, sms)
    splits, per = swa_attention.decode_splits(n, c, hd, sms)
    got = _emulate(q, k, v, pos, window, ks, vs, sms)
    want = ref.swa_decode_ref(q, k, v, pos, window=window, k_scale=ks,
                              v_scale=vs)
    torch.testing.assert_close(got, want, **DEC_TOL)
    jout = _repro(_CASES.index((g, hd, c, window, kind, sms)))
    torch.testing.assert_close(got, jout, **DEC_TOL)
    # the splits past pos are dead: e.g. pos 0 has one live split, which
    # writes its output itself
    lives = [max(1, -(-min(c, int(p) + 1) // per)) for p in pos]
    assert min(lives) == 1 and max(lives) == splits


def test_merge_gives_a_partial_without_visible_slots_no_weight():
    """A partial with d = 0 and m = -1e30 beside live ones: the online
    merge skips it, so no NaN and the same result as without it."""
    g, hd = 2, 4
    rng = np.random.RandomState(3)
    live = [(torch.from_numpy(rng.randn(g).astype(np.float32)),
             torch.from_numpy(rng.rand(g).astype(np.float32) + 1.0),
             torch.from_numpy(rng.randn(g, hd).astype(np.float32)))
            for _ in range(3)]
    empty = (torch.full((g,), NEG_INF), torch.zeros(g), torch.zeros(g, hd))

    def merge(parts):
        m, d, o = torch.full((g,), NEG_INF), torch.zeros(g), torch.zeros(g, hd)
        for ms, ds, accs in parts:
            keep = ds != 0
            m_new = torch.where(keep, torch.maximum(m, ms), m)
            a = torch.exp(m - m_new)
            b = torch.where(keep, torch.exp(ms - m_new), torch.tensor(0.0))
            d, o, m = d * a + ds * b, o * a[:, None] + accs * b[:, None], m_new
        return o / torch.clamp(d, min=1e-30)[:, None]
    with_empty = merge(live[:1] + [empty] + live[1:])
    assert torch.isfinite(with_empty).all()
    torch.testing.assert_close(with_empty, merge(live), rtol=0, atol=0)
    # the two-pass form of the same sum
    big_m = torch.stack([p[0] for p in live]).max(0).values
    w = [torch.exp(p[0] - big_m) for p in live]
    two = sum(wi[:, None] * p[2] for wi, p in zip(w, live)) / \
        sum(wi * p[1] for wi, p in zip(w, live))[:, None]
    torch.testing.assert_close(with_empty, two, **DEC_TOL)
