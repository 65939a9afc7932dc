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
  nothing visible, a ring unwrapped and wrapped, G 1 and 16, hd 64 and
  128, one tile a split and several.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypothesis_compat import given, settings, st
from repro.kernels import ops as jops
from repro_torch.kernels import ref, swa_attention
from repro_torch.quant import quant

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

DEC_TOL = chip_smoke.DEC_TOL
NEG_INF, MASKED = -1e30, -5e29           # csrc/common.cuh REPRO_NEG_INF, REPRO_MASKED
H100_SMS = 132


@settings(deadline=None)
@given(n=st.integers(1, 600), c=st.integers(1, 70000),
       hd=st.sampled_from([64, 128]), sms=st.integers(1, 200))
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
                sc = torch.where(vis[None, :], qs[row] @ kt.T,
                                 torch.tensor(NEG_INF))
                m_new = torch.maximum(m, sc.max(-1).values)
                pv = torch.where(sc > MASKED, torch.exp(sc - m_new[:, None]),
                                 torch.tensor(0.0))
                corr = torch.exp(m - m_new)
                d = d * corr + pv.sum(-1)
                acc = acc * corr[:, None] + pv @ vt
                m = m_new
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


def _jax(t):
    if t is None:
        return None
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    if t.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        dt = {torch.float8_e4m3fn: jnp.float8_e4m3fn,
              torch.float8_e5m2: jnp.float8_e5m2}[t.dtype]
        return jnp.asarray(t.view(torch.uint8).numpy()).view(dt)
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("g,hd,c,window,kind,sms", [
    (4, 64, 256, 0, "f32", H100_SMS),        # one tile a split
    (1, 64, 256, 256, "e4m3", H100_SMS),     # ring, G 1
    (16, 128, 128, 128, "e5m2", H100_SMS),   # ring, G 16, hd 128
    (16, 64, 512, 0, "bf16", H100_SMS),      # dense bf16, G 16
    (4, 128, 256, 0, "f32", 20),             # several tiles a split
    (2, 64, 512, 512, "bf16", 30),           # ring, several tiles a split
    (12, 192, 420, 0, "bf16", H100_SMS),     # hd 192, G 12, 21-slot tiles
    (12, 192, 256, 256, "e4m3", 40),         # ring, hd 192, a ragged tile,
                                             # several tiles a split
])
def test_split_emulation_matches_repro_and_plain(g, hd, c, window, kind,
                                                 sms):
    rng = np.random.RandomState(g * 131 + hd + c + sms)
    n = 36
    splits, per = swa_attention.decode_splits(n, c, hd, sms)
    assert splits > 1
    pos = _boundary_positions(c, per, window, rng, n)
    q = torch.from_numpy(rng.randn(n, g, hd).astype(np.float32))
    k, v, ks, vs = _cache(rng, n, c, hd, kind)
    got = _emulate(q, k, v, pos, window, ks, vs, sms)
    want = ref.swa_decode_ref(q, k, v, pos, window=window, k_scale=ks,
                              v_scale=vs)
    torch.testing.assert_close(got, want, **DEC_TOL)
    jout = jops.swa_decode(jnp.asarray(q.numpy()), _jax(k), _jax(v),
                           jnp.asarray(pos.numpy()), window=window,
                           k_scale=_jax(ks), v_scale=_jax(vs),
                           interpret=True)
    torch.testing.assert_close(got, torch.from_numpy(np.array(jout)),
                               **DEC_TOL)
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
