"""repro_torch K-FAC math and its two kernel ops against the JAX package,
on the CPU.

The plain versions of ``factor_sum`` and ``block_precond_left/_right`` are
held against the JAX package's ``ref`` ops and its Pallas kernels in
interpret mode (``ops.kfac_factor`` / ``ops.kfac_block_precond``) on the
same numpy inputs, with a ragged n, d not a multiple of the tile, several
blocks and a padded last block; then the rest of ``core/kfac.py``. The
tolerance is 1e-4 relative to the largest entry (f32 sums in another
order), the JAX package's own for factors and preconditioning. The CUDA
kernels run only on the card (``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kfac as jkfac
from repro.kernels import dispatch as jdispatch
from repro.kernels import ops as jops
from repro_torch.core import kfac
from repro_torch.kernels import dispatch, kfac as kern, ref

TOL = 1e-4


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("n,d,max_dim", [
    (37, 50, 16),      # ragged n, 4 blocks of 13 -> 2 zero-padded columns
    (64, 64, 64),      # one block
    (33, 96, 32),      # 3 exact blocks
    (20, 7, 128),      # d below the cap
])
def test_factor_sum_plain_matches_jax_ref_and_pallas(n, d, max_dim):
    rng = np.random.default_rng(n + d)
    x = _rand(rng, (n, d))
    got = dispatch.factor_sum(torch.from_numpy(x), max_dim).numpy()
    want_ref = np.asarray(jdispatch.factor_sum(jnp.asarray(x), max_dim,
                                               backend="ref"))
    want_pl = np.asarray(jdispatch.factor_sum(jnp.asarray(x), max_dim,
                                              backend="pallas"))
    assert got.shape == want_ref.shape
    assert _rel(got, want_ref) <= TOL
    assert _rel(got, want_pl) <= TOL


def test_factor_sum_plain_matches_pallas_with_small_tiles():
    """d not a multiple of the Pallas tile (ops.kfac_factor pads to it and
    mirrors the upper tiles), n not a multiple of the depth, and leading
    layer axes on the plain op."""
    rng = np.random.default_rng(7)
    x = _rand(rng, (2, 29, 20))
    got = dispatch.factor_sum(torch.from_numpy(x), 20).numpy()
    for i in range(2):
        want = np.asarray(jops.kfac_factor(jnp.asarray(x[i]), bm=8, bn=8,
                                           bk=8, interpret=True))
        assert _rel(got[i, 0], want) <= TOL


def test_factor_sum_bf16_inputs_sum_in_f32():
    rng = np.random.default_rng(8)
    x = _rand(rng, (40, 24))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = dispatch.factor_sum(xb, 16)
    assert got.dtype == torch.float32
    want = jdispatch.factor_sum(jnp.asarray(x).astype(jnp.bfloat16), 16,
                                backend="ref")
    assert _rel(got.numpy(), np.asarray(want)) <= TOL


@pytest.mark.parametrize("nb,b,dim,m", [
    (1, 16, 16, 24),       # one block
    (3, 12, 36, 10),       # several exact blocks
    (3, 12, 34, 9),        # a padded last block (34 = 3 x 12 - 2)
])
def test_block_precond_plain_matches_jax(nb, b, dim, m):
    rng = np.random.default_rng(nb * 100 + dim)
    binv = _rand(rng, (nb, b, b))
    wl = _rand(rng, (dim, m))
    wr = _rand(rng, (m, dim))
    got_l = dispatch.block_precond_left(torch.from_numpy(binv),
                                        torch.from_numpy(wl)).numpy()
    got_r = dispatch.block_precond_right(torch.from_numpy(wr),
                                         torch.from_numpy(binv)).numpy()
    jb = jnp.asarray(binv)
    wlb = jkfac.block_reshape(jnp.asarray(wl), dim, b, axis=-2)
    wrb = jkfac.block_reshape(jnp.asarray(wr), dim, b, axis=-1)
    for backend in ("ref", "pallas"):
        ul = jdispatch.block_precond_left(jb, wlb, backend=backend)
        ur = jdispatch.block_precond_right(wrb, jb, backend=backend)
        assert _rel(got_l, jkfac.block_unreshape(ul, dim, axis=-3)) <= TOL
        assert _rel(got_r, jkfac.block_unreshape(ur, dim, axis=-2)) <= TOL


def test_block_precond_plain_matches_pallas_with_ragged_tiles():
    """b not a multiple of the Pallas tiles (the TPU wrapper pads b to
    lcm(bm, bk) and m to bn)."""
    rng = np.random.default_rng(9)
    binv, w = _rand(rng, (2, 10, 10)), _rand(rng, (2, 10, 13))
    want = jops.kfac_block_precond(jnp.asarray(binv), jnp.asarray(w), bm=8,
                                   bn=8, bk=4, interpret=True)
    got = ref.block_precond_left_ref(torch.from_numpy(binv),
                                     torch.from_numpy(w))
    assert _rel(got.numpy(), np.asarray(want)) <= TOL


def test_block_helpers_match_jax():
    rng = np.random.default_rng(10)
    x = _rand(rng, (3, 34, 5))
    for d, max_dim in ((34, 12), (34, 34), (34, 100)):
        assert kfac.num_blocks(d, max_dim) == jkfac.num_blocks(d, max_dim)
        assert kfac.block_size(d, max_dim) == jkfac.block_size(d, max_dim)
        assert kfac.padded_dim(d, max_dim) == jkfac.padded_dim(d, max_dim)
        got = kfac.block_reshape(torch.from_numpy(x), d, max_dim, axis=-2)
        want = jkfac.block_reshape(jnp.asarray(x), d, max_dim, axis=-2)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        back = kfac.block_unreshape(got, d, axis=-3)
        np.testing.assert_array_equal(back.numpy(), x)


def _spd(rng, lead, b, scale=1.0):
    m = _rand(rng, lead + (b, 2 * b))
    return (m @ np.swapaxes(m, -1, -2) / (2 * b) * scale).astype(np.float32)


@pytest.mark.parametrize("method", ["eigh", "cholesky"])
def test_damped_inverses_match_jax(method):
    rng = np.random.default_rng(11)
    a, g = _spd(rng, (2, 3), 8), _spd(rng, (2, 2), 6, scale=1e-3)
    ta, tg = torch.from_numpy(a), torch.from_numpy(g)
    ja, jg = jnp.asarray(a), jnp.asarray(g)
    np.testing.assert_allclose(
        kfac.pi_correction(ta, tg, 22, 12).numpy(),
        np.asarray(jkfac.pi_correction(ja, jg, 22, 12)), rtol=1e-5)
    *got, info = kfac.damped_factor_inverses(ta, tg, 1e-3, 22, 12,
                                             method=method)
    want = jkfac.damped_factor_inverses(ja, jg, 1e-3, 22, 12, method=method,
                                        backend="ref")
    assert len(got) == len(want) == 2
    for x, y in zip(got, want):
        assert _rel(x.numpy(), np.asarray(y)) <= TOL
    # the direct methods' per-block info: residual 0, converged
    assert set(info) == {"a", "g"}
    for k, f in (("a", a), ("g", g)):
        assert torch.equal(info[k]["ns_res"], torch.zeros(f.shape[:-2]))
        assert info[k]["ns_converged"].all()


@pytest.mark.parametrize("a_kind,g_kind,sides", [
    ("full", "diag", "ag"), ("diag", "full", "ag"), ("diag", "diag", "ag"),
    ("full", "full", "g"), ("diag", "full", "a")])
def test_damped_factor_inverses_match_the_jax_refresh(a_kind, g_kind, sides):
    """The Eq. 12 split as the JAX optimizer's refresh computes it
    (``repro/core/ngd.py`` ``_mean_eig`` / ``_damped_inv``): diagonal
    factors, and sites with one factor (pi = 1), over a leading layer
    axis."""
    from repro.core import ngd as jngd
    rng = np.random.default_rng(13)
    lam, d_a, d_g = 1e-3, 14, 10

    def stat(kind, d):
        if kind == "full":
            return _spd(rng, (2, 2), 7 if d == d_a else 5)
        return np.abs(_rand(rng, (2, d)))
    a = stat(a_kind, d_a) if "a" in sides else None
    g = stat(g_kind, d_g) if "g" in sides else None
    *got, info = kfac.damped_factor_inverses(
        None if a is None else torch.from_numpy(a),
        None if g is None else torch.from_numpy(g), lam, d_a, d_g,
        a_kind=a_kind, g_kind=g_kind)
    # per-block info only for the blocked factors
    assert set(info) == {k for k, f, kind in (("a", a, a_kind),
                                              ("g", g, g_kind))
                         if f is not None and kind == "full"}
    if a is not None and g is not None:
        ea = jngd._mean_eig(jnp.asarray(a), a_kind, d_a)
        eg = jngd._mean_eig(jnp.asarray(g), g_kind, d_g)
        pi = jnp.sqrt(jnp.maximum(ea, 1e-12) / jnp.maximum(eg, 1e-12))
        np.testing.assert_allclose(
            kfac.pi_correction(torch.from_numpy(a), torch.from_numpy(g), d_a,
                               d_g, a_kind=a_kind, g_kind=g_kind).numpy(),
            np.asarray(pi), rtol=1e-5)
    else:
        pi = jnp.ones((2,))
    sl = jnp.sqrt(jnp.float32(lam))
    for x, f, kind, damp in ((got[0], a, a_kind, pi * sl),
                             (got[1], g, g_kind, sl / pi)):
        if f is None:
            assert x is None
            continue
        want = jngd._damped_inv(jnp.asarray(f), kind, damp, "eigh",
                                backend="ref")
        assert _rel(x.numpy(), np.asarray(want)) <= TOL


def test_eigh_inverse_clamps_negative_eigenvalues_like_jax():
    rng = np.random.default_rng(12)
    f = _spd(rng, (1,), 6) - 0.3 * np.eye(6, dtype=np.float32)
    got = kfac.damped_inverse(torch.from_numpy(f), 0.05)
    want = jkfac.damped_inverse(jnp.asarray(f), 0.05)
    assert _rel(got.numpy(), np.asarray(want)) <= TOL


def test_newton_schulz_waits_for_its_slice():
    """The Stage-4 slice is in: dispatch inverts with Newton-Schulz on the
    CPU (the plain iteration), every block converged, within 5e-3 of the
    largest entry of eigh's inverse (the JAX package's NS-vs-eigh
    tolerance, tests/test_inverse_numerics.py:141) and within TOL of
    repro's own Newton-Schulz; an unknown method still raises."""
    rng = np.random.default_rng(15)
    f = _spd(rng, (2, 3), 12)
    d = np.full((2, 1), 1e-3, np.float32)
    got, info = dispatch.damped_inverse(torch.from_numpy(f),
                                        torch.from_numpy(d),
                                        method="newton_schulz",
                                        return_info=True)
    assert info["ns_converged"].shape == (2, 3) and info["ns_converged"].all()
    eigh = dispatch.damped_inverse(torch.from_numpy(f), torch.from_numpy(d))
    assert _rel(got.numpy(), eigh.numpy()) <= 5e-3
    want = jdispatch.damped_inverse(jnp.asarray(f), jnp.asarray(d),
                                    method="newton_schulz", backend="ref")
    assert _rel(got.numpy(), np.asarray(want)) <= TOL
    with pytest.raises(ValueError, match="unknown inverse method"):
        dispatch.damped_inverse(torch.from_numpy(f), 1e-3, method="lu")


@pytest.mark.parametrize("a_kind,g_kind", [("full", "full"), ("diag", "full"),
                                           ("full", "diag"), (None, "full")])
def test_precondition_matches_jax(a_kind, g_kind):
    """A^-1 dW G^-1 with blocked (ragged last block) or diagonal sides, and
    leading layer axes."""
    rng = np.random.default_rng(13)
    d_in, d_out = 34, 20
    dw = _rand(rng, (2, d_in, d_out))
    side = {"full": lambda d, b: _spd(rng, (2, kfac.num_blocks(d, b)),
                                      kfac.block_size(d, b)),
            "diag": lambda d, b: np.abs(_rand(rng, (2, d))),
            None: lambda d, b: None}
    a, g = side[a_kind](d_in, 12), side[g_kind](d_out, 8)
    tt = (lambda x: None if x is None else torch.from_numpy(x))
    jj = (lambda x: None if x is None else jnp.asarray(x))
    got = kfac.precondition(torch.from_numpy(dw), tt(a), tt(g))
    want = jkfac.precondition(jnp.asarray(dw), jj(a), jj(g), backend="ref")
    assert _rel(got.numpy(), np.asarray(want)) <= TOL


def test_unitwise_diag_solve_and_frob_match_jax():
    rng = np.random.default_rng(14)
    st = np.abs(_rand(rng, (5, 3)))
    gg, gb = _rand(rng, (5,)), _rand(rng, (5,))
    ug, ub = kfac.unitwise_solve(torch.from_numpy(st), torch.from_numpy(gg),
                                 torch.from_numpy(gb), 1e-2)
    jg, jb = jkfac.unitwise_solve(jnp.asarray(st), jnp.asarray(gg),
                                  jnp.asarray(gb), 1e-2)
    np.testing.assert_allclose(ug.numpy(), np.asarray(jg), rtol=1e-5)
    np.testing.assert_allclose(ub.numpy(), np.asarray(jb), rtol=1e-5)
    np.testing.assert_allclose(
        kfac.diag_solve(torch.from_numpy(st[:, 0]), torch.from_numpy(gg),
                        1e-2).numpy(),
        np.asarray(jkfac.diag_solve(jnp.asarray(st[:, 0]), jnp.asarray(gg),
                                    1e-2)), rtol=1e-6)
    x, y = _rand(rng, (3, 4, 4)), _rand(rng, (3, 4, 4))
    np.testing.assert_allclose(
        float(kfac.frob_distance(torch.from_numpy(x), torch.from_numpy(y))),
        float(jkfac.frob_distance(jnp.asarray(x), jnp.asarray(y))), rtol=1e-5)
    np.testing.assert_allclose(
        kfac.diag_factor_sum(torch.from_numpy(x)).numpy(),
        np.asarray(jkfac.diag_factor_sum(jnp.asarray(x))), rtol=1e-5)


def test_kfac_kernel_wrappers_refuse_cpu_tensors_and_cuda_backend_on_cpu():
    before = dict(kern.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        kern.factor_syrk(torch.zeros(8, 4), 4)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        kern.block_precond(torch.zeros(1, 4, 4), torch.zeros(4, 3))
    assert kern.LAUNCHES == before
    for call in (lambda: dispatch.factor_sum(torch.zeros(8, 4), 4,
                                             backend="cuda"),
                 lambda: dispatch.block_precond_left(
                     torch.zeros(1, 4, 4), torch.zeros(4, 3), backend="cuda"),
                 lambda: dispatch.damped_inverse(torch.eye(4)[None], 1.0,
                                                 backend="cuda")):
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()
    dispatch.reset_calls()
    dispatch.factor_sum(torch.zeros(8, 4), 4)
    dispatch.block_precond_right(torch.zeros(3, 4), torch.eye(4)[None])
    dispatch.damped_inverse(torch.eye(4)[None], 1.0)
    assert dispatch.CALLS == {("factor_sum", "ref"): 1,
                              ("block_precond_right", "ref"): 1,
                              ("damped_inverse", "ref"): 1}
    for op in ("factor_sum", "block_precond_left", "block_precond_right",
               "damped_inverse", "swa_attention_bwd"):
        assert dispatch.lookup(op, "cuda") is not dispatch.lookup(op, "ref")


def test_kfac_cuda_entries_take_one_matrix_per_call():
    """The cuda factor_sum, factor_sum_wire and block_precond entries take
    a leading axis (an MoE site's experts: one launch per call on the card,
    never a loop over it) and, like every kernel wrapper, refuse CPU
    tensors before any launch."""
    before = dict(kern.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        dispatch.lookup("factor_sum", "cuda")(torch.zeros(2, 8, 4), 4)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        dispatch.lookup("block_precond_left", "cuda")(
            torch.eye(4).expand(2, 1, 4, 4), torch.zeros(2, 4, 3))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        dispatch.lookup("block_precond_right", "cuda")(
            torch.zeros(2, 3, 4), torch.eye(4).expand(2, 1, 4, 4))
    for d in (4, 2050):              # the fused kernel, and the b > 1024 route
        with pytest.raises(ValueError, match="CUDA tensors only"):
            dispatch.lookup("factor_sum_wire", "cuda")(
                torch.zeros(2, 8, d), 2048 if d > 4 else 4, "e4m3", "fp32")
    assert kern.LAUNCHES == before


# ---------------------------------------------------------------------------
# factor_syrk's launch geometry (kernels/kfac.py syrk_geometry,
# syrk_sharers): the CUDA kernel runs only on the card, its partition of the
# work is checked here
# ---------------------------------------------------------------------------

def _tile_pair(bx, tiles):
    """The upper-triangle tile pair (ti <= tj) of pair index bx: the
    kernel's decode (csrc/kfac_factor.cu tile_pair), step for step."""
    ti = 0
    while bx >= tiles - ti:
        bx -= tiles - ti
        ti += 1
    return ti, ti + bx


def _segments(n, b, nb, sms):
    """Each block of threads' segments (tile q, first slice, end slice), in
    the kernel's order, and the geometry."""
    tiles, slices, ctas, per = kern.syrk_geometry(n, b, nb, sms)
    total = nb * tiles * (tiles + 1) // 2 * slices
    segs = []
    for w in range(ctas):
        g, g1, mine = w * per, min(total, (w + 1) * per), []
        while g < g1:
            q = g // slices
            end = min(g1, (q + 1) * slices)
            mine.append((q, g % slices, g % slices + end - g))
            g = end
        segs.append(mine)
    return segs, (tiles, slices, ctas, per, total)


# the f32 bodies' split over tokens (kernels/kfac.py syrk_f32_route,
# syrk_f32_split: the kernel's chunk_rows and chunk count); below
# F32_SPLIT_ROWS rows one chunk, from there a multiple of the route's stage

def _f32_unit(route, b):
    return {"simt": kern.SIMT_BK, "narrow": kern.narrow_stage_rows(b),
            "wide": kern.WIDE_BK}[route]


@pytest.mark.parametrize("n,d", [
    (1048576, 27), (1048576, 16), (1048576, 144),   # the ConvNet's stage 0
    (262144, 288), (65536, 576), (1024, 10),         # stages 1, 2, the head
    (1024, 2048), (4096, 512), (4000, 2050),         # the LM's f32 route
    (0, 16), (17, 16), (1025, 64),
    (16383, 27), (16384, 27), (16383, 144), (16384, 144)])   # the boundary
def test_syrk_f32_split_covers_every_row_once(n, d):
    nb, b = kfac.num_blocks(d, 2048), kfac.block_size(d, 2048)
    route = kern.syrk_f32_route(n, b)
    asked, rows, chunks = kern.syrk_f32_split(n, b, nb, 132)
    assert 1 <= chunks <= asked
    unit = _f32_unit(route, b)
    assert rows % unit == 0 and rows >= unit
    if route == "simt":
        assert n < kern.F32_SPLIT_ROWS and asked == chunks == 1
        assert rows == max(16, -(-n // 16) * 16)
    else:
        # the kernel's chunk_rows from (n, asked), and its chunk count
        assert rows == -(-(-(-n // asked)) // unit) * unit
        assert chunks == -(-n // rows) and rows <= kern.F32_MAX_CHUNK
        assert route == ("narrow" if b <= kern.F32_NARROW_MAX else "wide")
    spans = [(z * rows, min(n, (z + 1) * rows)) for z in range(chunks)]
    if n:
        assert sum(e - s for s, e in spans) == n and spans[-1][1] == n
        assert all(e > s for s, e in spans)
    else:
        assert chunks == 1
    if route == "narrow":       # chunks asked to fill the SMs
        assert asked * nb >= kern.NARROW_CTAS_PER_SM * 132
    # the LM's f32 route (the 2-layer checks) and the head keep one chunk
    if n < 16384:
        assert route == "simt"
    else:
        assert route != "simt"


def _f32_partial_writes(n, d, max_dim, lead):
    """Every (chunk, matrix block, entry) write of the f32 route's first
    launch, and the reduce's output writes, as the kernels make them."""
    nb, b = kfac.num_blocks(d, max_dim), kfac.block_size(d, max_dim)
    route = kern.syrk_f32_route(n, b)
    asked, rows, chunks = kern.syrk_f32_split(n, b, nb, 132, lead)
    blocks = lead * nb
    writes = np.zeros((chunks, blocks, b, b), np.int32)
    rows_seen = np.zeros((chunks, blocks, n), np.int32)
    if route == "narrow":
        s = kern.narrow_stage_rows(b)
        patches = kern.narrow_patches(b)
        slots = 256 // len(patches)
        assert slots >= 1
        for z in range(chunks):
            t0, t1 = z * rows, min(n, (z + 1) * rows)
            for st in range(-(-(t1 - t0) // s)):
                r0 = t0 + st * s
                nr = min(s, t1 - r0)
                # every row of a stage to exactly one slot
                taken = [r for slot in range(slots)
                         for r in range(slot, nr, slots)]
                assert sorted(taken) == list(range(nr))
                rows_seen[z, :, r0:r0 + nr] += 1
            for pi, pj in patches:
                i = np.arange(4 * pi, min(b, 4 * pi + 4))
                j = np.arange(4 * pj, min(b, 4 * pj + 4))
                writes[z][:, i[:, None], j[None, :]] += 1
    else:
        assert route == "wide" and rows % kern.WIDE_BK == 0
        pairs = kern.wide_pairs(b)
        tiles = -(-b // kern.WIDE_TILE)
        assert all(0 <= c <= r < tiles for r, c in pairs)
        assert len(set(pairs)) == len(pairs)
        items = [(z, blk, q) for z in range(chunks) for blk in range(blocks)
                 for q in range(len(pairs))]
        # block of threads i takes item i: chunk-major, the pair fastest
        for i, (z, blk, q) in enumerate(items):
            assert i // (blocks * len(pairs)) == z
            assert i % (blocks * len(pairs)) == blk * len(pairs) + q
            r, c = pairs[q]
            tn = kern.wide_tile_rows(r, b)
            assert tn in (16, 32, 64, 128, 144)
            assert r * kern.WIDE_TILE + tn >= min(b, (r + 1) * kern.WIDE_TILE)
            t0, t1 = z * rows, min(n, (z + 1) * rows)
            if q == 0:
                rows_seen[z, blk, t0:t1] += 1
            rr = np.arange(r * 128, min(b, r * 128 + tn))
            cc = np.arange(c * 128, min(b, c * 128 + 128))
            writes[z, blk][rr[:, None], cc[None, :]] += 1
    # every row of every (matrix, block) in exactly one chunk
    assert (rows_seen.sum(0) == 1).all()
    # every lower entry (i >= j, what the reduce reads) written once by
    # each chunk's partial of every (matrix, block)
    low = np.tril(np.ones((b, b), bool))
    assert (writes[..., low] == 1).all()
    # the reduce: chunk z to group z mod G in chunk order, then the groups
    # in order; each output entry written exactly once, from its lower twin
    order = [z for g in range(kern.SYRK_REDUCE_GROUPS)
             for z in range(g, chunks, kern.SYRK_REDUCE_GROUPS)]
    assert sorted(order) == list(range(chunks))
    out = np.zeros((b, b), np.int32)
    for e in range(b * b):
        i, j = divmod(e, b)
        if j <= i:
            out[i, j] += 1
            if i != j:
                out[j, i] += 1
    assert (out == 1).all()
    return route


@pytest.mark.parametrize("n,d,max_dim,lead", [
    (16384, 27, 2048, 1), (16384, 144, 2048, 1), (20000, 16, 2048, 1),
    (16384, 100, 64, 1),      # nb 2 of 50: the narrow strided loads
    (16384, 2050, 1024, 1),   # nb 3 of 684, ragged: the wide element loads
    (16384, 300, 2048, 2),    # a lead, b 300: a last row tile of 64
    (20000, 27, 2048, 3),     # a lead on the narrow route
    (17000, 80, 2048, 1),     # b 80: a last row tile of 16
    (16384, 272, 2048, 1),    # 16 rows absorbed into the second row tile
    (16384, 129, 2048, 1),    # one row absorbed
    (65536, 576, 2048, 1), (262144, 288, 2048, 1), (65536, 64, 2048, 1)])
def test_syrk_f32_routes_write_every_entry_once(n, d, max_dim, lead):
    """The mirror of the two f32 routes from F32_SPLIT_ROWS rows: the
    narrow body's slots take every row of a stage once and its lower 4 x 4
    patches every lower entry once; the wide body's items (chunk, matrix
    block, lower tile pair) every lower entry once, each chunk's rows read
    once; the reduce writes every entry of the (b, b) output once, from the
    lower partials in a fixed order."""
    nb, b = kfac.num_blocks(d, max_dim), kfac.block_size(d, max_dim)
    route = _f32_partial_writes(n, d, max_dim, lead)
    assert route == ("narrow" if b <= kern.F32_NARROW_MAX else "wide")


def test_syrk_f32_chunks_bound_the_rounding():
    """The reason for the split, emulated in numpy f32 (a product rounded,
    then added; the kernel fuses them): one accumulator over 262,144 rows
    drifts from the f64 sum, chunk partials (the narrow route's geometry)
    added in the reduce's order do not."""
    rng = np.random.RandomState(0)
    n, d = 262144, 6
    x = rng.randn(n, d).astype(np.float32)
    exact = x.astype(np.float64).T @ x.astype(np.float64)
    prods = (x[:, :, None] * x[:, None, :]).astype(np.float32)
    one = np.cumsum(prods, axis=0, dtype=np.float32)[-1]
    assert kern.syrk_f32_route(n, d) == "narrow"
    _, rows, chunks = kern.syrk_f32_split(n, d, 1, 132)
    parts = [np.cumsum(prods[z * rows:(z + 1) * rows], axis=0,
                       dtype=np.float32)[-1] for z in range(chunks)]
    g = kern.SYRK_REDUCE_GROUPS
    groups = [np.cumsum(np.stack(parts[k::g]), axis=0, dtype=np.float32)[-1]
              for k in range(min(g, chunks))]
    split = np.cumsum(np.stack(groups), axis=0, dtype=np.float32)[-1]
    scale = np.abs(exact).max()
    assert chunks > 1
    assert np.abs(split - exact).max() / scale < 1e-6
    assert np.abs(one - exact).max() / scale > 10 * (
        np.abs(split - exact).max() / scale)


@pytest.mark.parametrize("n,d,max_dim", [
    (4096, 512, 2048),     # wk/wv G, every wire call
    (4096, 2048, 2048),    # b 2048, nb 1
    (4096, 8192, 2048),    # d 8192, nb 4
    (4000, 2050, 1024),    # 3 blocks of 684, ragged n
    (4096, 1000, 2048),    # b 1000
    (1000, 2050, 1024),    # the unaligned check case
    (0, 512, 2048),        # no tokens: one all-zero slice per tile
])
def test_syrk_geometry_covers_every_tile_and_slice_once(n, d, max_dim):
    nb, b = kfac.num_blocks(d, max_dim), kfac.block_size(d, max_dim)
    segs, (tiles, slices, ctas, per, total) = _segments(n, b, nb, 132)
    assert (tiles - 1) * kern.TC_TILE < b <= tiles * kern.TC_TILE
    assert slices * kern.TC_SLICE >= n > (slices - 1) * kern.TC_SLICE or n == 0
    pairs = [_tile_pair(bx, tiles)
             for bx in range(tiles * (tiles + 1) // 2)]
    assert sorted(pairs) == [(i, j) for i in range(tiles)
                             for j in range(i, tiles)]
    # no block idle, every (tile, slice) summed once; blocks that share
    # tiles wait for each other, so they must all be resident: one wave
    ntiles = total // slices
    assert (ctas - 1) * per < total <= ctas * per
    if per % slices:
        assert 1 <= ctas <= 132
    else:
        assert ctas == ntiles
    done = [(q, s) for mine in segs for q, s0, s1 in mine
            for s in range(s0, s1)]
    assert sorted(done) == [(q, s) for q in range(total // slices)
                            for s in range(slices)]
    # the blocks that share a tile, and their workspace slots (the kernel's
    # Work::slot: 2w for the tile a block starts in, 2w + 1 for the one it
    # ends in) are distinct
    slots = set()
    for q in range(total // slices):
        who = [w for w, mine in enumerate(segs) if any(t == q for t, _, _ in
                                                        mine)]
        assert list(kern.syrk_sharers(q, slices, per)) == who
        if len(who) > 1:
            for w in who:
                slot = 2 * w + (q != w * per // slices)
                assert slot not in slots and slot < 2 * ctas
                slots.add(slot)
    # tiles that would leave SMs idle are shared out; more fill the card
    if n:
        assert ctas > ntiles if ntiles < 132 else ctas >= 132


def _emulate_syrk(x, max_dim, sms):
    """factor_syrk's bf16 partition in numpy: each block's segments summed
    over their slices; a shared tile's partials summed in block order; each
    tile written with its mirror (a diagonal tile: its lower half,
    mirrored)."""
    n, d = x.shape
    nb, b = kfac.num_blocks(d, max_dim), kfac.block_size(d, max_dim)
    segs, (tiles, slices, ctas, per, total) = _segments(n, b, nb, sms)
    e, pairs = kern.TC_TILE, tiles * (tiles + 1) // 2
    xp = np.zeros((n + slices * kern.TC_SLICE, nb * b + e * tiles),
                  np.float32)
    xp[:n, :d] = x
    parts = {}
    for w, mine in enumerate(segs):
        for q, s0, s1 in mine:
            blk, (ti, tj) = q // pairs, _tile_pair(q % pairs, tiles)
            i0, j0 = blk * b + ti * e, blk * b + tj * e
            t0, t1 = s0 * kern.TC_SLICE, s1 * kern.TC_SLICE
            acc = np.zeros((e, e), np.float32)
            for t in range(t0, t1, kern.TC_SLICE):
                rows = xp[t:t + kern.TC_SLICE]
                acc += rows[:, i0:i0 + e].T @ rows[:, j0:j0 + e]
            parts[(q, w)] = acc
    out = np.full((nb, b, b), np.nan, np.float32)
    for q in range(total // slices):
        who = kern.syrk_sharers(q, slices, per)
        acc = parts[(q, who[0])].copy()
        for w in who[1:]:
            acc += parts[(q, w)]
        blk, (ti, tj) = q // pairs, _tile_pair(q % pairs, tiles)
        gi = ti * e + np.arange(e)[:, None] + 0 * np.arange(e)[None, :]
        gj = tj * e + np.arange(e)[None, :] + 0 * np.arange(e)[:, None]
        keep = (gi < b) & (gj < b) & ((ti != tj) | (gi >= gj))
        out[blk, gi[keep], gj[keep]] = acc[keep]
        out[blk, gj[keep], gi[keep]] = acc[keep]
    return out, max(len(kern.syrk_sharers(q, slices, per))
                    for q in range(total // slices))


@pytest.mark.parametrize("n,d,max_dim,sms", [
    (1000, 200, 256, 132),   # 2 tiles of a ragged b, shared tiles
    (1100, 300, 128, 132),   # 3 blocks of 100, ragged n
    (700, 260, 1024, 132),   # 3 tiles of one ragged block
    (700, 260, 1024, 1),     # one block of threads does everything
])
def test_syrk_partition_matches_jax_factor_sum(n, d, max_dim, sms):
    x = _rand(np.random.default_rng(n + d), (n, d))
    got, most = _emulate_syrk(x, max_dim, sms)
    want = np.asarray(jkfac.factor_sum(jnp.asarray(x), max_dim,
                                       backend="ref"))
    assert got.shape == want.shape and not np.isnan(got).any()
    assert _rel(got, want) <= TOL
    np.testing.assert_array_equal(got, np.swapaxes(got, -1, -2))
    assert (most > 1) == (sms == 132)


@pytest.mark.parametrize("inner,items", [
    (3, 66000),     # f32 factor_syrk below F32_SPLIT_ROWS: the tile pairs
                    # of b 100 (2 tiles), then the (matrix, block)
    (1, 66000),     # the narrow route at one chunk: (16384, 66000), b 1
    (4, 70000),     # the reduce: 32-entry runs of a (b, b) block, b 11
    (2, 66000),     # factor_syrk_wire's pack: 8-row groups, b 16
    (2, 65536),     # ns_inverse_blocks: a cluster of 2 per factor block
    (16, 4200),     # f32 swa_flash: 16 query tiles per head, BH 4200
])
def test_folded_grids_cover_every_item_once(inner, items):
    """Past grid y's 65,535 the launches fold their (matrix, block) items
    into grid x (kernels/common.py fold_grid, the kernels' own ``blockIdx.x
    % inner`` and ``/ inner``): every (position, item) is one block, an
    item's blocks neighbour each other and the items go in order, as grid
    y took them; past grid x's 2^31 - 1 the fold refuses."""
    from repro_torch.kernels.common import GRID_X_MAX, fold_grid
    grid = np.asarray(fold_grid(inner, items))
    assert len(grid) == inner * items > 65535
    seen = np.zeros((items, inner), np.int32)
    np.add.at(seen, (grid[:, 1], grid[:, 0]), 1)
    assert (seen == 1).all()
    np.testing.assert_array_equal(grid[:, 1], np.repeat(np.arange(items),
                                                        inner))
    with pytest.raises(ValueError, match="grid x"):
        fold_grid(inner, GRID_X_MAX // inner + 1)


def test_f32_split_past_65535_blocks():
    """The narrow route at 66,000 blocks of one column (chip_smoke's case)
    asks one chunk, whose partials the reduce sums block by block."""
    asked, rows, chunks = kern.syrk_f32_split(16384, 1, 66000, 132)
    assert kern.syrk_f32_route(16384, 1) == "narrow"
    assert (asked, chunks) == (1, 1) and rows >= 16384
