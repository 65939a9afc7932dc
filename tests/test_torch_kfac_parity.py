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
    """The training path sums and preconditions layer by layer; the cuda
    entries refuse a leading axis (before any kernel is reached) instead of
    looping over it."""
    before = dict(kern.LAUNCHES)
    with pytest.raises(ValueError, match="one matrix per call"):
        dispatch.lookup("factor_sum", "cuda")(torch.zeros(2, 8, 4), 4)
    with pytest.raises(ValueError, match="one matrix per call"):
        dispatch.lookup("block_precond_left", "cuda")(
            torch.eye(4).expand(2, 1, 4, 4), torch.zeros(2, 4, 3))
    with pytest.raises(ValueError, match="one matrix per call"):
        dispatch.lookup("block_precond_right", "cuda")(
            torch.zeros(2, 3, 4), torch.eye(4).expand(2, 1, 4, 4))
    assert kern.LAUNCHES == before
