"""repro_torch's Newton-Schulz Stage 4 against the JAX package, on the CPU.

The plain versions of the three kernels (``kernels/ref.py``) are held
against the TPU kernels in interpret mode, the whole dispatched inverse
against ``repro``'s ``backend="ref"`` over the conditioning grid of
``tests/test_inverse_numerics.py``, and the tiled path's trip loop
(``kernels/newton_schulz.py``) against the one-launch plain version with
the kernels replaced by their plain versions. Tolerances, each with its
reason, stand beside the assertions. The CUDA kernels run only on the card
(``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kfac as jkfac
from repro.kernels import dispatch as jdispatch
from repro.kernels import newton_schulz as jns
from repro_torch.core import kfac
from repro_torch.kernels import dispatch, ref
from repro_torch.kernels import newton_schulz as ns
from test_inverse_numerics import (FALLBACK_EXPECTED, SPECTRA,
                                   _gram_from_spectrum, _logspec,
                                   _spd_from_spectrum, _seed)

# the whole inverse: the JAX package's own ref-vs-Pallas Newton-Schulz
# tolerance (tests/test_inverse_numerics.py:199), relative to max |X|; two
# f32 iterations in another summation order agree to the residual's order
NS_REL_TOL = 2e-3
# any route against the eigh oracle (tests/test_inverse_numerics.py:141)
EIGH_REL_TOL = 5e-3
# one product (R = I - M X, X + X R): f32 sums in another order, relative
# to the largest entry, as for the factor and preconditioning kernels
PRODUCT_REL_TOL = 1e-4
# the residuals ||I - M X||_F / sqrt(b): once converged they are f32
# rounding of I - M X, which two summation orders give differently (up to
# ~10 % at 1e-5); held to a tenth of the tolerance 1e-4 there, and to 1 %
# of themselves while still large
RES_TOL = dict(rtol=1e-2, atol=1e-5)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _damped_blocks(cond, g, b, damping, seed):
    """Damped symmetric blocks M = F + damping I, F SPD with condition
    number ``cond`` (the iteration's own input)."""
    f = np.array(_spd_from_spectrum(_logspec(cond), nb=g, b=b, seed=seed))
    m = 0.5 * (f + np.swapaxes(f, -1, -2)) + damping * np.eye(b)
    return m.astype(np.float32)


def test_ns_inverse_blocks_ref_matches_the_resident_tpu_kernel():
    """b = 128 (no padding on either side): three blocks that contract and
    one (condition 1e8, damping 1e-9) that hits the 40-trip cap."""
    m = np.concatenate([_damped_blocks(1e2, 2, 128, 1e-3, 1),
                        _damped_blocks(1e4, 1, 128, 1e-3, 2),
                        _damped_blocks(1e8, 1, 128, 1e-9, 3)])
    x, res, _ = ref.ns_inverse_blocks_ref(torch.from_numpy(m), 40, 1e-4)
    jx, jres = jns.ns_inverse_blocks(jnp.asarray(m), iters=40, tol=1e-4,
                                     interpret=True)
    jres = np.asarray(jres)[:, 0]
    assert x.shape == m.shape and res.shape == (4,)
    np.testing.assert_array_equal(res.numpy() <= 1e-4, jres <= 1e-4)
    assert list(res.numpy() <= 1e-4) == [True, True, True, False]
    np.testing.assert_allclose(res.numpy(), jres, **RES_TOL)
    for k in range(3):
        assert _rel(x[k], np.asarray(jx)[k]) <= NS_REL_TOL, k


def test_ns_tiled_refs_match_the_tiled_tpu_kernels():
    """(2, 256, 256) with the TPU's 128 tiles: one residual and one update
    on the same inputs."""
    rng = np.random.default_rng(0)
    m = _damped_blocks(1e2, 2, 256, 1e-3, 4)
    x = (m / np.abs(m).sum(-1).max() ** 2
         + 1e-3 * rng.standard_normal(m.shape)).astype(np.float32)
    r, ss = ref.ns_tiled_residual_ref(torch.from_numpy(m),
                                      torch.from_numpy(x))
    jr, jss = jns.ns_tiled_residual(jnp.asarray(m), jnp.asarray(x), bt=128,
                                    interpret=True)
    assert _rel(r, jr) <= PRODUCT_REL_TOL
    np.testing.assert_allclose(ss.numpy(), np.asarray(jss)[:, 0, 0],
                               rtol=PRODUCT_REL_TOL)
    xn = ref.ns_tiled_update_ref(torch.from_numpy(x), r)
    jxn = jns.ns_tiled_update(jnp.asarray(x), jnp.asarray(r.numpy()), bt=128,
                              interpret=True)
    assert _rel(xn, jxn) <= PRODUCT_REL_TOL


@pytest.mark.parametrize("damping", [1e-8, 1e-3, 1e-1])
@pytest.mark.parametrize("spectrum", sorted(SPECTRA))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conditioning_grid_matches_jax(spectrum, damping, dtype):
    """The port's dispatched inverse against repro's backend="ref" on the
    grid's factors: the same blocks converge (and the same ones fall back),
    every route within EIGH_REL_TOL of eigh, and the fallback blocks are the
    port's own eigh bit for bit."""
    seed = _seed(spectrum, damping)
    if dtype == "bfloat16":
        f = np.array(_gram_from_spectrum(SPECTRA[spectrum], seed=seed))
    else:
        f = np.array(_spd_from_spectrum(SPECTRA[spectrum], seed=seed))
    tf = torch.from_numpy(f)
    x, info = dispatch.damped_inverse(tf, damping, method="newton_schulz",
                                      return_info=True)
    _, jinfo = jdispatch.damped_inverse(
        jnp.asarray(f), jnp.asarray(damping, jnp.float32),
        method="newton_schulz", backend="ref", return_info=True)
    eigh = dispatch.damped_inverse(tf, damping, method="eigh")
    conv = info["ns_converged"].numpy()
    np.testing.assert_array_equal(conv, np.asarray(jinfo["ns_converged"]))
    assert torch.isfinite(x).all() and x.dtype == torch.float32
    scale = eigh.abs().amax((-1, -2))
    assert ((x - eigh).abs().amax((-1, -2)) <= EIGH_REL_TOL * scale).all()
    if (spectrum, damping) in FALLBACK_EXPECTED[dtype]:
        assert not conv.any()
    else:
        assert conv.all()
    bad = torch.from_numpy(~conv)
    assert torch.equal(x[bad], eigh[bad])


def test_indefinite_block_takes_the_clamped_eigh_inverse():
    """Small eigenvalues pushed negative: the iteration would converge to
    the indefinite inverse, so the SPD guard (min diag(X) <= 0) sets
    res = +inf and the block ships eigh's clamped result, as in repro."""
    rng = np.random.RandomState(4)
    q = np.linalg.qr(rng.randn(16, 16))[0]
    lam = np.r_[np.logspace(0, -2, 14), [-4e-3, -1e-2]]
    f = (q @ np.diag(lam) @ q.T).astype(np.float32)[None]
    x, info = dispatch.damped_inverse(torch.from_numpy(f), 1e-3,
                                      method="newton_schulz",
                                      return_info=True)
    _, jinfo = jdispatch.damped_inverse(jnp.asarray(f), jnp.asarray(1e-3),
                                        method="newton_schulz", backend="ref",
                                        return_info=True)
    assert torch.isposinf(info["ns_res"]).all()
    assert np.isposinf(np.asarray(jinfo["ns_res"])).all()
    assert not info["ns_converged"].any()
    assert torch.equal(x, kfac.damped_inverse(torch.from_numpy(f), 1e-3))


@pytest.mark.parametrize("lead", [(), (3,), (2, 2)])
def test_newton_schulz_inverse_matches_jax_over_leading_axes(lead):
    """The plain whole method (kfac.newton_schulz_inverse) with a per-layer
    damping broadcast against the block axis, as the optimizer calls it."""
    f = np.array(_spd_from_spectrum(_logspec(1e3), seed=len(lead),
                                    lead=lead))
    damp = (1e-3 * (1.0 + np.arange(int(np.prod(lead, dtype=int))))
            ).reshape(lead + (1,)).astype(np.float32)
    x, res = kfac.newton_schulz_inverse(torch.from_numpy(f),
                                        torch.from_numpy(damp))
    jx, jres = jkfac.newton_schulz_inverse(jnp.asarray(f), jnp.asarray(damp))
    assert x.shape == f.shape and res.shape == f.shape[:-2]
    assert (res.numpy() <= kfac.NS_TOL).all()
    assert _rel(x, jx) <= NS_REL_TOL
    np.testing.assert_allclose(res.numpy(), np.asarray(jres), **RES_TOL)


def test_ns_defaults_and_direct_methods_match_jax():
    assert (kfac.NS_ITERS, kfac.NS_TOL) == (jkfac.NS_ITERS, jkfac.NS_TOL)
    f = torch.eye(4)[None]
    for method in ("eigh", "cholesky"):
        _, info = dispatch.damped_inverse(f, 1e-3, method=method,
                                          return_info=True)
        assert torch.equal(info["ns_res"], torch.zeros(1))
        assert info["ns_converged"].all()
    with pytest.raises(ValueError, match="unknown inverse method"):
        dispatch.damped_inverse(f, 1e-3, method="lu")


@pytest.mark.parametrize("b,kernel", [(16, "resident"), (512, "resident"),
                                      (1024, "resident"), (1025, "tiled"),
                                      (1100, "tiled"), (2048, "tiled")])
def test_block_size_routes_like_the_jax_package(monkeypatch, b, kernel):
    """b <= 1024 (the JAX package's NS_KERNEL_MAX_DIM) takes the resident
    kernel, larger blocks the tiled pair: the route and a spy on the two
    wrappers."""
    from repro.kernels import ops as jops
    assert ns.NS_RESIDENT_MAX_DIM == jops.NS_KERNEL_MAX_DIM
    assert ns.route(b) == kernel
    seen = []
    for name in ("ns_inverse_blocks", "ns_inverse_tiled"):
        monkeypatch.setattr(ns, name, lambda m, iters, tol, name=name:
                            seen.append(name))
    ns.ns_inverse(torch.zeros(2, b, b), 40, 1e-4)
    assert seen == ["ns_inverse_blocks" if kernel == "resident"
                    else "ns_inverse_tiled"]


def _plain_tiled_kernels(monkeypatch):
    """The tiled wrappers replaced by their plain versions with the kernels'
    frozen-block semantics (residual: r unwritten, ss 0; update: x as it
    is), counting launches as the wrappers do."""
    counts = {"ns_tiled_residual": 0, "ns_tiled_update": 0}

    def residual(m, x, active=None):
        counts["ns_tiled_residual"] += 1
        r, ss = ref.ns_tiled_residual_ref(m, x)
        if active is not None:
            live = active.bool()
            r = torch.where(live[:, None, None], r, torch.nan)
            ss = torch.where(live, ss, 0.0)
        return r, ss

    def update(x, r, active=None):
        counts["ns_tiled_update"] += 1
        live = torch.ones(len(x), dtype=torch.bool) if active is None \
            else active.bool()
        return torch.where(live[:, None, None],
                           ref.ns_tiled_update_ref(x, r), x)

    monkeypatch.setattr(ns, "ns_tiled_residual", residual)
    monkeypatch.setattr(ns, "ns_tiled_update", update)
    monkeypatch.setattr(ns, "_blocks", lambda name, *ts: None)
    return counts


@pytest.mark.parametrize("iters", [40, 6])
def test_tiled_trip_loop_equals_the_one_launch_method(monkeypatch, iters):
    """ns_inverse_tiled's freeze and early stop, run on the plain products:
    the same x and res as ns_inverse_blocks_ref, one residual launch more
    than updates, as many updates as the most trips, and each block's trip
    count that of the plain iteration. Blocks converging at different trips
    (conditions 10 to 1e4) and a ragged b; iters 6 stops at the cap with
    blocks still active."""
    m = np.concatenate([_damped_blocks(c, 1, 40, 1e-3, i)
                        for i, c in enumerate((10.0, 1e2, 1e4))])
    tm = torch.from_numpy(m)
    counts = _plain_tiled_kernels(monkeypatch)
    x, res, trips = ns.ns_inverse_tiled(tm, iters, 1e-4)
    want_x, want_res, want_trips = ref.ns_inverse_blocks_ref(tm, iters, 1e-4)
    torch.testing.assert_close(x, want_x, rtol=0, atol=0)
    torch.testing.assert_close(res, want_res, rtol=0, atol=0)
    assert torch.equal(trips, want_trips)
    n = int(trips.max())
    assert counts == {"ns_tiled_residual": n + 1, "ns_tiled_update": n}
    assert (trips <= iters).all() and (trips > 0).all()
    if iters == 40:
        assert len(set(trips.tolist())) == 3 and (res <= 1e-4).all()
    else:
        assert (trips == 6).all() and (res > 1e-4).any()


def test_ns_wrappers_refuse_cpu_tensors():
    before = dict(ns.LAUNCHES)
    m = torch.eye(8)[None]
    for call in (lambda: ns.ns_inverse_blocks(m, 4, 1e-4),
                 lambda: ns.ns_tiled_residual(m, m),
                 lambda: ns.ns_tiled_update(m, m),
                 lambda: ns.ns_inverse(m, 4, 1e-4)):
        with pytest.raises(ValueError, match="CUDA tensors only"):
            call()
    assert ns.LAUNCHES == before
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        dispatch.lookup("damped_inverse", "cuda")(m, 1e-3, "newton_schulz")
