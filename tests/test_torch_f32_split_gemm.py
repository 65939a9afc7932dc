"""The f32-accurate tensor-core products of repro_torch
(``csrc/f32_split_gemm.cuh``: ``block_precond`` and the resident
``ns_inverse_blocks``) on the CPU.

The kernels run only on the card (``chip_smoke.py``). Here their geometry
and their arithmetic are checked through two mirrors:

* the geometry, as the wrappers give it to the launches: block_precond's
  work items (``kernels/kfac.py`` ``precond_geometry``, ``precond_item``,
  ``precond_block_items``) cover every output element of every block
  exactly once, and the persistent blocks of threads take every item
  once; the resident Newton-Schulz kernel's output tiles
  (``kernels/newton_schulz.py`` ``resident_tiles``) cover each b x b
  product exactly once for every cluster size the kernel can pick;
* the arithmetic: a plain-torch emulation of the kernels' split at their
  stage depth (each f32 operand x as hi = TF32(x), rounded to nearest as
  ``cvt.rna`` does, plus lo = TF32(x - hi); per 8-deep step the products
  lo_P hi_Q, hi_P lo_Q and hi_P hi_Q summed in f32; a stage's 32 terms
  into a fresh partial that an f32 add folds into the accumulator). The
  8-term sums are f32 matrix products here, not the tensor core's own
  internal order. It is held against ``repro``'s kernels in interpret mode:
  block preconditioning left and right at ``chip_smoke.py``'s
  ``KFAC_REL_TOL``, the Newton-Schulz inverse over the conditioning grid of
  ``tests/test_torch_newton_schulz_parity.py`` by ``NS_REL_TOL``,
  ``NS_FLAG_BAND`` and the trip counts of the port's plain f32 iteration
  (see ``test_split_ns_matches_repro_on_the_conditioning_grid`` for the
  cells where f32 rounding itself decides at that level). One TF32 product
  (hi hi alone) leaves those bounds, which is why the kernels pay for the
  other two.
"""

import importlib.util
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dispatch as jdispatch
from repro.kernels import newton_schulz as jns
from repro_torch.core import kfac
from repro_torch.kernels import kfac as kern
from repro_torch.kernels import newton_schulz as ns
from repro_torch.kernels import ref
from test_inverse_numerics import (SPECTRA, _gram_from_spectrum,
                                   _spd_from_spectrum, _seed)

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

# the bounds the card holds the kernels to (chip_smoke.py)
KFAC_REL_TOL = chip_smoke.KFAC_REL_TOL
NS_REL_TOL = chip_smoke.NS_REL_TOL
NS_FLAG_BAND = chip_smoke.NS_FLAG_BAND
NS_ITERS, NS_TOL = kfac.NS_ITERS, kfac.NS_TOL
STAGE = 32        # csrc/f32_split_gemm.cuh BK: K per stage
STEP = 8          # one wgmma k8 step
# 3xTF32 keeps about 22 bits of each operand where f32 keeps 24: on cells
# where two f32 iterations already disagree beyond NS_REL_TOL, the split is
# held to 2^2 times that disagreement
SPLIT_BITS_FACTOR = 4.0
SMS = 132         # an H100 SXM's SMs


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nb,b,dim,other", [
    (1, 2048, 2048, 8192),        # the kernel table's shape
    (4, 2048, 8192, 2048),        # nb 4 (the mlp down A side)
    (63, 2048, 128256, 512),      # nb 63, ragged: the embedding's blocks
    (3, 684, 2050, 300),          # ragged dim 2050 in blocks of 684
    (3, 97, 290, 70),             # rows off 16-byte alignment
    (1, 16, 16, 5),               # one partial tile
])
@pytest.mark.parametrize("right", [False, True])
def test_precond_items_cover_every_output_once(nb, b, dim, other, right):
    tiles_r, tiles_c, items, blocks = kern.precond_geometry(
        nb, b, dim, other, right, SMS)
    assert blocks == min(items, SMS) and items == nb * tiles_r * tiles_c
    taken = sorted(i for w in range(blocks)
                   for i in kern.precond_block_items(w, blocks, items))
    assert taken == list(range(items))
    # every (block, tile) at most once, every tile inside its block's
    # output, and the tiles' clipped areas add up to the whole output
    seen, area, tiles = set(), 0, []
    for i in range(items):
        it = kern.precond_item(i, nb, b, dim, other, right)
        if it is None:
            continue
        k, r0, c0, valid = it
        assert valid == min(b, dim - k * b) > 0
        rows, cols = (other, valid) if right else (valid, other)
        assert 0 <= r0 < rows and 0 <= c0 < cols
        assert (k, r0, c0) not in seen
        seen.add((k, r0, c0))
        tiles.append((k, r0, c0, valid))
        area += (min(r0 + kern.PRECOND_TILE, rows) - r0) * \
            (min(c0 + kern.PRECOND_TILE, cols) - c0)
    assert area == dim * other
    if dim * other <= 2 ** 22:       # element by element where it is cheap
        cover = np.zeros((other, dim) if right else (dim, other), np.int32)
        for k, r0, c0, valid in tiles:
            t = kern.PRECOND_TILE
            if right:
                cover[r0:r0 + t, k * b + c0:k * b + min(c0 + t, valid)] += 1
            else:
                cover[k * b + r0:k * b + min(r0 + t, valid), c0:c0 + t] += 1
        assert (cover == 1).all()


@pytest.mark.parametrize("b", [16, 97, 512, 1024])
def test_resident_tiles_cover_each_product_once(b):
    for csize in range(1, ns.MAX_CLUSTER + 1):
        cover = np.zeros((b, b), np.int32)
        tn, tm = ns.RESIDENT_TILE
        for rank in range(csize):
            for r0, c0 in ns.resident_tiles(b, csize, rank):
                assert r0 < b and c0 < b
                cover[r0:r0 + tn, c0:c0 + tm] += 1
        assert (cover == 1).all(), (b, csize)


# ---------------------------------------------------------------------------
# arithmetic
# ---------------------------------------------------------------------------

def _tf32(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32: to the nearest TF32 (10 stored mantissa bits),
    ties away from zero; the low 13 bits zero."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _split(x: np.ndarray):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _product(q, p, products: int = 3) -> torch.Tensor:
    """C = Q P (f32, (..., n, K) x (..., K, m)) as the kernels sum it:
    split operands, per 8-deep step lo_P hi_Q, hi_P lo_Q, hi_P hi_Q (or
    with ``products=1`` the hi hi product alone: one TF32 product), each
    32-deep stage into a fresh partial added to the accumulator."""
    q = np.asarray(q, np.float32)
    p = np.asarray(p, np.float32)
    (qh, ql), (ph, pl) = _split(q), _split(p)
    qh, ql, ph, pl = (torch.from_numpy(a) for a in (qh, ql, ph, pl))
    k = q.shape[-1]
    acc = torch.zeros(q.shape[:-1] + p.shape[-1:], dtype=torch.float32)
    for s0 in range(0, k, STAGE):
        part = torch.zeros_like(acc)
        for k0 in range(s0, min(s0 + STAGE, k), STEP):
            sl = slice(k0, k0 + STEP)
            if products == 3:
                part = part + qh[..., sl] @ pl[..., sl, :]
                part = part + ql[..., sl] @ ph[..., sl, :]
            part = part + qh[..., sl] @ ph[..., sl, :]
        acc = acc + part
    return acc


def _precond(binv, w, right: bool, products: int = 3) -> np.ndarray:
    """block_precond through the emulated product, block by block, in the
    kernel's operand roles (left: Q = binv[k], P = w's rows; right: Q = w's
    columns, P = binv[k])."""
    nb, b, _ = binv.shape
    dim = w.shape[1] if right else w.shape[0]
    out = np.zeros(w.shape, np.float32)
    for k in range(nb):
        lo, hi = k * b, min(dim, (k + 1) * b)
        v = hi - lo
        if right:
            out[:, lo:hi] = _product(w[:, lo:hi], binv[k, :v, :v],
                                     products).numpy()
        else:
            out[lo:hi] = _product(binv[k, :v, :v], w[lo:hi], products).numpy()
    return out


def _blocked(w, nb, b, right):
    """w with its dim zero-padded to nb b, in the blocked layout of the
    dispatch ops: (nb, b, m) on the left, (m, nb, b) on the right."""
    dim = w.shape[1] if right else w.shape[0]
    if right:
        return np.pad(w, ((0, 0), (0, nb * b - dim))).reshape(-1, nb, b)
    return np.pad(w, ((0, nb * b - dim), (0, 0))).reshape(nb, b, -1)


def _unblocked(u, dim, right):
    u = np.asarray(u)
    if right:
        return u.reshape(u.shape[0], -1)[:, :dim]
    return u.reshape(-1, u.shape[-1])[:dim]


def _repro_precond(binv, w, right: bool) -> np.ndarray:
    """repro's Pallas block_precond in interpret mode through its dispatch
    op (the right mode is its transposed reuse of the left kernel), a
    ragged last block zero-padded."""
    nb, b, _ = binv.shape
    dim = w.shape[1] if right else w.shape[0]
    wb, jb = jnp.asarray(_blocked(w, nb, b, right)), jnp.asarray(binv)
    u = (jdispatch.block_precond_right(wb, jb, backend="pallas") if right
         else jdispatch.block_precond_left(jb, wb, backend="pallas"))
    return _unblocked(u, dim, right)


def _precond_inputs(nb, b, dim, other, right, seed):
    rng = np.random.default_rng(seed)
    binv = (rng.standard_normal((nb, b, b)) / math.sqrt(b)).astype(np.float32)
    w = rng.standard_normal((other, dim) if right else (dim, other)).astype(
        np.float32)
    return binv, w


@pytest.mark.parametrize("nb,b,dim,other", [(2, 256, 512, 300),
                                            (3, 100, 290, 70)])
@pytest.mark.parametrize("right", [False, True])
def test_split_precond_matches_repro(nb, b, dim, other, right):
    """binv not symmetric (the eigh inverse is not bit-symmetric, and the
    right mode reads binv as it is): the split holds KFAC_REL_TOL against
    repro's interpret-mode kernel and the port's plain version alike."""
    binv, w = _precond_inputs(nb, b, dim, other, right, nb * 10 + right)
    got = _precond(binv, w, right)
    want = _repro_precond(binv, w, right)
    wb, tb = torch.from_numpy(_blocked(w, nb, b, right)), torch.from_numpy(binv)
    p = _unblocked(ref.block_precond_right_ref(wb, tb) if right
                   else ref.block_precond_left_ref(tb, wb), dim, right)
    assert got.shape == want.shape == p.shape
    # the split sits at f32 level: far inside the bound
    assert _rel(got, want) <= KFAC_REL_TOL / 10
    assert _rel(got, p) <= KFAC_REL_TOL / 10


def _ns(m: torch.Tensor, products: int = 3):
    """ref.ns_inverse_blocks_ref with both products emulated."""
    x = ref.ns_x0(m)
    rnorm = 1.0 / math.sqrt(m.shape[-1])
    eye = torch.eye(m.shape[-1])
    trips = torch.zeros(m.shape[:-2], dtype=torch.int32)

    def residual(x):
        r = eye - _product(m.numpy(), x.numpy(), products)
        return r, torch.sqrt((r * r).sum((-1, -2))) * rnorm

    for _ in range(NS_ITERS):
        r, res = residual(x)
        live = res > NS_TOL
        if not bool(live.any()):
            break
        x = torch.where(live[..., None, None],
                        x + _product(x.numpy(), r.numpy(), products), x)
        trips += live
    return x, residual(x)[1], trips


def _grid_blocks(spectrum, damping, dtype):
    """The conditioning grid's damped blocks M (the kernel's input), as
    tests/test_torch_newton_schulz_parity.py builds its factors."""
    seed = _seed(spectrum, damping)
    if dtype == "bfloat16":
        f = np.array(_gram_from_spectrum(SPECTRA[spectrum], seed=seed))
    else:
        f = np.array(_spd_from_spectrum(SPECTRA[spectrum], seed=seed))
    return kfac.damped_sym(torch.from_numpy(f), damping)


def _repro_ns(m: torch.Tensor):
    jx, jres = jns.ns_inverse_blocks(jnp.asarray(m.numpy()), iters=NS_ITERS,
                                     tol=NS_TOL, interpret=True)
    return np.asarray(jx), np.asarray(jres)[:, 0]


@pytest.mark.parametrize("damping", [1e-8, 1e-3, 1e-1])
@pytest.mark.parametrize("spectrum", sorted(SPECTRA))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_ns_matches_repro_on_the_conditioning_grid(spectrum, damping,
                                                         dtype):
    """The emulated iteration against repro's interpret-mode resident
    kernel: the same blocks converge everywhere; trips equal to the port's
    plain f32 iteration's (repro's kernel does not report them) wherever
    its residual is not within NS_FLAG_BAND of tol; X within NS_REL_TOL of
    repro's where converged. On the cells where the plain f32 iteration is
    itself farther than NS_REL_TOL from repro's kernel (damped condition
    ~1e4 and up: f32 rounding decides the result at that level) the split
    is held to SPLIT_BITS_FACTOR times that distance and to a trip count
    within one of the plain iteration's."""
    m = _grid_blocks(spectrum, damping, dtype)
    jx, jres = _repro_ns(m)
    x, res, trips = _ns(m)
    px, pres, ptrips = ref.ns_inverse_blocks_ref(m, NS_ITERS, NS_TOL)
    jconv = jres <= NS_TOL
    np.testing.assert_array_equal(res.numpy() <= NS_TOL, jconv)
    if not jconv.any():
        return
    plain_err = _rel(px.numpy()[jconv], jx[jconv])
    err = _rel(x.numpy()[jconv], jx[jconv])
    band = np.abs(pres.numpy() - NS_TOL) <= NS_FLAG_BAND * NS_TOL
    if plain_err <= NS_REL_TOL:
        assert err <= NS_REL_TOL, (err, plain_err)
        assert ((trips == ptrips).numpy() | band).all(), (trips, ptrips)
    else:
        assert err <= SPLIT_BITS_FACTOR * plain_err, (err, plain_err)
        assert ((trips - ptrips).abs() <= 1).all(), (trips, ptrips)


def test_one_tf32_product_misses_the_bounds():
    """hi hi alone (what one TF32 wgmma gives): block preconditioning leaves
    KFAC_REL_TOL, and the Newton-Schulz residual stalls above tol on a
    well-conditioned block that repro's kernel and the split both converge
    in 18 trips."""
    binv, w = _precond_inputs(2, 256, 512, 300, False, 20)
    want = _repro_precond(binv, w, False)
    assert _rel(_precond(binv, w, False, products=1), want) > KFAC_REL_TOL
    assert _rel(_precond(binv, w, False), want) <= KFAC_REL_TOL / 10
    m = _grid_blocks("cond_1e2", 1e-3, "float32")
    _, jres = _repro_ns(m)
    _, res, trips = _ns(m)
    _, res1, trips1 = _ns(m, products=1)
    assert (jres <= NS_TOL).all() and (res <= NS_TOL).all()
    assert trips.tolist() == [18, 18]
    assert (res1 > NS_TOL).all() and (trips1 == NS_ITERS).all()
