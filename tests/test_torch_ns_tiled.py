"""The tiled Newton-Schulz pair of repro_torch (``ns_tiled_residual``,
``ns_tiled_update`` in ``csrc/newton_schulz.cu``) on the CPU.

The kernels run only on the card (``chip_smoke.py``). Here their partition
and their arithmetic are checked through two mirrors:

* the partition, as the wrappers give it to the launches
  (``kernels/newton_schulz.py`` ``tiled_geometry``, ``tiled_item``): the
  persistent blocks of threads take every (factor block, tile) item
  exactly once, the items run block-major, and the clipped 128 x 128 tiles
  cover each b x b output exactly once;
* the arithmetic: both products are the split-TF32 tile of
  ``csrc/f32_split_gemm.cuh``, emulated as in
  ``tests/test_torch_f32_split_gemm.py`` (``_product``, 32-deep stages):
  one residual and one update against ``repro``'s tiled kernels in
  interpret mode at ``chip_smoke.py``'s ``NS_PRODUCT_REL_TOL``, and the
  port's tiled trip loop on the emulated products against ``repro``'s
  tiled inverse on cells of the conditioning grid by ``NS_REL_TOL``,
  ``NS_FLAG_BAND`` and the trip counts of the port's plain iteration.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import newton_schulz as jns
from repro.kernels import ops as jops
from repro_torch.core import kfac
from repro_torch.kernels import newton_schulz as ns
from repro_torch.kernels import ref
from test_torch_f32_split_gemm import (NS_FLAG_BAND, NS_REL_TOL, SMS,
                                       _grid_blocks, _product, _rel,
                                       chip_smoke)
from test_torch_newton_schulz_parity import _damped_blocks

NS_PRODUCT_REL_TOL = chip_smoke.NS_PRODUCT_REL_TOL
NS_ITERS, NS_TOL = kfac.NS_ITERS, kfac.NS_TOL
TILE = ns.TILED_TILE


# ---------------------------------------------------------------------------
# partition
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b", [2048, 1100, 1030, 512, 97])
@pytest.mark.parametrize("g", [1, 16, 64])
def test_tiled_items_cover_every_output_once(g, b):
    nc, tiles, items, blocks = ns.tiled_geometry(g, b, SMS)
    assert nc == -(-b // TILE) and tiles == nc * nc and items == g * tiles
    assert blocks == min(items, SMS)
    # the persistent blocks take every item once (block w: w, w + B, ...)
    taken = sorted(i for w in range(blocks)
                   for i in range(w, items, blocks))
    assert taken == list(range(items))
    # block-major: item i belongs to factor block i // tiles, and every
    # factor block has the same tiles, in the same (row-major) order
    per_block = [[] for _ in range(g)]
    for i in range(items):
        gi, r0, c0 = ns.tiled_item(i, g, b)
        assert gi == i // tiles
        per_block[gi].append((r0, c0))
    assert all(p == per_block[0] for p in per_block)
    assert per_block[0] == sorted(per_block[0])
    # the items in flight at once (one per block of threads) span at most
    # the factor blocks that `blocks` consecutive items can touch
    for start in range(0, items, blocks):
        touched = {ns.tiled_item(i, g, b)[0]
                   for i in range(start, min(start + blocks, items))}
        assert len(touched) <= -(-blocks // tiles) + 1
    # the clipped tiles cover one b x b output exactly once
    cover = np.zeros((b, b), np.int32)
    for r0, c0 in per_block[0]:
        assert 0 <= r0 < b and 0 <= c0 < b
        cover[r0:r0 + TILE, c0:c0 + TILE] += 1
    assert (cover == 1).all()


# ---------------------------------------------------------------------------
# arithmetic
# ---------------------------------------------------------------------------

def _residual(m: torch.Tensor, x: torch.Tensor):
    """The kernel's residual, emulated: R = I - M X on the split product
    (Q = M, P = X) and ss per block as the kernel sums it, each 128 x 128
    tile's sum of r^2 first, then the tiles' partials."""
    b = m.shape[-1]
    r = torch.eye(b) - _product(m.numpy(), x.numpy())
    sq = r * r
    parts = [sq[:, i:i + TILE, j:j + TILE].sum((-1, -2))
             for i in range(0, b, TILE) for j in range(0, b, TILE)]
    ss = torch.zeros(m.shape[0])
    for p in parts:
        ss = ss + p
    return r, ss


def _update(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """The kernel's update, emulated: X + X R on the split product (Q = X,
    P = R), X added to the product in f32."""
    return _product(x.numpy(), r.numpy()) + x


def _iterate(m: np.ndarray, seed: int) -> np.ndarray:
    """An iterate near the start of the iteration: X0 plus noise."""
    rng = np.random.default_rng(seed)
    x0 = ref.ns_x0(torch.from_numpy(m)).numpy()
    return (x0 + 1e-3 * np.abs(x0).max()
            * rng.standard_normal(m.shape)).astype(np.float32)


@pytest.mark.parametrize("b", [256, 384])
def test_split_tiled_products_match_repro(b):
    """One residual and one update on the emulated split products against
    repro's tiled kernels in interpret mode (bt 128), within
    NS_PRODUCT_REL_TOL of the largest entry; ss within it too."""
    m = _damped_blocks(1e2, 2, b, 1e-3, b)
    x = _iterate(m, b + 1)
    r, ss = _residual(torch.from_numpy(m), torch.from_numpy(x))
    jr, jss = jns.ns_tiled_residual(jnp.asarray(m), jnp.asarray(x), bt=128,
                                    interpret=True)
    assert _rel(r, jr) <= NS_PRODUCT_REL_TOL
    np.testing.assert_allclose(ss.numpy(), np.asarray(jss)[:, 0, 0],
                               rtol=NS_PRODUCT_REL_TOL)
    xn = _update(torch.from_numpy(x), r)
    jxn = jns.ns_tiled_update(jnp.asarray(x), jnp.asarray(r.numpy()),
                              bt=128, interpret=True)
    assert _rel(xn, jxn) <= NS_PRODUCT_REL_TOL
    # the port's plain versions agree as closely
    pr, pss = ref.ns_tiled_residual_ref(torch.from_numpy(m),
                                        torch.from_numpy(x))
    assert _rel(r, pr) <= NS_PRODUCT_REL_TOL
    assert _rel(xn, ref.ns_tiled_update_ref(torch.from_numpy(x), r)) \
        <= NS_PRODUCT_REL_TOL
    np.testing.assert_allclose(ss.numpy(), pss.numpy(),
                               rtol=NS_PRODUCT_REL_TOL)


def _split_tiled_kernels(monkeypatch):
    """The tiled wrappers replaced by the emulated kernels with their
    frozen-block semantics (residual: r unwritten, ss 0; update: x as it
    is)."""
    def residual(m, x, active=None):
        r, ss = _residual(m, x)
        live = active.bool()
        return (torch.where(live[:, None, None], r, torch.nan),
                torch.where(live, ss, 0.0))

    def update(x, r, active=None):
        return torch.where(active.bool()[:, None, None], _update(x, r), x)

    monkeypatch.setattr(ns, "ns_tiled_residual", residual)
    monkeypatch.setattr(ns, "ns_tiled_update", update)
    monkeypatch.setattr(ns, "_blocks", lambda name, *ts: None)


@pytest.mark.parametrize("spectrum,damping,dtype", [
    ("cond_1e2", 1e-3, "float32"),
    ("near_rank_def", 1e-1, "bfloat16"),
])
def test_split_tiled_inverse_matches_repro(monkeypatch, spectrum, damping,
                                           dtype):
    """The port's tiled trip loop on the emulated split products against
    repro's tiled inverse in interpret mode on two cells of the
    conditioning grid: the same blocks converge, X within NS_REL_TOL of
    repro's, and the trips those of the port's plain iteration, wherever
    the plain residual is not within NS_FLAG_BAND of tol."""
    m = _grid_blocks(spectrum, damping, dtype)
    _split_tiled_kernels(monkeypatch)
    x, res, trips = ns.ns_inverse_tiled(m, NS_ITERS, NS_TOL)
    jx, jres = jops.ns_inverse_tiled(jnp.asarray(m.numpy()), iters=NS_ITERS,
                                     tol=NS_TOL, interpret=True)
    jx, jres = np.asarray(jx), np.asarray(jres)
    _, pres, ptrips = ref.ns_inverse_blocks_ref(m, NS_ITERS, NS_TOL)
    band = (np.abs(pres.numpy() - NS_TOL) <= NS_FLAG_BAND * NS_TOL)
    conv, jconv = res.numpy() <= NS_TOL, jres <= NS_TOL
    assert (conv == jconv)[~band].all()
    assert jconv.all(), jres
    assert _rel(x.numpy(), jx) <= NS_REL_TOL
    assert ((trips == ptrips).numpy() | band).all(), (trips, ptrips)
    assert math.isfinite(float(res.max())) and (trips > 0).all()
