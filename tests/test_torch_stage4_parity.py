"""repro_torch.comm.Stage4Inverter (sharded Stage 4 over torch.distributed)
against repro.comm.Stage4Inverter, on gloo ranks on the CPU; and the
optimizer's Stage-3/4 byte ledger against repro's.

* On 8 gloo ranks (a (4, 2) mesh, ``tests/torch_dist_ranks.py``) with
  ``tests/test_stage4_sharding.py``'s SPD blocks: ``owners``, the gathered
  ``owner`` vector (repro's too), which leading rows each rank's
  ``damped_inverse`` was given (its own contiguous chunk, once), and the
  gathered inverse against the replicated one and repro's at repro's
  2e-4 / 1e-5; eigh under "all" and "auto", Newton-Schulz under "all"
  (its gathered residuals against the replicated ones at the same
  tolerance, the converged flags equal).
* The indivisible fallback: owner -1 everywhere, the whole statistic
  inverted on every rank, the inverse the replicated one bit for bit.
* ``SPNGD.wire_bytes`` / ``gather_bytes`` / ``wire_level_bytes`` equal to
  repro's on the reduced llama3_2_1b template (dense and fused capture),
  and ``launch.train.run`` filling the controller's wire and gather
  columns with them.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import comm as jcomm
from repro.launch import compat
from repro_torch import comm as tcomm
from repro_torch.configs import get_config
from repro_torch.launch import train
from test_torch_train_parity import _setup
from torch_dist_ranks import RankPool

MESH = (4, 2)
# the gathered inverse against the replicated one (repro's own tolerance,
# tests/test_stage4_sharding.py)
INV_TOL = dict(rtol=2e-4, atol=1e-5)
LLAMA = dict(head_dim=32, d_ff=128, vocab=256, kfac_max_dim=64)

needs_devices = pytest.mark.skipif(len(jax.devices()) < 8,
                                   reason="needs 8 virtual devices")


@pytest.fixture(scope="module")
def pool():
    ranks = RankPool(MESH[0] * MESH[1])
    yield ranks
    ranks.close()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spd_blocks(lead, nb, b, seed=0):
    """tests/test_stage4_sharding.py's SPD blocks."""
    rng = np.random.RandomState(seed)
    m = rng.randn(lead, nb, b, 3 * b).astype(np.float32)
    return np.einsum("lnbk,lnck->lnbc", m, m) / (3 * b)


def _repro_invert(manual_axes, f, damp, method):
    mesh = compat.make_mesh(MESH, ("data", "model"))
    red = jcomm.FactorReducer(
        mesh, manual_axes=manual_axes,
        template={"fam": {"a": jax.ShapeDtypeStruct(f.shape, jnp.float32)}},
        sym_fn=lambda fam, key: True)
    inv4 = jcomm.Stage4Inverter(red, method=method, backend="ref")
    with compat.set_mesh(mesh):
        inv, info = jax.jit(lambda f, d: inv4.invert(
            f, d, fam="fam", key="a", return_info=True))(
                jnp.asarray(f), jnp.asarray(damp))
    return inv4, np.asarray(inv), jax.tree.map(np.asarray, info)


@needs_devices
@pytest.mark.parametrize("manual_axes,method", [
    ("all", "eigh"), ("auto", "eigh"), ("all", "newton_schulz")])
def test_each_rank_inverts_only_its_chunk(pool, manual_axes, method):
    lead, nb, b = 16, 2, 8
    f = _spd_blocks(lead, nb, b)
    damp = np.linspace(0.05, 0.2, lead).astype(np.float32)
    jinv4, jinv, jinfo = _repro_invert(manual_axes, f, damp, method)
    p = 8 if manual_axes == "all" else 4
    owners = np.repeat(np.arange(p, dtype=np.int32), lead // p)
    np.testing.assert_array_equal(jinv4.owners(lead), owners)
    np.testing.assert_array_equal(jinfo["owner"], owners)
    results = pool.run("stage4_invert", MESH, manual_axes, f, damp, method)
    assert sorted(r["index"] for r in results) == sorted(
        np.repeat(np.arange(p), 8 // p).tolist())
    for r in results:
        i, c = r["index"], lead // p
        np.testing.assert_array_equal(r["owners"], owners)
        np.testing.assert_array_equal(r["info"]["owner"], owners)
        # one inversion call, on this rank's contiguous chunk only
        assert r["inverted"] == [list(range(i * c, (i + 1) * c))]
        np.testing.assert_allclose(r["inv"], r["replicated"], **INV_TOL)
        np.testing.assert_allclose(r["inv"], jinv, **INV_TOL)
        np.testing.assert_array_equal(r["info"]["ns_converged"],
                                      r["replicated_info"]["ns_converged"])
        np.testing.assert_array_equal(r["info"]["ns_converged"],
                                      jinfo["ns_converged"])
        np.testing.assert_allclose(r["info"]["ns_res"],
                                   r["replicated_info"]["ns_res"], **INV_TOL)
        assert r["info"]["ns_converged"].all()


@needs_devices
def test_indivisible_leading_dim_falls_back_to_replicated(pool):
    lead, nb, b = 6, 1, 8                    # 6 % 4 != 0: cannot scatter
    f = _spd_blocks(lead, nb, b, seed=3)
    damp = np.full((lead,), 0.1, np.float32)
    jinv4, jinv, jinfo = _repro_invert("auto", f, damp, "eigh")
    np.testing.assert_array_equal(jinfo["owner"], np.full(lead, -1))
    for r in pool.run("stage4_invert", MESH, "auto", f, damp, "eigh"):
        assert r["index"] == -1
        np.testing.assert_array_equal(r["owners"], np.full(lead, -1))
        np.testing.assert_array_equal(r["info"]["owner"], np.full(lead, -1))
        assert r["inverted"] == [list(range(lead))]
        np.testing.assert_array_equal(r["inv"], r["replicated"])
        np.testing.assert_allclose(r["inv"], jinv, **INV_TOL)


# ---------------------------------------------------------------------------
# the optimizer's byte ledger
# ---------------------------------------------------------------------------

def _opts(**cfg_kw):
    (_, jopt, *_), (_, topt, *_) = _setup(dict(LLAMA), **cfg_kw)
    return jopt, topt


@pytest.fixture(scope="module")
def opts():
    return _opts(), _opts(factor_wire="e4m3")


@pytest.mark.parametrize("strategy", tcomm.STRATEGIES)
def test_spngd_ledger_equals_repro(opts, strategy):
    for jopt, topt in opts:
        assert topt.gather_bytes() == jopt.gather_bytes()
        assert topt.wire_bytes() == jopt.wire_bytes()
        for dph, gs in ((2, 4), (4, 8), (1, 2)):
            t = tcomm.make_comm_config(strategy, devices_per_host=dph)
            j = jcomm.make_comm_config(strategy, devices_per_host=dph)
            assert topt.wire_bytes(t, gs) == jopt.wire_bytes(j, gs)
            assert topt.wire_level_bytes(t, gs) == \
                jopt.wire_level_bytes(j, gs)
    # wire-format capture prices the decoded dense shape: the same ledger
    (jd, td), (jw, tw) = opts
    assert tw.wire_bytes() == td.wire_bytes()


def test_run_fills_the_comm_ledger():
    """One capture step of run() with every statistic refreshed: the wire
    column is the sum of SPNGD.wire_bytes, the gather column that of
    gather_bytes (inverse_sharding)."""
    cfg = get_config("llama3_2_1b").reduced(**LLAMA)
    model, opt, params, state = train.build(cfg=cfg, device="cpu",
                                            damping=1e-3,
                                            inverse_sharding=True)
    assert opt.cfg.double_buffer and opt.cfg.inverse_sharding
    comm = tcomm.make_comm_config("ring_fp8")
    lines = []
    train.run(model, opt, params, state, steps=1, batch=2, seq=16,
              log=lines.append, comm=comm)
    wire = int(re.search(r"modelled wire \[ring_fp8/fp8_e4m3\]: (\d+) B",
                         lines[-2]).group(1))
    gather = int(re.search(r"Stage-4 gather .*: (\d+) B",
                           lines[-1]).group(1))
    assert wire == sum(opt.wire_bytes(comm).values()) > 0
    assert gather == sum(opt.gather_bytes().values()) > 0
