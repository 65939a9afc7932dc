"""repro_torch's dist step builders (``launch.train.make_dist_train_step``
/ ``make_dist_fast_step``) on gloo ranks on the CPU.

* World size 1: for every Stage-3 strategy, captures and fast steps of the
  dist steps equal the single-device steps bit for bit (params, state and
  losses) on ``tests/test_torch_train_parity.py``'s fixture (reduced
  llama3_2_1b, head_dim 16, d_ff 64, vocab 128, f32, batch (4, 16));
  ``fused`` with fused e4m3 capture, and ``inverse_sharding`` (a group of
  one inverts the whole statistic) against the double buffer, inline and
  with the refresh pipeline (K 2); and ``launch.train.run(mesh=...)``
  against ``run()``: the same losses, step kinds and printed ledger.
* Two data ranks against ``repro``'s ``make_shardmap_{train,fast}_step``
  on conftest's 8 host devices, mesh (2, 4) ``auto``
  (``tests/test_stage4_sharding.py``'s ``_losses_shardmap``: reduced
  llama3_2_1b, head_dim 32, d_ff 128, vocab 256, kfac_max_dim 64, batch
  (8, 16), damping 1e-3, every flag set), from ``repro``'s params: ``dense``
  and ``ring_fp8`` capturing every step (ring_fp8 held to ``repro``'s own
  ring_fp8 curve, not to dense), and sharded Stage 4 with the refresh
  pipeline (K 2, a capture every 3 steps). The first 8 of 20 losses within
  rtol = atol = 1e-3, the port's rule for this chaotic fixture
  (``tests/test_torch_train_parity.py``); both ranks report the same
  losses.
"""

import jax
import numpy as np
import pytest

from repro_torch.comm import STRATEGIES
from test_stage4_sharding import _llama_setup, _losses_shardmap
from test_torch_train_parity import TINY
from torch_dist_ranks import RankPool

LLAMA = dict(head_dim=32, d_ff=128, vocab=256, kfac_max_dim=64)
PLAN = ("capture", "fast", "capture", "fast")
PIPE_PLAN = ("capture", "fast", "fast", "fast", "capture", "fast")

needs_devices = pytest.mark.skipif(len(jax.devices()) < 8,
                                   reason="needs 8 virtual devices")


@pytest.fixture(scope="module")
def pool1():
    ranks = RankPool(1)
    yield ranks
    ranks.close()


@pytest.fixture(scope="module")
def pool2():
    ranks = RankPool(2)
    yield ranks
    ranks.close()


def _batch(vocab: int, shape) -> dict:
    rng = np.random.RandomState(0)
    return {"tokens": rng.randint(0, vocab, shape).astype(np.int32),
            "labels": rng.randint(0, vocab, shape).astype(np.int32)}


def _world_one(pool1, strategy, ngd_kw, plan, **cfg_kw):
    r, = pool1.run("dist_equals_single", strategy, dict(TINY, **cfg_kw),
                   ngd_kw, plan, _batch(TINY["vocab"], (4, 16)))
    assert r["diffs"] == [[]] * len(plan), r["diffs"]
    assert r["dist"] == r["single"]
    assert np.isfinite(r["dist"]).all()


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_world_one_dist_steps_equal_single_device(pool1, strategy):
    _world_one(pool1, strategy, {}, PLAN,
               factor_wire="e4m3" if strategy == "fused" else "")


def test_world_one_inverse_sharding_equals_double_buffer(pool1):
    _world_one(pool1, "dense", {"double_buffer": True,
                                "inverse_sharding": True}, PLAN)


def test_world_one_sharded_pipeline_equals_single_device(pool1):
    _world_one(pool1, "ring_fp8", {"double_buffer": True,
                                   "inverse_sharding": True,
                                   "refresh_chunks": 2}, PIPE_PLAN)


@pytest.mark.parametrize("strategy", ["dense", "ring_fp8"])
def test_world_one_run_with_mesh_equals_run(pool1, strategy):
    """launch.train.run(mesh=...) takes the dist steps and the reducer's
    ledger; at world size 1 every statistic scatters over a group of one,
    so the losses, step kinds and printed ledger are the single-device
    run's. With the refresh pipeline (K 2) the controller takes fast steps
    at random init too."""
    r, = pool1.run("run_with_mesh", strategy, TINY,
                   {"refresh_chunks": 2}, 5)
    assert r["dist"]["losses"] == r["single"]["losses"]
    assert r["dist"]["kinds"] == r["single"]["kinds"]
    assert "capture" in r["dist"]["kinds"] and "fast" in r["dist"]["kinds"]
    assert r["dist"]["log"][-1] == r["single"]["log"][-1]
    assert f"modelled wire [{strategy}/" in r["dist"]["log"][-1]


CASES = {
    "dense": ("dense", {}, 1, 2e-3),
    "ring_fp8": ("ring_fp8", {}, 1, 2e-3),
    "sharded_pipeline": ("dense", dict(double_buffer=True,
                                       inverse_sharding=True,
                                       refresh_chunks=2), 3, 5e-4),
}


@pytest.fixture(scope="module")
def repro_params():
    params = _llama_setup({})[2]
    return jax.tree.map(np.asarray, params)


@needs_devices
@pytest.mark.parametrize("case", CASES)
def test_two_ranks_match_repro_shardmap(pool2, repro_params, case):
    strategy, ngd_kw, period, lr = CASES[case]
    want = _losses_shardmap(strategy, period=period, offset=0, lr=lr,
                            **ngd_kw)
    got = pool2.run("dist_losses", strategy, LLAMA, repro_params, ngd_kw,
                    _batch(LLAMA["vocab"], (8, 16)), 20, period, 0, lr)
    assert got[0] == got[1]
    print(f"{case}: port {np.round(got[0][:8], 6).tolist()}, "
          f"repro {np.round(want[:8], 6).tolist()}")
    assert np.isfinite(got[0]).all()
    np.testing.assert_allclose(got[0][:8], want[:8], rtol=1e-3, atol=1e-3)
