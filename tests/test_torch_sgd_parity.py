"""repro_torch's momentum-SGD baseline against the JAX package's, on the CPU.

The fixture is ``tests/test_torch_train_parity.py``'s (reduced llama3_2_1b,
head_dim 16, d_ff 64, vocab 128, f32, batch (4, 16), the same JAX
PRNGKey(0) params in both packages). Tolerances:

* one step's params and velocity: 1e-4 relative to the largest entry of
  each leaf (f32, gradients summed in another order);
* losses over 20 steps: the first 8 within rtol = atol = 1e-3, every later
  one below 1.0 (the train parity test's rule). At SP-NGD's lr 5e-3 SGD
  needs 11 steps to fall below 1.0 on this fixture; at lr 0.1 (momentum
  0.9) it falls below 1.0 at step 6 in both packages and stays there.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.optim.sgd import SGD as JSGD
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models.transformer import DecoderLM
from repro_torch.optim import SGD
from test_torch_train_parity import _get, _leaves, _rel, _setup

LR, MOM = 0.1, 0.9


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(weight_decay=0.0):
    (jm, _, jp, _, jb, _), (tm, _, _, tb, _) = _setup()
    jopt, topt = JSGD(jm.loss, weight_decay), SGD(tm.loss, weight_decay)
    params = tm.params()
    return (jopt, jp, jopt.init(jp), jb), (tm, topt, params,
                                           topt.init(params), tb)


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_one_step_params_and_velocity_match_jax(weight_decay):
    (jopt, jp, js, jb), (tm, topt, params, ts, tb) = _both(weight_decay)
    jstep = jax.jit(jopt.step)
    jp1, js1, jmet = jstep(jp, js, jb, LR, MOM)
    # a second step, so the momentum term is not zero
    jp2, js2, _ = jstep(jp1, js1, jb, LR, MOM)
    tp1, ts1, tmet = topt.step(params, ts, tb, LR, MOM)
    assert abs(float(tmet["loss"]) - float(jmet["loss"])) <= 1e-5
    tp2, ts2, _ = topt.step(tp1, ts1, tb, LR, MOM)
    assert tp2 is params and ts2["step"] == 2
    got_p = convert.params_to_jax(tp2)
    for path, want in _leaves(jax.tree.map(np.asarray, jp2)):
        assert _rel(_get(got_p, path), want) <= 1e-4, path
    got_s = convert.sgd_state_to_jax(ts2)
    assert int(got_s["step"]) == int(js2["step"]) == 2
    for path, want in _leaves(jax.tree.map(np.asarray, js2["velocity"])):
        assert _rel(_get(got_s["velocity"], path), want) <= 1e-4, path


def test_weight_decay_moves_the_step():
    """weight_decay adds ``wd * w`` to the gradient: without momentum the
    velocity after one step differs from the plain one by ``-lr wd w``."""
    from repro_torch.core.fisher import flatten
    _, (_, plain, params, ts, tb) = _both()
    w0 = {k: v.detach().clone() for k, v in flatten(params).items()}
    _, s_plain, _ = plain.step(params, ts, tb, LR, 0.0)
    _, (_, decay, params2, ts2, tb2) = _both(0.5)
    _, s_decay, _ = decay.step(params2, ts2, tb2, LR, 0.0)
    for k, w in w0.items():
        want = s_plain["velocity"][k] - LR * 0.5 * w
        torch.testing.assert_close(s_decay["velocity"][k], want, rtol=1e-5,
                                   atol=1e-6)


def test_twenty_step_losses_match_jax():
    (jopt, jp, js, jb), (tm, topt, params, ts, tb) = _both()
    jstep = jax.jit(jopt.step)
    want = []
    for _ in range(20):
        jp, js, m = jstep(jp, js, jb, LR, MOM)
        want.append(float(m["loss"]))
    got = []
    for _ in range(20):
        params, ts, m = topt.step(params, ts, tb, LR, MOM)
        got.append(float(m["loss"]))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[:8], want[:8], rtol=1e-3, atol=1e-3)
    assert max(got[8:]) < 1.0 and max(want[8:]) < 1.0


def test_velocity_in_each_parameter_dtype():
    """``init`` gives zeros in each parameter's own dtype (bf16 weights,
    f32 norms), as ``jnp.zeros_like`` does; a step keeps the dtypes."""
    cfg = dataclasses.replace(get_config("llama3_2_1b").reduced(
        head_dim=16, d_ff=64, vocab=128, sliding_window=8),
        dtype=torch.bfloat16)
    model = DecoderLM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    params = model.params()
    opt = SGD(model.loss)
    state = opt.init(params)
    from repro_torch.core.fisher import flatten
    flat = flatten(params)
    assert set(state["velocity"]) == set(flat)
    assert {p.dtype for p in flat.values()} >= {torch.bfloat16}
    for path, p in flat.items():
        v = state["velocity"][path]
        assert v.dtype == p.dtype and v.shape == p.shape and not v.any()
    rng = np.random.RandomState(1)
    batch = {k: torch.from_numpy(rng.randint(0, 128, (2, 8)))
             for k in ("tokens", "labels")}
    _, state, m = opt.step(params, state, batch, LR, MOM)
    assert np.isfinite(float(m["loss"]))
    for path, p in flat.items():
        assert state["velocity"][path].dtype == p.dtype


def test_sgd_state_converters_round_trip():
    _, (tm, topt, params, ts, tb) = _both()
    _, ts1, _ = topt.step(params, ts, tb, LR, MOM)
    back = convert.sgd_state_from_jax(convert.sgd_state_to_jax(ts1), tm.cfg,
                                      "cpu")
    assert back["step"] == ts1["step"] == 1 and set(back) == set(ts1)
    for path, v in ts1["velocity"].items():
        assert torch.equal(back["velocity"][path], v)
