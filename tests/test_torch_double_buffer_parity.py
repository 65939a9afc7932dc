"""repro_torch's double-buffered SP-NGD (``NGDConfig.double_buffer``)
against the JAX package's, on the CPU.

The fixture is ``tests/test_torch_train_parity.py``'s (reduced llama3_2_1b,
head_dim 16, d_ff 64, vocab 128, f32, batch (4, 16), every statistic
refreshed each capture step), at damping 0.1. At that fixture's damping
1e-3 the JAX package's own double-buffered run does not train: the
one-step-stale inverses of a tiny damping throw the loss back above 1.0
after step 6 (5.24 at step 20), so the losses rule below could not hold
for the reference; at damping 0.1 both packages fall below 1.0 from step 7
on. Tolerances, as in the train parity test: the buffers and params 1e-4
relative to the largest entry of each leaf (f32, another reduction order),
the first 8 of 20 losses within rtol = atol = 1e-3, every later one below
1.0.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.train import make_fast_step as jmake_fast_step
from repro.launch.train import make_train_step as jmake_train_step
from repro_torch import convert
from repro_torch.core.fisher import flatten
from repro_torch.launch.train import make_fast_step, make_train_step
from test_torch_train_parity import _get, _leaves, _rel, _setup

DAMP, LR, MOM = 0.1, 5e-3, 0.9
# the family that does not refresh in the partial-flags step
IDLE = "blk/mlp_up"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _db(double_buffer=True):
    return _setup(damping=DAMP, ngd_kw={"double_buffer": double_buffer})


def _partial(flags, on):
    return {k: (on(True) if not k.startswith(IDLE + ".") else on(False))
            for k in flags}


@functools.lru_cache(maxsize=None)
def _jax_run():
    """The JAX package's double-buffered trajectory, run to its end before
    any torch step: the states after capture steps 1-3, the params and
    state after a fast step from step 1's state, the state after a step
    from step 1's state that refreshes every family but IDLE, and the 20
    losses."""
    (jm, jopt, jp, js, jb, jflags), _ = _db()
    step = jax.jit(jmake_train_step(jm, jopt))
    fast = jax.jit(jmake_fast_step(jm, jopt))
    out = {"states": [], "params": [], "losses": []}
    for t in range(20):
        jp, js, m = step(jp, js, jb, jflags, DAMP, LR, MOM)
        out["losses"].append(float(m["loss"]))
        if t < 3:
            out["states"].append(jax.tree.map(np.asarray, js))
            out["params"].append(jax.tree.map(np.asarray, jp))
        if t == 0:
            fp, fs, _ = fast(jp, js, jb, DAMP, LR, MOM)
            out["fast"] = jax.tree.map(np.asarray, (fp, fs))
            _, ps, _ = step(jp, js, jb, _partial(jflags, jnp.asarray), DAMP,
                            LR, MOM)
            out["partial"] = jax.tree.map(np.asarray, ps)
    return out


def _check_state(tstate, jstate, slots=("precond", "precond_next")):
    tst = convert.opt_state_to_jax(tstate)
    assert set(tst["curv"]) == set(jstate["curv"])
    for fam, entry in jstate["curv"].items():
        assert set(tst["curv"][fam]) == set(entry), fam
        for slot in slots:
            for key, want in entry[slot].items():
                got = tst["curv"][fam][slot][key]
                assert _rel(got, want) <= 1e-4, (fam, slot, key)


def _check_params(tparams, jparams):
    got = convert.params_to_jax(tparams)
    for path, want in _leaves(jparams):
        assert _rel(_get(got, path), want) <= 1e-4, path


def test_three_capture_steps_match_jax_buffer_by_buffer():
    """precond and precond_next after each of the first three capture
    steps, and the updated params; after step 1 the active buffer is still
    the initial one (the identity for the blocked factors)."""
    want = _jax_run()
    _, (tm, topt, ts, tb, tflags) = _db()
    init = convert.opt_state_to_jax(ts)
    step = make_train_step(tm, topt)
    params = tm.params()
    for t in range(3):
        params, ts, _ = step(params, ts, tb, tflags, DAMP, LR, MOM)
        _check_state(ts, want["states"][t])
        _check_params(params, want["params"][t])
        if t == 0:
            got = convert.opt_state_to_jax(ts)
            for fam, entry in init["curv"].items():
                for key, pc in entry["precond"].items():
                    np.testing.assert_array_equal(
                        got["curv"][fam]["precond"][key], pc)


def test_step_one_applies_the_identity_and_stages_the_refresh():
    """Step 1 of the double-buffered run moves the params as a fast step
    on the initial (identity) preconditioners does, and stages exactly the
    inverses the single-buffer run's step 1 makes active."""
    _, (tm, topt, ts, tb, tflags) = _db()
    p1, s1, _ = make_train_step(tm, topt)(tm.params(), ts, tb, tflags, DAMP,
                                          LR, MOM)
    got = {k: v.detach().clone() for k, v in flatten(p1).items()}
    _, (tm2, topt2, ts2, tb2, tflags2) = _db(double_buffer=False)
    p2, _, _ = topt2.step_fast(tm2.params(), ts2, tb2, DAMP, LR, MOM)
    for k, v in flatten(p2).items():
        assert _rel(got[k], v.detach()) <= 1e-5, k
    _, (tm3, topt3, ts3, tb3, tflags3) = _db(double_buffer=False)
    _, s3, _ = make_train_step(tm3, topt3)(tm3.params(), ts3, tb3, tflags3,
                                           DAMP, LR, MOM)
    for fam, entry in s3["curv"].items():
        assert "precond_next" not in entry
        for key, v in entry["precond"].items():
            assert torch.equal(s1["curv"][fam]["precond_next"][key], v), \
                (fam, key)


def test_fast_step_activates_the_staged_buffer():
    """A fast step after capture step 1 applies the staged inverses: both
    buffers then hold them (the same tensors), and the params match the
    JAX package's fast step."""
    want = _jax_run()
    _, (tm, topt, ts, tb, tflags) = _db()
    params, ts, _ = make_train_step(tm, topt)(tm.params(), ts, tb, tflags,
                                              DAMP, LR, MOM)
    staged = {fam: dict(e["precond_next"]) for fam, e in ts["curv"].items()}
    params, ts2, _ = make_fast_step(tm, topt)(params, ts, tb, DAMP, LR, MOM)
    for fam, entry in ts2["curv"].items():
        for key, v in staged[fam].items():
            assert entry["precond"][key] is v
            assert entry["precond_next"][key] is v
    jp, js = want["fast"]
    _check_params(params, jp)
    _check_state(ts2, js)


def test_a_family_that_does_not_refresh_keeps_its_staged_buffer():
    """From step 1's state, a capture step with IDLE's flags off: IDLE
    activates what it staged and keeps it staged (the JAX package's keep
    branch); the other families stage fresh inverses. Both as in JAX."""
    want = _jax_run()["partial"]
    _, (tm, topt, ts, tb, tflags) = _db()
    step = make_train_step(tm, topt)
    params, ts, _ = step(tm.params(), ts, tb, tflags, DAMP, LR, MOM)
    staged = dict(ts["curv"][IDLE]["precond_next"])
    params, ts2, _ = step(params, ts, tb, _partial(tflags, bool), DAMP, LR,
                          MOM)
    for key, v in staged.items():
        assert ts2["curv"][IDLE]["precond"][key] is v
        assert ts2["curv"][IDLE]["precond_next"][key] is v
    _check_state(ts2, want)


def test_twenty_step_losses_match_jax():
    want = _jax_run()["losses"]
    _, (tm, topt, ts, tb, tflags) = _db()
    step = make_train_step(tm, topt)
    params, got = tm.params(), []
    for _ in range(20):
        params, ts, m = step(params, ts, tb, tflags, DAMP, LR, MOM)
        got.append(float(m["loss"]))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[:8], want[:8], rtol=1e-3, atol=1e-3)
    assert max(got[8:]) < 1.0 and max(want[8:]) < 1.0


def _layout(state):
    return {fam: {slot: sorted(v) for slot, v in entry.items()}
            for fam, entry in state["curv"].items()}


def test_upgrade_state_matches_repro_in_both_directions():
    """A single-buffer state entering a double-buffered run seeds the
    staged buffer from the active one, a double-buffered state entering a
    single-buffer run drops it, a state already in the layout passes: the
    same layouts as the JAX package's ``upgrade_state``. A fast step on the
    seeded state moves the params as the single-buffer fast step does."""
    (jm, jdb, jp, js_db, jb, _), (tm, tdb, ts_db, tb, tflags) = _db()
    (_, jsb, _, js_sb, _, _), (tm2, tsb, ts_sb, tb2, tflags2) = _db(False)
    for jopt, topt, js, ts in ((jdb, tdb, js_sb, ts_sb),
                               (jsb, tsb, js_db, ts_db),
                               (jdb, tdb, js_db, ts_db),
                               (jsb, tsb, js_sb, ts_sb)):
        ju = jax.tree.map(np.asarray, jopt.upgrade_state(js))
        tu = topt.upgrade_state(ts)
        assert _layout(tu) == _layout(ju)
        assert _layout(convert.opt_state_to_jax(tu)) == _layout(ju)
        assert tu["step"] == ts["step"]
    # single -> double after a real refresh: the first activation is a no-op
    p_sb, s_sb, _ = make_train_step(tm2, tsb)(tm2.params(), ts_sb, tb2,
                                              tflags2, DAMP, LR, MOM)
    # the fast steps below update the velocity in place: each its own
    up = tdb.upgrade_state({**s_sb, "velocity": {
        k: v.clone() for k, v in s_sb["velocity"].items()}})
    for fam, entry in up["curv"].items():
        assert "precond_next" not in s_sb["curv"][fam]
        for key, v in entry["precond"].items():
            assert entry["precond_next"][key] is v
    snap = {k: v.detach().clone() for k, v in flatten(p_sb).items()}
    _, (tm3, _, _, _, _) = _db(False)
    tm3.load_state_dict(tm2.state_dict())
    p_db, _, _ = tdb.step_fast(tm3.params(), up, tb, DAMP, LR, MOM)
    p_ref, _, _ = tsb.step_fast(p_sb, s_sb, tb2, DAMP, LR, MOM)
    for k, v in flatten(p_ref).items():
        assert torch.equal(flatten(p_db)[k], v), k
    assert any(not torch.equal(snap[k], v) for k, v in flatten(p_ref).items())


def test_converters_round_trip_a_double_buffered_state():
    (_, _, _, js, _, _), (tm, topt, ts, tb, tflags) = _db()
    _, ts1, _ = make_train_step(tm, topt)(tm.params(), ts, tb, tflags, DAMP,
                                          LR, MOM)
    as_jax = convert.opt_state_to_jax(ts1)
    assert _layout(as_jax) == _layout(jax.tree.map(np.asarray, js))
    back = convert.opt_state_from_jax(as_jax, tm.cfg, "cpu")
    assert back["step"] == ts1["step"] == 1
    for path, v in ts1["velocity"].items():
        assert torch.equal(back["velocity"][path], v)
    for fam, entry in ts1["curv"].items():
        assert set(back["curv"][fam]) == set(entry) >= {"precond_next"}
        for slot, stats in entry.items():
            for key, v in stats.items():
                assert torch.equal(back["curv"][fam][slot][key], v)


@pytest.mark.parametrize("argv,value", [([], False),
                                        (["--double-buffer"], True)])
def test_train_cli_double_buffer_reaches_the_optimizer(monkeypatch, argv,
                                                       value):
    from repro_torch.launch import train
    seen = {}
    monkeypatch.setattr(train, "run", lambda model, opt, params, state, **kw:
                        seen.update(cfg=opt.cfg, state=state))
    train.main(["--device", "cpu"] + argv)
    assert seen["cfg"].double_buffer is value
    assert all(("precond_next" in e) is value
               for e in seen["state"]["curv"].values())
