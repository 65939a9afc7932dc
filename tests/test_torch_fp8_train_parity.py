"""The fp8 factor slice of repro_torch's training step against the JAX
package, on the CPU, at the ``benchmarks/kernels_bench.py:40-69``
configuration (reduced llama3_2_1b with head_dim 32, d_ff 128, vocab 256,
window 8, batch (4, 16), ``NGDConfig(damping=1e-3)``, every refresh flag
set, JAX ``PRNGKey(0)`` params drawn under
``jax.threefry_partitionable(False)``). Tolerances:

* losses: the first-step loss is the committed 6.300164 (the capture
  format does not change the forward); with the fp8 history the first 8
  of 20 within rtol = atol = 1e-3; with fused fp8 capture the first 5
  within rtol = atol = 1e-3 along the JAX trajectory with the same
  captured wire sums (the JAX package's), each step's own capture held
  beside them, and the free run's first 2 within 1e-3 and first 5 within
  the JAX package's fused rule (rtol = atol = 2e-2);
* captured wire sums and the encoded history: scales within 1e-5
  relative at step 1 and 5e-5 at steps 2-5, payload bytes within one fp8
  step (the f32 sums in another order).
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.launch.train import make_train_step as jmake_train_step
from repro_torch import convert
from repro_torch.launch import train
from repro_torch.launch.train import make_train_step
from test_torch_train_parity import _setup

BENCH = dict(head_dim=32, d_ff=128, vocab=256, sliding_window=8)
FIRST_LOSS = 6.300164


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the machine's cores: torch's intra-op threads
    would spin against the other workers' and JAX's, so this module's torch
    ops run on one thread (the models are tiny)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ordinal(bits: np.ndarray) -> np.ndarray:
    mag = (bits & 0x7F).astype(np.int32)
    return np.where(bits >= 0x80, -mag, mag)


@functools.lru_cache(maxsize=None)
def _run(wire: str, steps: int):
    """Both packages' training steps with the fp8 history (and fused
    ``wire`` capture) from the same params, state and batch: (torch
    losses, JAX losses, the port's state after step 1, the JAX state after
    step 1 as numpy, the port's template and optimizer, the JAX template
    and optimizer). Cached: the step-1 checks reuse the loss runs."""
    (jm, jopt, jp, js, jb, jflags), (tm, topt, ts, tb, tflags) = _setup(
        BENCH, partitionable=False, ngd_kw={"factor_dtype": "fp8_e4m3"},
        factor_wire=wire)
    # one package after the other: JAX's asynchronous steps would otherwise
    # run beside torch's and the two CPU thread pools slow each other
    jstep = jax.jit(jmake_train_step(jm, jopt))
    want = []
    for i in range(steps):
        jp, js, jmet = jstep(jp, js, jb, jflags, 1e-3, 5e-3, 0.9)
        want.append(float(jmet["loss"]))
        if i == 0:
            js1 = jax.tree.map(np.asarray, js)
    tstep = make_train_step(tm, topt)
    params, got = tm.params(), []
    for i in range(steps):
        params, ts, tmet = tstep(params, ts, tb, tflags, 1e-3, 5e-3, 0.9)
        got.append(float(tmet["loss"]))
        if i == 0:
            ts1 = ts
    return (got, want, ts1, js1, (tm.fstats(), topt, tm.cfg),
            (jax.eval_shape(jm.fstats), jopt))


def test_fp8_history_twenty_steps_match_jax():
    got, want, *_ = _run("", 20)
    assert abs(got[0] - FIRST_LOSS) <= 1e-5 * FIRST_LOSS
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[:8], want[:8], rtol=1e-3, atol=1e-3)


def _wire_gap(got: dict, want: dict) -> tuple[int, float]:
    """Largest fp8-step distance of the payloads and largest relative scale
    difference over the wire-format entries of two raw-stat trees."""
    steps, rel = 0, 0.0
    for fam, entry in want.items():
        for key, w in entry.items():
            if not isinstance(w, dict):
                continue
            g = convert.stats_to_jax({"x": got[fam][key]})["x"]
            d = np.abs(_ordinal(g["payload"].view(np.uint8)).astype(np.int64)
                       - _ordinal(w["payload"].view(np.uint8)))
            steps = max(steps, int(d.max()))
            rel = max(rel, float(np.max(np.abs(g["scale"] - w["scale"])
                                        / np.abs(w["scale"]))))
    return steps, rel


def _leaves(tree, prefix: str = "") -> dict:
    """Flat {path: numpy array} of a nested dict/list tree."""
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _run_shared_capture(steps: int):
    """Fused fp8 capture and the fp8 history along the JAX package's
    trajectory: each step the port starts from the JAX params and state
    (through ``convert``), both packages capture from them, and both
    optimizers take the JAX package's captured sums (the port's through
    ``stats_from_jax``). Carrying each package's own params instead lets
    the f32 rounding gaps (~1e-6) grow by about an order of magnitude a
    step through the inverses of the quantized sums on this overfitting
    fixture. Returns per step: (torch loss, JAX loss, updated params max
    |err| / max, encoded history bytes that differ, (fp8 steps, scale rel
    diff) of the two packages' own captures)."""
    (jm, jopt, jp, js, jb, jflags), (tm, topt, _, tb, tflags) = _setup(
        BENCH, partitionable=False, ngd_kw={"factor_dtype": "fp8_e4m3"},
        factor_wire="e4m3")
    counts = jm.site_counts(jb)
    jcapture = jax.jit(jopt.grads_and_raw)
    japply = jax.jit(lambda p, s, g, r, f, lam, lr, mom, l, a:
                     jopt.apply_update(p, s, g, r, counts, f, lam, lr, mom,
                                       l, a))
    own, shared = {}, {}
    capture = topt.grads_and_raw

    def shared_capture(params, batch, generator=None):
        loss, aux, grads, raw = capture(params, batch, generator)
        own["raw"] = raw
        return loss, aux, grads, convert.stats_from_jax(shared["raw"],
                                                        "cpu")

    topt.grads_and_raw = shared_capture
    tstep = make_train_step(tm, topt)
    out = []
    for _ in range(steps):
        tm.load_state_dict(convert.params_from_jax(
            jax.tree.map(np.asarray, jp), tm.cfg, "cpu"))
        ts = convert.opt_state_from_jax(jax.tree.map(np.asarray, js),
                                        tm.cfg, "cpu")
        loss, aux, grads, raw = jcapture(jp, jb)
        shared["raw"] = jax.tree.map(np.asarray, raw)
        jp, js, jmet = japply(jp, js, grads, raw, jflags, 1e-3, 5e-3, 0.9,
                              loss, aux)
        params, ts, tmet = tstep(tm.params(), ts, tb, tflags, 1e-3, 5e-3,
                                 0.9)
        got = _leaves(convert.params_to_jax(params))
        want = _leaves(jax.tree.map(np.asarray, jp))
        p_err = max(float(np.abs(got[k] - want[k]).max()
                          / np.abs(want[k]).max()) for k in want)
        got = _leaves(convert.opt_state_to_jax(ts)["curv"])
        want = _leaves(jax.tree.map(np.asarray, js)["curv"])
        h_bad = sum(int((got[k].view(np.uint8) != want[k].view(np.uint8))
                        .sum()) for k in want if k.endswith("payload"))
        out.append((float(tmet["loss"]), float(jmet["loss"]), p_err, h_bad,
                    _wire_gap(own["raw"], shared["raw"])))
    return out


def test_fused_fp8_capture_matches_jax_jit_schedule():
    """factor_wire="e4m3" under make_train_step, with the fp8 history as
    the card's path runs it. Free run, as the JAX package's fused_jit run:
    20 steps, the first-step loss and the first 2 losses within rtol = atol
    = 1e-3, the first 5 within the JAX package's own fused rule (rtol = atol
    = 2e-2, tests/test_comm_hier_fused.py:362), every later loss trained
    below 1.0 in both. Along the JAX
    trajectory with the same captured sums (``_run_shared_capture``), 5
    steps: the losses within rtol = atol = 1e-3, the updated params within
    1e-5 of the largest entry (measured 2.9e-6), the encoded history bit
    for bit, and each step's own capture within one fp8 step and 5e-5 in
    scale of the JAX package's (measured 1.3e-5; step 1's captures are
    held to 1e-5 in the next test)."""
    got, want, *_ = _run("e4m3", 20)
    assert abs(got[0] - FIRST_LOSS) <= 1e-5 * FIRST_LOSS
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[:2], want[:2], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got[:5], want[:5], rtol=2e-2, atol=2e-2)
    assert max(got[5:]) < 1.0 and max(want[5:]) < 1.0
    steps = _run_shared_capture(5)
    np.testing.assert_allclose([s[0] for s in steps], [s[1] for s in steps],
                               rtol=1e-3, atol=1e-3)
    for i, (_, _, p_err, h_bad, (fp8_steps, s_rel)) in enumerate(steps):
        assert p_err <= 1e-5, (i, p_err)
        assert h_bad == 0, (i, h_bad)
        assert fp8_steps <= 1 and s_rel <= 5e-5, (i, fp8_steps, s_rel)


@pytest.mark.parametrize("wire", ["", "e4m3"])
def test_one_step_encoded_history_matches_jax(wire):
    """After one capture step the encoded X_-1 of every statistic (and the
    wire template) agrees with the JAX package's, and the state converters
    carry the encoded history both ways bit for bit."""
    _, _, ts1, jnp_state, (tt, topt, cfg), (jt, jopt) = _run(wire, 20)
    for fam in jt:
        for key, leaf in jt[fam].items():
            if isinstance(leaf, dict):
                assert {k: tuple(v.shape) for k, v in tt[fam][key].items()} \
                    == {k: v.shape for k, v in leaf.items()}, (fam, key)
                assert tt[fam][key]["payload"].dtype == torch.float8_e4m3fn
    assert topt.stat_bytes() == jopt.stat_bytes()
    got = convert.opt_state_to_jax(ts1)
    n = 0
    for fam, entry in jnp_state["curv"].items():
        for key, want in entry["prev"].items():
            tw = got["curv"][fam]["prev"][key]
            np.testing.assert_allclose(tw["scale"], want["scale"], rtol=1e-5)
            d = np.abs(_ordinal(tw["payload"].view(np.uint8)).astype(np.int64)
                       - _ordinal(want["payload"].view(np.uint8)))
            assert d.max() <= 1, (fam, key)
            n += 1
    assert n == len(topt.stat_names())
    back = convert.opt_state_to_jax(
        convert.opt_state_from_jax(got, cfg, "cpu"))
    for fam, entry in got["curv"].items():
        for slot in ("prev", "prev2"):
            for key, enc in entry[slot].items():
                for k, v in enc.items():
                    w = back["curv"][fam][slot][key][k]
                    assert w.dtype == v.dtype and w.shape == v.shape
                    assert w.tobytes() == v.tobytes(), (fam, slot, key, k)


def test_accum_refuses_wire_capture():
    _, (tm, topt, *_) = _setup(BENCH, factor_wire="e4m3")
    with pytest.raises(ValueError, match="accumulate wire-format"):
        make_train_step(tm, topt, accum=2)
    make_train_step(tm, topt, accum=1)
    _, (tm_d, topt_d, *_) = _setup(BENCH)
    make_train_step(tm_d, topt_d, accum=2)


def test_train_cli_runs_the_fp8_slice_on_cpu(capsys):
    """--factor-dtype fp8_e4m3 with fused e4m3 capture through the step
    loop: finite losses, the first equal to the f32 path's."""
    lines = {}
    for argv in ([], ["--factor-dtype", "fp8_e4m3", "--factor-wire",
                      "e4m3"]):
        train.main(["--device", "cpu", "--steps", "3", "--batch", "2",
                    "--seq", "16"] + argv)
        lines[bool(argv)] = [ln for ln in capsys.readouterr().out.splitlines()
                             if ln.startswith("step")]
    assert [ln.split()[1] for ln in lines[True]] == ["1", "3"]
    assert all(np.isfinite(float(ln.split()[4])) for ln in lines[True])
    assert lines[True][0].split()[4] == lines[False][0].split()[4]


def test_build_threads_factor_dtype_and_wire():
    model, opt, _, state = train.build(device="cpu", factor_dtype="fp8_e5m2",
                                       factor_wire="e5m2")
    assert model.cfg.factor_wire == "e5m2" and model.spec.wire_fmt == "e5m2"
    assert opt.cfg.factor_dtype == "fp8_e5m2"
    prev = state["curv"]["blk/attn_wq"]["prev"]["a"]
    assert prev["payload"].dtype == torch.float8_e5m2
    assert dataclasses.replace(model.cfg, factor_wire="").factor_wire == ""
