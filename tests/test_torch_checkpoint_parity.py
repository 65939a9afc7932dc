"""repro_torch's checkpoints (``repro_torch.checkpoint``) against the JAX
package's, on the CPU.

The port's counterparts of ``tests/test_checkpoint_roundtrip.py``'s four
cases (bf16 and fp8 history, the double buffer, mid-drain of the refresh
pipeline, a single-buffer checkpoint entering a double-buffered run), each
a save at step 3 of 5 and a continuation that must equal the uninterrupted
run bit for bit; then the files of both packages: the same state written
by either gives the same npz keys (in order), dtypes and bytes, a
checkpoint of either restores in the other bit for bit and continues there
at the parity tolerance (params and buffers 1e-4 relative to the largest
entry of each leaf, as ``tests/test_torch_pipeline_parity.py``), and the
controller's JSON loads both ways. Last, the port saves and restores a
bf16-param, fp8-history state with ``ml_dtypes`` and ``jax`` unimportable,
as on the card's machine, which has neither.

Fixture: ``tests/test_torch_train_parity.py``'s (reduced llama3_2_1b,
head_dim 16, d_ff 64, vocab 128), damping 0.1.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jrestore
from repro.checkpoint import save_checkpoint as jsave
from repro.core.stale import IntervalController as JController
from repro.launch.train import make_fast_step as jmake_fast_step
from repro.launch.train import make_train_step as jmake_train_step
from repro_torch import convert
from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.checkpoint.ckpt import _flatten
from repro_torch.configs import get_config
from repro_torch.core.stale import IntervalController
from repro_torch.launch import train
from test_torch_train_parity import TINY, _get, _leaves, _rel, _setup

ROOT = Path(__file__).resolve().parents[1]
STEPS, BREAK_AT = 5, 3
DAMP, LR, MOM = 0.1, 5e-3, 0.9
K = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(dtype=torch.float32):
    return dataclasses.replace(get_config("llama3_2_1b").reduced(**TINY),
                               dtype=dtype)


def _make(cfg, **ngd_kw):
    model, opt, params, state = train.build(cfg=cfg, device="cpu",
                                            damping=DAMP, **ngd_kw)
    k = opt.cfg.refresh_chunks
    ctrl = IntervalController(opt.stat_names(), alpha=0.1,
                              min_interval=k + 1 if k > 1 else 1,
                              bytes_per_stat=opt.stat_bytes())
    return model, opt, params, state, ctrl


def _batch(cfg, t):
    rng = np.random.RandomState(t)
    return {k: torch.from_numpy(rng.randint(0, cfg.vocab, (4, 16)))
            for k in ("tokens", "labels")}


def _advance(model, opt, ctrl, params, state, t, cadence=None):
    """Step t as the controller decides, or with ``cadence`` a capture at
    t % cadence == 1 and a fast (drain) step otherwise."""
    flags = (ctrl.flags(t) if cadence is None
             else {n: t % cadence == 1 for n in opt.stat_names()})
    batch = _batch(model.cfg, t)
    if any(flags.values()):
        params, state, m = opt.step(params, state, batch, flags, DAMP, LR,
                                    MOM)
        ctrl.update(t, flags, m["sims"])
    else:
        params, state, m = opt.step_fast(params, state, batch, DAMP, LR, MOM)
        ctrl.update(t, flags, {})
    return params, state


def _bits(tree) -> dict:
    return {k: (v.dtype.str, v.shape, v.tobytes())
            for k, v in _flatten(tree).items()}


def _assert_same(model_a, state_a, model_b, state_b):
    assert _bits(convert.params_layout(model_a.params())) == \
        _bits(convert.params_layout(model_b.params()))
    assert _bits(convert.opt_state_layout(state_a)) == \
        _bits(convert.opt_state_layout(state_b))


def _interrupted(tmp_path, cfg, ngd_kw, cadence=None):
    """Steps 1..BREAK_AT, a save, a restore into a fresh model and
    optimizer (through its ``upgrade_state``), then steps BREAK_AT+1..STEPS. The restored params
    and state are the saved ones bit for bit (checked before the
    continuation updates them in place). Returns the resumed (model, opt,
    state, ctrl), the restore, and the state saved."""
    model, opt, params, state, ctrl = _make(cfg, **ngd_kw)
    for t in range(1, BREAK_AT + 1):
        params, state = _advance(model, opt, ctrl, params, state, t, cadence)
    save_checkpoint(str(tmp_path), BREAK_AT, params, state,
                    ctrl.state_dict())
    r = restore_checkpoint(str(tmp_path), cfg=cfg, device="cpu")
    assert r["step"] == latest_step(str(tmp_path)) == BREAK_AT
    assert _bits(convert.opt_state_layout(r["opt_state"])) == \
        _bits(convert.opt_state_layout(state))
    model3, opt3, _, _, _ = _make(cfg, **ngd_kw)
    model3.load_state_dict(r["params"])
    assert _bits(convert.params_layout(model3.params())) == \
        _bits(convert.params_layout(model.params()))
    state3 = opt3.upgrade_state(r["opt_state"])
    ctrl3 = IntervalController.from_state_dict(r["controller"])
    assert ctrl3.state_dict() == ctrl.state_dict()
    saved = state
    params3 = model3.params()
    for t in range(BREAK_AT + 1, STEPS + 1):
        params3, state3 = _advance(model3, opt3, ctrl3, params3, state3, t,
                                   cadence)
    return (model3, opt3, state3, ctrl3), r, saved


def _uninterrupted(cfg, ngd_kw, cadence=None):
    model, opt, params, state, ctrl = _make(cfg, **ngd_kw)
    for t in range(1, STEPS + 1):
        params, state = _advance(model, opt, ctrl, params, state, t, cadence)
    return model, state, ctrl


# ---------------------------------------------------------------------------
# the port's own round trips (tests/test_checkpoint_roundtrip.py's cases)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("factor_dtype", [torch.bfloat16, "fp8_e4m3"],
                         ids=["bf16", "fp8_e4m3"])
def test_checkpoint_roundtrip_continuation(tmp_path, factor_dtype):
    cfg, kw = _cfg(), {"factor_dtype": factor_dtype}
    model, state, ctrl = _uninterrupted(cfg, kw)
    (m3, _, s3, c3), _, _ = _interrupted(tmp_path, cfg, kw)
    _assert_same(m3, s3, model, state)
    assert c3.state_dict() == ctrl.state_dict()


def test_checkpoint_roundtrip_double_buffer(tmp_path):
    """BREAK_AT lands between a refresh and the step that activates it:
    both buffers differ at the break."""
    cfg, kw = _cfg(), {"double_buffer": True}
    model, state, ctrl = _uninterrupted(cfg, kw)
    (m3, _, s3, c3), r, saved = _interrupted(tmp_path, cfg, kw)
    assert all("precond_next" in e for e in r["opt_state"]["curv"].values())
    assert any(not torch.equal(e["precond"][k], e["precond_next"][k])
               for e in saved["curv"].values() for k in e["precond"])
    _assert_same(m3, s3, model, state)
    assert c3.state_dict() == ctrl.state_dict()


def test_checkpoint_roundtrip_mid_pipeline(tmp_path):
    """A capture every K+1 steps: BREAK_AT lands at cursor K, both chunks
    drained and the flip pending, so the resumed run's first step is the
    activation the saved run had not applied."""
    cfg, kw = _cfg(), {"refresh_chunks": K, "factor_dtype": "fp8_e4m3"}
    model, state, ctrl = _uninterrupted(cfg, kw, cadence=K + 1)
    (m3, _, s3, c3), r, saved = _interrupted(tmp_path, cfg, kw,
                                             cadence=K + 1)
    pipe = r["opt_state"]["pipeline"]
    assert saved["pipeline"]["cursor"] == pipe["cursor"] == K
    assert all(v for e in pipe["valid"].values() for v in e.values())
    assert c3.min_interval == K + 1
    _assert_same(m3, s3, model, state)
    assert c3.state_dict() == ctrl.state_dict()


def test_single_buffer_checkpoint_enters_a_double_buffered_run(tmp_path):
    """A single-buffer checkpoint whose controller lacks the gather
    ledger: the double-buffered run seeds its staged buffer from the
    active one (the first activation changes nothing), the controller
    resumes with the ledger at zero, and it trains on."""
    cfg = _cfg()
    model, opt, params, state, ctrl = _make(cfg)
    for t in range(1, BREAK_AT + 1):
        params, state = _advance(model, opt, ctrl, params, state, t)
    cs = ctrl.state_dict()
    del cs["total_gather_bytes"], cs["dense_gather_bytes"]
    for st in cs["stats"].values():
        del st["gather_bytes_per_refresh"]
    save_checkpoint(str(tmp_path), BREAK_AT, params, state, cs)
    r = restore_checkpoint(str(tmp_path), cfg=cfg, device="cpu")
    model2, opt2, _, _, _ = _make(cfg, double_buffer=True)
    model2.load_state_dict(r["params"])
    s2 = opt2.upgrade_state(r["opt_state"])
    for e in s2["curv"].values():
        for k, v in e["precond"].items():
            assert e["precond_next"][k] is v
    c2 = IntervalController.from_state_dict(r["controller"])
    assert c2.total_gather_bytes == 0
    p2 = model2.params()
    for t in range(BREAK_AT + 1, STEPS + 1):
        p2, s2 = _advance(model2, opt2, c2, p2, s2, t)
    assert all(torch.isfinite(v).all() for v in model2.state_dict().values())


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

def _np_files(path: str) -> dict:
    out = {}
    for kind in ("params", "opt"):
        with np.load(f"{path}.{kind}.npz") as z:
            out[kind] = [(k, z[k].dtype.str, z[k].shape, z[k].tobytes())
                         for k in z.files]
    return out


FP8_PIPE = {"double_buffer": True, "refresh_chunks": K,
            "factor_dtype": "fp8_e4m3"}


@functools.lru_cache(maxsize=None)
def _jax_fp8_pipe():
    """repro on the fixture with fp8 history and the pipeline (K 2): its
    capture step and one drain (cursor 1), and its jitted fast step
    (compiled once for the tests that share it)."""
    (jm, jopt, jp, js, jb, jflags), _ = _setup(damping=DAMP, ngd_kw=FP8_PIPE)
    jp, js, _ = jax.jit(jmake_train_step(jm, jopt))(jp, js, jb, jflags, DAMP,
                                                    LR, MOM)
    fast = jax.jit(jmake_fast_step(jm, jopt))
    jp, js, _ = fast(jp, js, jb, DAMP, LR, MOM)
    assert int(js["pipeline"]["cursor"]) == 1
    return jm, jopt, jp, js, jb, fast


def _jax_mid_drain():
    """repro's mid-drain run (``_jax_fp8_pipe``) and the port's objects
    from the same initial state, made anew."""
    return _jax_fp8_pipe(), _setup(damping=DAMP, ngd_kw=FP8_PIPE)[1]


def _jctrl(names):
    ctrl = JController(names, alpha=0.1, min_interval=K + 1)
    ctrl.update(1, {n: True for n in names},
                {n: (0.5, 0.7) for n in names})
    return ctrl


def test_both_packages_write_the_same_files_fp8_mid_drain(tmp_path):
    """repro's mid-drain state with fp8 history, written by repro and,
    after conversion, by the port: the same npz keys in the same order,
    dtypes and bytes, and the same controller JSON."""
    (jm, jopt, jp, js, _, _), (tm, topt, _, _, _) = _jax_mid_drain()
    ctrl = _jctrl(jopt.stat_names()).state_dict()
    jsave(str(tmp_path / "jax"), 2, jp, js, ctrl)
    tm.load_state_dict(convert.params_from_jax(jax.tree.map(np.asarray, jp),
                                               tm.cfg, "cpu"))
    ts = convert.opt_state_from_jax(jax.tree.map(np.asarray, js), tm.cfg,
                                    "cpu")
    save_checkpoint(str(tmp_path / "torch"), 2, tm.params(), ts, ctrl)
    want = _np_files(str(tmp_path / "jax" / "ckpt_00000002"))
    got = _np_files(str(tmp_path / "torch" / "ckpt_00000002"))
    assert got == want
    assert any("@float8_e4m3fn" in k for k, *_ in got["opt"])
    assert ("pipeline|cursor", "<i4", (), np.int32(1).tobytes()) in \
        got["opt"]
    for name in ("ckpt_00000002.ctrl.json", "LATEST"):
        assert (tmp_path / "torch" / name).read_text() == \
            (tmp_path / "jax" / name).read_text()


def test_both_packages_write_the_same_files_bf16(tmp_path):
    """A port state with bf16 params and bf16 history (double buffer),
    written by the port and, through ``convert``'s numpy trees, by repro:
    the same files; the bf16 leaves as uint16 under '@bfloat16'."""
    cfg = _cfg(torch.bfloat16)
    model, opt, params, state, ctrl = _make(cfg, factor_dtype=torch.bfloat16,
                                            double_buffer=True)
    for t in range(1, 3):
        params, state = _advance(model, opt, ctrl, params, state, t)
    save_checkpoint(str(tmp_path / "torch"), 2, params, state,
                    ctrl.state_dict())
    jsave(str(tmp_path / "jax"), 2, convert.params_to_jax(params),
          convert.opt_state_to_jax(state), ctrl.state_dict())
    want = _np_files(str(tmp_path / "jax" / "ckpt_00000002"))
    got = _np_files(str(tmp_path / "torch" / "ckpt_00000002"))
    assert got == want
    bf16 = [k for k, dt, *_ in got["params"] if k.endswith("@bfloat16")]
    assert bf16 and all(dt == "<u2" for k, dt, *_ in got["params"]
                        if k in bf16)


def _check_close(tparams, tstate, jparams, jstate):
    got = convert.params_to_jax(tparams)
    for path, want in _leaves(jax.tree.map(np.asarray, jparams)):
        assert _rel(_get(got, path), want) <= 1e-4, path
    tst = convert.opt_state_to_jax(tstate)
    jst = jax.tree.map(np.asarray, jstate)
    assert int(tst["pipeline"]["cursor"]) == int(jst["pipeline"]["cursor"])
    for fam, e in jst["curv"].items():
        for slot in ("precond", "precond_next"):
            for key, want in e[slot].items():
                assert _rel(tst["curv"][fam][slot][key], want) <= 1e-4, \
                    (fam, slot, key)


def test_repro_checkpoint_restores_in_the_port(tmp_path):
    """A mid-drain fp8 checkpoint written by repro: the port restores every
    leaf bit for bit (the port's layout of what it restored is the file),
    then both packages drain on (chunk 1, then the flip) and agree."""
    (jm, jopt, jp, js, jb, fast), (tm, topt, _, tb, _) = _jax_mid_drain()
    jsave(str(tmp_path), 2, jp, js, _jctrl(jopt.stat_names()).state_dict())
    r = restore_checkpoint(str(tmp_path), cfg=tm.cfg, device="cpu")
    tm.load_state_dict(r["params"])
    path = str(tmp_path / "ckpt_00000002")
    with np.load(path + ".params.npz") as z:
        want = {k: (z[k].dtype.str, z[k].shape, z[k].tobytes())
                for k in z.files}
    assert _bits(convert.params_layout(tm.params())) == want
    with np.load(path + ".opt.npz") as z:
        want = {k: (z[k].dtype.str, z[k].shape, z[k].tobytes())
                for k in z.files}
    ts = topt.upgrade_state(r["opt_state"])
    assert _bits(convert.opt_state_layout(ts)) == want
    assert ts["pipeline"]["cursor"] == 1
    ctrl = IntervalController.from_state_dict(r["controller"])
    assert ctrl.state_dict() == r["controller"]
    params = tm.params()
    for _ in range(2):
        jp, js, _ = fast(jp, js, jb, DAMP, LR, MOM)
        params, ts, _ = topt.step_fast(params, ts, tb, DAMP, LR, MOM)
    _check_close(params, ts, jp, js)


def test_port_checkpoint_restores_in_repro(tmp_path):
    """The port's own mid-drain fp8 run from the shared initial state,
    written by the port: repro restores every leaf bit for bit, then both
    packages drain on and agree."""
    (jm, jopt, jp, js, jb, jflags), (tm, topt, ts, tb, tflags) = _setup(
        damping=DAMP, ngd_kw=FP8_PIPE)
    params, ts, _ = topt.step(tm.params(), ts, tb, tflags, DAMP, LR, MOM)
    params, ts, _ = topt.step_fast(params, ts, tb, DAMP, LR, MOM)
    ctrl = IntervalController(topt.stat_names(), alpha=0.1,
                              min_interval=K + 1)
    save_checkpoint(str(tmp_path), 2, params, ts, ctrl.state_dict())
    r = jrestore(str(tmp_path))
    want = convert.opt_state_to_jax(ts)
    got = jax.tree.map(np.asarray, r["opt_state"])
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for x, y in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()
    for x, y in zip(jax.tree.leaves(jax.tree.map(np.asarray, r["params"])),
                    jax.tree.leaves(convert.params_to_jax(params))):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    assert JController.from_state_dict(r["controller"]).state_dict() == \
        ctrl.state_dict()
    jp, js = r["params"], jopt.upgrade_state(r["opt_state"])
    fast = _jax_fp8_pipe()[5]
    for _ in range(2):
        jp, js, _ = fast(jp, js, jb, DAMP, LR, MOM)
        params, ts, _ = topt.step_fast(params, ts, tb, DAMP, LR, MOM)
    _check_close(params, ts, jp, js)


def test_controller_json_loads_both_ways():
    names = ["a.a", "a.g", "b.d"]
    jc = _jctrl(names)
    jc.update(4, {"a.a": True, "a.g": False, "b.d": True},
              {"a.a": (0.01, 0.02), "b.d": (0.3, 0.1)})
    text = json.dumps(jc.state_dict())
    tc = IntervalController.from_state_dict(json.loads(text))
    assert tc.state_dict() == jc.state_dict()
    assert tc.flags(7) == jc.flags(7)
    tc.update(7, tc.flags(7), {n: (0.05, 0.05) for n in names})
    back = JController.from_state_dict(json.loads(json.dumps(
        tc.state_dict())))
    assert back.state_dict() == tc.state_dict()


# ---------------------------------------------------------------------------
# without ml_dtypes and jax
# ---------------------------------------------------------------------------

_NO_ML_DTYPES = r"""
import sys
sys.modules["ml_dtypes"] = None      # as on the card's machine
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
import dataclasses
import torch
from repro_torch import convert
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.checkpoint.ckpt import _flatten
from repro_torch.configs import get_config
from repro_torch.launch import train
from repro_torch.models.transformer import DecoderLM

torch.set_num_threads(1)
cfg = dataclasses.replace(get_config("llama3_2_1b").reduced(
    head_dim=16, d_ff=64, vocab=128, sliding_window=8, kfac_max_dim=32),
    dtype=torch.bfloat16)
model, opt, params, state = train.build(cfg=cfg, device="cpu", damping=0.1,
                                        factor_dtype="fp8_e4m3",
                                        refresh_chunks=2)
params, state, _ = train.run(model, opt, params, state, steps=2, batch=2,
                             seq=8, damping=0.1, log=lambda m: None)
save_checkpoint(sys.argv[1], 2, params, state, {"note": 1})
r = restore_checkpoint(sys.argv[1], cfg=cfg, device="cpu")
model2 = DecoderLM(cfg, device="cpu")
model2.load_state_dict(r["params"])


def bits(tree):
    return {k: (v.dtype.str, v.shape, v.tobytes())
            for k, v in _flatten(tree).items()}


p1, p2 = (bits(convert.params_layout(m.params())) for m in (model, model2))
s1, s2 = (bits(convert.opt_state_layout(s)) for s in (state, r["opt_state"]))
assert p1 == p2 and s1 == s2
assert any(k.endswith("@bfloat16") for k in p1)
assert any(k.endswith("@float8_e4m3fn") for k in s1)
assert sys.modules["ml_dtypes"] is None and sys.modules["jax"] is None
print("restored", len(p1), len(s1), "cursor", r["opt_state"]["pipeline"]["cursor"])
"""


def test_checkpoint_needs_neither_ml_dtypes_nor_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _NO_ML_DTYPES,
                          str(tmp_path)], capture_output=True, text=True,
                         env=env, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert "restored" in out.stdout and "cursor 1" in out.stdout
