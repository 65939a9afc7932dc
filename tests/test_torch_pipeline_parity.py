"""repro_torch's chunked refresh pipeline (``NGDConfig.refresh_chunks``,
``repro_torch.core.pipeline.RefreshPipeline``) against the JAX package's,
on the CPU.

The port's counterparts of ``tests/test_refresh_pipeline.py``'s cases, on
``tests/test_torch_train_parity.py``'s fixture (reduced llama3_2_1b, head_dim
16, d_ff 64, vocab 128, f32, batch (4, 16)) at damping 0.1, as
``tests/test_torch_double_buffer_parity.py`` explains; then the schedule
against ``repro``'s, drained inverses against the port's inline
double-buffered refresh (bit for bit: the same functions on the same
statistics), and capture, drain and flip steps against ``repro``'s, step by
step from ``repro``'s state (buffers, raw store and params 1e-4 relative to
the largest entry of each leaf; the fp8 history within one fp8 step and its
scales 1e-5, as ``tests/test_torch_fp8_train_parity.py``), and 20 losses
as the double-buffer test holds them. The full BN Fisher's ``uwf`` unit is
held the same way on a small ConvNet with ``bn_fisher="full"``, and the
expert families' (L, E, ...) units on reduced qwen2_moe_a2_7b, driven by
Algorithm 2's controller.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.stale import IntervalController as JController
from repro.launch.train import make_fast_step as jmake_fast_step
from repro.launch.train import make_train_step as jmake_train_step
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core.pipeline import RefreshPipeline
from repro_torch.core.stale import IntervalController
from repro_torch.launch import train
from repro_torch.launch.train import make_fast_step, make_train_step
import jax_one_cpu
from test_torch_moe_parity import _jax_side as _moe_jax_side
from test_torch_moe_parity import _recorded_routes
from test_torch_moe_parity import _setup as _moe_setup
from test_torch_train_parity import TINY, _get, _leaves, _rel, _setup

K = 2
DAMP, LR, MOM = 0.1, 5e-3, 0.9
# the family whose flags are off in the mixed capture
IDLE = "blk/mlp_up"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _moe_child():
    """repro's side of the MoE controller run (``jax_moe_controlled``), in a
    process of its own on one CPU, begun with the module: the test that
    reads it comes late."""
    child = jax_one_cpu.start(__name__, "jax_moe_controlled")
    yield child
    child.close()


def _port(**ngd_kw):
    """The port alone on the fixture's config (seed-0 torch weights):
    (model, opt, params, state, batch, flags)."""
    cfg = get_config("llama3_2_1b").reduced(**TINY)
    model, opt, params, state = train.build(cfg=cfg, device="cpu",
                                            damping=DAMP, **ngd_kw)
    rng = np.random.RandomState(0)
    batch = {k: torch.from_numpy(rng.randint(0, cfg.vocab, (4, 16)))
             for k in ("tokens", "labels")}
    return model, opt, params, state, batch, {
        k: True for k in opt.stat_names()}


def _mixed(flags):
    return {k: v and not k.startswith(IDLE + ".") for k, v in flags.items()}


def _same(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(torch.uint8) if a.dtype.itemsize == 1 else a,
        b.view(torch.uint8) if b.dtype.itemsize == 1 else b)


def _buffers_equal(s1, s2) -> bool:
    """The active buffers of two states, bit for bit."""
    return all(_same(v, s2["curv"][fam]["precond"][key])
               for fam, e in s1["curv"].items()
               for key, v in e["precond"].items())


def _snap(state):
    return {fam: {slot: dict(stats) for slot, stats in e.items()}
            for fam, e in state["curv"].items()}


# ---------------------------------------------------------------------------
# construction and the schedule
# ---------------------------------------------------------------------------

def test_config_validation():
    from repro_torch.core.ngd import NGDConfig, SPNGD
    model, opt, *_ = _port(double_buffer=True)
    assert opt.pipeline is None                  # K == 1: no pipeline
    with pytest.raises(ValueError, match="double_buffer"):
        SPNGD(model.loss, model.site_infos(), model.fstats,
              model.site_counts, NGDConfig(refresh_chunks=2))
    with pytest.raises(ValueError):
        RefreshPipeline(opt, 0)


def test_build_sets_the_double_buffer():
    _, opt, *_ = _port(refresh_chunks=3)
    assert opt.cfg.double_buffer and opt.cfg.refresh_chunks == 3
    assert opt.pipeline.chunks == 3


def test_schedule_partitions_every_stat_once():
    _, opt, *_ = _port(refresh_chunks=K)
    pipe = opt.pipeline
    assert pipe.chunks == K
    units = [u for chunk in pipe.schedule for u in chunk]
    assert len(units) == len(set(units))         # disjoint
    assert {f"{fam}.{key}" for fam, key in units} == set(opt.stat_names())
    # K beyond the stat count is legal: trailing chunks are empty no-ops
    big = RefreshPipeline(opt, 64)
    assert sorted(u for chunk in big.schedule for u in chunk) == \
        sorted(units)
    assert any(not chunk for chunk in big.schedule)


@pytest.mark.parametrize("k", [2, 4, 64])
def test_schedule_and_loads_match_repro(k):
    (_, jopt, *_), (_, topt, *_) = _setup(
        damping=DAMP, ngd_kw={"double_buffer": True, "refresh_chunks": k})
    assert topt.pipeline.schedule == jopt.pipeline.schedule
    assert topt.pipeline.loads == jopt.pipeline.loads
    assert all(topt.pipeline.chunk_names(i) == jopt.pipeline.chunk_names(i)
               for i in range(k))


def test_chunk_names_and_costs():
    _, opt, *_ = _port(refresh_chunks=K)
    pipe = opt.pipeline
    names = [n for i in range(K) for n in pipe.chunk_names(i)]
    assert sorted(names) == sorted(opt.stat_names())
    assert len(pipe.loads) == K and all(x > 0 for x in pipe.loads)


# ---------------------------------------------------------------------------
# the state machine: capture -> drain -> flip -> idle
# ---------------------------------------------------------------------------

def test_activation_timing_and_inflight_sequence():
    """The capture leaves the active buffer as it was; it stays so through
    the K drain steps and flips on step K+1 to exactly the inverses the
    inline double-buffered refresh stages in one step."""
    model, opt, params, state, batch, flags = _port(refresh_chunks=K)
    m_db, opt_db, p_db, s_db, _, _ = _port(double_buffer=True)
    init = _snap(state)
    _, s_db, _ = opt_db.step(p_db, s_db, batch, flags, DAMP, LR, MOM)

    params, state, m = opt.step(params, state, batch, flags, DAMP, LR, MOM)
    assert m["refresh_inflight"] == K + 1 and state["pipeline"]["cursor"] == 0
    assert "inverse_info" not in m
    assert _buffers_equal(state, {"curv": init})
    seen = []
    for i in range(K + 2):
        params, state, m = opt.step_fast(params, state, batch, DAMP, LR, MOM)
        seen.append(m["refresh_inflight"])
        if i < K:      # drain steps: the active buffer stays as it was
            assert _buffers_equal(state, {"curv": init}), i
    assert seen == list(range(K + 1, 0, -1)) + [0]
    assert state["pipeline"]["cursor"] == K + 1
    for fam, e in state["curv"].items():
        for key, v in e["precond"].items():
            assert e["precond_next"][key] is v
            assert _same(v, s_db["curv"][fam]["precond_next"][key]), \
                (fam, key)
    # idle steps leave the curvature and the pipeline as they are
    _, s2, m2 = opt.step_fast(params, state, batch, DAMP, LR, MOM)
    assert m2["refresh_inflight"] == 0
    assert all(s2["curv"][f][slot][k] is v for f, e in state["curv"].items()
               for slot, stats in e.items() for k, v in stats.items())
    assert s2["pipeline"] == state["pipeline"]


@pytest.mark.parametrize("factor_dtype", [torch.float32, "fp8_e4m3"],
                         ids=["f32", "fp8_e4m3"])
def test_drained_inverses_are_the_inline_double_buffer_bit_for_bit(
        factor_dtype):
    """Two captures (the second with IDLE's flags off), each drained, on
    the pipeline and on the inline double buffer from the same weights and
    batches: every statistic of a family the inline refresh recomputes is
    inverted to the same bits; IDLE, which the inline refresh keeps, is
    re-inverted from its decoded X_-1 by the pipeline (the same bits under
    f32 history, where that is the statistic the first refresh
    inverted)."""
    model, opt, p, s, batch, flags = _port(refresh_chunks=K,
                                           factor_dtype=factor_dtype)
    _, opt_db, p_db, s_db, _, _ = _port(double_buffer=True,
                                        factor_dtype=factor_dtype)
    counts = model.site_counts(batch)
    for fl in (flags, _mixed(flags)):
        # one backward feeds both: the same statistics
        loss, aux, grads, raw = opt.grads_and_raw(p, batch)
        _, s_db, _ = opt_db.apply_update(p_db, s_db, grads, raw, counts, fl,
                                         DAMP, LR, MOM, loss, aux)
        p, s, _ = opt.apply_update(p, s, grads, raw, counts, fl, DAMP, LR,
                                   MOM, loss, aux)
        for _ in range(K + 1):
            p, s, _ = opt.step_fast(p, s, batch, DAMP, LR, MOM)
        n = 0
        for fam, e in s["curv"].items():
            if (fam == IDLE and fl is not flags
                    and factor_dtype != torch.float32):
                continue
            for key, v in e["precond"].items():
                assert _same(v, s_db["curv"][fam]["precond_next"][key]), \
                    (fam, key)
                n += 1
        assert n >= len(flags) - 2


def test_mid_drain_recapture_restarts_cleanly():
    """A capture before the drain ended restarts the pipeline on the new
    statistics; the interrupted refresh never activates."""
    _, opt, params, state, batch, flags = _port(refresh_chunks=K)
    init = _snap(state)
    params, state, _ = opt.step(params, state, batch, flags, DAMP, LR, MOM)
    params, state, _ = opt.step_fast(params, state, batch, DAMP, LR, MOM)
    params, state, m = opt.step(params, state, batch, flags, DAMP, LR, MOM)
    assert m["refresh_inflight"] == K + 1 and state["pipeline"]["cursor"] == 0
    assert _buffers_equal(state, {"curv": init})
    for _ in range(K + 1):
        params, state, _ = opt.step_fast(params, state, batch, DAMP, LR,
                                         MOM)
    assert not _buffers_equal(state, {"curv": init})
    assert all(torch.isfinite(v).all() for e in state["curv"].values()
               for stats in e.values() for v in stats.values())


def _layout(state):
    out = {fam: {slot: sorted(v) for slot, v in e.items()}
           for fam, e in state["curv"].items()}
    if "pipeline" in state:
        out["pipeline"] = {k: (sorted(v) if isinstance(v, dict) else None)
                           for k, v in state["pipeline"].items()}
    return out


def test_upgrade_state_pipeline_layouts():
    """A pre-pipeline state entering a pipelined run gets an idle
    pipeline, a pipelined state entering an inline run loses it, a state
    already in the layout passes; the same layouts as ``repro``'s."""
    (_, jdb, _, js_db, _, _), (_, tdb, ts_db, _, _) = _setup(
        damping=DAMP, ngd_kw={"double_buffer": True})
    (_, jpl, _, js_pl, _, _), (_, tpl, ts_pl, _, _) = _setup(
        damping=DAMP, ngd_kw={"double_buffer": True, "refresh_chunks": K})
    up = tpl.upgrade_state(ts_db)
    assert up["pipeline"]["cursor"] == K + 1
    assert not any(v for e in up["pipeline"]["valid"].values()
                   for v in e.values())
    assert _layout(up) == _layout(ts_pl)
    assert "pipeline" not in tdb.upgrade_state(ts_pl)
    same = tpl.upgrade_state(ts_pl)
    assert same["pipeline"] is ts_pl["pipeline"]
    for jopt, topt, js, ts in ((jpl, tpl, js_db, ts_db), (jdb, tdb, js_pl,
                                                          ts_pl),
                               (jpl, tpl, js_pl, ts_pl)):
        ju = jax.tree.map(np.asarray, jopt.upgrade_state(js))
        tu = convert.opt_state_to_jax(topt.upgrade_state(ts))
        assert jax.tree.structure(tu) == jax.tree.structure(ju)
        if "pipeline" in ju:
            assert int(tu["pipeline"]["cursor"]) == int(
                ju["pipeline"]["cursor"])


def test_interval_controller_min_interval_floor():
    ctrl = IntervalController(["x"], alpha=0.1, min_interval=K + 1)
    ctrl.update(1, {"x": True}, {"x": (0.9, 0.9)})
    st = ctrl.stats["x"]
    assert st.delta == K + 1 and st.t_next == 1 + (K + 1)
    ctrl.update(st.t_next, {"x": True}, {"x": (0.0, 0.0)})
    assert ctrl.stats["x"].delta == (K + 1) + 1
    rt = IntervalController.from_state_dict(ctrl.state_dict())
    assert rt.min_interval == K + 1
    legacy = ctrl.state_dict()
    del legacy["min_interval"]
    assert IntervalController.from_state_dict(legacy).min_interval == 1
    # the same decisions as repro's controller
    jc = JController(["x"], alpha=0.1, min_interval=K + 1)
    jc.update(1, {"x": True}, {"x": (0.9, 0.9)})
    jc.update(jc.stats["x"].t_next, {"x": True}, {"x": (0.0, 0.0)})
    assert jc.state_dict() == ctrl.state_dict()


# ---------------------------------------------------------------------------
# the full BN Fisher's unit (uwf): a ConvNet with bn_fisher="full"
# ---------------------------------------------------------------------------

def test_uwf_unit_drains_like_repro():
    """The ConvNet at widths (8, 16), one block, ``bn_fisher="full"``, under
    ``refresh_chunks`` K: the same LPT schedule and loads as ``repro``'s
    (each 2C x 2C ``uwf`` costed as a full block), then a capture, K drain
    steps and the flip, each taken from ``repro``'s state with its batch:
    the active and staged buffers (the ``uwf`` inverses among them), the
    raw store, the cursor and the params within 1e-4 of each array's
    largest entry."""
    from repro.models.resnet import ConvNet as JConvNet
    from repro.models.resnet import ConvNetConfig as JConvNetConfig
    from repro.core.ngd import NGDConfig as JNGDConfig
    from repro.core.ngd import SPNGD as JSPNGD
    from repro_torch.core.ngd import NGDConfig, SPNGD
    from repro_torch.models.resnet import ConvNet, ConvNetConfig
    kw = dict(widths=(8, 16), blocks_per_stage=1, bn_fisher="full")
    ngd = dict(damping=DAMP, double_buffer=True, refresh_chunks=K)
    jm = JConvNet(JConvNetConfig(**kw))
    jp = jm.init(jax.random.PRNGKey(0))
    jopt = JSPNGD(jm.loss, jm.site_infos(), jm.fstats, jm.site_counts,
                  JNGDConfig(**ngd))
    js = jopt.init(jp)
    tm = ConvNet(ConvNetConfig(**kw), device="cpu")
    topt = SPNGD(tm.loss, tm.site_infos(), tm.fstats, tm.site_counts,
                 NGDConfig(**ngd))
    assert topt.pipeline.schedule == jopt.pipeline.schedule
    assert topt.pipeline.loads == jopt.pipeline.loads
    assert any(key == "uwf" for chunk in topt.pipeline.schedule
               for _, key in chunk)
    rng = np.random.RandomState(3)
    x = rng.randn(6, 8, 8, 3).astype(np.float32)
    y = rng.randint(0, 10, 6)
    jb = {"images": jnp.asarray(x), "labels": jnp.asarray(y)}
    tb = {"images": torch.from_numpy(x), "labels": torch.from_numpy(y)}
    flags = {k: True for k in jopt.stat_names()}
    jstep, jfast = jax.jit(jopt.step), jax.jit(jopt.step_fast)
    for i in range(K + 2):
        np_p = jax.tree.map(np.asarray, jp)
        tm.load_state_dict(convert.params_from_jax(np_p, tm.cfg, "cpu"))
        ts = convert.opt_state_from_jax(jax.tree.map(np.asarray, js),
                                        tm.cfg, "cpu")
        if i == 0:
            jp, js, jmet = jstep(jp, js, jb, {k: jnp.asarray(v) for k, v
                                              in flags.items()},
                                 DAMP, LR, MOM)
            tp, ts, tmet = topt.step(tm.params(), ts, tb, flags, DAMP, LR,
                                     MOM)
        else:
            jp, js, jmet = jfast(jp, js, jb, DAMP, LR, MOM)
            tp, ts, tmet = topt.step_fast(tm.params(), ts, tb, DAMP, LR, MOM)
        assert tmet["refresh_inflight"] == int(jmet["refresh_inflight"]), i
        jst = jax.tree.map(np.asarray, js)
        tst = convert.opt_state_to_jax(ts)
        assert int(tst["pipeline"]["cursor"]) == int(
            jst["pipeline"]["cursor"]), i
        for path, want in _leaves({"curv": jst["curv"],
                                   "raw": jst["pipeline"]["raw"]}):
            got = _get({"curv": tst["curv"],
                        "raw": tst["pipeline"]["raw"]}, path)
            assert _rel(got, want) <= 1e-4, (i, path)
        for path, want in _leaves(jax.tree.map(np.asarray, jp)):
            assert _rel(_get(convert.params_to_jax(tp), path), want) \
                <= 1e-4, (i, path)
    # the flip made the drained uwf inverses active
    assert not np.array_equal(jst["curv"]["stem_bn"]["precond"]["uwf"], 0)


# ---------------------------------------------------------------------------
# against repro, step by step
# ---------------------------------------------------------------------------

def _ordinal(bits: np.ndarray) -> np.ndarray:
    mag = (bits & 0x7F).astype(np.int64)
    return np.where(bits >= 0x80, -mag, mag)


def _check_hist(got, want, where):
    if isinstance(want, dict):                   # fp8: payload and scale
        d = np.abs(_ordinal(got["payload"].view(np.uint8))
                   - _ordinal(want["payload"].view(np.uint8)))
        assert d.max() <= 1, where
        np.testing.assert_allclose(got["scale"], want["scale"], rtol=1e-5,
                                   err_msg=str(where))
    else:
        assert _rel(got, want) <= 1e-4, where


# the step sequence: (kind, mixed flags): a capture, K drains, a capture
# at cursor == K with IDLE's flags off (it flips first), K drains, the flip
SEQ = ([("capture", False)] + [("fast", False)] * K + [("capture", True)]
       + [("fast", False)] * (K + 1))


def _seq_kw(factor_dtype: str) -> dict:
    kw = {"double_buffer": True, "refresh_chunks": K}
    if factor_dtype != "f32":
        kw["factor_dtype"] = factor_dtype
    return kw


@functools.lru_cache(maxsize=None)
def _jax_start(factor_dtype: str):
    """repro's pipelined optimizer on the fixture: the initial params,
    state, batch and flags, and its jitted capture and fast steps (compiled
    once for the tests that share them)."""
    (jm, jopt, jp, js, jb, jflags), _ = _setup(damping=DAMP,
                                               ngd_kw=_seq_kw(factor_dtype))
    return (jp, js, jb, jflags, jax.jit(jmake_train_step(jm, jopt)),
            jax.jit(jmake_fast_step(jm, jopt)))


@functools.lru_cache(maxsize=None)
def _jax_seq(factor_dtype: str):
    """repro's pipelined run through SEQ: the state and params before each
    step and after the last, numpy leaves, and each step's inflight."""
    jp, js, jb, jflags, step, fast = _jax_start(factor_dtype)
    states, inflight = [], []
    for kind, mixed in SEQ + [(None, None)]:
        states.append(jax.tree.map(np.asarray, (jp, js)))
        if kind == "capture":
            fl = ({k: jnp.asarray(not k.startswith(IDLE + "."))
                   for k in jflags} if mixed else jflags)
            jp, js, m = step(jp, js, jb, fl, DAMP, LR, MOM)
        elif kind == "fast":
            jp, js, m = fast(jp, js, jb, DAMP, LR, MOM)
        if kind:
            inflight.append(int(m["refresh_inflight"]))
    return states, inflight


@pytest.mark.parametrize("factor_dtype", ["f32", "fp8_e4m3"])
def test_capture_drain_flip_match_repro_step_by_step(factor_dtype):
    """Each step of SEQ from repro's state and params before it: the
    port's state after it (both buffers, the raw store, the history, the
    cursor and valid latches), its params and its refresh_inflight agree
    with repro's. IDLE's encoded history passes the mixed capture bit for
    bit in both packages."""
    states, inflight = _jax_seq(factor_dtype)
    _, (tm, topt, _, tb, tflags) = _setup(damping=DAMP,
                                          ngd_kw=_seq_kw(factor_dtype))
    step, fast = make_train_step(tm, topt), make_fast_step(tm, topt)
    for i, (kind, mixed) in enumerate(SEQ):
        (jp0, js0), (jp1, js1) = states[i], states[i + 1]
        tm.load_state_dict(convert.params_from_jax(jp0, tm.cfg, "cpu"))
        ts = convert.opt_state_from_jax(js0, tm.cfg, "cpu")
        if kind == "capture":
            fl = _mixed(tflags) if mixed else tflags
            params, ts, m = step(tm.params(), ts, tb, fl, DAMP, LR, MOM)
        else:
            params, ts, m = fast(tm.params(), ts, tb, DAMP, LR, MOM)
        assert m["refresh_inflight"] == inflight[i], i
        got = convert.opt_state_to_jax(ts)
        assert jax.tree.structure(got) == jax.tree.structure(js1)
        assert int(got["pipeline"]["cursor"]) == int(
            js1["pipeline"]["cursor"])
        for (fam, key), v in _leaves(js1["pipeline"]["valid"]):
            assert bool(got["pipeline"]["valid"][fam][key]) == bool(v)
        for path, want in _leaves(js1["pipeline"]["raw"]):
            assert _rel(_get(got["pipeline"]["raw"], path), want) <= 1e-4, \
                (i, path)
        for fam, e in js1["curv"].items():
            for slot in ("precond", "precond_next"):
                for key, want in e[slot].items():
                    assert _rel(got["curv"][fam][slot][key], want) <= 1e-4, \
                        (i, fam, slot, key)
            for slot in ("prev", "prev2"):
                for key, want in e[slot].items():
                    _check_hist(got["curv"][fam][slot][key], want,
                                (i, fam, slot, key))
        for path, want in _leaves(jp1):
            assert _rel(_get(convert.params_to_jax(params), path),
                        want) <= 1e-4, (i, path)
        if mixed:          # the stale statistic's history, bit for bit
            for slot in ("prev", "prev2"):
                for key, enc in js0["curv"][IDLE][slot].items():
                    for a, b in ((got, js1), (js1, js0)):
                        for x, y in zip(jax.tree.leaves(
                                a["curv"][IDLE][slot][key]),
                                jax.tree.leaves(b["curv"][IDLE][slot][key])):
                            assert x.tobytes() == y.tobytes(), (slot, key)
    assert inflight == [K + 1] * 2 + [K] + [K + 1] * 2 + [K, 1]


@functools.lru_cache(maxsize=None)
def _jax_losses():
    jp, js, jb, jflags, step, fast = _jax_start("f32")
    out = []
    for t in range(1, 21):
        if t % (K + 1) == 1:
            jp, js, m = step(jp, js, jb, jflags, DAMP, LR, MOM)
        else:
            jp, js, m = fast(jp, js, jb, DAMP, LR, MOM)
        out.append(float(m["loss"]))
    return out


def test_twenty_step_losses_match_repro():
    """A capture every K+1 steps, the drains between: 20 losses."""
    want = _jax_losses()
    _, (tm, topt, ts, tb, tflags) = _setup(
        damping=DAMP, ngd_kw={"double_buffer": True, "refresh_chunks": K})
    step, fast = make_train_step(tm, topt), make_fast_step(tm, topt)
    params, got = tm.params(), []
    for t in range(1, 21):
        if t % (K + 1) == 1:
            params, ts, m = step(params, ts, tb, tflags, DAMP, LR, MOM)
        else:
            params, ts, m = fast(params, ts, tb, DAMP, LR, MOM)
        got.append(float(m["loss"]))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[:8], want[:8], rtol=1e-3, atol=1e-3)
    assert max(got[8:]) < 1.0 and max(want[8:]) < 1.0


MOE_STEPS = 10
MOE_KW = {"damping": DAMP, "double_buffer": True, "refresh_chunks": K}


def _moe_ctrl(cls, opt):
    return cls(opt.stat_names(), alpha=0.1, min_interval=K + 1,
               bytes_per_stat=opt.stat_bytes())


def jax_moe_controlled():
    """repro's side of the MoE controller run (in a process of its own on
    one CPU, ``jax_one_cpu``): each step's (flags, refresh_inflight, loss,
    distances), its controller's state and its routing indices."""
    jm, jopt, jp, js, jb, _ = _moe_jax_side("qwen2_moe_a2_7b", **MOE_KW)
    jc, out = _moe_ctrl(JController, jopt), []
    with _recorded_routes() as rec:
        jstep = jax.jit(jmake_train_step(jm, jopt))
        jfast = jax.jit(jmake_fast_step(jm, jopt))
        for t in range(1, MOE_STEPS + 1):
            flags = jc.flags(t)
            if any(flags.values()):
                jflags = {n: jnp.asarray(v) for n, v in flags.items()}
                jp, js, m = jstep(jp, js, jb, jflags, DAMP, LR, MOM)
                sims = {n: (float(v[0]), float(v[1]))
                        for n, v in m["sims"].items()}
            else:
                jp, js, m = jfast(jp, js, jb, DAMP, LR, MOM)
                sims = {}
            jc.update(t, flags, sims)
            out.append((flags, int(m["refresh_inflight"]), float(m["loss"]),
                        sims))
        jax.effects_barrier()
    return out, jc.state_dict(), rec["jax"]


def test_moe_pipelined_controller_run_matches_repro(_moe_child):
    """Reduced qwen2_moe_a2_7b (``tests/test_torch_moe_parity.py``'s
    fixture, this file's damping: at its 1e-3 both packages' double-buffered
    runs climb back from step 7 on) under the pipeline (K chunks, double
    buffer) with Algorithm 2's controller on (min interval K + 1), each
    package's controller fed its own step's distances, as both trainers run
    it: the LPT schedule and loads over the expert families' (L, E, nb, b,
    b) units, then at every step the same flags (captures at steps 1, 4, 7
    and 10, the last one leaving a statistic stale), the same
    refresh_inflight, distances and losses within 1e-4 and equal routing
    indices. repro's side is ``jax_moe_controlled``."""
    (_, jopt, *_), (tm, topt, ts, tb, _) = _moe_setup("qwen2_moe_a2_7b",
                                                      **MOE_KW)
    assert topt.pipeline.schedule == jopt.pipeline.schedule
    assert topt.pipeline.loads == jopt.pipeline.loads
    assert any(fam.startswith("blk/moe_we_")
               for chunk in topt.pipeline.schedule for fam, _ in chunk)
    tc, params, got = _moe_ctrl(IntervalController, topt), tm.params(), []
    with _recorded_routes() as rec:
        step, fast = make_train_step(tm, topt), make_fast_step(tm, topt)
        for t in range(1, MOE_STEPS + 1):
            flags = tc.flags(t)
            if any(flags.values()):
                params, ts, m = step(params, ts, tb, flags, DAMP, LR, MOM)
            else:
                params, ts, m = fast(params, ts, tb, DAMP, LR, MOM)
            tc.update(t, flags, m["sims"])
            got.append((flags, m["refresh_inflight"], float(m["loss"]),
                        m["sims"]))
    want, jstate, jroutes = _moe_child.result()
    for t, ((jf, ji, jl, jsims), (tf, ti, tl, tsims)) in enumerate(
            zip(want, got), 1):
        assert tf == jf and ti == ji, t
        assert abs(tl - jl) <= 1e-4 * max(1.0, abs(jl)), t
        assert set(tsims) == set(jsims), t
        for n, v in jsims.items():
            np.testing.assert_allclose(tsims[n], v, rtol=1e-4, atol=1e-4,
                                       err_msg=f"step {t} {n}")
    captures = [t for t, (f, *_) in enumerate(got, 1) if any(f.values())]
    assert captures == [1, 4, 7, 10]
    assert any(0 < sum(f.values()) < len(f) for f, *_ in got)
    assert tc.state_dict() == jstate
    assert len(rec["torch"]) == len(jroutes) == MOE_STEPS * tm.cfg.n_layers
    for i, (t, j) in enumerate(zip(rec["torch"], jroutes)):
        np.testing.assert_array_equal(t, j, err_msg=f"router call {i}")


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv,k,db,floor", [
    ([], 1, False, 1), (["--refresh-chunks", "3"], 3, True, 4),
    (["--refresh-chunks", "2", "--double-buffer"], 2, True, 3)])
def test_train_cli_refresh_chunks_reach_the_optimizer_and_controller(
        monkeypatch, argv, k, db, floor):
    from repro_torch.core import stale
    seen = {}

    class Spy(stale.IntervalController):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen["min_interval"] = self.min_interval

    monkeypatch.setattr(stale, "IntervalController", Spy)
    real_run = train.run

    def run(model, opt, params, state, **kw):
        seen.update(cfg=opt.cfg, state=state)
        kw.update(steps=2, batch=2, seq=8)
        return real_run(model, opt, params, state, **kw)

    monkeypatch.setattr(train, "run", run)
    train.main(["--device", "cpu"] + argv)
    assert seen["cfg"].refresh_chunks == k
    assert seen["cfg"].double_buffer is db
    assert ("pipeline" in seen["state"]) is (k > 1)
    assert seen["min_interval"] == floor


def test_run_records_inflight_and_chunks():
    """launch.train.run on the pipeline: no capture within K steps of a
    capture, the inflight sequence, and each drain step's chunk."""
    model, opt, params, state, _, _ = _port(refresh_chunks=K)
    _, _, recs = train.run(model, opt, params, state, steps=2 * (K + 1) + 1,
                           batch=2, seq=8, damping=DAMP, log=lambda m: None)
    kinds = [r["kind"] for r in recs]
    assert kinds == (["capture"] + ["fast"] * K) * 2 + ["capture"]
    assert [r["refresh_inflight"] for r in recs] == \
        [K + 1, K + 1, K] * 2 + [K + 1]
    for r in recs:
        if r["kind"] == "fast":
            assert r["chunk_stats"] == opt.pipeline.chunk_names(r["chunk"])
        else:
            assert "chunk" not in r
