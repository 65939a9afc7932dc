"""repro_torch.obs against repro.obs, on the CPU.

The stage and kernel range names, ``Span``, the two ``MetricsLogger``s
driven by the same calls (JSON lines equal once the wall-clock fields are
removed), ``inverse_tally`` on identical arrays, the port's CLI stream
(``repro``'s keys per event type and its ``kind`` vocabulary, losses bit
for bit those of a run without the stream, comm drains summing to the
summary, ``make_report``'s decomposition table), a ``torch.profiler`` trace
of a port step, ``ProfileCapture``, and ``NGDConfig.inverse_info`` against
``repro``'s tally on converted weights.
"""

import contextlib
import importlib.util
import inspect
import io
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.train as jtrain
from repro import obs as jobs
from repro.core.ngd import NGDConfig as JNGDConfig
from repro.core.ngd import SPNGD as JSPNGD
from repro.core.ngd import _dense_leaf_shape as jdense_leaf_shape
from repro_torch import obs
from repro_torch.core import stale
from repro_torch.core.ngd import NGDConfig, SPNGD
from repro_torch.launch import train

from test_torch_train_parity import _setup

ROOT = Path(__file__).resolve().parents[1]
CLI = ["--device", "cpu", "--steps", "6", "--batch", "2", "--seq", "16"]
# the wall-clock fields of a stream line, which no two runs share
CLOCK_FIELDS = ("t_wall", "start", "dur")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the machine's cores: this module's torch ops
    run on one thread (the models are tiny)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# names
# ---------------------------------------------------------------------------

def _jax_scope_name(scope) -> str:
    """The name stack ``repro``'s named_scope gives a traced op."""
    def f(x):
        with scope:
            return x * 2.0
    eqn = jax.make_jaxpr(f)(1.0).jaxpr.eqns[0]
    return str(eqn.source_info.name_stack)


def test_public_names_and_constants_match_repro():
    assert obs.__all__ == jobs.__all__
    assert obs.SCHEMA_VERSION == jobs.SCHEMA_VERSION
    for name in jobs.__all__:
        if name.startswith("STAGE_"):
            assert getattr(obs, name) == getattr(jobs, name), name


@pytest.mark.parametrize("op,which,jwhich", [
    ("factor_sum", "ref", "ref"), ("block_precond_left", "cuda", "pallas"),
    ("damped_inverse", "ref", "ref")])
def test_scope_names_are_repros(op, which, jwhich):
    """The port's ranges carry the name ``repro``'s named_scopes give a
    traced op, the backend word the port's own (``cuda`` for ``pallas``);
    they are ranges while a profiler records, null contexts otherwise."""
    from torch.profiler import ProfilerActivity, profile
    stages = [getattr(obs, s) for s in ("STAGE_CAPTURE", "STAGE_INVERSE",
                                        "STAGE_PRECOND")]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.kernel_scope(op, which):
            torch.ones(2).sum()
        for name in stages:
            with obs.stage_scope(name):
                torch.ones(2).sum()
    got = {e.name for e in prof.events()}
    assert _jax_scope_name(jobs.kernel_scope(op, jwhich)).replace(
        jwhich, which) in got
    assert {_jax_scope_name(jobs.stage_scope(n)) for n in stages} <= got
    assert not torch.autograd._profiler_enabled()
    assert isinstance(obs.kernel_scope(op, which), contextlib.nullcontext)
    assert isinstance(obs.stage_scope(stages[0]), contextlib.nullcontext)


# ---------------------------------------------------------------------------
# Span
# ---------------------------------------------------------------------------

def _span_records(pkg) -> list:
    recs = []
    with pkg.Span("outer", sink=recs.append, annotate=False) as outer:
        with pkg.Span("mid", sink=recs.append, annotate=False):
            with pkg.Span("inner", sink=recs.append, annotate=False):
                pass
        with pytest.raises(ValueError):
            with pkg.Span("boom", sink=recs.append, annotate=False):
                raise ValueError("unwinds")
        with pkg.Span("after", sink=recs.append):
            pass
    assert outer.dur >= max(r.dur for r in recs[:-1])
    return recs


def test_span_nesting_unwinding_and_sink_match_repro():
    got, want = _span_records(obs), _span_records(jobs)
    assert [(r.name, r.depth, r.parent) for r in got] == \
        [(r.name, r.depth, r.parent) for r in want] == [
            ("inner", 2, "mid"), ("mid", 1, "outer"), ("boom", 1, "outer"),
            ("after", 1, "outer"), ("outer", 0, None)]
    assert all(r.dur >= 0 and r.start > 0 for r in got)
    from repro_torch.obs import tracing
    assert tracing._ACTIVE == []          # the stack unwound
    s = obs.Span("alone")                 # no sink: times itself
    with s:
        pass
    assert s.dur >= 0 and s.sink is None


# ---------------------------------------------------------------------------
# MetricsLogger
# ---------------------------------------------------------------------------

def _drive(pkg, stream):
    log = pkg.MetricsLogger(stream=stream, hist_window=4)
    log.emit("run_config", arch="x", steps=3)
    log.console("hello")
    for t, dt in enumerate([0.5, 0.25, 0.75, 0.125, 1.0], start=1):
        log.log_step(t, loss=1.0 / t, dt=dt, kind="fast", lr=0.1)
    log.log_step(6, loss=0.1)
    with log.span("phase"):
        with log.span("sub"):
            pass
    log.emit("summary", steps=6)
    return log


def _clean(text: str) -> list:
    out = []
    for line in text.splitlines():
        evt = json.loads(line)
        for k in CLOCK_FIELDS:
            assert k not in evt or evt.pop(k) >= 0
        out.append(evt)
    return out


@pytest.mark.parametrize("enabled", [True, False])
def test_loggers_write_the_same_lines(enabled, capsys):
    got, want = (io.StringIO(), io.StringIO()) if enabled else (None, None)
    a, b = _drive(obs, got), _drive(jobs, want)
    out = capsys.readouterr().out
    assert out == "hello\nhello\n"            # the console text, both
    assert a.enabled == b.enabled == enabled
    assert a.events_written == b.events_written
    if enabled:
        assert _clean(got.getvalue()) == _clean(want.getvalue())
        steps = [e for e in _clean(got.getvalue()) if e["type"] == "step"]
        assert steps[3]["dt_p50"] == 0.5 and steps[4]["dt_p99"] == 1.0


def test_logger_path_stream_and_disabled_file(tmp_path):
    with pytest.raises(ValueError):
        obs.MetricsLogger(path=str(tmp_path / "x"), stream=io.StringIO())
    _drive(obs, None).close()
    assert list(tmp_path.iterdir()) == []     # disabled: no file
    p = tmp_path / "m.jsonl"
    with obs.MetricsLogger(str(p)) as log:
        log.emit("summary", steps=1)
    assert not log.enabled
    assert json.loads(p.read_text())["type"] == "summary"
    s = io.StringIO()
    obs.MetricsLogger(stream=s).close()       # a stream is not owned
    assert not s.closed


# ---------------------------------------------------------------------------
# inverse_tally
# ---------------------------------------------------------------------------

def test_inverse_tally_matches_repro():
    rng = np.random.default_rng(4)
    res = rng.uniform(0, 2e-4, (3, 4)).astype(np.float32)
    res[1] = -1.0                               # a family kept this step
    conv = res <= 1e-4
    info = {"f.a": {"ns_res": res, "ns_converged": conv},
            "f.g": {"ns_res": np.full((2,), -1.0, np.float32),
                    "ns_converged": np.ones((2,), bool)},
            "h.a": {"ns_res": np.zeros((5,), np.float32),
                    "ns_converged": np.ones((5,), bool)}}
    sizes = {"f.a": 64, "f.g": 128, "h.a": 64}
    want = jobs.inverse_tally(info, sizes)
    assert obs.inverse_tally(info, sizes) == want
    tinfo = {n: {k: torch.from_numpy(np.asarray(v)) for k, v in i.items()}
             for n, i in info.items()}
    assert obs.inverse_tally(tinfo, sizes) == want
    assert want["stats"]["f.g"]["refreshed_blocks"] == 0
    assert want["stats"]["f.a"]["refreshed_blocks"] == 8


# ---------------------------------------------------------------------------
# the CLI stream
# ---------------------------------------------------------------------------

def _repro_emit_keys(event: str) -> set:
    """The keyword fields of ``repro``'s ``log.emit(event, ...)`` call in
    its CLI loop, read from its source."""
    src = inspect.getsource(jtrain)
    start = src.index(f'log.emit("{event}"')
    call, depth = "", 0
    for ch in src[start:]:
        call += ch
        depth += ch == "("
        depth -= ch == ")"
        if depth == 0 and ch == ")":
            break
    import re
    return set(re.findall(r"(\w+)=", call))


# repro's step-event fields (src/repro/launch/train.py:583-618), besides
# log_step's own step, loss, dt, dt_ema, dt_p50, dt_p99
STEP_KEYS = {"kind", "lr", "mom", "n_refreshed", "n_stats", "refreshed",
             "grad_norm", "update_norm", "comm"}
# the run_config fields of the port's own flags, which repro has not
PORT_FLAGS = {"device", "estimator", "weight_rescale", "history",
              "sgd_fallback_scale", "factor_wire"}


@pytest.fixture
def _similar_always(monkeypatch):
    """Alpha 1e9: every statistic reads "similar", so Algorithm 2 grows the
    intervals and a short run mixes refresh and fast steps (the random-init
    distances of the tiny model exceed the default 0.1 every step)."""
    init = stale.IntervalController.__init__

    def patched(self, names, alpha=0.1, **kw):
        init(self, names, alpha=1e9, **kw)
    monkeypatch.setattr(stale.IntervalController, "__init__", patched)


def _events(path: Path) -> list:
    return [json.loads(line) for line in path.read_text().splitlines()]


@pytest.mark.parametrize("chunks", [1, 2])
def test_cli_stream_matches_repros_and_leaves_the_run_alone(
        tmp_path, _similar_always, chunks):
    argv = CLI + ["--refresh-chunks", str(chunks)]
    path = tmp_path / "experiments" / "metrics_torch.jsonl"
    path.parent.mkdir()
    _, _, recs = train.main(argv + ["--metrics-jsonl", str(path)])
    _, _, plain = train.main(argv)
    evts = _events(path)
    by_type: dict = {}
    for e in evts:
        assert e["v"] == 1 and isinstance(e["t_wall"], float)
        by_type.setdefault(e["type"], []).append(e)
    drains = [r for r in recs if "chunk" in r]
    assert {k: len(v) for k, v in by_type.items() if k != "console"} == \
        {"run_config": 1, "probe": 1, "step": 6, "summary": 1,
         **({"span": len(drains)} if drains else {})}
    assert [e["text"] for e in by_type["console"]][1] == \
        f"step    1 capture loss {recs[0]['loss']:.4f} lr 0.0200 refresh " \
        f"21/21 {recs[0]['seconds']:.3f} s"

    cfg = by_type["run_config"][0]
    want = _repro_emit_keys("run_config")
    assert want <= set(cfg) and set(cfg) - want - {"v", "type",
                                                    "t_wall"} == PORT_FLAGS
    assert cfg["refresh_chunks"] == chunks and cfg["full_config"] is False
    probe = by_type["probe"][0]
    assert set(probe) - {"v", "type", "t_wall"} == _repro_emit_keys("probe")
    assert all(v > 0 for k, v in probe.items() if k.endswith("_us"))
    assert len(probe["inverse_us_per_stat"]) == 16
    summary = by_type["summary"][0]
    assert set(stale.IntervalController(["x"]).summary_flat()) < set(summary)

    steps = by_type["step"]
    # the stream's losses are a default run's, bit for bit: the probe
    # restored the weights, the momentum and the RNG
    assert [e["loss"] for e in steps] == [r["loss"] for r in recs] == \
        [r["loss"] for r in plain]
    assert all(math.isfinite(e["loss"]) for e in steps)
    for e in steps:
        assert STEP_KEYS | {"step", "loss", "dt", "dt_ema", "dt_p50",
                            "dt_p99"} <= set(e)
    kinds = [e["kind"] for e in steps]
    if chunks == 1:
        assert kinds == ["refresh" if r["kind"] == "capture" else "fast"
                         for r in recs]
        assert "refresh" in kinds and "fast" in kinds
        assert all(("inverse" in e) == (e["kind"] == "refresh")
                   for e in steps)
        inv = steps[0]["inverse"]
        assert inv["stats"]["blk/attn_wq.a"]["fallback_blocks"] == 0
        assert sum(v["refreshed_blocks"]
                   for v in inv["by_block_size"].values()) == sum(
            s["refreshed_blocks"] for s in inv["stats"].values()) > 0
    else:
        assert kinds == [r["kind"] for r in recs] and "fast" in kinds
        assert [e["refresh_inflight"] for e in steps] == \
            [r["refresh_inflight"] for r in recs]
        assert [e["refresh_inflight"] for e in steps[:3]] == [3, 3, 2]
        spans = by_type["span"]
        names = [r["chunk"] if r["chunk"] < 2 else "flip" for r in drains]
        assert [(s["name"], s["step"], s["stats"]) for s in spans] == [
            (f"spngd.pipeline.chunk[{n}]", r["t"], r["chunk_stats"])
            for n, r in zip(names, drains)]
        assert spans[0]["name"] == "spngd.pipeline.chunk[0]"
        assert spans[0]["stats"] and spans[1]["stats"]
        assert all("inverse" not in e for e in steps)
    # the comm drains sum to the summary's counters exactly
    totals: dict = {}
    for e in steps:
        for k, v in e["comm"].items():
            totals[k] = totals.get(k, 0) + v
    assert totals and all(summary[k] == v for k, v in totals.items())
    assert summary["steps"] == 6

    # make_report, unchanged and loaded by path, reads the stream
    spec = importlib.util.spec_from_file_location(
        "make_report", ROOT / "experiments" / "make_report.py")
    report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(report)
    out = io.StringIO()
    with contextlib.chdir(tmp_path), contextlib.redirect_stdout(out):
        report.overhead_section()
    text = out.getvalue()
    assert "| component | isolated us | amortized us |" in text
    for row in ("forward/backward", "Stage-4 precondition apply",
                "Stage-2 capture (extra)", "Stage-4 inverse"):
        assert f"| {row} |" in text
    assert "`llama3_2_1b`, 6 steps" in text


def test_cli_trace_names_the_stages_and_kernels(tmp_path):
    train.main(CLI[:3] + ["2", "--batch", "2", "--seq", "16",
                          "--profile-dir", str(tmp_path),
                          "--profile-steps", "1"])
    names = {e.get("name") for e in json.loads(
        (tmp_path / "trace.json").read_text())["traceEvents"]}
    for name in ("spngd.stage2.capture", "spngd.stage4.inverse",
                 "spngd.stage4.precond", "repro.kernels.factor_sum[ref]",
                 "repro.kernels.block_precond_left[ref]",
                 "repro.kernels.damped_inverse[ref]"):
        assert name in names, name


# ---------------------------------------------------------------------------
# profiler ranges and ProfileCapture
# ---------------------------------------------------------------------------

def test_profiler_trace_of_a_port_step_shows_the_ranges():
    model, opt, params, state = train.build(device="cpu")
    step = train.make_train_step(model, opt)
    fast = train.make_fast_step(model, opt)
    batch = {"tokens": torch.randint(0, model.cfg.vocab, (2, 16),
                                     generator=torch.Generator()
                                     .manual_seed(0))}
    batch["labels"] = batch["tokens"].roll(-1, 1)
    flags = {k: True for k in opt.stat_names()}
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        params, state, _ = step(params, state, batch, flags, 2.5e-4, 1e-3,
                                0.9)
    names = {e.key for e in prof.key_averages()}
    for name in ("spngd.stage2.capture", "spngd.stage4.inverse",
                 "spngd.stage4.precond", "repro.kernels.factor_sum[ref]",
                 "repro.kernels.damped_inverse[ref]"):
        assert name in names, name
    precond = [e for e in prof.events() if e.name == "spngd.stage4.precond"]
    assert len(precond) == len(opt.infos)       # one range per family
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fast(params, state, batch, 2.5e-4, 1e-3, 0.9)
    names = {e.key for e in prof.key_averages()}
    assert "spngd.stage4.precond" in names
    assert "spngd.stage2.capture" not in names   # a fast step: no capture


def test_profile_capture_traces_n_steps_then_stops(tmp_path):
    cap = obs.ProfileCapture(str(tmp_path / "trace"), steps=2, device="cpu")
    for t in range(1, 4):
        cap.step_start(t)
        with obs.stage_scope(f"probe.step{t}"):
            torch.ones(8).sum()
        cap.step_end(t)
        assert cap.done == (t >= 2)
    cap.stop()
    names = {e.get("name") for e in json.loads(
        Path(cap.path).read_text())["traceEvents"]}
    assert {"probe.step1", "probe.step2"} <= names
    assert "probe.step3" not in names
    inert = obs.ProfileCapture(None)
    inert.step_start(1)
    inert.step_end(1)
    inert.stop()
    assert inert.done and inert.path is None


# ---------------------------------------------------------------------------
# NGDConfig.inverse_info
# ---------------------------------------------------------------------------

def test_inverse_info_off_leaves_the_metrics_tree():
    _, (tm, topt, ts, tb, tflags) = _setup()
    assert NGDConfig().inverse_info is False
    _, _, m = topt.step(tm.params(), ts, tb, tflags, 1e-3, 5e-3, 0.9)
    assert "inverse_info" not in m
    assert {"loss", "sims", "grad_norm", "update_norm"} <= set(m)


def test_inverse_info_eigh_tally_matches_repro():
    """``inverse_info=True`` under eigh: the tally of a step with one
    family kept equals ``repro``'s on the same converted weights."""
    (jm, _, jp, js, jb, jflags), (tm, _, ts, tb, tflags) = _setup()
    jopt = JSPNGD(jm.loss, jm.site_infos(), jm.fstats, jm.site_counts,
                  JNGDConfig(damping=1e-3, backend="ref", inverse_info=True))
    topt = SPNGD(tm.loss, tm.site_infos(), tm.fstats, tm.site_counts,
                 NGDConfig(damping=1e-3, inverse_info=True))
    kept = "blk/mlp_up"
    jflags = {k: jnp.asarray(not k.startswith(kept)) for k in jflags}
    tflags = {k: not k.startswith(kept) for k in tflags}
    _, _, jm_ = jax.jit(jopt.step)(jp, js, jb, jflags, 1e-3, 5e-3, 0.9)
    _, _, tm_ = topt.step(tm.params(), ts, tb, tflags, 1e-3, 5e-3, 0.9)
    sizes = {f"{fam}.{key}": jdense_leaf_shape(leaf)[-1]
             for fam, stats in jax.eval_shape(jm.fstats).items()
             for key, leaf in stats.items()
             if key in ("a", "g") and jopt.sym_stat(fam, key)}
    want = jobs.inverse_tally(jax.tree.map(np.asarray, jm_["inverse_info"]),
                              sizes)
    got = obs.inverse_tally(tm_["inverse_info"], sizes)
    assert got == want
    assert got["stats"][f"{kept}.a"]["refreshed_blocks"] == 0
    assert got["stats"]["blk/attn_wq.a"]["refreshed_blocks"] > 0
