"""The fused fp8 capture of the MoE family (``ArchConfig.factor_wire``)
against the JAX package, on the CPU through the plain versions.

Reduced ``mixtral_8x22b`` and ``qwen2_moe_a2_7b`` with ``factor_wire=
"e4m3"``: every full-kind factor, the experts' grouped sites with their
expert axis included (payload ``(L, E, nb, t)``, scales ``(L, E, nb)``),
is captured in the wire format. The fixture is
``tests/test_torch_moe_parity.py``'s (the same ``PRNGKey(0)`` params drawn
under ``jax.threefry_partitionable(False)``, batch (4, 16), damping 1e-3,
every refresh flag set); ``repro``'s side runs in a process of its own on
one CPU (``tests/jax_one_cpu.py``, the jobs in ``tests/jax_side_jobs.py``).
Tolerances:

* the captured scales within 1e-5 relative (measured 5.3e-6 at most, on
  qwen2_moe's experts' G: the f32 backward in another order; the A
  scales 1.8e-6);
* the payload codes at most one e4m3 step off, on at most 1e-3 of them
  (the f32 sums in another order, ROADMAP's mixtral finding);
* the loss and every param after one capture step within 1e-4 of the
  largest entry, or within twice ``repro``'s own move when its params move
  by one f32 ulp (``test_torch_moe_parity.py``'s rule).

The kernel route over a leading axis (``dispatch._factor_sum_wire_cuda``:
one ``factor_syrk_wire`` launch for b <= 1024, else ``factor_syrk`` then
``sym_pack`` then one ``quant_rows`` over the flattened rows) is run here
with the kernel wrappers replaced by their plain versions; the kernels
themselves run on the card (``chip_smoke.py check_fp8_kernels``).
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.comm import comm as jcomm
from repro.configs import get_config as jget_config
from repro.core.ngd import NGDConfig as JNGDConfig
from repro.core.ngd import SPNGD as JSPNGD
from repro.launch import compat
from repro.models.transformer import DecoderLM as JDecoderLM
from repro_torch import convert
from repro_torch.comm import comm as tcomm
from repro_torch.configs import get_config
from repro_torch.core import kfac
from repro_torch.core.ngd import NGDConfig, SPNGD
from repro_torch.kernels import dispatch, ref
from repro_torch.kernels import kfac as kern
from repro_torch.kernels import quant as qk
from repro_torch.launch import sharding
from repro_torch.launch.train import make_train_step
from repro_torch.models.transformer import DecoderLM
import jax_one_cpu
from test_torch_fp8_train_parity import _ordinal
from test_torch_moe_parity import DAMP, LR, MOM, REL, _batch
from test_torch_train_parity import _get, _leaves, _rel

ARCHS = ["mixtral_8x22b", "qwen2_moe_a2_7b"]
WIRE = "e4m3"
SCALE_REL = 1e-5
CODE_SHARE = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_children: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _jax_children():
    for arch in ARCHS:
        _children[arch] = jax_one_cpu.start(
            "jax_side_jobs", "moe_wire_capture", arch, WIRE,
            _batch(get_config(arch).reduced().vocab), DAMP, LR, MOM)
    _children["routes"] = jax_one_cpu.start(
        "jax_side_jobs", "wire_routes",
        [(_route_input(lead, n, d), max_dim)
         for lead, n, d, max_dim, _ in ROUTE_CASES], WIRE)
    yield
    for child in _children.values():
        child.close()


def _jcfg(arch):
    return dataclasses.replace(jget_config(arch).reduced(), backend="ref",
                               factor_wire=WIRE)


@functools.lru_cache(maxsize=None)
def _runs(arch):
    """(repro's results, the port's raw wire sums, loss, step loss and
    params after one step from the same params and state)."""
    j = _children[arch].result()
    (jp, js), *_ = j
    cfg = dataclasses.replace(get_config(arch).reduced(), factor_wire=WIRE)
    tm = DecoderLM(cfg, device="cpu")
    tm.load_state_dict(convert.params_from_jax(jp, cfg, "cpu"))
    topt = SPNGD(tm.loss, tm.site_infos(), tm.fstats, tm.site_counts,
                 NGDConfig(damping=DAMP))
    ts = convert.opt_state_from_jax(js, cfg, "cpu")
    tb = {k: torch.from_numpy(v) for k, v in _batch(cfg.vocab).items()}
    loss, _, _, raw = topt.grads_and_raw(tm.params(), tb)
    flags = {k: True for k in topt.stat_names()}
    p1, _, m = make_train_step(tm, topt)(tm.params(), ts, tb, flags, DAMP,
                                         LR, MOM)
    return j, (convert.stats_to_jax(raw), float(loss), float(m["loss"]),
               jax.tree.map(np.array, convert.params_to_jax(p1)))


@pytest.mark.parametrize("arch", ARCHS)
def test_expert_wire_capture_matches_repro(arch):
    """Every wire-format statistic, the experts' (L, E, nb, t) payloads
    among them: the same shapes and dtypes, scales within SCALE_REL,
    payload codes at most one e4m3 step off on at most 1e-3 of them; the
    embedding's G captured dense in both packages."""
    (_, jraw, jloss, *_), (traw, tloss, *_) = _runs(arch)
    assert abs(tloss - jloss) <= REL * abs(jloss)
    n_wire = n_expert = 0
    for fam, entry in jraw.items():
        for key, want in entry.items():
            if not isinstance(want, dict):
                continue
            got = traw[fam][key]
            n_wire += 1
            assert got["payload"].shape == want["payload"].shape, (fam, key)
            assert got["payload"].dtype == want["payload"].dtype
            if fam.startswith("blk/moe_we_"):
                n_expert += 1
                e = get_config(arch).reduced().n_experts
                assert want["payload"].shape[1] == e, (fam, key)
            s_rel = np.abs(got["scale"] - want["scale"]) / np.abs(
                want["scale"])
            assert s_rel.max() <= SCALE_REL, (fam, key, s_rel.max())
            d = np.abs(_ordinal(got["payload"].view(np.uint8)).astype(
                np.int64) - _ordinal(want["payload"].view(np.uint8)))
            assert d.max() <= 1, (fam, key)
            assert (d > 0).mean() <= CODE_SHARE, (fam, key, (d > 0).mean())
    assert n_expert == 6 and n_wire > n_expert
    assert not isinstance(jraw["embed"]["g"], dict)
    assert not isinstance(traw["embed"]["g"], dict)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_wire_capture_step_matches_repro(arch):
    """One capture step with the experts' wire capture: loss and every
    param within 1e-4, or twice repro's own ulp-moved move."""
    (_, _, _, jstep_loss, jp1, mp1), (_, _, tstep_loss, tp1) = _runs(arch)
    assert np.isfinite(tstep_loss)
    assert abs(tstep_loss - jstep_loss) <= REL * abs(jstep_loss)
    for path, want in _leaves(jp1):
        bound = max(REL, 2 * _rel(_get(mp1, path), want))
        assert _rel(_get(tp1, path), want) <= bound, path


def _plain_kernels(monkeypatch):
    """The kernel wrappers of the wire route replaced by their plain
    versions, each call counted: {wrapper: calls}."""
    calls = {"factor_syrk_wire": 0, "factor_syrk": 0, "quant_rows": 0}

    def counted(name, fn):
        def run(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return run
    monkeypatch.setattr(qk, "factor_syrk_wire", counted(
        "factor_syrk_wire", lambda x, m, f, s: ref.factor_sum_wire_ref(
            x, m, f, s)))
    monkeypatch.setattr(kern, "factor_syrk", counted(
        "factor_syrk", ref.factor_sum_ref))
    monkeypatch.setattr(qk, "quant_rows", counted(
        "quant_rows", lambda x, f, s: ref.quant_rows_ref(x, f, s)))
    return calls


ROUTE_CASES = [
    ((3,), 40, 200, 128, "fused"),         # b 100: one fused launch
    ((2, 3), 24, 96, 64, "fused"),         # (L, E) leading axes
    ((3,), 24, 2050, 2048, "unfused"),     # b 1025 > 1024
    ((2, 2), 16, 1100, 2048, "unfused"),   # b 1100, one block
]


def _route_input(lead, n, d):
    return np.random.RandomState(11).randn(*lead, n, d).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_routes():
    return _children["routes"].result()


@pytest.mark.parametrize("case", range(len(ROUTE_CASES)))
def test_wire_route_over_a_leading_axis(monkeypatch, case):
    """The cuda entry of factor_sum_wire over leading axes, the kernels
    replaced by their plain versions: one fused call for b <= 1024; past
    it one factor_syrk call over the lead, then one quant_rows call over
    the flattened rows. Payload and scales equal the plain
    factor_sum_wire_ref's bit for bit, and repro's ref factor_sum_wire's
    within SCALE_REL and one e4m3 step (the f32 sums in another order)."""
    lead, n, d, max_dim, route = ROUTE_CASES[case]
    calls = _plain_kernels(monkeypatch)
    x = _route_input(lead, n, d)
    p, s = dispatch.lookup("factor_sum_wire", "cuda")(
        torch.from_numpy(x), max_dim, WIRE, "fp32")
    b = kfac.block_size(d, max_dim)
    assert (b <= dispatch.FACTOR_WIRE_MAX_DIM) == (route == "fused")
    want = {"fused": {"factor_syrk_wire": 1, "factor_syrk": 0,
                      "quant_rows": 0},
            "unfused": {"factor_syrk_wire": 0, "factor_syrk": 1,
                        "quant_rows": 1}}[route]
    assert calls == want
    nb = kfac.num_blocks(d, max_dim)
    assert p.shape == (*lead, nb, b * (b + 1) // 2) and s.shape == (*lead, nb)
    rp, rs = ref.factor_sum_wire_ref(torch.from_numpy(x), max_dim, WIRE)
    assert torch.equal(s, rs) and torch.equal(p.view(torch.uint8),
                                              rp.view(torch.uint8))
    jp, js = _jax_routes()[case]
    assert np.abs(s.numpy() - js).max() <= SCALE_REL * np.abs(js).max()
    d8 = np.abs(_ordinal(p.view(torch.uint8).numpy()).astype(np.int64)
                - _ordinal(jp))
    assert d8.max() <= 1 and (d8 > 0).mean() <= CODE_SHARE


def test_trainer_cli_takes_the_expert_wire_capture(capsys):
    """``--arch mixtral_8x22b --factor-wire e4m3 --device cpu`` trains:
    finite losses, the experts' history built from wire captures."""
    from repro_torch.launch import train
    params, state, recs = train.main(["--device", "cpu", "--arch",
                                      "mixtral_8x22b", "--factor-wire",
                                      WIRE, "--steps", "2", "--batch", "2",
                                      "--seq", "16"])
    assert len(recs) == 2 and np.isfinite([r["loss"] for r in recs]).all()
    assert "capture e4m3" in capsys.readouterr().out
    assert state["curv"]["blk/moe_we_up"]["prev"]["a"].shape[:2] == (2, 4)


@pytest.mark.parametrize("arch", ARCHS)
def test_fused_reducer_wire_bytes_with_expert_template(arch):
    """FactorReducer ``fused`` with an MoE wire template on a shape-only
    (2, 4) mesh: per-statistic wire bytes, gather bytes and scatter
    decisions equal repro's reducer on a (2, 4) mesh of the 8 host devices
    (repro's reducer reads only axis names and sizes, but the comparison is
    with what its dry run builds: a real Mesh)."""
    jm = JDecoderLM(_jcfg(arch))
    jtemplate = jax.eval_shape(jm.fstats)
    cfg = dataclasses.replace(get_config(arch).reduced(), factor_wire=WIRE)
    tm = DecoderLM(cfg, device="meta")
    jopt = JSPNGD(jm.loss, jm.site_infos(), jm.fstats, jm.site_counts,
                  JNGDConfig(backend="ref"))
    topt = SPNGD(tm.loss, tm.site_infos(), tm.fstats, tm.site_counts,
                 NGDConfig())
    mesh = compat.make_mesh((2, 4), ("data", "model"))
    jred = jcomm.FactorReducer(mesh, manual_axes="all",
                               comm=jcomm.make_comm_config("fused"),
                               template=jtemplate, sym_fn=jopt.sym_stat)
    tred = tcomm.FactorReducer(sharding.ShapeMesh((2, 4), ("data", "model")),
                               manual_axes="all",
                               comm=tcomm.make_comm_config("fused"),
                               template=tm.fstats(), sym_fn=topt.sym_stat)
    assert any(isinstance(v, dict) and len(v["payload"].shape) == 4
               for v in tm.fstats()["blk/moe_we_up"].values())
    assert tred.wire_bytes_per_stat() == jred.wire_bytes_per_stat()
    assert tred.gather_bytes_per_stat() == jred.gather_bytes_per_stat()
    assert tred.replicated == jred.replicated
    assert tred.scatter_report() == jred.scatter_report()
