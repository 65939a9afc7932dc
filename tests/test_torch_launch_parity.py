"""The port's launch layer (``repro_torch.launch.sharding``, ``.roofline``,
``.dryrun``, ``DecoderLM.input_specs``, ``configs.base.INPUT_SHAPES``)
against ``repro``'s, on the CPU, with no compilation of a large program.

* ``INPUT_SHAPES``, ``effective_config``, ``pick_accum``, ``count_params``,
  ``active_param_fraction``, ``_active_params`` and ``model_flops_*``
  equal ``repro``'s for every LM arch and shape, exactly.
* ``input_specs`` shapes equal ``repro``'s ``ShapeDtypeStruct``s, dtypes
  mapped (the decode cache against ``jax.eval_shape(init_cache)``).
* ``params_pspecs``, ``batch_pspecs``, ``cache_pspecs`` and
  ``opt_state_pspecs`` equal ``repro``'s leaf for leaf for every arch at
  full width, the port's params built on meta and ``repro``'s by
  ``jax.eval_shape``, on the production ``16x16`` and ``2x16x16`` meshes
  as shape-only meshes: ``repro``'s policy functions read only
  ``axis_names`` and ``shape`` of a mesh, so no devices are needed.
* ``roofline_terms`` equal ``repro``'s once rescaled by the ratio of the
  rates (H100 here, TPU v5e there).
* ``count_step``'s FLOPs of reduced ``llama3_2_1b``'s train step equal
  ``repro``'s ``analyze_hlo`` FLOPs of the same step compiled on the CPU
  (in a process of its own on one CPU, ``tests/jax_one_cpu.py``, the job
  in ``tests/jax_side_jobs.py``) within ``FLOP_REL``.
* ``run_case`` of reduced ``llama3_2_1b`` (train, fast, prefill, decode)
  and reduced ``qwen2_moe_a2_7b`` (train) ends ``ok`` on meta with no op
  output off the meta device.

``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices when it is
imported; the JAX backend is started first (with ``tests/conftest.py``'s 8)
and the variable restored, so the import changes nothing else.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

jax.devices()
_XLA_FLAGS = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jdryrun  # noqa: E402
if _XLA_FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _XLA_FLAGS

from repro.configs import INPUT_SHAPES as J_INPUT_SHAPES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.ngd import NGDConfig as JNGDConfig  # noqa: E402
from repro.core.ngd import SPNGD as JSPNGD  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro.launch import sharding as jshd  # noqa: E402
from repro.models.transformer import DecoderLM as JDecoderLM  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import INPUT_SHAPES, get_config  # noqa: E402
from repro_torch.core.ngd import NGDConfig, SPNGD  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch import sharding as shd  # noqa: E402
from repro_torch.launch.train import make_train_step  # noqa: E402
from repro_torch.models.transformer import DecoderLM  # noqa: E402
import jax_one_cpu  # noqa: E402

LM_ARCHS = dryrun.LM_ARCHS
MESHES = ("16x16", "2x16x16")
# count_step against analyze_hlo on reduced llama3_2_1b's train step:
# measured 1,092,616,192 against 1,067,450,368, +2.36 %
FLOP_REL = 0.03
DTYPES = {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16,
          jnp.float32: torch.float32, jnp.bool_: torch.bool,
          jnp.float8_e4m3fn: torch.float8_e4m3fn}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_children: dict = {}
BATCH = (4, 16)


# LLVM's optimization off in the HLO child: the optimized HLO, which is all
# it reads, is the same (1,067,450,368 FLOPs either way), its compile ~30 %
# faster
FAST_COMPILE = " --xla_backend_optimization_level=0" \
    " --xla_llvm_disable_expensive_passes=true"


@pytest.fixture(autouse=True, scope="module")
def _jax_children():
    flags = os.environ.get("XLA_FLAGS")
    os.environ["XLA_FLAGS"] = (flags or "") + FAST_COMPILE
    try:
        _children["hlo"] = jax_one_cpu.start("jax_side_jobs", "hlo_flops",
                                             BATCH)
    finally:
        if flags is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = flags
    yield
    for child in _children.values():
        child.close()


def _dtype(d):
    return DTYPES[jnp.dtype(d).type]


def _cfg_fields_equal(t, j):
    for f in dataclasses.fields(t):
        if f.name != "dtype":
            assert getattr(t, f.name) == getattr(j, f.name), f.name


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_config_helpers_match_repro(arch):
    """INPUT_SHAPES, effective_config, pick_accum, active_param_fraction,
    _active_params and the model-FLOPs rules, exactly."""
    assert {k: dataclasses.astuple(v) for k, v in INPUT_SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in J_INPUT_SHAPES.items()}
    for name, shape in INPUT_SHAPES.items():
        t, j = dryrun.effective_config(arch, name), \
            jdryrun.effective_config(arch, name)
        _cfg_fields_equal(t, j)
        for shards in (1, 16, 32, 512):
            assert dryrun.pick_accum(t, shape, shards) == \
                jdryrun.pick_accum(j, J_INPUT_SHAPES[name], shards)
        assert dryrun.active_param_fraction(t) == \
            jdryrun.active_param_fraction(j)
        assert dryrun._active_params(t) == jdryrun._active_params(j)
    for n, d in ((1.5e9, 1 << 20), (3.7e11, 3.0), (7, 11)):
        assert roofline.model_flops_train(n, d) == \
            jroof.model_flops_train(n, d)
        assert roofline.model_flops_decode(n, d) == \
            jroof.model_flops_decode(n, d)


@pytest.fixture(scope="module")
def _full():
    """Per arch: (the port's meta model, params in repro's layout, its
    optimizer) and (repro's model, eval_shape params, optimizer), full
    width."""
    out = {}

    def get(arch):
        if arch not in out:
            tm = DecoderLM(get_config(arch), device="meta")
            topt = SPNGD(tm.loss, tm.site_infos(), tm.fstats, tm.site_counts,
                         NGDConfig())
            jm = JDecoderLM(jget_config(arch))
            jp = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
            jopt = JSPNGD(jm.loss, jm.site_infos(), jm.fstats,
                          jm.site_counts, JNGDConfig())
            out[arch] = ((tm, convert.params_layout(tm.params()), topt),
                         (jm, jp, jopt))
        return out[arch]
    return get


def _flat(tree, prefix=""):
    """{path: leaf} of a nested dict (repro's P specs are leaves)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_count_params_and_input_specs_match_repro(arch, _full):
    """count_params of the meta params equals repro's of its eval_shape
    tree; every input shape's batch (and decode cache) equals repro's
    ShapeDtypeStructs, shapes and mapped dtypes."""
    (tm, tp, _), (jm, jp, _) = _full(arch)
    assert dryrun.count_params(tp) == jdryrun.count_params(jp)
    jt, tt = _flat(jp), _flat(tp)
    assert set(jt) == set(tt)
    for k in jt:
        assert tuple(tt[k].shape) == jt[k].shape and \
            tt[k].dtype == _dtype(jt[k].dtype), k
    for name, shape in INPUT_SHAPES.items():
        tb = _flat(tm.input_specs(shape))
        jb = _flat(jm.input_specs(J_INPUT_SHAPES[name]))
        assert set(tb) == set(jb), name
        for k in jb:
            assert tb[k].is_meta, (name, k)
            assert tuple(tb[k].shape) == jb[k].shape, (name, k)
            assert tb[k].dtype == _dtype(jb[k].dtype), (name, k)


def _same_specs(tspecs, jspecs, shapes):
    """Leaf for leaf: repro's PartitionSpec padded with None to the
    leaf's rank equals the port's tuple."""
    tf, jf, sf = _flat(tspecs), _flat(jspecs), _flat(shapes)
    assert set(tf) == set(jf)
    for k, j in jf.items():
        nd = len(sf[k].shape)
        assert tf[k] == tuple(j) + (None,) * (nd - len(j)), (k, tf[k], j)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_pspecs_match_repro(arch, _full):
    """params_pspecs, batch_pspecs (cache_pspecs through decode),
    opt_state_pspecs, and the factor hook, on both production meshes."""
    (tm, tp, topt), (jm, jp, jopt) = _full(arch)
    t_state = convert.opt_state_layout(topt.init(tm.params()))
    j_state = jax.eval_shape(jopt.init, jp)
    for name in MESHES:
        mesh = shd.make_mesh(name)
        cfg, jcfg = get_config(arch), jget_config(arch)
        t_specs = shd.params_pspecs(tp, cfg, mesh=mesh)
        j_specs = jshd.params_pspecs(jp, jcfg, mesh=mesh)
        _same_specs(t_specs, j_specs, jp)
        _same_specs(shd.opt_state_pspecs(t_state, t_specs, mesh),
                    jshd.opt_state_pspecs(j_state, j_specs, mesh), j_state)
        for shape in INPUT_SHAPES:
            tb = tm.input_specs(INPUT_SHAPES[shape])
            jb = jm.input_specs(J_INPUT_SHAPES[shape])
            _same_specs(shd.batch_pspecs(tb, mesh),
                        jshd.batch_pspecs(jb, mesh), jb)
        hook = shd.factor_sharding_hook(mesh)
        for fam, stats in tm.fstats().items():
            for key, x in stats.items():
                spec = hook(fam, key, x)
                axes = jshd._lead_axes(x.shape[0], mesh)
                if fam.startswith("blk/") and axes:
                    want = axes[0] if len(axes) == 1 else axes
                    assert spec == (want,) + (None,) * (x.dim() - 1)
                else:
                    assert spec is None


def test_shard_shape_placements_and_the_reducer_take_a_shape_mesh():
    """shard_shape divides, placements name the sharded dims, and
    FactorReducer reads the shape-only mesh's axes."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.comm import FactorReducer
    mesh = shd.make_mesh("2x16x16")
    assert mesh.shape == {"pod": 2, "data": 16, "model": 16}
    spec = (("pod", "data"), None, "model")
    assert shd.shard_shape(spec, (64, 3, 48), mesh) == (2, 3, 3)
    assert shd.shard_bytes(spec, torch.empty(64, 3, 48, device="meta"),
                           mesh) == 2 * 3 * 3 * 4
    assert shd.placements(spec, mesh) == [Shard(0), Shard(0), Shard(2)]
    assert shd.placements((None, None), mesh) == [Replicate()] * 3
    red = FactorReducer(mesh, manual_axes="all")
    assert red.ndev == 512 and red.dp == ("pod", "data", "model")


def test_roofline_terms_match_repro_rescaled():
    """Each term equals repro's times the ratio of repro's rate to the
    port's; the bottleneck is the port's own largest term."""
    ratios = {"compute_s": jroof.PEAK_FLOPS / roofline.PEAK_FLOPS,
              "memory_s": jroof.HBM_BW / roofline.HBM_BW,
              "collective_s": jroof.LINK_BW / roofline.LINK_BW}
    for f, h, c, n in ((1.6e16, 5.3e14, 2e12, 256), (3e9, 4e11, 0.0, 1),
                       (7e18, 1e13, 9e13, 512)):
        t, j = roofline.roofline_terms(f, h, c, n), \
            jroof.roofline_terms(f, h, c, n)
        for k, r in ratios.items():
            assert t[k] == pytest.approx(j[k] * r, rel=1e-12)
        assert t["bottleneck"] == max(ratios, key=t.get)[:-2]
    assert roofline.PEAK_FLOPS == 989e12 and roofline.HBM_BW == 3.35e12
    assert roofline.LINK_BW == 450e9


class _OffMeta(TorchDispatchMode):
    """Records every op whose output is not on the meta device."""

    def __init__(self):
        super().__init__()
        self.off = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and not t.is_meta:
                self.off.append(str(func))
        return out


@pytest.mark.parametrize("arch,shape,fast", [
    ("llama3_2_1b", "train_4k", False), ("llama3_2_1b", "train_4k", True),
    ("llama3_2_1b", "prefill_32k", False),
    ("llama3_2_1b", "decode_32k", False),
    ("qwen2_moe_a2_7b", "train_4k", False)])
def test_run_case_on_meta_allocates_nothing(arch, shape, fast):
    """Reduced configs at the production shapes on the 16x16 mesh: status
    ok, the record's fields filled or null with a why, and every op's
    output on meta."""
    with _OffMeta() as mode:
        rec = dryrun.run_case(arch, shape, False, fast=fast, reduced=True)
    assert rec["status"] == "ok", rec.get("traceback")
    assert mode.off == []
    assert rec["hlo_flops"] > 0 and rec["hlo_bytes"] > 0
    mem = rec["memory_analysis"]
    assert mem["argument_size_in_bytes"] > 0
    assert mem["temp_size_in_bytes"] is None and \
        "temp_size_in_bytes" in rec["why"]       # TP over "model" 16
    assert rec["collective_bytes"] is None and rec["lower_s"] is None
    assert {"lower_s", "compile_s", "collective_bytes"} <= set(rec["why"])
    assert rec["label"].startswith({"train_4k": "train-fast" if fast
                                    else "train(",
                                    "prefill_32k": "prefill",
                                    "decode_32k": "decode"}[shape])


def test_shardmap_case_reports_the_reducer_and_stage4():
    """--schedule shardmap --comm-strategy fused on reduced qwen2_moe: the
    comm and stage4 fields repro's run_case fills, the wire capture on,
    every device's rows one microbatch of the batch, temp bytes known (no
    tensor parallelism: all axes carry data)."""
    rec = dryrun.run_case("qwen2_moe_a2_7b", "train_4k", False,
                          schedule="shardmap", comm_strategy="fused",
                          stage4_device="meta", reduced=True)
    assert rec["status"] == "ok", rec.get("traceback")
    comm = rec["comm"]
    assert comm["strategy"] == "fused" and comm["wire_bytes_per_refresh"] > 0
    assert {"wire_intra_bytes_per_refresh", "wire_inter_bytes_per_refresh",
            "gather_bytes_per_refresh"} <= set(comm)
    s4 = rec["stage4"]
    assert s4["stats"] and rec["collective_bytes"] > 0
    assert s4["device"] == "meta" and set(s4["why"]) == {
        "us_per_layer", "replicated_us_per_device", "sharded_us_per_device"}
    assert all(v[k] is None for v in s4["stats"].values() for k in s4["why"])
    assert rec["memory_analysis"]["temp_size_in_bytes"] > 0
    assert rec["label"] == "train(accum=1,shardmap)"


def test_stage4_report_times_on_the_card_unless_asked():
    """stage4_report times the inversions on the card by default and
    raises where there is none (no silent CPU); on a named device it
    times there; on meta it times nothing."""
    case = dryrun.build_case("llama3_2_1b", "train_4k",
                             shd.make_mesh("16x16"), schedule="shardmap",
                             reduced=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dryrun.stage4_report(case.reducer, False, "eigh")
    rep = dryrun.stage4_report(case.reducer, False, "eigh", device="cpu")
    assert rep["device"] == "cpu" and "why" not in rep
    assert rep["stats"] and all(
        v["us_per_layer"] > 0 and v["replicated_us_per_device"]
        == v["us_per_layer"] * v["layers"] for v in rep["stats"].values())
    meta = dryrun.stage4_report(case.reducer, False, "eigh", device="meta")
    assert meta["stats"].keys() == rep["stats"].keys()
    assert all(v["us_per_layer"] is None for v in meta["stats"].values())


def test_cli_writes_records_and_dryrun_case_events(tmp_path):
    """python -m repro_torch.launch.dryrun --reduced with --metrics-jsonl:
    one JSON record per case and one dryrun_case event each."""
    stream = tmp_path / "m.jsonl"
    recs = dryrun.main(["--arch", "llama3_2_1b", "--shape", "decode_32k",
                        "--mesh", "both", "--reduced", "--out",
                        str(tmp_path / "out"), "--metrics-jsonl",
                        str(stream)])
    assert [r["status"] for r in recs] == ["ok", "ok"]
    assert sorted(os.listdir(tmp_path / "out")) == [
        "llama3_2_1b__decode_32k__multi__reduced.json",
        "llama3_2_1b__decode_32k__single__reduced.json"]
    events = [json.loads(ln) for ln in stream.read_text().splitlines()]
    cases = [e for e in events if e.get("type") == "dryrun_case"]
    assert len(cases) == 2 and {c["mesh"] for c in cases} == set(MESHES)


def test_fitted_count_of_a_scan_equals_the_direct_count():
    """The recurrent blocks' counts are fitted from short runs
    (dryrun.fitted_count): reduced hymba_1_5b's prefill (its SSM scan a
    loop over the tokens, its attention quadratic) at 128 tokens, FLOPs,
    bytes and op count equal to the direct count's."""
    mesh = shd.make_mesh("16x16")
    shape = dataclasses.replace(INPUT_SHAPES["prefill_32k"], seq_len=128)

    def build(**kw):
        return dryrun.build_case("hymba_1_5b", "prefill_32k", mesh,
                                 reduced=True, **kw)
    case = build(shape=shape)
    direct, _ = roofline.count_step(case.step, *case.args)
    fit = dryrun.fitted_count(build, get_config("hymba_1_5b").reduced()
                              .n_layers, shape)
    assert fit.flops == pytest.approx(direct.flops, rel=1e-9)
    assert fit.hbm_bytes == pytest.approx(direct.hbm_bytes, rel=1e-9)
    assert fit.ops == direct.ops and fit.peak_live_bytes is None


# last in the file: the HLO child compiles while the tests above run
def test_count_step_flops_match_repro_hlo():
    """count_step over the port's reduced llama3_2_1b train step on meta
    against repro's analyze_hlo of its compiled step (same config, batch
    (4, 16), eigh): within FLOP_REL. The port counts every matmul it
    dispatches; XLA's optimized program holds fewer dots of some shapes
    (the backward's input-gradient products of the (256, 256) weights
    among them: it merges and simplifies dots), and analyze_hlo weights a
    loop body by the largest constant in its condition, so the totals, not
    the dots, are compared. No dot is rewritten into a custom call here:
    the program's one custom call is LAPACK's eigh (lapack_ssyevd_ffi),
    which neither side counts."""
    cfg = get_config("llama3_2_1b").reduced()
    tm = DecoderLM(cfg, device="meta")
    opt = SPNGD(tm.loss, tm.site_infos(), tm.fstats, tm.site_counts,
                NGDConfig())
    params = tm.params()
    batch = {k: torch.empty(BATCH, dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    cnt, out = roofline.count_step(
        make_train_step(tm, opt), params, opt.init(params), batch,
        {k: True for k in opt.stat_names()}, 1e-3, 1e-3, 0.9)
    assert out[0]["embed"]["table"].is_meta
    assert cnt.ops > 0 and cnt.hbm_bytes > 0 and cnt.peak_live_bytes > 0
    want, calls = _children["hlo"].result()
    assert calls == ["lapack_ssyevd_ffi"], calls
    assert abs(cnt.flops - want) <= FLOP_REL * want, (cnt.flops, want)
