"""Dry run of the production meshes on the meta device (counterpart of
``repro/launch/dryrun.py``).

For every (architecture x input shape) pair, build the step ``repro``
lowers (train / fast / prefill / single-token decode) on
``torch.device("meta")`` (nothing is allocated, no card is needed), lay
its arguments out on ``repro``'s meshes (``16x16`` and ``2x16x16``, as
shape-only meshes: ``launch/sharding.py``) and record:

* ``memory_analysis``: the argument bytes per device, exact, from the
  sharding policy (``sharding.shard_shape``); the output bytes likewise;
  the peak live bytes of one run of the step beyond its arguments;
* the step's FLOPs and (unfused, upper-bound) HBM bytes, counted over one
  run on meta tensors (``roofline.count_step``), and the roofline terms at
  H100 rates;
* under ``--schedule shardmap``, the Stage-3 reducer's report and the
  Stage-4 timing (``FactorReducer`` on the shape-only mesh,
  :func:`stage4_report`), field for field as ``repro`` records them. The
  timing runs on the card unless ``--stage4-device`` names another device;
  ``--stage4-device meta`` (no card) leaves it null.

The step run on meta is one microbatch at one device's rows of the batch
(the batch's data axes cut its first dim) with the whole model: the port
has no tensor-parallel step. Its counts are scaled by ``accum`` and by the
number of such per-device programs the global batch makes, as ``repro``
scales its per-device program by the chip count; the update's own work is
so charged ``accum`` times, an upper bound. On meta the kernel dispatch
resolves to the plain versions, so what is counted is the plain math.

Fields of ``repro``'s record without a counterpart hold ``null``, and the
record's ``why`` says why: ``lower_s`` and ``compile_s`` and the
``static_*`` numbers (there is no compiled program), the collective bytes
under ``--schedule auto`` (eager PyTorch inserts no collectives), and the
temp bytes of a tensor-parallel case. ``repro``'s ``--save-hlo`` and
``--tp-align`` have no torch meaning and are not taken. Neither is
``launch/compat.py`` (JAX version shims) nor ``make_production_mesh`` as a
device layout (a TPU v5e pod): the meshes here are logical shapes.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3_2_1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --out experiments/dryrun_torch
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2_moe_a2_7b --shape train_4k --schedule shardmap --comm-strategy fused --stage4-device meta
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Optional

import torch

from repro_torch import convert
from repro_torch.configs import INPUT_SHAPES, get_config, list_archs
from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.core.ngd import SPNGD, NGDConfig
from repro_torch.launch import sharding as shd
from repro_torch.launch.roofline import (count_step, model_flops_decode,
                                         model_flops_train, roofline_terms)
from repro_torch.launch.train import (make_fast_step, make_prefill_step,
                                      make_serve_step, make_train_step)
from repro_torch.models.transformer import DecoderLM

LM_ARCHS = [a for a in list_archs() if a != "resnet50"]
MESHES = {False: "16x16", True: "2x16x16"}

# dense/MoE full-attention archs run long_500k with a sliding-window variant
SWA_FOR_LONG = 8192

WHY = {
    "lower_s": "no lowering: the step runs eagerly on meta tensors",
    "compile_s": "no compiled program in eager PyTorch",
    "static_flops": "no XLA cost_analysis: hlo_flops is the meta count",
    "static_bytes": "no XLA cost_analysis: hlo_bytes is the meta count",
    "generated_code_size_in_bytes": "no compiled program",
    "alias_size_in_bytes": "no compiled program",
    "collective": "schedule auto: eager PyTorch inserts no collectives "
                  "(GSPMD's are XLA's); see --schedule shardmap",
    "fitted": "count fitted from short runs (count_fit): the peak of the "
              "live bytes, a max over the step's phases, does not "
              "extrapolate",
    "temp_size_in_bytes": "tensor-parallel case: the port has no "
                          "tensor-parallel step, so the meta run's live "
                          "bytes are not one device's",
    "stage4_meta": "--stage4-device meta: no inversion is timed (a dry run "
                   "with no card)",
}


def effective_config(arch: str, shape_name: str) -> Optional[ArchConfig]:
    cfg = get_config(arch)
    if shape_name == "long_500k":
        if cfg.block_type in ("rwkv",):
            return cfg                     # O(1)-state: native
        if cfg.block_type == "hymba":
            # hybrid: SSM branch is O(1); attention branch gets a window
            return dataclasses.replace(cfg, sliding_window=SWA_FOR_LONG)
        if cfg.sliding_window == 0:
            # dense/moe full attention: run the documented SWA variant
            return dataclasses.replace(cfg, sliding_window=SWA_FOR_LONG)
    return cfg


def pick_accum(cfg: ArchConfig, shape: InputShape, data_shards: int) -> int:
    if shape.kind != "train":
        return 1
    per_shard = 1 if cfg.d_model >= 6144 else 4
    return max(1, shape.global_batch // (per_shard * data_shards))


def count_params(shapes) -> int:
    return sum(math.prod(t.shape) for t in _leaves(shapes))


def active_param_fraction(cfg: ArchConfig) -> float:
    """Fraction of expert params active per token (MoE 6*N_active*D)."""
    if cfg.n_experts:
        return (cfg.top_k + cfg.n_shared_experts) / (
            cfg.n_experts + cfg.n_shared_experts)
    return 1.0


def _active_params(cfg: ArchConfig) -> float:
    """Active params/token for MoE: non-expert params + top_k routed +
    shared experts."""
    d, ff, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    per_expert = 3 * d * ff
    shared_total = (3 * d * ff * cfg.n_shared_experts) * L
    attn = L * (2 * d * cfg.n_heads * cfg.hd + 2 * d * cfg.n_kv_heads * cfg.hd)
    emb = 2 * cfg.vocab * d
    other = attn + emb + L * d * cfg.n_experts  # router
    active = other + shared_total + L * cfg.top_k * per_expert
    return active


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _spec_bytes(tree, specs, mesh) -> int:
    if isinstance(tree, dict):
        return sum(_spec_bytes(v, specs[k], mesh) for k, v in tree.items())
    return shd.shard_bytes(specs, tree, mesh)


def _local(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """One device's rows of a batch tensor: its first dim cut where the
    spec puts the data axes there, the other dims whole (the step is a
    data-parallel one)."""
    shape = list(t.shape)
    if t.dim() and spec and spec[0] is not None:
        shape[0] = -(-shape[0] // shd._mesh_size(mesh, spec[0]))
    return torch.empty(shape, dtype=t.dtype, device="meta")


# The recurrent blocks' scans are loops of ops over the tokens: on meta a
# train or prefill step costs some 140 dispatches a token and a layer
# (rwkv6_7b train_4k: 12.1M, ~28 min at ~140 us a dispatch). Their counts are polynomials of degree 1 in the
# layer count and of degree <= 2 in the sequence length (the attention
# scores), so they are fitted exactly from runs at these depths and lengths.
FIT_LAYERS = (1, 2)
FIT_SEQ = (32, 64, 96)


def _lagrange(xs, ys, x: float) -> float:
    out = 0.0
    for i, (xi, yi) in enumerate(zip(xs, ys)):
        w = 1.0
        for j, xj in enumerate(xs):
            if j != i:
                w *= (x - xj) / (xi - xj)
        out += w * yi
    return out


def fitted_count(build, n_layers: int, shape: InputShape):
    """The counts of ``build(layers=L, shape=S)``'s step at ``n_layers``
    and ``shape.seq_len``, fitted from runs at FIT_LAYERS x FIT_SEQ: the
    quadratic in S through three lengths at each depth, then the line in L
    through the two depths. FLOPs, bytes and op counts are such
    polynomials exactly; the peak live bytes, a max over the step's phases,
    are not, and come back None."""
    from repro_torch.launch.roofline import StepCount
    runs = {}
    for L in FIT_LAYERS:
        for s in FIT_SEQ:
            case = build(layers=L, shape=dataclasses.replace(shape,
                                                             seq_len=s))
            runs[L, s], _ = count_step(case.step, *case.args)

    def fit(field):
        at = [_lagrange(FIT_SEQ, [getattr(runs[L, s], field)
                                  for s in FIT_SEQ], shape.seq_len)
              for L in FIT_LAYERS]
        return at[0] + (n_layers - FIT_LAYERS[0]) * (at[1] - at[0]) / (
            FIT_LAYERS[1] - FIT_LAYERS[0])
    return StepCount(fit("flops"), fit("hbm_bytes"), None,
                     int(round(fit("ops"))))


@dataclasses.dataclass
class Case:
    step: object            # the step function
    args: tuple             # what one run on meta takes (one device's rows)
    arg_bytes: int          # per device, from the sharding policy
    out_bytes: int          # per device, likewise
    n_params: int
    label: str
    replicas: float         # per-device programs the global batch makes
    tensor_parallel: bool   # some weight is cut over a mesh axis
    reducer: object = None


def build_case(arch: str, shape_name: str, mesh, *,
               schedule: str = "auto", rwkv_chunk: int = 0,
               fast: bool = False, backend: str = "auto",
               factor_dtype: str = "f32", inverse_method: str = "eigh",
               comm_strategy: str = "dense",
               wire_dtype: Optional[str] = None,
               devices_per_host: Optional[int] = None,
               inverse_sharding: bool = False, refresh_chunks: int = 1,
               shape: Optional[InputShape] = None,
               reduced: bool = False, layers: Optional[int] = None) -> Case:
    """The step of one case on meta and its per-device layout. ``shape``
    replaces ``INPUT_SHAPES[shape_name]`` (a train batch of another size).
    Flags as ``repro``'s ``build_case``; a ``"cuda"`` backend cannot run on
    meta tensors and raises in the dispatch. ``reduced`` takes the
    config's smoke-test variant (``ArchConfig.reduced``); ``layers``
    replaces its depth."""
    from repro_torch.comm import FactorReducer, make_comm_config
    from repro_torch.quant.quant import FACTOR_DTYPES
    cfg = effective_config(arch, shape_name)
    if reduced:
        cfg = cfg.reduced()
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    if backend != "auto":
        cfg = dataclasses.replace(cfg, backend=backend)
    if rwkv_chunk:
        cfg = dataclasses.replace(cfg, scan_chunk=rwkv_chunk)
    shape = shape or INPUT_SHAPES[shape_name]
    comm = None
    if schedule == "shardmap" and shape.kind == "train":
        comm = make_comm_config(comm_strategy, wire_dtype,
                                backend=cfg.backend,
                                devices_per_host=devices_per_host)
        if comm.strategy == "fused" and not fast:
            # fused: the capture emits the wire-format payloads itself
            cfg = dataclasses.replace(cfg, factor_wire=comm.wire_fmt or "")
    model = DecoderLM(cfg, device="meta")
    data_shards = math.prod(mesh.shape[a] for a in shd.dp_axes(mesh))
    n_chips = math.prod(mesh.shape.values())

    params = model.params()
    params_shape = convert.params_layout(params)
    sm_manual = "all" if cfg.d_model < 6144 else "dp"
    all_data = (schedule == "shardmap" and sm_manual == "all"
                and shape.kind == "train")
    if all_data:
        p_specs = shd.tree_map(lambda t: (None,) * t.dim(), params_shape)
    else:
        p_specs = shd.params_pspecs(params_shape, cfg, mesh=mesh)
    n_params = count_params(params_shape)
    tp = any(any(s is not None and "model" in shd._axes(s)
                 and mesh.shape["model"] > 1 for s in spec)
             for spec in shd.flat_paths(p_specs).values())
    batch_shape = model.input_specs(shape)
    b_specs = shd.batch_pspecs(batch_shape, mesh)
    arg_bytes = _spec_bytes(params_shape, p_specs, mesh) + _spec_bytes(
        batch_shape, b_specs, mesh)
    out_bytes = _spec_bytes(params_shape, p_specs, mesh)
    b = batch_shape["tokens"].shape[0]
    if all_data and b % n_chips == 0:
        # every mesh axis is a data axis: one device's rows of all of them
        local = {k: _local(v, (tuple(mesh.axis_names),), mesh)
                 for k, v in batch_shape.items()}
    else:
        local = {k: (v if k == "cache" else _local(v, b_specs[k], mesh))
                 for k, v in batch_shape.items()}

    if shape.kind == "train":
        opt = SPNGD(model.loss, model.site_infos(), model.fstats,
                    model.site_counts,
                    NGDConfig(backend=cfg.backend,
                              inverse_method=inverse_method,
                              factor_dtype=FACTOR_DTYPES[factor_dtype],
                              double_buffer=(inverse_sharding
                                             or refresh_chunks > 1),
                              refresh_chunks=refresh_chunks))
        accum = pick_accum(cfg, shape, data_shards)
        reducer = None
        if schedule == "shardmap":
            if sm_manual == "all":
                accum = max(1, shape.global_batch // n_chips)
            if cfg.factor_wire:
                accum = 1      # fp8 wire payloads cannot accumulate
            reducer = FactorReducer(mesh, manual_axes=sm_manual, comm=comm,
                                    template=opt.fstats_fn(),
                                    sym_fn=opt.sym_stat)
        state = opt.init(params)
        o_shape = convert.opt_state_layout(state)
        o_specs = shd.opt_state_pspecs(o_shape, p_specs, mesh)
        state_bytes = _spec_bytes(o_shape, o_specs, mesh)
        arg_bytes += state_bytes
        out_bytes += state_bytes
        rows = local["tokens"].shape[0]
        micro = {k: v[:max(1, rows // accum)] for k, v in local.items()}
        replicas = b / micro["tokens"].shape[0]
        if fast:
            step = make_fast_step(model, opt)
            args = (params, state, micro, 1e-3, 1e-3, 0.9)
            arg_bytes += 3 * 4
            return Case(step, args, arg_bytes, out_bytes, n_params,
                        f"train-fast(accum={accum},{schedule})", replicas,
                        tp, reducer)
        step = make_train_step(model, opt)
        flags = {k: True for k in opt.stat_names()}
        arg_bytes += len(flags) + 3 * 4
        args = (params, state, micro, flags, 1e-3, 1e-3, 0.9)
        return Case(step, args, arg_bytes, out_bytes, n_params,
                    f"train(accum={accum},{schedule})", replicas, tp,
                    reducer)

    replicas = b / local["tokens"].shape[0]
    if shape.kind == "prefill":
        return Case(make_prefill_step(model), (params, local), arg_bytes, 0,
                    n_params, "prefill", replicas, tp)

    # decode: the cache's rows follow the tokens'
    cache = batch_shape["cache"]
    c_specs = b_specs["cache"]
    rows = local["tokens"].shape[0]
    local_cache = {k: (torch.empty((v.shape[0], rows) + tuple(v.shape[2:]),
                                   dtype=v.dtype, device="meta")
                       if v.dim() >= 2 else v) for k, v in cache.items()}
    out_bytes = _spec_bytes(cache, c_specs, mesh)
    return Case(make_serve_step(model),
                (params, local_cache, local["tokens"]), arg_bytes, out_bytes,
                n_params, "decode", replicas, tp)


def run_case(arch: str, shape_name: str, multi_pod: bool = False, *,
             schedule: str = "auto", rwkv_chunk: int = 0,
             fast: bool = False, backend: str = "auto",
             factor_dtype: str = "f32", inverse_method: str = "eigh",
             comm_strategy: str = "dense", wire_dtype: Optional[str] = None,
             devices_per_host: Optional[int] = None,
             inverse_sharding: bool = False, refresh_chunks: int = 1,
             mesh: Optional[str] = None, shape: Optional[InputShape] = None,
             stage4_device: Optional[str] = None,
             reduced: bool = False) -> dict:
    """One case's record (``repro``'s fields; ``status`` "ok" or "fail"
    with the error). ``mesh`` ("16x16", "1x1", ...) replaces the
    production mesh ``multi_pod`` picks; ``shape`` the named input shape;
    ``stage4_device`` is where :func:`stage4_report` times the
    inversions (the card unless the caller names another device; "meta"
    times nothing); ``reduced`` the config's smoke-test variant."""
    mesh_name = mesh or MESHES[multi_pod]
    m = shd.make_mesh(mesh_name)
    n_chips = m.size()
    t0 = time.time()
    rec = {"arch": arch, "shape": shape_name, "schedule": schedule,
           "tp_align": False, "backend": backend,
           "factor_dtype": factor_dtype, "inverse_method": inverse_method,
           "comm_strategy": comm_strategy,
           "inverse_sharding": inverse_sharding,
           "refresh_chunks": refresh_chunks, "mesh": mesh_name,
           "chips": n_chips, "reduced": reduced}
    try:
        case = build_case(arch, shape_name, m, schedule=schedule,
                          rwkv_chunk=rwkv_chunk, fast=fast, backend=backend,
                          factor_dtype=factor_dtype,
                          inverse_method=inverse_method,
                          comm_strategy=comm_strategy, wire_dtype=wire_dtype,
                          devices_per_host=devices_per_host,
                          inverse_sharding=inverse_sharding,
                          refresh_chunks=refresh_chunks, shape=shape,
                          reduced=reduced)
        why = {k: WHY[k] for k in ("lower_s", "compile_s", "static_flops",
                                   "static_bytes")}
        coll, by_kind, counts = None, None, None
        red = case.reducer
        if red is not None:
            rec["comm"] = red.scatter_report()
            wire = red.wire_bytes_per_stat()
            rec["comm"]["wire_bytes_per_refresh"] = sum(wire.values())
            levels = red.wire_bytes_per_stat_levels().values()
            rec["comm"]["wire_intra_bytes_per_refresh"] = sum(
                intra for intra, _ in levels)
            rec["comm"]["wire_inter_bytes_per_refresh"] = sum(
                inter for _, inter in levels)
            gather = (sum(red.gather_bytes_per_stat().values())
                      if inverse_sharding else 0)
            rec["comm"]["gather_bytes_per_refresh"] = gather
            rec["stage4"] = stage4_report(red, inverse_sharding,
                                          inverse_method,
                                          device=stage4_device)
            # the modelled collectives of one device's step: the gradients'
            # all_reduce, the Stage-3 reduce (capture steps) and the
            # Stage-4 gather
            grads = sum(t.numel() * 4 for t in _leaves(case.args[0]))
            stage3 = 0 if fast else rec["comm"]["wire_bytes_per_refresh"]
            by_kind = {"all-reduce": grads, "reduce-scatter": stage3,
                       "all-gather": 0 if fast else gather}
            counts = {"all-reduce": 1, "reduce-scatter": 0 if fast
                      else len(wire), "all-gather": 0 if fast or not gather
                      else len(wire)}
            coll = float(sum(by_kind.values())) * n_chips
        elif schedule == "auto":
            why["collective_bytes"] = WHY["collective"]
        t1 = time.time()
        cfg = effective_config(arch, shape_name)
        if reduced:
            cfg = cfg.reduced()
        shp = shape or INPUT_SHAPES[shape_name]
        if (cfg.block_type in ("rwkv", "hymba") and shp.kind != "decode"
                and shp.seq_len > max(FIT_SEQ)):
            def build(**kw):
                return build_case(
                    arch, shape_name, m, schedule=schedule,
                    rwkv_chunk=rwkv_chunk, fast=fast, backend=backend,
                    factor_dtype=factor_dtype, inverse_method=inverse_method,
                    comm_strategy=comm_strategy, wire_dtype=wire_dtype,
                    devices_per_host=devices_per_host,
                    inverse_sharding=inverse_sharding,
                    refresh_chunks=refresh_chunks, reduced=reduced, **kw)
            cnt = fitted_count(build, cfg.n_layers, shp)
            rec["count_fit"] = {"layers": list(FIT_LAYERS),
                                "seq": list(FIT_SEQ)}
        else:
            cnt, _ = count_step(case.step, *case.args)
        count_s = time.time() - t1
        flops = cnt.flops * case.replicas
        hbm = cnt.hbm_bytes * case.replicas
        n_params = case.n_params
        n_active = (n_params * active_param_fraction(cfg)
                    if cfg.n_experts == 0 else _active_params(cfg))
        if shp.kind == "train":
            mflops = model_flops_train(n_active, shp.global_batch
                                       * shp.seq_len)
        elif shp.kind == "prefill":
            mflops = 2.0 * n_active * shp.global_batch * shp.seq_len
        else:
            mflops = model_flops_decode(n_active, shp.global_batch)
        terms = roofline_terms(flops, hbm, coll or 0.0, n_chips)
        if coll is None:
            terms["collective_s"] = None
            why["collective_s"] = WHY["collective"]
        peak = cnt.peak_live_bytes
        mem = {"argument_size_in_bytes": int(case.arg_bytes),
               "output_size_in_bytes": int(case.out_bytes),
               "temp_size_in_bytes": (None if case.tensor_parallel
                                      else peak),
               "generated_code_size_in_bytes": None,
               "alias_size_in_bytes": None}
        why.update({k: WHY[k] for k in ("generated_code_size_in_bytes",
                                        "alias_size_in_bytes")})
        if case.tensor_parallel:
            why["temp_size_in_bytes"] = WHY["temp_size_in_bytes"]
        elif peak is None:
            why["temp_size_in_bytes"] = WHY["fitted"]
        if peak is None:
            why["peak_live_bytes"] = WHY["fitted"]
        rec.update({
            "label": case.label, "status": "ok",
            "n_params": int(n_params), "n_params_active": int(n_active),
            "lower_s": None, "compile_s": None,
            "count_s": round(count_s, 1), "count_ops": cnt.ops,
            "hlo_flops": flops, "hlo_bytes": hbm,
            "static_flops": None, "static_bytes": None,
            "peak_live_bytes": peak,
            "collective_bytes": coll,
            "collective_by_kind": by_kind,
            "collective_counts": counts,
            "model_flops": mflops,
            "useful_flops_ratio": (mflops / flops) if flops else None,
            "memory_analysis": _mem_dict(mem),
            **terms, "why": why,
        })
    except Exception as e:
        rec.update({"status": "fail", "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-2000:]})
    rec["wall_s"] = round(time.time() - t0, 1)
    return rec


def stage4_report(reducer, inverse_sharding: bool, method: str,
                  device=None) -> dict:
    """Per-layer Stage-4 inversion timing + gather bytes for the scatter
    report. For every full-kind factor the reducer knows, invert ONE
    leading slice of a synthetic SPD stand-in with the configured method on
    ``device`` and scale by the layer count / scatter group, so the report
    shows the modelled replicated-vs-sharded refresh cost per layer without
    a training step. ``device`` is the card unless the caller names another
    (it raises where there is no card, as the port's entry points do); on
    "meta" nothing is timed: the timing fields are null and the report's
    ``why`` says so."""
    import numpy as np

    from repro_torch.comm.comm import _leaf_shape
    from repro_torch.kernels import dispatch
    from repro_torch.models.transformer import resolve_device

    dev = resolve_device(device)
    timed = dev.type != "meta"
    gather = reducer.gather_bytes_per_stat()
    rep = {"inverse_sharding": inverse_sharding, "method": method,
           "device": str(dev), "stats": {}}
    if not timed:
        rep["why"] = {k: WHY["stage4_meta"] for k in (
            "us_per_layer", "replicated_us_per_device",
            "sharded_us_per_device")}
    rng = np.random.RandomState(0)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    for fam, stats in reducer.template.items():
        for key, leaf in stats.items():
            if key not in ("a", "g") or not reducer.sym_fn(fam, key):
                continue
            shape = _leaf_shape(leaf)          # (lead..., nb, b, b)
            lead = shape[0]
            axes = reducer.scatter_axes(lead)
            p = reducer.group_size(axes) if axes else 1
            us = None
            if timed:
                b = shape[-1]
                one = (1,) + tuple(shape[1:])  # one leading (layer) slice
                m = rng.randn(*one[:-1], b).astype(np.float32)
                spd = torch.from_numpy(m @ np.swapaxes(m, -1, -2) / b
                                       + 0.1 * np.eye(b, dtype=np.float32)
                                       ).to(dev)
                dispatch.damped_inverse(spd, 1e-3, method=method)  # warm
                sync()
                t0 = time.perf_counter()
                dispatch.damped_inverse(spd, 1e-3, method=method)
                sync()
                us = (time.perf_counter() - t0) * 1e6
            name = f"{fam}.{key}"
            rep["stats"][name] = {
                "block_shape": list(shape),
                "us_per_layer": us,
                "layers": int(lead),
                "group": int(p),
                "replicated_us_per_device": us * lead if timed else None,
                "sharded_us_per_device": (us * math.ceil(lead / p)
                                          if timed else None),
                "gather_bytes": int(gather.get(name, 0))
                if inverse_sharding else 0,
            }
    return rep


def _mem_dict(mem) -> dict:
    if mem is None:
        return {}
    return {k: mem.get(k) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes",
        "alias_size_in_bytes")}


def main(argv=None):
    from repro_torch.comm import STRATEGIES, WIRE_DTYPES
    from repro_torch.quant.quant import FACTOR_DTYPES
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--schedule", default="auto",
                    choices=["auto", "shardmap"])
    ap.add_argument("--backend", default="auto",
                    choices=["ref", "cuda", "auto"],
                    help="kernel backend (repro_torch.kernels.dispatch); on "
                         "meta tensors auto resolves to ref and cuda "
                         "raises")
    ap.add_argument("--factor-dtype", default="f32",
                    choices=sorted(FACTOR_DTYPES),
                    help="factor-history storage dtype; fp8 shrinks the "
                         "optimizer state the argument bytes account")
    ap.add_argument("--inverse-method", default="eigh",
                    choices=["eigh", "cholesky", "newton_schulz"])
    ap.add_argument("--comm-strategy", default="dense", choices=STRATEGIES,
                    help="Stage-3 factor reduce under --schedule shardmap "
                         "(repro_torch.comm), modelled by the reducer")
    ap.add_argument("--wire-dtype", default=None,
                    choices=sorted(WIRE_DTYPES))
    ap.add_argument("--devices-per-host", type=int, default=None)
    ap.add_argument("--inverse-sharding", action="store_true")
    ap.add_argument("--refresh-chunks", type=int, default=1)
    ap.add_argument("--stage4-device", default=None,
                    help="where --schedule shardmap times the Stage-4 "
                         "inversions: the card unless named (cuda, cuda:1, "
                         "cpu); meta times nothing and records the timing "
                         "fields as null")
    ap.add_argument("--rwkv-chunk", type=int, default=0)
    ap.add_argument("--fast", action="store_true",
                    help="Algorithm 1 no-refresh steady-state step")
    ap.add_argument("--reduced", action="store_true",
                    help="the configs' smoke-test variants (2 layers, "
                         "narrow widths)")
    ap.add_argument("--metrics-jsonl", default=None, metavar="PATH",
                    help="write one dryrun_case event per record (plus "
                         "per-case spans and the console mirror) to this "
                         "JSONL stream (repro_torch.obs.MetricsLogger)")
    args = ap.parse_args(argv)
    if args.comm_strategy != "dense" and args.schedule != "shardmap":
        ap.error("--comm-strategy requires --schedule shardmap")
    if args.inverse_sharding and args.schedule != "shardmap":
        ap.error("--inverse-sharding requires --schedule shardmap")

    archs = LM_ARCHS if (args.all or args.arch is None) else [args.arch]
    shapes = (list(INPUT_SHAPES) if (args.all or args.shape is None)
              else [args.shape])
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    variant = ""
    if args.schedule != "auto":
        variant += f"__{args.schedule}"
    if args.backend != "auto":
        variant += f"__{args.backend}"
    if args.factor_dtype != "f32":
        variant += f"__{args.factor_dtype}"
    if args.inverse_method != "eigh":
        variant += f"__{args.inverse_method}"
    if args.comm_strategy != "dense":
        variant += f"__{args.comm_strategy}"
        if args.wire_dtype:
            variant += f"__{args.wire_dtype}"
        if args.devices_per_host:
            variant += f"__dph{args.devices_per_host}"
    if args.inverse_sharding:
        variant += "__invshard"
    if args.refresh_chunks > 1:
        variant += f"__rc{args.refresh_chunks}"
    if args.rwkv_chunk:
        variant += f"__chunk{args.rwkv_chunk}"
    if args.fast:
        variant += "__fast"
    if args.reduced:
        variant += "__reduced"
    from repro_torch.obs import MetricsLogger
    log = MetricsLogger(args.metrics_jsonl)
    records = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = (f"{arch}__{shape}__{'multi' if mp else 'single'}"
                       f"{variant}")
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path):
                    log.console(f"[skip] {tag}")
                    continue
                with log.span(f"dryrun.{tag}"):
                    rec = run_case(arch, shape, mp, schedule=args.schedule,
                                   rwkv_chunk=args.rwkv_chunk,
                                   fast=args.fast, backend=args.backend,
                                   factor_dtype=args.factor_dtype,
                                   inverse_method=args.inverse_method,
                                   comm_strategy=args.comm_strategy,
                                   wire_dtype=args.wire_dtype,
                                   devices_per_host=args.devices_per_host,
                                   inverse_sharding=args.inverse_sharding,
                                   refresh_chunks=max(1,
                                                      args.refresh_chunks),
                                   stage4_device=args.stage4_device,
                                   reduced=args.reduced)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                log.emit("dryrun_case", tag=tag,
                         **{k: v for k, v in rec.items()
                            if k != "traceback"})
                records.append(rec)
                status = rec["status"]
                extra = ("" if status != "ok" else
                         f" flops={rec['hlo_flops']:.3g}"
                         f" args={rec['memory_analysis']['argument_size_in_bytes']:.3g}B"
                         f" bottleneck={rec['bottleneck']}"
                         f" count={rec['count_s']}s")
                log.console(f"[{status}] {tag}{extra}")
                if status != "ok":
                    log.console(rec["error"])
    log.close()
    return records


if __name__ == "__main__":
    main()
