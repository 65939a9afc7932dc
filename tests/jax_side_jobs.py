"""The JAX package's side of port parity tests, run in processes of their
own on one CPU (``tests/jax_one_cpu.py``).

This module imports JAX and the JAX package but not torch nor the port, so
a child starts in half the time the test modules take to import.
``tests/test_torch_moe_wire_parity.py`` runs :func:`moe_wire_capture` and
:func:`wire_routes`, ``tests/test_torch_swa_attention_parity.py``
:func:`head_dim_model`, ``tests/test_torch_decode_split.py``
:func:`decode_cases`, ``tests/test_torch_launch_parity.py``
:func:`hlo_flops`, ``tests/test_torch_tp_align_parity.py``
:func:`tp_aligned_steps` and ``tests/test_torch_dist_families_parity.py``
:func:`shardmap_steps` and :func:`shard_wire_raw`; the tests pass in
their fixtures (batch, step sizes, inputs) as numpy arrays and plain
values, and get numpy back.
"""

from __future__ import annotations

import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config
from repro.core.ngd import NGDConfig, SPNGD
from repro.kernels import dispatch
from repro.launch import roofline
from repro.launch.train import make_train_step
from repro.models.transformer import DecoderLM


def moe_wire_capture(arch: str, wire: str, batch: dict, damp: float,
                     lr: float, mom: float):
    """Reduced ``arch`` with ``factor_wire=wire``, its params drawn from
    ``PRNGKey(0)`` under ``jax.threefry_partitionable(False)``: the wire
    capture and one capture step on ``batch``, one compiled program for
    both. Returns (params, state) at the start, the raw wire sums, the
    loss, the step's loss, the params after the step, and the params after
    the step from params moved by one f32 ulp (each element times 1 +-
    2^-23), all numpy. The step is ``make_train_step``'s at accum 1
    (``grads_and_raw`` then ``apply_update``) with its raw sums kept, so
    the program holds one backward."""
    cfg = dataclasses.replace(get_config(arch).reduced(), backend="ref",
                              factor_wire=wire)
    jm = DecoderLM(cfg)
    with jax.threefry_partitionable(False):
        jp = jm.init(jax.random.PRNGKey(0))
    jopt = SPNGD(jm.loss, jm.site_infos(), jm.fstats, jm.site_counts,
                 NGDConfig(damping=damp, backend="ref"))
    js = jax.jit(jopt.init)(jp)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    flags = {k: jnp.asarray(True) for k in jopt.stat_names()}
    counts = jm.site_counts(jb)

    def both(p, s):
        loss, aux, grads, raw = jopt.grads_and_raw(p, jb)
        p1, _, m = jopt.apply_update(p, s, grads, raw, counts, flags, damp,
                                     lr, mom, loss, aux)
        return loss, raw, p1, m["loss"]
    run = jax.jit(both)
    loss, raw, jp1, step_loss = run(jp, js)
    rng = np.random.RandomState(3)
    moved = jax.tree.map(lambda a: a * (1 + 2.0 ** -23 * jnp.asarray(
        rng.choice([-1.0, 1.0], a.shape), a.dtype)), jp)
    mp1 = run(moved, js)[2]
    return (jax.tree.map(np.asarray, (jp, js)), jax.tree.map(np.asarray, raw),
            float(loss), float(step_loss), jax.tree.map(np.asarray, jp1),
            jax.tree.map(np.asarray, mp1))


def wire_routes(cases: list, wire: str) -> list:
    """``dispatch.factor_sum_wire`` of the ref backend on each (x,
    max_dim): [(payload bits, scales)]."""
    out = []
    for x, max_dim in cases:
        p, s = dispatch.factor_sum_wire(jnp.asarray(x), max_dim, fmt=wire,
                                        backend="ref")
        out.append((np.asarray(p).view(np.uint8), np.asarray(s)))
    return out


def hlo_flops(batch_shape: tuple):
    """Reduced llama3_2_1b's train step (ref backend, eigh) compiled on
    the CPU at ``batch_shape``: the trip-weighted dot FLOPs of
    ``roofline.analyze_hlo`` and the custom-call targets of the optimized
    HLO."""
    cfg = dataclasses.replace(get_config("llama3_2_1b").reduced(),
                              backend="ref")
    jm = DecoderLM(cfg)
    jp = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    jopt = SPNGD(jm.loss, jm.site_infos(), jm.fstats, jm.site_counts,
                 NGDConfig(backend="ref"))
    js = jax.eval_shape(jopt.init, jp)
    i32 = jax.ShapeDtypeStruct(batch_shape, jnp.int32)
    flags = {k: jax.ShapeDtypeStruct((), jnp.bool_)
             for k in jopt.stat_names()}
    scal = jax.ShapeDtypeStruct((), jnp.float32)
    hlo = jax.jit(make_train_step(jm, jopt)).lower(
        jp, js, {"tokens": i32, "labels": i32}, flags, scal, scal,
        scal).compile().as_text()
    return (float(roofline.analyze_hlo(hlo).flops),
            sorted(set(re.findall(r'custom_call_target="([^"]+)"', hlo))))


def _ulp_moved(tree, seed: int = 3):
    """Params (numpy), each element times 1 +- 2^-23 (signs from a seed)."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda a: np.asarray(a) * (1 + 2.0 ** -23 * rng.choice(
        [-1.0, 1.0], a.shape).astype(a.dtype)), tree)


def _np(tree):
    return jax.tree.map(np.array, tree)


def tp_aligned_steps(tp: int, min_block: int, batch: dict, damp: float,
                     lr: float, mom: float) -> dict:
    """Reduced llama3_2_1b at ``tp_shards=tp`` and ``min_block`` from
    ``repro``'s start (:func:`_family`): ``make_train_step`` with every
    flag set, then ``make_fast_step`` from its result; each step again from
    its start's params moved by one f32 ulp. Returns {"init", "capture",
    "fast", "moved": [capture, fast], "losses"}, the snapshots (params,
    state) as numpy."""
    from repro.launch.train import make_fast_step
    jm, jp = _family("llama3_2_1b", dict(tp_shards=tp, min_block=min_block))
    jopt = SPNGD(jm.loss, jm.site_infos(), jm.fstats, jm.site_counts,
                 NGDConfig(damping=damp, backend="ref"))
    js = jax.jit(jopt.init)(jp)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    flags = {k: jnp.asarray(True) for k in jopt.stat_names()}
    step = jax.jit(make_train_step(jm, jopt))
    fast = jax.jit(make_fast_step(jm, jopt))
    return _two_steps(step, fast, jp, js, jb, flags, damp, lr, mom)


def _two_steps(step, fast, jp, js, jb, flags, damp, lr, mom) -> dict:
    """``step`` (a capture) then ``fast`` from its result, each again from
    its start's params moved by one f32 ulp: the snapshots as numpy."""
    p1, s1, m1 = step(jp, js, jb, flags, damp, lr, mom)
    p1 = _np(p1)          # both fast steps from host params: one compile
    p2, s2, m2 = fast(p1, s1, jb, damp, lr, mom)
    mp1, ms1, _ = step(_ulp_moved(jp), js, jb, flags, damp, lr, mom)
    mp2, ms2, _ = fast(_ulp_moved(p1), s1, jb, damp, lr, mom)
    return {"init": _np((jp, js)), "capture": _np((p1, s1)),
            "fast": _np((p2, s2)), "moved": [_np((mp1, ms1)), _np((mp2, ms2))],
            "losses": [float(m1["loss"]), float(m2["loss"])]}


def _family(family: str, cfg_kw: dict, factor_wire: str = ""):
    """``repro``'s model of ``family``: the ConvNet of ``ConvNetConfig(
    **cfg_kw)``, or the reduced config of that name, and its ``PRNGKey(0)``
    params drawn under ``jax.threefry_partitionable(False)`` (the
    partitionable draw compiles ~5x slower here)."""
    if family == "convnet":
        from repro.models.resnet import ConvNet, ConvNetConfig
        jm = ConvNet(ConvNetConfig(**cfg_kw))
    else:
        cfg = dataclasses.replace(get_config(family).reduced(**cfg_kw),
                                  backend="ref", factor_wire=factor_wire)
        jm = DecoderLM(cfg)
    with jax.threefry_partitionable(False):
        return jm, jax.jit(jm.init)(jax.random.PRNGKey(0))


def shardmap_steps(family: str, cfg_kw: dict, strategy: str, ngd_kw: dict,
                   batch: dict, damp: float, lr: float, mom: float) -> dict:
    """``make_shardmap_train_step`` (every flag set) then
    ``make_shardmap_fast_step`` from its result, on the (2, 4) mesh of 8
    host devices under ``manual_axes="auto"`` (data axis 2), the Stage-3
    strategy ``strategy`` (``fused`` with the e4m3 capture; the ConvNet's
    optimizer with the weight rescale, as its trainers build it), each step
    again from its start's params moved by one f32 ulp. Returns {"init",
    "capture", "fast", "moved": [capture, fast], "losses"}, the snapshots
    (params, state) as numpy."""
    from repro.comm import make_comm_config
    from repro.launch import compat
    from repro.launch.train import (make_shardmap_fast_step,
                                    make_shardmap_train_step)
    comm = make_comm_config(strategy)
    jm, jp = _family(family, cfg_kw,
                     comm.wire_fmt if strategy == "fused" else "")
    if family == "convnet":
        ngd_kw = dict(ngd_kw, weight_rescale=True)
    jopt = SPNGD(jm.loss, jm.site_infos(), jm.fstats, jm.site_counts,
                 NGDConfig(damping=damp, backend="ref", **ngd_kw))
    js = jax.jit(jopt.init)(jp)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    flags = {k: jnp.asarray(True) for k in jopt.stat_names()}
    mesh = compat.make_mesh((2, 4), ("data", "model"))
    with compat.set_mesh(mesh):
        step = jax.jit(make_shardmap_train_step(jm, jopt, mesh, comm=comm))
        fast = jax.jit(make_shardmap_fast_step(jm, jopt, mesh, comm=comm))
        return _two_steps(step, fast, jp, js, jb, flags, damp, lr, mom)


def shard_wire_raw(family: str, cfg_kw: dict, wire: str, batch: dict,
                   shards: int) -> list:
    """The wire-format raw sums (capture ``wire``) of each of ``shards``
    data shards of ``batch`` from ``repro``'s start (:func:`_family`), the
    shard's rows through ``grads_and_raw`` as the shard_map body of
    :func:`shardmap_steps` runs them: one {family: {key: (payload bits as
    uint8, scale)}} per shard."""
    from repro import quant
    jm, jp = _family(family, cfg_kw, wire)
    jopt = SPNGD(jm.loss, jm.site_infos(), jm.fstats, jm.site_counts,
                 NGDConfig(backend="ref"))
    raw_fn = jax.jit(lambda p, b: jopt.grads_and_raw(p, b)[3])
    rows = next(iter(batch.values())).shape[0] // shards
    out = []
    for i in range(shards):
        raw = raw_fn(jp, {k: jnp.asarray(v[i * rows:(i + 1) * rows])
                          for k, v in batch.items()})
        wired = {fam: {k: (np.asarray(v["payload"]).view(np.uint8),
                           np.asarray(v["scale"]))
                       for k, v in stats.items() if quant.is_wire(v)}
                 for fam, stats in raw.items()}
        out.append({k: v for k, v in wired.items() if v})
    return out



def head_dim_model(cfg_kw: dict, batch: dict, toks, s: int, damp: float,
                   lr: float, mom: float) -> dict:
    """An ad-hoc reduced llama3_2_1b (``cfg_kw`` over ``reduced()``, built
    here and never registered) from :func:`_family`'s params: the forward
    logits on ``batch``; a prefill of ``toks[:, :s]`` on the dense f32
    cache and teacher-forced decode steps over the rest of ``toks`` (the
    prefill's logits, then each step's); and one capture step
    (``make_train_step``, every flag set). Returns {"params", "state",
    "logits", "served", "stepped": (params, state), "loss"}, numpy."""
    from repro.serve import ServeConfig
    jm, jp = _family("llama3_2_1b", cfg_kw)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    logits, _ = jax.jit(jm.forward)(jp, jb)
    serve = ServeConfig(backend="ref", kv_cache="dense", kv_dtype="f32")
    lg, cache = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :s])},
                           max_len=toks.shape[1], serve=serve)
    step = jax.jit(functools.partial(jm.decode_step, serve=serve))
    served = [lg]
    for i in range(s, toks.shape[1]):
        lg, cache = step(jp, cache, jnp.asarray(toks[:, i]))
        served.append(lg[:, None])
    jopt = SPNGD(jm.loss, jm.site_infos(), jm.fstats, jm.site_counts,
                 NGDConfig(damping=damp, backend="ref"))
    js = jax.jit(jopt.init)(jp)
    flags = {k: jnp.asarray(True) for k in jopt.stat_names()}
    p1, s1, m = jax.jit(make_train_step(jm, jopt))(jp, js, jb, flags, damp,
                                                   lr, mom)
    return {"params": _np(jp), "state": _np(js),
            "logits": np.asarray(logits),
            "served": np.asarray(jnp.concatenate(served, axis=1)),
            "stepped": (_np(p1), _np(s1)), "loss": float(m["loss"])}


def _operand(x):
    """A cache operand from the test: (numpy, dtype name) -> jax array."""
    if x is None:
        return None
    arr, name = x
    if name.startswith("float8"):
        return jnp.asarray(arr).view(getattr(jnp, name))
    return jnp.asarray(arr).astype(getattr(jnp, name))


def decode_cases(jobs: list) -> list:
    """``repro``'s interpret-mode ``ops.swa_decode`` on each job's (q, k, v,
    pos, window, k_scale, v_scale): the outputs, numpy."""
    from repro.kernels import ops
    return [np.array(ops.swa_decode(jnp.asarray(q), _operand(k), _operand(v),
                                    jnp.asarray(pos), window=window,
                                    k_scale=_operand(ks), v_scale=_operand(vs),
                                    interpret=True))
            for q, k, v, pos, window, ks, vs in jobs]


def run_jobs(calls: list) -> list:
    """Each (function name, args) of ``calls`` in turn, in this process:
    their results in order (two short jobs share one child)."""
    return [globals()[fn](*args) for fn, args in calls]


def shardmap_losses(strategy: str, period: int, lr: float, ngd_kw: dict,
                    with_params: bool = False) -> tuple:
    """``tests/test_stage4_sharding.py``'s 20 shard_map steps of reduced
    llama3_2_1b on the (2, 4) mesh (``_losses_shardmap``: a capture on
    the steps ``t % period == 0``, fast steps between): (its
    ``PRNGKey(0)`` params as numpy with ``with_params``, else None; the
    losses)."""
    from test_stage4_sharding import _llama_setup, _losses_shardmap
    losses = _losses_shardmap(strategy, period=period, offset=0, lr=lr,
                              **ngd_kw)
    params = (jax.tree.map(np.asarray, _llama_setup({})[2]) if with_params
              else None)
    return params, losses
