"""The JAX package's side of two port parity tests, run in processes of
their own on one CPU (``tests/jax_one_cpu.py``).

This module imports JAX and the JAX package but not torch nor the port, so
a child starts in half the time the test modules take to import.
``tests/test_torch_moe_wire_parity.py`` runs :func:`moe_wire_capture` and
:func:`wire_routes`, ``tests/test_torch_launch_parity.py``
:func:`hlo_flops`; the tests pass in their fixtures (batch, step sizes,
inputs) as numpy arrays and plain values, and get numpy back.
"""

from __future__ import annotations

import dataclasses
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
