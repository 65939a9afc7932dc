"""SP-NGD trainer: step builders and the CLI (counterpart of
``repro/launch/train.py``, its single-device default path).

``make_train_step(model, opt, accum)`` returns

    train_step(params, opt_state, batch, flags, lam, lr, mom)
        -> (params, opt_state, metrics)

With ``accum > 1`` the batch is split into microbatches run one after the
other: gradients average and raw factor sums add, the G-type sums rescaled
by 1/accum^2 (each microbatch's dL/ds carries 1/n_micro, not 1/n_total).
Fused fp8 wire capture (``ArchConfig.factor_wire``) cannot accumulate and
is refused with ``accum > 1``.

    python -m repro_torch.launch.train --arch llama3_2_1b --steps 4 \\
        --batch 4 --seq 1024 --full-config          # on the card
    python -m repro_torch.launch.train --device cpu  # reduced, plain versions
    python -m repro_torch.launch.train --device cpu --arch qwen1_5_4b
    python -m repro_torch.launch.train --device cpu --arch mixtral_8x22b
    python -m repro_torch.launch.train --device cpu --arch mixtral_8x22b \\
        --factor-wire e4m3                       # fused fp8 expert capture
    python -m repro_torch.launch.train --device cpu --arch rwkv6_7b
    python -m repro_torch.launch.train --device cpu --arch hymba_1_5b
    python -m repro_torch.launch.train --full-config --factor-dtype fp8_e4m3
    python -m repro_torch.launch.train --full-config --double-buffer
    python -m repro_torch.launch.train --full-config --refresh-chunks 4
    python -m repro_torch.launch.train --device cpu --steps 6 \
        --metrics-jsonl experiments/metrics_torch.jsonl --profile-dir trace

``make_serve_step(model)`` and ``make_prefill_step(model)`` are ``repro``'s
serving steps: one decode position against the legacy cache
(``serve_step(params, cache, tokens) -> (logits, cache)``) and the forward's
logits over a prompt (``prefill_step(params, batch) -> logits``).

``make_dist_train_step`` / ``make_dist_fast_step`` are the multi-rank
steps (``repro``'s ``make_shardmap_{train,fast}_step``) over a
``torch.distributed`` ``DeviceMesh`` (``launch/mesh.py``): each rank keeps
its rows of the global batch, the loss and gradients are summed by one
``all_reduce`` per dtype, the raw factor sums go through the Stage-3
``FactorReducer`` (``repro_torch.comm``) and are assembled back to full
statistics, and with ``inverse_sharding`` Stage 4 inverts this rank's chunk
of each factor and all-gathers. ``run(mesh=...)`` drives them; the CLI runs
one process, where ``--comm-strategy`` and ``--inverse-sharding`` set the
config and the modelled byte ledger.

Telemetry is ``repro``'s (``repro_torch.obs``): ``--metrics-jsonl`` writes
its JSONL stream (with the overhead probe's ``probe`` event unless
``--no-overhead-probe``), which ``experiments/make_report.py`` turns into
the overhead decomposition, and ``--profile-dir`` / ``--profile-steps``
trace the first steps with ``torch.profiler`` (Chrome-trace JSON), the
SP-NGD stages and the dispatched ops named as in ``repro``'s traces.
"""

from __future__ import annotations

import time
from typing import Callable

import torch

from repro_torch.core.fisher import flatten, unflatten, value_and_grad
from repro_torch.core.ngd import SPNGD, _dense_leaf_shape


def _micro(batch: dict, accum: int) -> list[dict]:
    """Contiguous microbatches along the batch axis."""
    return [{k: v.chunk(accum, dim=0)[i] for k, v in batch.items()}
            for i in range(accum)]


def _tree_add(a, b):
    fb = flatten(b)
    return unflatten({k: v + fb[k] for k, v in flatten(a).items()}, a)


def _check_accum_capture(opt: SPNGD, accum: int) -> None:
    """Fused wire-format capture emits fp8 payloads whose microbatch sums
    are not representable (fp8 has no add): refuse accumulation up front
    instead of adding quantized payloads."""
    if accum <= 1:
        return
    from repro_torch.quant import quant
    wired = [f"{fam}.{k}" for fam, stats in opt.fstats_fn().items()
             for k, leaf in stats.items() if quant.is_wire(leaf)]
    if wired:
        raise ValueError(
            f"accum={accum} cannot accumulate wire-format statistics "
            f"({', '.join(sorted(wired))}): fp8 payloads do not add across "
            "microbatches. Use accum=1 with fused capture, or dense "
            "capture (factor_wire='') with accumulation.")


def make_train_step(model, opt: SPNGD, accum: int = 1) -> Callable:
    _check_accum_capture(opt, accum)

    def train_step(params, opt_state, batch, flags, lam, lr, mom):
        counts = model.site_counts(batch)          # full-batch counts
        if accum == 1:
            loss, aux, grads, raw = opt.grads_and_raw(params, batch)
        else:
            grads = raw = None
            loss = 0.0
            for mb in _micro(batch, accum):
                l, _, g, r = opt.grads_and_raw(params, mb)
                grads = g if grads is None else _tree_add(grads, g)
                raw = r if raw is None else _tree_add(raw, r)
                loss = loss + l
            grads = unflatten({k: v / accum for k, v in
                               flatten(grads).items()}, grads)
            # G-type raw sums: undo the microbatch mean-loss scaling
            raw = {fam: {k: (v if k == "a" else v / (accum * accum))
                         for k, v in stats.items()}
                   for fam, stats in raw.items()}
            loss, aux = loss / accum, {}
        return opt.apply_update(params, opt_state, grads, raw, counts,
                                flags, lam, lr, mom, loss, aux)

    return train_step


def make_fast_step(model, opt: SPNGD, accum: int = 1) -> Callable:
    """No-capture step (every statistic within its refresh interval)."""
    def fast_step(params, opt_state, batch, lam, lr, mom):
        if accum == 1:
            return opt.step_fast(params, opt_state, batch, lam, lr, mom)
        grads, loss = None, 0.0
        for mb in _micro(batch, accum):
            l, _, g = value_and_grad(opt.loss_fn, params, mb)
            grads = g if grads is None else _tree_add(grads, g)
            loss = loss + l
        grads = unflatten({k: v / accum for k, v in flatten(grads).items()},
                          grads)
        opt_state, curv, extra = opt.fast_curv(opt_state, lam)
        return opt._finish(params, opt_state, grads, curv, lam, lr, mom,
                           loss / accum, {}, {}, extra=extra)

    return fast_step


def make_serve_step(model) -> Callable:
    """Single-token decode against a persistent cache (the legacy
    ``serve=None`` layout of ``model.init_cache`` / ``model.prefill``)."""
    def serve_step(params, cache, tokens):
        return model.decode_step(cache, tokens, params=params)
    return serve_step


def make_prefill_step(model) -> Callable:
    def prefill_step(params, batch):
        logits, _ = model.forward(batch, None, params)
        return logits
    return prefill_step


def _local_rows(batch: dict, reducer) -> dict:
    """This rank's contiguous rows of the global batch, in data-axis order
    (``P(dp)``)."""
    b = next(iter(batch.values())).shape[0]
    if b % reducer.ndev:
        raise ValueError(f"global batch {b} does not split over "
                         f"{reducer.ndev} data ranks")
    rows = b // reducer.ndev
    i = reducer.dp_index()
    return {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}


# each gradient's view in the reduced buffer starts on a 256-byte boundary
# (the caching allocator's own blocks start on 512), so the elementwise and
# copy kernels that read the gradients keep their vector loads
GRAD_ALIGN_BYTES = 256


def all_reduce_grads(reducer, loss: torch.Tensor, grads: dict, n: int):
    """Loss and gradients summed over the data axes and divided by ``n``:
    one ``all_reduce`` per dtype over the tensors laid end to end, each
    padded to ``GRAD_ALIGN_BYTES`` (the f32 loss rides with the f32
    gradients). Returns (loss, grads), the gradients views into the
    reduced buffers."""
    from repro_torch.comm.comm import all_reduce
    flat = {"": loss.reshape(1), **flatten(grads)}
    buckets: dict[torch.dtype, list[str]] = {}
    for path, t in flat.items():
        buckets.setdefault(t.dtype, []).append(path)
    out = {}
    group = reducer.group(reducer.dp)
    for dtype, paths in buckets.items():
        align = max(1, GRAD_ALIGN_BYTES // dtype.itemsize)
        parts, sizes = [], []
        for p in paths:
            t = flat[p].reshape(-1)
            pad = -t.numel() % align
            parts += [t, t.new_zeros(pad)] if pad else [t]
            sizes.append(t.numel() + pad)
        buf = all_reduce(torch.cat(parts), group).div_(n)
        for p, part in zip(paths, buf.split(sizes)):
            out[p] = part[:flat[p].numel()].view(flat[p].shape)
    loss = out.pop("").reshape(())
    return loss, unflatten(out, grads)


def _local_grads(opt: SPNGD, params, batch: dict, accum: int,
                 capture: bool):
    """The local backward: (loss, grads[, raw]) summed over ``accum``
    microbatches, not yet averaged (the dist steps divide after the
    all_reduce, the G sums after the Stage-3 rescale)."""
    parts = _micro(batch, accum) if accum > 1 else [batch]
    loss = grads = raw = None
    for mb in parts:
        if capture:
            l, _, g, r = opt.grads_and_raw(params, mb)
        else:
            l, _, g = value_and_grad(opt.loss_fn, params, mb)
            r = None
        loss = l if loss is None else loss + l
        grads = g if grads is None else _tree_add(grads, g)
        if capture:
            raw = r if raw is None else _tree_add(raw, r)
    return loss, grads, raw


def make_dist_train_step(model, opt: SPNGD, mesh, accum: int = 1,
                         comm=None) -> Callable:
    """The paper's Algorithm 3 over ``torch.distributed``: Stage 1-2 on
    this rank's rows of the global batch (no traffic), then one
    ``all_reduce`` of the loss and gradients, the G-type raw sums rescaled
    by 1/(accum^2 ndev^2) (a wire dict's scales, not its payload), ONE
    Stage-3 reduce per statistic (``FactorReducer``, strategy from
    ``comm``) and its assembly back to the full statistic, statistic by
    statistic (each raw sum freed once reduced), and the update. With
    ``inverse_sharding`` the builder attaches a ``Stage4Inverter`` over the
    same reducer. Same signature as :func:`make_train_step`; every rank of
    ``mesh`` calls it with the same arguments (the global batch). The data
    axes are the mesh's "pod" / "data" axes (``manual_axes="auto"``):
    ranks that differ only in a "model" index compute the same step."""
    from repro_torch.comm import FactorReducer, Stage4Inverter
    from repro_torch.quant import quant
    _check_accum_capture(opt, accum)
    reducer = FactorReducer(mesh, comm=comm, template=opt.fstats_fn(),
                            sym_fn=opt.sym_stat)
    ndev = reducer.ndev
    if opt.cfg.inverse_sharding:
        opt.set_stage4(Stage4Inverter(reducer, method=opt.cfg.inverse_method,
                                      backend=opt.cfg.backend))
    g_scale = 1.0 / (accum * accum * ndev * ndev)

    def rescale_g(v):
        if quant.is_wire(v):
            return {"payload": v["payload"], "scale": v["scale"] * g_scale}
        return v * g_scale

    def train_step(params, opt_state, batch, flags, lam, lr, mom):
        counts = model.site_counts(batch)          # full-batch counts
        loss, grads, raw = _local_grads(opt, params,
                                        _local_rows(batch, reducer), accum,
                                        capture=True)
        loss, grads = all_reduce_grads(reducer, loss, grads, ndev * accum)
        stats = {}
        for fam, fam_raw in raw.items():
            stats[fam] = {}
            for key in list(fam_raw):
                v = fam_raw.pop(key)         # each raw sum dies once reduced
                v = reducer.reduce_stat(fam, key,
                                        v if key == "a" else rescale_g(v))
                stats[fam][key] = reducer.assemble_stat(fam, key, v)
                del v
        del raw
        return opt.apply_update(params, opt_state, grads, stats, counts,
                                flags, lam, lr, mom, loss, {})

    train_step.reducer = reducer
    return train_step


def make_dist_fast_step(model, opt: SPNGD, mesh, accum: int = 1,
                        comm=None) -> Callable:
    """The fast step over ``torch.distributed``: the local backward, one
    ``all_reduce`` of loss and gradients, then ``opt.fast_curv`` (the
    double buffer's activation or one drain chunk, sharded under an
    attached Stage4Inverter) and the stale-preconditioned update."""
    from repro_torch.comm import FactorReducer
    reducer = FactorReducer(mesh, comm=comm)
    ndev = reducer.ndev

    def fast_step(params, opt_state, batch, lam, lr, mom):
        loss, grads, _ = _local_grads(opt, params,
                                      _local_rows(batch, reducer), accum,
                                      capture=False)
        loss, grads = all_reduce_grads(reducer, loss, grads, ndev * accum)
        opt_state, curv, extra = opt.fast_curv(opt_state, lam)
        return opt._finish(params, opt_state, grads, curv, lam, lr, mom,
                           loss, {}, {}, extra=extra)

    fast_step.reducer = reducer
    return fast_step


def build(arch: str = "llama3_2_1b", *, full_config: bool = False,
          backend: str = "auto", damping: float = 2.5e-4,
          inverse_method: str = "eigh", estimator: str = "emp",
          weight_rescale: bool = False, history: int = 2,
          sgd_fallback_scale: float = 1.0, factor_dtype=torch.float32,
          factor_wire: str | None = None, double_buffer: bool = False,
          refresh_chunks: int = 1, inverse_sharding: bool = False,
          inverse_info: bool = False, device=None, seed: int = 0, cfg=None):
    """The model (random weights from ``seed``), its optimizer (the
    ``NGDConfig`` fields of the same names; ``refresh_chunks`` > 1 and
    ``inverse_sharding`` set the double buffer too, as ``repro``'s CLI
    does) and the initial state: (model, opt, params, state).
    ``factor_wire`` sets ``ArchConfig.factor_wire`` (None keeps the
    config's)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.ngd import NGDConfig
    from repro_torch.models.transformer import DecoderLM
    if cfg is None:
        cfg = get_config(arch)
        if not full_config:
            cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, backend=backend)
    if factor_wire is not None:
        cfg = dataclasses.replace(cfg, factor_wire=factor_wire)
    model = DecoderLM(cfg, device=device).init(
        torch.Generator().manual_seed(seed))
    params = model.params()
    opt = SPNGD(model.loss, model.site_infos(), model.fstats,
                model.site_counts,
                NGDConfig(damping=damping, backend=backend,
                          inverse_method=inverse_method, estimator=estimator,
                          weight_rescale=weight_rescale, history=history,
                          sgd_fallback_scale=sgd_fallback_scale,
                          factor_dtype=factor_dtype,
                          inverse_sharding=inverse_sharding,
                          double_buffer=(double_buffer or inverse_sharding
                                         or refresh_chunks > 1),
                          refresh_chunks=refresh_chunks,
                          inverse_info=inverse_info))
    return model, opt, params, opt.init(params)


# ---------------------------------------------------------------------------
# the overhead-accounting probe (make_report.py's decomposition input)
# ---------------------------------------------------------------------------

def _probe_time(fn, *, iters: int = 3, reset: Callable = None,
                device=None) -> float:
    """Median synchronized wall microseconds of ``fn()`` over ``iters``
    calls after one warm-up call; ``reset()`` runs before every call,
    outside the timing."""
    ts = []
    for i in range(iters + 1):
        if reset is not None:
            reset()
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        if i:
            ts.append((time.perf_counter() - t0) * 1e6)
    return sorted(ts)[len(ts) // 2]


class _Snapshot:
    """A copy of the tensors a step updates in place (the parameters and
    the momentum), on their device unless it lacks room (the copy over a
    quarter of its free memory), then on the host, with the RNG states
    the ``1mc`` estimator draws from; :meth:`restore` puts every bit
    back."""

    def __init__(self, tensors: list, device):
        self.tensors = tensors
        self.device = torch.device(device)
        need = sum(t.numel() * t.element_size() for t in tensors)
        keep = self.device
        if (self.device.type == "cuda"
                and 4 * need > torch.cuda.mem_get_info(self.device)[0]):
            keep = torch.device("cpu")
        with torch.no_grad():
            self.copies = [t.detach().to(keep, copy=True) for t in tensors]
        self.rng = torch.get_rng_state()
        self.cuda_rng = (torch.cuda.get_rng_state(self.device)
                         if self.device.type == "cuda" else None)

    def restore(self) -> None:
        with torch.no_grad():
            for t, c in zip(self.tensors, self.copies):
                t.copy_(c)
        torch.set_rng_state(self.rng)
        if self.cuda_rng is not None:
            torch.cuda.set_rng_state(self.cuda_rng, self.device)


def _overhead_probe(opt: SPNGD, step_fn, fast_fn, params, state, batch: dict,
                    lr0: float, mom0: float, lam: float, logger) -> None:
    """Time the step's stage-isolated parts and emit one ``probe`` event
    (``repro``'s keys): the forward/backward alone, with the Stage-2
    capture, the fast step, the all-flags refresh step, and one
    ``damped_inverse`` per full-kind factor on an SPD stand-in shaped like
    the statistic. ``make_report.py`` combines these with the stream's
    refresh frequency into the paper's overhead decomposition. The steps
    update ``params`` and the momentum in place, so both (and the RNG
    states) are restored before every timed step and after the probe: the
    run that follows sees the weights it would have seen without it. The
    stand-ins' shapes come from the statistics template (views of one zero,
    no memory) and they are drawn on the device from a seeded generator."""
    from repro_torch.kernels import dispatch
    flat = flatten(params)
    dev = next(iter(flat.values())).device
    snap = _Snapshot(list(flat.values()) + list(state["velocity"].values()),
                     dev)
    all_on = {k: True for k in opt.stat_names()}

    def timed(fn, reset=None):
        return _probe_time(fn, reset=reset, device=dev)

    fwd_bwd_us = timed(lambda: value_and_grad(opt.loss_fn, params, batch))
    capture_us = timed(lambda: opt.grads_and_raw(params, batch))
    fast_us = timed(lambda: fast_fn(params, state, batch, lam, lr0, mom0),
                    snap.restore)
    refresh_us = timed(lambda: step_fn(params, state, batch, all_on, lam,
                                       lr0, mom0), snap.restore)
    snap.restore()
    del snap

    gen = torch.Generator(device=dev).manual_seed(0)
    inv_per_stat = {}
    for fam, stats in opt.fstats_fn().items():
        for key, leaf in stats.items():
            if key not in ("a", "g") or not opt.sym_stat(fam, key):
                continue
            shape = _dense_leaf_shape(leaf)
            b = shape[-1]
            m = torch.randn(shape, generator=gen, device=dev)
            spd = (m @ m.transpose(-1, -2) / b
                   + 0.1 * torch.eye(b, device=dev))
            del m
            inv_per_stat[f"{fam}.{key}"] = _probe_time(
                lambda: dispatch.damped_inverse(
                    spd, lam, method=opt.cfg.inverse_method,
                    backend=opt.cfg.backend),
                iters=1, device=dev)
            del spd
    logger.emit("probe", fwd_bwd_us=fwd_bwd_us, capture_us=capture_us,
                fast_us=fast_us, refresh_us=refresh_us,
                inverse_us=sum(inv_per_stat.values()),
                inverse_us_per_stat=inv_per_stat)


def run(model, opt, params, state, *, steps: int, batch: int, seq: int,
        accum: int = 1, lr: float = 2e-2, damping: float = 2.5e-4,
        log: Callable = print, comm=None, mesh=None, logger=None,
        profile=None, overhead_probe: bool = True,
        run_config: dict | None = None):
    """The step loop of :func:`main`: the ``IntervalController`` decides
    per step which statistics refresh; a step with any refresh runs the
    capture step, the others the fast step. Without ``mesh`` these are the
    single-device steps and the controller's wire, level and gather
    columns model ``comm`` (a ``repro_torch.comm.CommConfig``, dense by
    default) with every statistic scattering; with a ``DeviceMesh`` they
    are the dist steps under ``comm`` and the columns take the reducer's
    own decisions (every rank of the mesh runs this loop). The gather
    column is filled under ``inverse_sharding``. Returns (params, state,
    records) with one record per step: {"t", "kind" ("capture" | "fast"),
    "loss", "seconds" (synchronized wall time), "n_refreshed", "n_stats",
    "sims" (the Algorithm-2 distances the step measured, {} on a fast
    step)}; with Stage 4 by Newton-Schulz, a capture step's record also
    holds "inverse" ({"{fam}.{key}": {"ns_res", "ns_converged"}}
    of the refreshed blocked factors, on the host) and "fallbacks" (how many
    of their blocks the Newton-Schulz inverse left to eigh). With the
    refresh pipeline (``refresh_chunks`` K > 1) the controller never
    captures again within K steps of a capture (``min_interval`` K + 1),
    every record holds "refresh_inflight" (steps until the refresh in
    flight is live: K+1 on the capture and on the first drain step, 0 when
    idle), and a drain step's record "chunk" (the chunk it ran; K for the
    flip step) and "chunk_stats" (its statistics, [] at the flip).

    ``logger`` (a ``repro_torch.obs.MetricsLogger``, disabled by default)
    receives ``repro``'s stream: one ``run_config`` (``run_config`` adds
    the caller's fields: the CLI's arch and full_config), one ``probe``
    (:func:`_overhead_probe`, unless ``overhead_probe`` is False), a
    ``step`` per step (``kind`` "refresh" for an inline refresh, "capture"
    with K > 1, else "fast"; the records keep "capture" | "fast"), a
    ``span`` per drain step and the ``summary``. Only an enabled logger
    reads the norms to the host. ``profile`` (a
    ``repro_torch.obs.ProfileCapture``, inert by default) traces the first
    steps."""
    from repro_torch.comm import CommConfig
    from repro_torch.core.stale import IntervalController
    from repro_torch.data.synthetic import token_batches
    from repro_torch.obs import (STAGE_CHUNK, MetricsLogger, ProfileCapture,
                                 inverse_tally)
    from repro_torch.optim.schedules import polynomial_decay
    from repro_torch.quant.quant import FACTOR_DTYPES
    logger = logger or MetricsLogger()
    profile = profile or ProfileCapture(None)
    cfg = model.cfg
    k = opt.cfg.refresh_chunks
    comm = comm or CommConfig()
    sharding = opt.cfg.inverse_sharding
    if mesh is None:
        step_fn = make_train_step(model, opt, accum=accum)
        fast_fn = make_fast_step(model, opt, accum=accum)
        wire, levels = opt.wire_bytes(comm), opt.wire_level_bytes(comm)
        gather = opt.gather_bytes() if sharding else None
        report = {"strategy": comm.strategy, "wire_dtype": comm.wire_dtype}
    else:
        step_fn = make_dist_train_step(model, opt, mesh, accum=accum,
                                       comm=comm)
        fast_fn = make_dist_fast_step(model, opt, mesh, accum=accum,
                                      comm=comm)
        red = step_fn.reducer
        wire, levels = (red.wire_bytes_per_stat(),
                        red.wire_bytes_per_stat_levels())
        gather = red.gather_bytes_per_stat() if sharding else None
        report = red.scatter_report()
    ctrl = IntervalController(opt.stat_names(), alpha=opt.cfg.alpha,
                              # a drain takes K chunk steps and the flip:
                              # never capture again before it ends
                              min_interval=k + 1 if k > 1 else 1,
                              bytes_per_stat=opt.stat_bytes(),
                              wire_bytes_per_stat=wire,
                              wire_level_bytes_per_stat=levels,
                              gather_bytes_per_stat=gather)
    ctrl.record_comm({**report, "inverse_sharding": sharding,
                      "double_buffer": opt.cfg.double_buffer,
                      "refresh_chunks": k})
    data = token_batches(cfg.vocab, batch, seq, seed=0)
    lr_fn = polynomial_decay(lr, 0, steps, 4.0)
    dev = model.device
    logger.emit("run_config", arch=cfg.name, **(run_config or {}),
                n_params=sum(p.numel() for p in model.parameters()),
                steps=steps, batch=batch, seq=seq, accum=accum, lr=lr,
                damping=damping, backend=opt.cfg.backend,
                factor_dtype=next(n for n, d in FACTOR_DTYPES.items()
                                  if d == opt.cfg.factor_dtype),
                inverse_method=opt.cfg.inverse_method,
                comm_strategy=comm.strategy, wire_dtype=comm.wire_dtype,
                inverse_sharding=sharding,
                double_buffer=opt.cfg.double_buffer, refresh_chunks=k,
                device=str(dev), estimator=opt.cfg.estimator,
                weight_rescale=opt.cfg.weight_rescale,
                history=opt.cfg.history,
                sgd_fallback_scale=opt.cfg.sgd_fallback_scale,
                factor_wire=cfg.factor_wire)
    # the Stage-4 tallies' per-block-size rollup needs each full-kind
    # factor's block size, which the info tensors do not carry
    block_sizes = {f"{fam}.{key}": _dense_leaf_shape(leaf)[-1]
                   for fam, stats in opt.fstats_fn().items()
                   for key, leaf in stats.items()
                   if key in ("a", "g") and opt.sym_stat(fam, key)}
    if logger.enabled and overhead_probe:
        # a generator of its own: the probe does not advance the training
        # stream, so a metrics run sees the batches of a default run
        probe_batch = {k: v.to(dev) for k, v in next(token_batches(
            cfg.vocab, batch, seq, seed=1)).items()}
        _overhead_probe(opt, step_fn, fast_fn, params, state, probe_batch,
                        lr_fn(0), 0.9 * lr_fn(0) / lr, damping, logger)
    records = []
    for t in range(1, steps + 1):
        b = {k: v.to(dev) for k, v in next(data).items()}
        lr_t = lr_fn(t - 1)
        mom = 0.9 * lr_t / lr
        flags = ctrl.flags(t)
        profile.step_start(t)
        _sync(dev)
        t0 = time.perf_counter()
        if any(flags.values()):
            params, state, m = step_fn(params, state, b, flags, damping,
                                       lr_t, mom)
            kind = "capture"
            ctrl.update(t, flags, m["sims"])
        else:
            params, state, m = fast_fn(params, state, b, damping, lr_t, mom)
            kind = "fast"
            ctrl.update(t, flags, {})
        loss = float(m["loss"])
        _sync(dev)
        dt = time.perf_counter() - t0
        rec = {"t": t, "kind": kind, "loss": loss, "seconds": dt,
               "n_refreshed": sum(flags.values()), "n_stats": len(flags),
               "sims": m["sims"]}
        note = ""
        if "refresh_inflight" in m:
            infl = rec["refresh_inflight"] = m["refresh_inflight"]
            if kind == "fast" and infl > 0:
                rec["chunk"] = k + 1 - infl
                rec["chunk_stats"] = (opt.pipeline.chunk_names(rec["chunk"])
                                      if rec["chunk"] < k else [])
                note = (f" chunk {rec['chunk']}/{k}" if rec["chunk"] < k
                        else " flip")
        if "inverse_info" in m and opt.cfg.inverse_method == "newton_schulz":
            rec["inverse"] = {
                n: {k: v.cpu() for k, v in i.items()}
                for n, i in m["inverse_info"].items()
                if bool((i["ns_res"] >= 0).all())}
            rec["fallbacks"] = sum(int((~i["ns_converged"]).sum())
                                   for i in rec["inverse"].values())
            blocks = sum(i["ns_res"].numel() for i in rec["inverse"].values())
            note = f" eigh fallback {rec['fallbacks']}/{blocks} blocks"
        records.append(rec)
        if logger.enabled:
            trigger = kind == "capture"
            evt = {"kind": ("capture" if trigger and k > 1 else
                            "refresh" if trigger else "fast"),
                   "lr": lr_t, "mom": mom,
                   "n_refreshed": rec["n_refreshed"], "n_stats": len(flags),
                   "refreshed": sorted(n for n, v in flags.items() if v),
                   "grad_norm": float(m["grad_norm"]),
                   "update_norm": float(m["update_norm"]),
                   "comm": ctrl.drain()}
            if "refresh_inflight" in rec:
                evt["refresh_inflight"] = rec["refresh_inflight"]
            if "chunk" in rec:
                # the step window this chunk (or the flip) ran in
                logger.emit("span", name=f"{STAGE_CHUNK}["
                            f"{rec['chunk'] if rec['chunk'] < k else 'flip'}]",
                            start=t0, dur=dt, depth=0, parent=None, step=t,
                            stats=rec["chunk_stats"])
            if "inverse_info" in m:
                evt["inverse"] = inverse_tally(m["inverse_info"], block_sizes)
            logger.log_step(t, loss=loss, dt=dt, **evt)
        profile.step_end(t)
        if t % 10 == 0 or t == 1 or t == steps:
            log(f"step {t:4d} {kind:7s} loss {loss:.4f} lr {lr_t:.4f} "
                f"refresh {sum(flags.values())}/{len(flags)} {dt:.3f} s"
                + note)
    profile.stop()
    s = ctrl.summary()
    log(f"statistic traffic: {100 * s['reduction_rate']:.1f}% of dense; "
        f"modelled wire [{comm.strategy}/{comm.wire_dtype}]: "
        f"{s['comm']['total_wire_bytes']} B "
        f"({100 * s['comm']['wire_reduction_rate']:.1f}% of "
        f"refresh-every-step)")
    if sharding:
        log(f"modelled Stage-4 gather (sym-packed f32): "
            f"{s['comm']['total_gather_bytes']} B")
    logger.emit("summary", **ctrl.summary_flat())
    return params, state, records


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def _refuse_arch(ap, arch: str) -> None:
    """Stop before anything is built when the loop cannot feed ``arch``:
    it draws token batches only (``data.synthetic.token_batches``, as
    ``repro``'s CLI does), so a vision-frontend config, whose batches need
    ``pixel_embeds``, and the ConvNet, which has its own trainer, are
    refused with the reason."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ArchConfig
    cfg = get_config(arch)
    if not isinstance(cfg, ArchConfig):
        ap.error(f"--arch {arch}: the ConvNet trains through "
                 f"repro_torch.launch.train_convnet")
    if cfg.frontend == "vision":
        ap.error(f"--arch {arch}: its batches need pixel_embeds (the "
                 f"vision frontend's {cfg.frontend_tokens} patch embeddings "
                 f"of dim {cfg.frontend_dim}), and this trainer feeds token "
                 f"batches only (data.synthetic.token_batches, as repro's "
                 f"CLI does); drive DecoderLM.loss with a batch that "
                 f"carries pixel_embeds instead")


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        description="SP-NGD trainer of repro_torch: on the card unless "
                    "--device cpu (reduced configs unless --full-config)")
    ap.add_argument("--arch", default="llama3_2_1b",
                    help="a registered text decoder: llama3_2_1b, "
                         "llama3_2_3b, qwen1_5_4b, musicgen_medium, "
                         "nemotron_4_340b, the MoE mixtral_8x22b and "
                         "qwen2_moe_a2_7b, the recurrent rwkv6_7b and "
                         "hymba_1_5b (llava_next_34b is refused: its "
                         "batches need pixel_embeds)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=2e-2)
    ap.add_argument("--damping", type=float, default=2.5e-4)
    ap.add_argument("--backend", default="auto", choices=["ref", "cuda",
                                                          "auto"],
                    help="kernel backend of the hot paths "
                         "(repro_torch.kernels.dispatch): auto takes the "
                         "CUDA kernels for tensors on the card")
    ap.add_argument("--inverse-method", default="eigh",
                    choices=["eigh", "cholesky", "newton_schulz"],
                    help="Stage-4 factor inversion; newton_schulz runs the "
                         "matmul-only iteration (Newton-Schulz kernels on "
                         "the card) and logs its eigh fallbacks")
    from repro_torch.quant.quant import FACTOR_DTYPES
    ap.add_argument("--factor-dtype", default="f32",
                    choices=sorted(FACTOR_DTYPES),
                    help="storage dtype of the X_-1/X_-2 factor history and "
                         "of the statistics payload ledger; the fp8 variants "
                         "store sym-packed payloads + per-block scales and "
                         "dequantize on read (fp8 kernels on the card)")
    ap.add_argument("--factor-wire", default="", choices=["", "e4m3", "e5m2"],
                    help="fused fp8 capture: full-kind factor sums leave the "
                         "backward as sym-packed fp8 payloads + per-block "
                         "scales (ArchConfig.factor_wire; needs --accum 1)")
    ap.add_argument("--estimator", default="emp", choices=["emp", "1mc"],
                    help="Fisher estimator: empirical (true labels) or one "
                         "Monte-Carlo sample of the model's own labels")
    ap.add_argument("--weight-rescale", action="store_true",
                    help="rescale each dense weight to norm sqrt(2 d_out) "
                         "after the update (Eq. 24)")
    ap.add_argument("--history", type=int, default=2, choices=[1, 2],
                    help="factor history of the staleness test: 2 compares "
                         "with X_-1 and X_-2 (Algorithm 2), 1 with X_-1 only")
    ap.add_argument("--sgd-fallback-scale", type=float, default=1.0,
                    help="learning-rate scale of the parameters no "
                         "curvature site covers")
    ap.add_argument("--double-buffer", action="store_true",
                    help="stage each refresh's inverses and apply them from "
                         "the next step on (NGDConfig.double_buffer)")
    ap.add_argument("--refresh-chunks", type=int, default=1,
                    help="chunked refresh pipeline (repro_torch.core."
                         "pipeline): K>1 turns each refresh into a capture "
                         "step (Stage-2/3 + similarities only) followed by K "
                         "drain chunks of Stage-4 inversions, one run in "
                         "each subsequent fast step, activated atomically "
                         "K+1 steps after the capture. Implies "
                         "--double-buffer and floors the refresh interval "
                         "at K+1 so a drain always completes. 1 = inline "
                         "refresh (default)")
    from repro_torch import comm as comm_lib
    ap.add_argument("--comm-strategy", default="dense",
                    choices=comm_lib.STRATEGIES,
                    help="Stage-3 factor reduce strategy (repro_torch.comm): "
                         "dense reduce-scatter, ring over sym-packed "
                         "triangles, ring_fp8 (fp8 hops, f32 accumulation), "
                         "hier (intra-host f32 + inter-host fp8 rings) or "
                         "fused (wire-format capture). This one-process CLI "
                         "runs the single-device steps: the flag sets the "
                         "config and MODELS the wire ledger; the collectives "
                         "run under make_dist_train_step")
    ap.add_argument("--wire-dtype", default=None,
                    choices=sorted(comm_lib.WIRE_DTYPES),
                    help="collective wire dtype; defaults to f32 for "
                         "dense/ring and fp8_e4m3 for ring_fp8/hier/fused")
    ap.add_argument("--devices-per-host", type=int, default=None,
                    help="host-topology model of the hier strategy: the "
                         "intra-host group width (default: "
                         "LOCAL_WORLD_SIZE, else the world size)")
    ap.add_argument("--inverse-sharding", action="store_true",
                    help="Stage-4 distribution: invert only the local "
                         "factor chunk and all-gather the preconditioners "
                         "as sym-packed f32 triangles. Implies "
                         "--double-buffer. In this one-process CLI the flag "
                         "MODELS the gather ledger; the sharded inversion "
                         "runs under make_dist_train_step")
    ap.add_argument("--full-config", action="store_true",
                    help="use the full (non-reduced) architecture")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--metrics-jsonl", default=None, metavar="PATH",
                    help="write the per-step JSONL event stream here "
                         "(repro_torch.obs.MetricsLogger, repro's schema): "
                         "loss/lr/norms, refresh decisions, drained "
                         "comm-ledger bytes, Stage-4 inversion tallies, "
                         "step-time EMA + p50/p99. Console text is "
                         "unchanged (and mirrored into the stream)")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="trace the first --profile-steps steps with "
                         "torch.profiler into DIR/trace.json (Chrome "
                         "trace; stage ranges spngd.stage*.* and kernel "
                         "ranges repro.kernels.<op>[<backend>] name the "
                         "regions)")
    ap.add_argument("--profile-steps", type=int, default=3,
                    help="length of the --profile-dir capture window")
    ap.add_argument("--no-overhead-probe", action="store_true",
                    help="skip the stage-isolated timing probe that "
                         "metrics-enabled runs emit for make_report.py's "
                         "overhead-accounting table")
    args = ap.parse_args(argv)
    _refuse_arch(ap, args.arch)

    from repro_torch.models.transformer import resolve_device
    from repro_torch.obs import MetricsLogger, ProfileCapture
    device = resolve_device(args.device)
    refresh_chunks = max(1, args.refresh_chunks)
    model, opt, params, state = build(
        args.arch, full_config=args.full_config, backend=args.backend,
        damping=args.damping, inverse_method=args.inverse_method,
        estimator=args.estimator, weight_rescale=args.weight_rescale,
        history=args.history, sgd_fallback_scale=args.sgd_fallback_scale,
        factor_dtype=FACTOR_DTYPES[args.factor_dtype],
        factor_wire=args.factor_wire, double_buffer=args.double_buffer,
        refresh_chunks=refresh_chunks,
        inverse_sharding=args.inverse_sharding,
        # metrics runs surface the per-block Stage-4 diagnostics; a capture
        # step of the chunked pipeline inverts nothing, so there is nothing
        # to report under it
        inverse_info=args.metrics_jsonl is not None and refresh_chunks == 1,
        device=device)
    comm = comm_lib.make_comm_config(args.comm_strategy, args.wire_dtype,
                                     backend=args.backend,
                                     devices_per_host=args.devices_per_host)
    n = sum(p.numel() for p in model.parameters())
    with MetricsLogger(args.metrics_jsonl) as logger:
        logger.console(f"arch={args.arch} "
                       f"({'full' if args.full_config else 'reduced'}), "
                       f"{n / 1e6:.1f}M params, device {device}, factor "
                       f"history {args.factor_dtype}, capture "
                       f"{args.factor_wire or 'f32'}")
        return run(
            model, opt, params, state, steps=args.steps, batch=args.batch,
            seq=args.seq, accum=args.accum, lr=args.lr, damping=args.damping,
            log=logger.console, comm=comm, logger=logger,
            profile=ProfileCapture(args.profile_dir, args.profile_steps,
                                   device=device),
            overhead_probe=not args.no_overhead_probe,
            run_config={"full_config": args.full_config})


if __name__ == "__main__":
    main()
