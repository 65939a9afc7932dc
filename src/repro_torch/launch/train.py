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
    python -m repro_torch.launch.train --full-config --factor-dtype fp8_e4m3
    python -m repro_torch.launch.train --full-config --double-buffer
    python -m repro_torch.launch.train --full-config --refresh-chunks 4
"""

from __future__ import annotations

import time
from typing import Callable

import torch

from repro_torch.core.fisher import flatten, unflatten, value_and_grad
from repro_torch.core.ngd import SPNGD


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


def build(arch: str = "llama3_2_1b", *, full_config: bool = False,
          backend: str = "auto", damping: float = 2.5e-4,
          inverse_method: str = "eigh", estimator: str = "emp",
          weight_rescale: bool = False, history: int = 2,
          sgd_fallback_scale: float = 1.0, factor_dtype=torch.float32,
          factor_wire: str | None = None, double_buffer: bool = False,
          refresh_chunks: int = 1, device=None, seed: int = 0, cfg=None):
    """The model (random weights from ``seed``), its optimizer (the
    ``NGDConfig`` fields of the same names; ``refresh_chunks`` > 1 sets
    the double buffer too) and the initial state: (model, opt, params,
    state). ``factor_wire`` sets ``ArchConfig.factor_wire`` (None keeps
    the config's)."""
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
                          double_buffer=double_buffer or refresh_chunks > 1,
                          refresh_chunks=refresh_chunks))
    return model, opt, params, opt.init(params)


def run(model, opt, params, state, *, steps: int, batch: int, seq: int,
        accum: int = 1, lr: float = 2e-2, damping: float = 2.5e-4,
        log: Callable = print):
    """The step loop of :func:`main`: the ``IntervalController`` decides
    per step which statistics refresh; a step with any refresh runs the
    capture step, the others the fast step. Returns (params, state,
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
    flip step) and "chunk_stats" (its statistics, [] at the flip)."""
    from repro_torch.core.stale import IntervalController
    from repro_torch.data.synthetic import token_batches
    from repro_torch.optim.schedules import polynomial_decay
    cfg = model.cfg
    k = opt.cfg.refresh_chunks
    ctrl = IntervalController(opt.stat_names(), alpha=opt.cfg.alpha,
                              # a drain takes K chunk steps and the flip:
                              # never capture again before it ends
                              min_interval=k + 1 if k > 1 else 1,
                              bytes_per_stat=opt.stat_bytes())
    data = token_batches(cfg.vocab, batch, seq, seed=0)
    lr_fn = polynomial_decay(lr, 0, steps, 4.0)
    step_fn = make_train_step(model, opt, accum=accum)
    fast_fn = make_fast_step(model, opt, accum=accum)
    dev = model.device
    records = []
    for t in range(1, steps + 1):
        b = {k: v.to(dev) for k, v in next(data).items()}
        lr_t = lr_fn(t - 1)
        mom = 0.9 * lr_t / lr
        flags = ctrl.flags(t)
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
        if "inverse_info" in m:
            rec["inverse"] = {
                n: {k: v.cpu() for k, v in i.items()}
                for n, i in m["inverse_info"].items()
                if bool((i["ns_res"] >= 0).all())}
            rec["fallbacks"] = sum(int((~i["ns_converged"]).sum())
                                   for i in rec["inverse"].values())
            blocks = sum(i["ns_res"].numel() for i in rec["inverse"].values())
            note = f" eigh fallback {rec['fallbacks']}/{blocks} blocks"
        records.append(rec)
        if t % 10 == 0 or t == 1 or t == steps:
            log(f"step {t:4d} {kind:7s} loss {loss:.4f} lr {lr_t:.4f} "
                f"refresh {sum(flags.values())}/{len(flags)} {dt:.3f} s"
                + note)
    s = ctrl.summary()
    log(f"statistic traffic: {100 * s['reduction_rate']:.1f}% of dense")
    return params, state, records


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        description="SP-NGD trainer of repro_torch: on the card unless "
                    "--device cpu (reduced configs unless --full-config)")
    ap.add_argument("--arch", default="llama3_2_1b")
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
    ap.add_argument("--full-config", action="store_true",
                    help="use the full (non-reduced) architecture")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.models.transformer import resolve_device
    device = resolve_device(args.device)
    model, opt, params, state = build(
        args.arch, full_config=args.full_config, backend=args.backend,
        damping=args.damping, inverse_method=args.inverse_method,
        estimator=args.estimator, weight_rescale=args.weight_rescale,
        history=args.history, sgd_fallback_scale=args.sgd_fallback_scale,
        factor_dtype=FACTOR_DTYPES[args.factor_dtype],
        factor_wire=args.factor_wire, double_buffer=args.double_buffer,
        refresh_chunks=max(1, args.refresh_chunks), device=device)
    n = sum(p.numel() for p in model.parameters())
    print(f"arch={args.arch} ({'full' if args.full_config else 'reduced'}), "
          f"{n / 1e6:.1f}M params, device {device}, factor history "
          f"{args.factor_dtype}, capture {args.factor_wire or 'f32'}",
          flush=True)
    run(model, opt, params, state, steps=args.steps, batch=args.batch,
        seq=args.seq, accum=args.accum, lr=args.lr, damping=args.damping,
        log=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
