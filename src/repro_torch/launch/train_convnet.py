"""The paper's training scheme on the ConvNet (counterpart of
``examples/train_convnet_paper.py``): SP-NGD with the empirical Fisher,
unit-wise (or full) BatchNorm Fisher, adaptive stale statistics, running
mixup (Eq. 18-19), random erasing with zero value, polynomial LR decay
(Eq. 21), coupled momentum (Eq. 22) and weight norm rescaling (Eq. 24).

    python -m repro_torch.launch.train_convnet                 # on the card
    python -m repro_torch.launch.train_convnet --device cpu --steps 20
    python -m repro_torch.launch.train_convnet --arch resnet50 \\
        --image-size 32 --batch 1024 --steps 8 --bn-fisher full

Without ``--arch`` the model is the example's ``ConvNetConfig(widths=(16,
32), blocks_per_stage=2)``; ``--arch resnet50`` takes the registered
full-width config. Each step the ``IntervalController`` decides which
statistics refresh: a step with any refresh runs ``SPNGD.step`` (capture),
the others ``SPNGD.step_fast``. Step 1 and every 20th step also measure the
accuracy on a clean batch of the stream.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from repro_torch.models.resnet import ConvNetConfig

# the model of examples/train_convnet_paper.py
EXAMPLE_CONFIG = ConvNetConfig(widths=(16, 32), blocks_per_stage=2)
PROBE_EVERY = 20


def build(arch: str | None = None, *, cfg: ConvNetConfig | None = None,
          bn_fisher: str | None = None, backend: str = "auto",
          damping: float = 2.5e-4, inverse_method: str = "eigh",
          device=None):
    """The ConvNet (random weights from seed 0), its SP-NGD optimizer
    (``NGDConfig(damping, weight_rescale=True)``, the given backend and
    inverse method) and the initial state: (model, opt, params, state).
    The config is ``cfg``, else the registered ``arch``, else the
    example's; ``bn_fisher`` and ``backend`` override its fields."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.ngd import NGDConfig, SPNGD
    from repro_torch.models.resnet import ConvNet
    if cfg is None:
        cfg = get_config(arch) if arch else EXAMPLE_CONFIG
    if not isinstance(cfg, ConvNetConfig):
        raise ValueError(f"train_convnet trains a ConvNet; {arch!r} is "
                         f"not one (launch.train trains the LMs)")
    cfg = dataclasses.replace(cfg, backend=backend,
                              bn_fisher=bn_fisher or cfg.bn_fisher)
    model = ConvNet(cfg, device=device).init(torch.Generator().manual_seed(0))
    params = model.params()
    opt = SPNGD(model.loss, model.site_infos(), model.fstats,
                model.site_counts,
                NGDConfig(damping=damping, weight_rescale=True,
                          backend=backend, inverse_method=inverse_method))
    return model, opt, params, opt.init(params)


def run(model, opt, params, state, *, steps: int, batch: int,
        image_size: int = 16, lr: float = 0.05, damping: float = 2.5e-4,
        alpha_mixup: float = 0.4, log: Callable = print):
    """The example's loop: each step draws a batch of ``image_batches``
    (seed 0), randomly erases it, mixes it with the running mixup, and takes
    the capture or the fast step as the controller's flags say, at
    ``polynomial_decay(lr, 1, steps, 4)`` with momentum 0.9 * lr_t / lr.
    Returns (params, state, records), one record per step: {"t", "kind"
    ("capture" | "fast"), "loss", "seconds" (synchronized wall time of the
    step), "lr", "mom", "refreshed" (the flagged statistics, sorted),
    "n_stats", "sims"} and, on a probe step, "acc"."""
    from repro_torch.core.stale import IntervalController
    from repro_torch.data.augment import RunningMixup, random_erase
    from repro_torch.data.synthetic import image_batches
    from repro_torch.optim.schedules import polynomial_decay
    n_classes = model.cfg.n_classes
    dev = model.device
    ctrl = IntervalController(opt.stat_names(), alpha=0.1,
                              bytes_per_stat=opt.stat_bytes())
    data = image_batches(n_classes, batch, size=image_size, seed=0,
                         device=dev)
    mixup = RunningMixup(alpha_mixup, n_classes, seed=0)
    rng = np.random.RandomState(0)
    lr_fn = polynomial_decay(lr, 1, steps, 4.0)
    records = []
    for t in range(1, steps + 1):
        raw = next(data)
        x, y = mixup(random_erase(rng, raw["images"]), raw["labels"])
        b = {"images": x, "labels": y}
        lr_t = lr_fn(t - 1)
        mom = 0.9 * lr_t / lr                     # Eq. 22
        flags = ctrl.flags(t)
        _sync(dev)
        t0 = time.perf_counter()
        if any(flags.values()):
            params, state, m = opt.step(params, state, b, flags, damping,
                                        lr_t, mom)
            kind = "capture"
            ctrl.update(t, flags, m["sims"])
        else:
            params, state, m = opt.step_fast(params, state, b, damping, lr_t,
                                             mom)
            kind = "fast"
            ctrl.update(t, flags, {})
        loss = float(m["loss"])
        _sync(dev)
        rec = {"t": t, "kind": kind, "loss": loss,
               "seconds": time.perf_counter() - t0, "lr": lr_t, "mom": mom,
               "refreshed": sorted(n for n, v in flags.items() if v),
               "n_stats": len(flags), "sims": m["sims"]}
        if t % PROBE_EVERY == 0 or t == 1:        # clean-data accuracy
            probe = next(data)
            with torch.no_grad():
                logits = model(probe["images"])
            rec["acc"] = float((logits.argmax(-1) == probe["labels"])
                               .float().mean())
            log(f"step {t:4d} loss {loss:.4f} acc {rec['acc']:.3f} "
                f"lr {lr_t:.4f} refresh {len(rec['refreshed'])}/"
                f"{len(flags)} {kind} {rec['seconds']:.3f} s")
        records.append(rec)
    s = ctrl.summary()
    accs = [r["acc"] for r in records if "acc" in r]
    log(f"final acc {accs[-1]:.3f}; statistics traffic "
        f"{100 * s['reduction_rate']:.1f}% of refresh-every-step "
        f"(paper Table 2 'reduction')")
    return params, state, records


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        description="The paper's training scheme on repro_torch's ConvNet: "
                    "on the card unless --device cpu")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--damping", type=float, default=2.5e-4)
    ap.add_argument("--alpha-mixup", type=float, default=0.4)
    ap.add_argument("--arch", default=None, choices=["resnet50"],
                    help="the registered full-width config (default: the "
                         "example's widths (16, 32), 2 blocks per stage)")
    ap.add_argument("--image-size", type=int, default=16)
    ap.add_argument("--bn-fisher", default=None, choices=["unit", "full"],
                    help="BatchNorm Fisher: unit-wise 2x2 (Eq. 15-17, the "
                         "config's default) or the full 2C x 2C baseline")
    ap.add_argument("--inverse-method", default="eigh",
                    choices=["eigh", "cholesky", "newton_schulz"],
                    help="Stage-4 inversion of the conv and head factors "
                         "(the full BN Fisher always takes eigh)")
    ap.add_argument("--backend", default="auto",
                    choices=["ref", "cuda", "auto"],
                    help="kernel backend (repro_torch.kernels.dispatch): "
                         "auto takes the CUDA kernels for tensors on the "
                         "card")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    from repro_torch.models.transformer import resolve_device
    device = resolve_device(args.device)
    model, opt, params, state = build(
        args.arch, bn_fisher=args.bn_fisher, backend=args.backend,
        damping=args.damping, inverse_method=args.inverse_method,
        device=device)
    cfg = model.cfg
    print(f"ConvNet widths {cfg.widths} x {cfg.blocks_per_stage} blocks, "
          f"bn_fisher {cfg.bn_fisher}, "
          f"{sum(p.numel() for p in model.parameters())} params, "
          f"{len(opt.stat_names())} statistics, device {device}, batch "
          f"{args.batch} x {args.image_size}^2", flush=True)
    return run(model, opt, params, state, steps=args.steps,
               batch=args.batch, image_size=args.image_size, lr=args.lr,
               damping=args.damping, alpha_mixup=args.alpha_mixup,
               log=lambda m: print(m, flush=True))


if __name__ == "__main__":
    main()
