"""Small ResNet (CIFAR-scale), the paper-faithful substrate (counterpart of
``repro/models/resnet.py``).

The paper trains ResNet-50 on ImageNet; this scaled-down ResNet exercises
its technique set: conv-layer K-FAC through im2col (Eq. 10-11), BatchNorm
scale/bias with the unit-wise 2x2 Fisher (Eq. 15-17) or the full 2C x 2C
one (Fig. 5's baseline, ``bn_fisher="full"``), trained by
``launch/train_convnet.py`` with running mixup and random erasing (section
6.1), polynomial decay and coupled momentum (6.2) and weight rescaling
(6.3). BatchNorm uses in-batch statistics (population variance, no moving
averages).

Activations are channels-last ``(B, H, W, C)``, as in the JAX package, so
a conv site's output gradient is a ``(B*H*W, cout)`` view. Conv weights are
torch's ``(cout, cin, kh, kw)``; ``w.reshape(cout, -1)`` is the transpose
of the JAX package's ``(cin*kh*kw, cout)`` matrix, so the factors match it
element for element (``repro_torch.convert`` moves weights between the
layouts). The head is dense ``(d_in, d_out)``.

Surface, as :class:`repro_torch.models.transformer.DecoderLM`'s:
``init(generator)``, ``forward(images, fstats, params)``, the objective
``loss(params, fstats, batch)`` (hard or soft labels), and the SP-NGD
wiring ``params()`` / ``site_infos()`` / ``fstats()`` /
``site_counts(batch)``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import check_backend
from repro_torch.core import tagging
from repro_torch.core.fisher import SiteInfo
from repro_torch.core.tagging import FactorSpec
from repro_torch.models.layers import he_normal
from repro_torch.models.transformer import (_device_generator, _param_tree,
                                            resolve_device)

BN_FISHERS = ("unit", "full")


@dataclasses.dataclass(frozen=True)
class ConvNetConfig:
    n_classes: int = 10
    widths: tuple = (16, 32, 64)
    blocks_per_stage: int = 2
    in_channels: int = 3
    kfac_max_dim: int = 2048
    bn_fisher: str = "unit"      # "unit" (Eq. 15) | "full" (Fig. 5 baseline)
    backend: str = "auto"        # "ref" | "cuda" | "auto" (kernels.dispatch)

    def __post_init__(self):
        check_backend(self.backend)
        if self.bn_fisher not in BN_FISHERS:
            raise ValueError(f"bn_fisher {self.bn_fisher!r} not in "
                             f"{BN_FISHERS}")


def _batchnorm(x, gamma, beta, stats, eps: float = 1e-5):
    """In-batch BatchNorm over (B, H, W), population variance."""
    mu = x.mean((0, 1, 2), keepdim=True)
    var = x.var((0, 1, 2), keepdim=True, correction=0)
    xhat = (x - mu) * torch.rsqrt(var + eps)
    return tagging.scale_bias_site(xhat, gamma, beta, stats, spatial=2)


def _stride(si: int, bi: int) -> int:
    return 2 if (bi == 0 and si > 0) else 1


class ConvNet(nn.Module):
    def __init__(self, cfg: ConvNetConfig = ConvNetConfig(), device=None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.spec = FactorSpec(max_dim=cfg.kfac_max_dim, backend=cfg.backend)

        def conv(cout, cin, k):
            return torch.empty((cout, cin, k, k), device=self.device)

        def ones(n):
            return torch.ones(n, device=self.device)

        def zeros(n):
            return torch.zeros(n, device=self.device)

        w0 = cfg.widths[0]
        self.add_module("stem", _param_tree({
            "w": conv(w0, cfg.in_channels, 3), "gamma": ones(w0),
            "beta": zeros(w0)}))
        c_in = w0
        for si, w in enumerate(cfg.widths):
            for bi in range(cfg.blocks_per_stage):
                blk = {"w1": conv(w, c_in, 3), "g1": ones(w), "b1": zeros(w),
                       "w2": conv(w, w, 3), "g2": ones(w), "b2": zeros(w)}
                if _stride(si, bi) != 1 or c_in != w:
                    blk["wskip"] = conv(w, c_in, 1)
                self.add_module(f"s{si}b{bi}", _param_tree(blk))
                c_in = w
        self.add_module("head", _param_tree({
            "w": torch.empty((c_in, cfg.n_classes), device=self.device)}))

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "ConvNet":
        """HeNormal conv and head weights (fan-in cin*kh*kw, and d_in), unit
        BatchNorm scales, zero shifts: the JAX package's distributions,
        deterministic in the generator's seed (its bits cannot match
        ``jax.random``)."""
        g = _device_generator(generator, self.device)
        for name, p in self.params().items():
            for key, t in p.items():
                if t.dim() == 4:
                    t.copy_(he_normal(g, tuple(t.shape),
                                      fan_in=t[0].numel(), device=self.device))
                elif t.dim() == 2:
                    t.copy_(he_normal(g, tuple(t.shape), device=self.device))
                elif key in ("gamma", "g1", "g2"):
                    t.fill_(1.0)
                else:
                    t.zero_()
        return self

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------

    def forward(self, images: torch.Tensor, fstats: dict | None = None,
                params: dict | None = None) -> torch.Tensor:
        """images (B, H, W, in_channels) -> logits (B, n_classes); with
        ``fstats`` (the accumulators of :meth:`fstats`) every site is
        tagged."""
        cfg = self.cfg
        params = params if params is not None else self.params()
        sp = self.spec

        def g(n):
            return fstats.get(n) if fstats else None

        x = images.to(self.device, torch.float32)
        p = params["stem"]
        h = tagging.conv_site(x, p["w"], g("stem_w"), spec=sp)
        h = F.relu(_batchnorm(h, p["gamma"], p["beta"], g("stem_bn")))
        for si in range(len(cfg.widths)):
            for bi in range(cfg.blocks_per_stage):
                name = f"s{si}b{bi}"
                p = params[name]
                stride = _stride(si, bi)
                y = tagging.conv_site(h, p["w1"], g(f"{name}_w1"),
                                      stride=stride, spec=sp)
                y = F.relu(_batchnorm(y, p["g1"], p["b1"], g(f"{name}_bn1")))
                y = tagging.conv_site(y, p["w2"], g(f"{name}_w2"), spec=sp)
                y = _batchnorm(y, p["g2"], p["b2"], g(f"{name}_bn2"))
                if "wskip" in p:
                    h = tagging.conv_site(h, p["wskip"], g(f"{name}_wskip"),
                                          stride=stride, spec=sp)
                h = F.relu(h + y)
        h = h.mean((1, 2))                          # global average pool
        return tagging.dense_site(h, params["head"]["w"], g("head"), sp)

    def loss(self, params: dict, fstats: dict | None, batch: dict):
        """Mean NLL against hard (B,) or soft (B, n_classes) labels:
        (loss, {"logits"})."""
        logits = self.forward(batch["images"], fstats, params)
        labels = batch["labels"].to(self.device)
        logp = F.log_softmax(logits.float(), dim=-1)
        if labels.dim() == 1:                       # hard labels
            nll = -torch.gather(logp, -1, labels.long()[:, None]).mean()
        else:                                       # soft labels (mixup)
            nll = -(labels * logp).sum(-1).mean()
        return nll, {"logits": logits}

    # ------------------------------------------------------------------
    # SP-NGD wiring
    # ------------------------------------------------------------------

    def params(self) -> dict:
        """{"stem": {...}, "s0b0": {...}, ..., "head": {"w"}}: plain dicts
        of the model's own tensors."""
        return {name: dict(m.items()) for name, m in self.named_children()}

    def site_infos(self) -> dict[str, SiteInfo]:
        cfg = self.cfg
        sp = self.spec
        w0 = cfg.widths[0]
        infos = {
            "stem_w": SiteInfo("conv", "stem/w", 9 * cfg.in_channels, w0, sp,
                               ksize=3),
            "stem_bn": SiteInfo("scale_bias", "stem/gamma", w0, w0,
                                beta_param="stem/beta"),
            "head": SiteInfo("dense", "head/w", cfg.widths[-1],
                             cfg.n_classes, sp),
        }
        c_in = w0
        for si, w in enumerate(cfg.widths):
            for bi in range(cfg.blocks_per_stage):
                nm = f"s{si}b{bi}"
                infos[f"{nm}_w1"] = SiteInfo("conv", f"{nm}/w1", 9 * c_in, w,
                                             sp, ksize=3)
                infos[f"{nm}_bn1"] = SiteInfo("scale_bias", f"{nm}/g1", w, w,
                                              beta_param=f"{nm}/b1")
                infos[f"{nm}_w2"] = SiteInfo("conv", f"{nm}/w2", 9 * w, w,
                                             sp, ksize=3)
                infos[f"{nm}_bn2"] = SiteInfo("scale_bias", f"{nm}/g2", w, w,
                                              beta_param=f"{nm}/b2")
                if _stride(si, bi) != 1 or c_in != w:
                    infos[f"{nm}_wskip"] = SiteInfo("conv", f"{nm}/wskip",
                                                    c_in, w, sp, ksize=1)
                c_in = w
        return infos

    def fstats(self) -> dict:
        """Zero factor-statistic accumulators {family: stats}: blocked A and
        G for the conv and dense sites, ``uw`` (or ``uwf`` under
        ``bn_fisher="full"``) for the BatchNorm sites; views of one zero
        scalar each."""
        full = self.cfg.bn_fisher == "full"
        out = {}
        for fam, info in self.site_infos().items():
            if info.kind in ("dense", "conv"):
                out[fam] = tagging.make_stats(info.spec, info.d_in,
                                              info.d_out, lead=info.lead,
                                              device=self.device)
            else:
                out[fam] = tagging.make_scale_bias_stats(
                    info.d_out, lead=info.lead, full=full,
                    device=self.device)
        return out

    def site_counts(self, batch) -> dict:
        """{family: (n_a, n_g)}: a conv site's A averages over its B*Ho*Wo
        patches (the stem at full resolution, a block's sites, ``wskip``
        included, at the resolution after its stride), every G over the B
        samples."""
        b, hh, ww, _ = batch["images"].shape
        counts = {"stem_w": (b * hh * ww, b), "stem_bn": (b, b),
                  "head": (b, b)}
        h, w_ = hh, ww
        for si in range(len(self.cfg.widths)):
            for bi in range(self.cfg.blocks_per_stage):
                nm = f"s{si}b{bi}"
                if _stride(si, bi) == 2:
                    h, w_ = -(-h // 2), -(-w_ // 2)
                for site in ("w1", "w2", "wskip"):
                    counts[f"{nm}_{site}"] = (b * h * w_, b)
                counts[f"{nm}_bn1"] = counts[f"{nm}_bn2"] = (b, b)
        infos = self.site_infos()
        return {k: v for k, v in counts.items() if k in infos}
