"""Layer tagging: curvature capture fused into the ordinary backward pass
(counterpart of ``repro/core/tagging.py``).

Every tagged site is a ``torch.autograd.Function`` that takes, besides its
operands, zero "statistics accumulator" tensors. The forward ignores them;
the backward returns, as their gradients, the RAW factor sums

    d(a_acc) = sum_t a_t a_t^T     (blocked, f32)
    d(g_acc) = sum_t gy_t gy_t^T   (blocked, f32; gy = dL/ds, un-normalized)

so one ``torch.autograd.grad`` over (params, fstats) yields the gradients
and the factor statistics in a single backward pass. The accumulators are
expanded views of a zero scalar (no memory of their own); a model hands
each layer one slice of a stacked ``(L, ...)`` family (``unbind``), so the
per-layer gradients come back stacked like the JAX package's ``lax.scan``
families. Normalization is not done here: ``core/fisher.py`` scales the
raw sums with the global counts.

A site called with ``stats=None`` runs the plain op (the fast path).
With ``FactorSpec.wire_fmt`` set, a full-kind factor's accumulator is a
``{"payload": fp8 (..., nb, t), "scale": f32 (..., nb)}`` pair and the
backward returns the fused capture's sym-packed fp8 payload and per-block
scales as their gradients (``kfac.factor_sum_wire``); the optimizer
decodes them once. A conv site is im2col patches through the dense site
(Eq. 10-11). A grouped site (an MoE block's experts, ``y[e] = x[e] @
w[e]``) keeps the expert axis in its factors: ``(E, nb, b, b)`` (or the
wire pair ``(E, nb, t)``, ``(E, nb)``), summed for all experts in one
``factor_sum`` or ``factor_sum_wire`` call.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import kfac


# ---------------------------------------------------------------------------
# Factor spec
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FactorSpec:
    """Static description of what curvature a site collects; ``backend``
    selects the factor-sum kernel ("ref" | "cuda" | "auto";
    ``kernels.dispatch``); ``wire_fmt`` ("" | "e4m3" | "e5m2") switches
    full-kind factor capture to the fused wire format. The per-side caps
    that align blocks to tensor-parallel shards arrive with the multi-GPU
    slice."""
    a_kind: str = "full"        # "full" | "diag" | "none"
    g_kind: str = "full"        # "full" | "diag" | "none"
    max_dim: int = 2048         # block-diagonal factor cap
    backend: str = "auto"
    wire_fmt: str = ""          # "" (dense f32) | "e4m3" | "e5m2"

    def a_shape(self, d_in: int) -> Optional[tuple[int, ...]]:
        return _kind_shape(self.a_kind, d_in, self.max_dim)

    def g_shape(self, d_out: int) -> Optional[tuple[int, ...]]:
        return _kind_shape(self.g_kind, d_out, self.max_dim)


def _kind_shape(kind: str, d: int, max_dim: int):
    if kind == "full":
        return (kfac.num_blocks(d, max_dim), kfac.block_size(d, max_dim),
                kfac.block_size(d, max_dim))
    if kind == "diag":
        return (d,)
    return None


def zeros(shape: tuple, device=None,
          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A zero accumulator of ``shape``: an expanded view of one zero scalar,
    so a template of every factor family costs no memory."""
    return torch.zeros((), dtype=dtype, device=device).expand(shape)


def _wire_zeros(spec: FactorSpec, shape: tuple, lead: tuple,
                device=None) -> dict:
    """Zero wire-format accumulator for one full-kind factor of dense shape
    ``(nb, b, b)``: fp8 payload rows + per-block f32 scales."""
    from repro_torch.quant import quant
    if spec.wire_fmt not in quant.FORMATS:
        raise ValueError(f"unknown wire_fmt {spec.wire_fmt!r}; expected "
                         f"{sorted(quant.FORMATS)}")
    nb, b = shape[0], shape[-1]
    return {"payload": zeros(lead + (nb, b * (b + 1) // 2), device,
                             quant.FORMATS[spec.wire_fmt]),
            "scale": zeros(lead + (nb,), device)}


def _factor_zeros(spec: FactorSpec, kind: str, shape, lead, device):
    if spec.wire_fmt and kind == "full":
        return _wire_zeros(spec, shape, lead, device)
    return zeros(lead + shape, device)


def make_stats(spec: FactorSpec, d_in: int, d_out: int,
               lead: tuple[int, ...] = (), device=None) -> dict:
    """Zero stats-accumulator dict for one dense site."""
    out = {}
    sa, sg = spec.a_shape(d_in), spec.g_shape(d_out)
    if sa is not None:
        out["a"] = _factor_zeros(spec, spec.a_kind, sa, lead, device)
    if sg is not None:
        out["g"] = _factor_zeros(spec, spec.g_kind, sg, lead, device)
    return out


def _stat_sum(x2d: torch.Tensor, kind: str, spec: FactorSpec, want_shape):
    """Raw factor sum of a token matrix (n, d) in the accumulator's shape;
    a dict ``want_shape`` asks for the wire format (kind "full"): the
    (payload, scale) pair."""
    if isinstance(want_shape, dict):
        payload, scale = kfac.factor_sum_wire(
            x2d, spec.max_dim, fmt=spec.wire_fmt, backend=spec.backend)
        return (payload.reshape(want_shape["payload"]),
                scale.reshape(want_shape["scale"]))
    if kind == "full":
        return kfac.factor_sum(x2d, spec.max_dim,
                               backend=spec.backend).reshape(want_shape), None
    if kind == "diag":
        return kfac.diag_factor_sum(x2d).reshape(want_shape), None
    raise ValueError(kind)


def _acc_parts(acc) -> tuple:
    """An accumulator as the site Function's two tensor inputs: (acc, None),
    or (payload, scale) for wire capture; (None, None) when absent."""
    if acc is None:
        return None, None
    if isinstance(acc, dict):
        return acc["payload"], acc["scale"]
    return acc, None


def _shape(acc, scale=None):
    """What the backward needs to shape an accumulator's gradient: its
    shape, or {"payload", "scale"} shapes for wire capture."""
    if acc is None:
        return None
    if scale is not None:
        return {"payload": acc.shape, "scale": scale.shape}
    return acc.shape


# ---------------------------------------------------------------------------
# Dense site: y = x @ w      x: (..., d_in), w: (d_in, d_out)
# ---------------------------------------------------------------------------

class _DenseSite(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, a_acc, a_scale, g_acc, g_scale, spec):
        ctx.save_for_backward(x, w)
        ctx.spec = spec
        ctx.shapes = (_shape(a_acc, a_scale), _shape(g_acc, g_scale))
        return torch.matmul(x, w)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        spec, (a_shape, g_shape) = ctx.spec, ctx.shapes
        d_in, d_out = w.shape
        x2d = x.reshape(-1, d_in)
        g2d = gy.reshape(-1, d_out)
        dx = dw = None
        da = dg = (None, None)
        if ctx.needs_input_grad[0]:
            dx = torch.matmul(gy, w.t()).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.matmul(x2d.t(), g2d.to(x2d.dtype)).to(w.dtype)
        if a_shape is not None and ctx.needs_input_grad[2]:
            da = _stat_sum(x2d, spec.a_kind, spec, a_shape)
        if g_shape is not None and ctx.needs_input_grad[4]:
            dg = _stat_sum(g2d, spec.g_kind, spec, g_shape)
        return (dx, dw) + da + dg + (None,)


def dense_site(x: torch.Tensor, w: torch.Tensor, stats: Optional[dict] = None,
               spec: FactorSpec = FactorSpec()) -> torch.Tensor:
    """Tagged dense matmul ``x @ w``; ``stats`` is the accumulator dict of
    :func:`make_stats` (None: the plain matmul)."""
    if stats is None:
        return torch.matmul(x, w)
    return _DenseSite.apply(x, w, *_acc_parts(stats.get("a")),
                            *_acc_parts(stats.get("g")), spec)


# ---------------------------------------------------------------------------
# Grouped dense site (MoE experts): y[e] = x[e] @ w[e]
#   x (E, n, d_in), w (E, d_in, d_out) -> per-expert factors (E, nb, b, b)
# ---------------------------------------------------------------------------

class _GroupedSite(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, a_acc, a_scale, g_acc, g_scale, spec):
        ctx.save_for_backward(x, w)
        ctx.spec = spec
        ctx.shapes = (_shape(a_acc, a_scale), _shape(g_acc, g_scale))
        return torch.matmul(x, w)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        spec, (a_shape, g_shape) = ctx.spec, ctx.shapes
        dx = dw = None
        da = dg = (None, None)
        if ctx.needs_input_grad[0]:
            dx = torch.matmul(gy, w.transpose(-1, -2)).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.matmul(x.transpose(-1, -2), gy.to(x.dtype)).to(w.dtype)
        # factor sums keep the expert axis: (E, n, d) -> (E, nb, b, b), or
        # the wire pair (E, nb, t), (E, nb); every expert in the one call
        if a_shape is not None and ctx.needs_input_grad[2]:
            da = _stat_sum(x, spec.a_kind, spec, a_shape)
        if g_shape is not None and ctx.needs_input_grad[4]:
            dg = _stat_sum(gy.contiguous(), spec.g_kind, spec, g_shape)
        return (dx, dw) + da + dg + (None,)


def grouped_dense_site(x: torch.Tensor, w: torch.Tensor,
                       stats: Optional[dict] = None,
                       spec: FactorSpec = FactorSpec()) -> torch.Tensor:
    """Tagged per-expert matmul ``y[e] = x[e] @ w[e]``: x (E, n, d_in), w
    (E, d_in, d_out); ``stats`` the accumulator dict of :func:`make_stats`
    with ``lead=(E,)`` (None: the plain product). With ``spec.wire_fmt``
    the full-kind factors come back in the wire format with the expert
    axis, as ``repro``'s ``_grouped_site_bwd``."""
    if stats is None:
        return torch.matmul(x, w)
    return _GroupedSite.apply(x, w, *_acc_parts(stats.get("a")),
                              *_acc_parts(stats.get("g")), spec)


# ---------------------------------------------------------------------------
# Bias site: y = x + b  (diagonal Fisher for b)
# ---------------------------------------------------------------------------

class _BiasSite(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, b, acc):
        ctx.b_meta = (b.shape[-1], b.dtype)
        return x + b

    @staticmethod
    def backward(ctx, gy):
        d, dtype = ctx.b_meta
        g2d = gy.reshape(-1, d).float()
        return gy, g2d.sum(0).to(dtype), torch.sum(g2d * g2d, dim=0)


def bias_site(x: torch.Tensor, b: torch.Tensor,
              stats: Optional[dict] = None) -> torch.Tensor:
    if stats is None:
        return x + b
    return _BiasSite.apply(x, b, stats["d"])


def make_bias_stats(d: int, lead: tuple[int, ...] = (), device=None) -> dict:
    return {"d": zeros(lead + (d,), device)}


# ---------------------------------------------------------------------------
# Scale-bias site (BatchNorm / RMSNorm / LayerNorm affine):
#   y = xhat * gamma (+ beta)
# Unit-wise 2x2 Fisher (Eq. 15-16); ``spatial`` counts trailing token axes
# within one sample, summed before the outer product (conv: H, W). A 2C-wide
# accumulator asks for the full (2C x 2C) BN Fisher, the paper's expensive
# baseline (Fig. 5).
# ---------------------------------------------------------------------------

class _ScaleBiasSite(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xhat, gamma, beta, acc, spatial, has_beta):
        ctx.save_for_backward(xhat, gamma)
        ctx.meta = (acc.shape, spatial, has_beta)
        y = xhat * gamma
        return y + beta if has_beta else y

    @staticmethod
    def backward(ctx, gy):
        xhat, gamma = ctx.saved_tensors
        acc_shape, spatial, has_beta = ctx.meta
        c = xhat.shape[-1]
        gf = gy.float()
        u = gf * xhat.float()                  # per-position dL/dgamma
        if spatial:
            ax = tuple(range(-1 - spatial, -1))
            us, vs = u.sum(ax), gf.sum(ax)
        else:
            us, vs = u, gf
        us2, vs2 = us.reshape(-1, c), vs.reshape(-1, c)
        dgamma, dbeta = us2.sum(0), vs2.sum(0)
        if len(acc_shape) >= 2 and acc_shape[-1] == 2 * c:
            # full BN Fisher: outer products of the per-sample [u, v]
            z = torch.cat([us2, vs2], dim=-1)            # (n, 2C)
            dacc = torch.matmul(z.t(), z).reshape(acc_shape)
        else:
            # unit-wise [sum u^2, sum u v, sum v^2] per channel
            dacc = torch.stack([torch.sum(us2 * us2, 0),
                                torch.sum(us2 * vs2, 0),
                                torch.sum(vs2 * vs2, 0)],
                               dim=-1).reshape(acc_shape)
        dx = (gf * gamma).to(xhat.dtype)
        if not has_beta:
            dbeta = torch.zeros_like(dbeta)
        return (dx, dgamma.to(gamma.dtype), dbeta.to(gamma.dtype), dacc,
                None, None)


def scale_bias_site(xhat: torch.Tensor, gamma: torch.Tensor,
                    beta: Optional[torch.Tensor], stats: Optional[dict] = None,
                    spatial: int = 0) -> torch.Tensor:
    if stats is None:
        y = xhat * gamma
        return y + beta if beta is not None else y
    has_beta = beta is not None
    b = beta if has_beta else torch.zeros_like(gamma)
    acc = stats["uwf"] if "uwf" in stats else stats["uw"]
    return _ScaleBiasSite.apply(xhat, gamma, b, acc, spatial, has_beta)


def make_scale_bias_stats(c: int, lead: tuple[int, ...] = (),
                          full: bool = False, device=None) -> dict:
    """Unit-wise ``{"uw": (..., C, 3)}``, or with ``full`` the full BN
    Fisher ``{"uwf": (..., 2C, 2C)}``."""
    if full:
        return {"uwf": zeros(lead + (2 * c, 2 * c), device)}
    return {"uw": zeros(lead + (c, 3), device)}


# ---------------------------------------------------------------------------
# Embedding site: y = table[ids]
#   A factor = diag(token counts); G factor = blocked gy^T gy over tokens.
# ---------------------------------------------------------------------------

class _EmbedSite(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ids, table, a_acc, g_acc, g_scale, spec):
        ctx.save_for_backward(ids)
        ctx.meta = (table.shape, table.dtype, spec, _shape(a_acc),
                    _shape(g_acc, g_scale))
        return table[ids]

    @staticmethod
    def backward(ctx, gy):
        (ids,) = ctx.saved_tensors
        tshape, tdtype, spec, a_shape, g_shape = ctx.meta
        v, d = tshape
        flat = ids.reshape(-1)
        g2d = gy.reshape(-1, d)
        # scatter-add in f32 (the JAX package adds in gy's dtype)
        dtable = torch.zeros(tshape, dtype=torch.float32, device=gy.device)
        dtable.index_add_(0, flat, g2d.float())
        da, dg = None, (None, None)
        if a_shape is not None and ctx.needs_input_grad[2]:
            if flat.device.type == "meta":   # bincount has no meta kernel
                da = torch.zeros(a_shape, device=flat.device)
            else:
                da = torch.bincount(flat, minlength=v).float().reshape(
                    a_shape)
        if g_shape is not None and ctx.needs_input_grad[3]:
            dg = _stat_sum(g2d, spec.g_kind, spec, g_shape)
        return (None, dtable.to(tdtype), da) + dg + (None,)


def embed_site(ids: torch.Tensor, table: torch.Tensor,
               stats: Optional[dict] = None,
               spec: FactorSpec = FactorSpec(a_kind="diag")) -> torch.Tensor:
    if stats is None:
        return table[ids]
    return _EmbedSite.apply(ids, table, stats.get("a"),
                            *_acc_parts(stats.get("g")), spec)


def make_embed_stats(vocab: int, d: int, spec: FactorSpec,
                     lead: tuple[int, ...] = (), device=None) -> dict:
    """The embedding's G factor is captured dense in f32 whatever
    ``spec.wire_fmt`` says, as ``repro``'s ``make_embed_stats`` makes it."""
    out = {"a": zeros(lead + (vocab,), device)}
    sg = spec.g_shape(d)
    if sg is not None:
        out["g"] = zeros(lead + sg, device)
    return out


# ---------------------------------------------------------------------------
# Conv site = im2col patches + dense_site (Eq. 10-11): the Kronecker factors
# of a conv layer are exactly the dense factors of its im2col matmul.
#   x (B, H, W, cin) channels-last; w (cout, cin, kh, kw), torch's layout
# ---------------------------------------------------------------------------

def same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's "SAME" padding of one spatial axis, (low, high): the output is
    ceil(size / stride) and the padding total is split with the extra
    element on the high side, so a 3x3 stride-2 conv on an even input pads
    (0, 1), not (1, 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv_patches(x: torch.Tensor, kh: int, kw: int,
                 stride: int = 1) -> torch.Tensor:
    """im2col of a channels-last batch under SAME padding: x (B, H, W, cin)
    -> (B, Ho, Wo, cin*kh*kw), features ordered (cin, kh, kw) as the JAX
    package's ``conv_general_dilated_patches``. The windows are a strided
    view of the padded input (``Tensor.unfold``, (B, Ho, Wo, cin, kh, kw));
    the reshape is the site's one layout copy (rows contiguous, as the
    factor-sum kernel reads them), a single launch for the whole batch."""
    b, h, w, c = x.shape
    (pt, pb), (pl, pr) = same_pads(h, kh, stride), same_pads(w, kw, stride)
    xp = F.pad(x, (0, 0, pl, pr, pt, pb))
    win = xp.unfold(1, kh, stride).unfold(2, kw, stride)
    return win.reshape(b, win.shape[1], win.shape[2], c * kh * kw)


def conv_site(x: torch.Tensor, w: torch.Tensor, stats: Optional[dict] = None,
              stride: int = 1,
              spec: FactorSpec = FactorSpec()) -> torch.Tensor:
    """Tagged 2-D conv under SAME padding, x (B, H, W, cin) channels-last,
    w (cout, cin, kh, kw) -> (B, Ho, Wo, cout): the patch matrix times
    ``w.reshape(cout, -1).T`` (the JAX package's ``w2d``, element for
    element) through :func:`dense_site`, so A is the patches' factor and G
    the output's."""
    cout, cin, kh, kw = w.shape
    w2d = w.reshape(cout, cin * kh * kw).t()
    if stats is None and (kh, kw) == (1, 1) and stride == 1:
        return torch.matmul(x, w2d)
    return dense_site(conv_patches(x, kh, kw, stride), w2d, stats, spec)
