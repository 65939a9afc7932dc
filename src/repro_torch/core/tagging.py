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
``grouped_dense_site`` and ``conv_site`` arrive with the MoE and ResNet
slices; the fp8 wire-format capture with the fp8 slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import kfac


# ---------------------------------------------------------------------------
# Factor spec
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FactorSpec:
    """Static description of what curvature a site collects; ``backend``
    selects the factor-sum kernel ("ref" | "cuda" | "auto";
    ``kernels.dispatch``). The per-side caps that align blocks to
    tensor-parallel shards arrive with the multi-GPU slice."""
    a_kind: str = "full"        # "full" | "diag" | "none"
    g_kind: str = "full"        # "full" | "diag" | "none"
    max_dim: int = 2048         # block-diagonal factor cap
    backend: str = "auto"

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


def zeros(shape: tuple, device=None) -> torch.Tensor:
    """A zero accumulator of ``shape``: an expanded view of one zero scalar,
    so a template of every factor family costs no memory."""
    return torch.zeros((), dtype=torch.float32, device=device).expand(shape)


def make_stats(spec: FactorSpec, d_in: int, d_out: int,
               lead: tuple[int, ...] = (), device=None) -> dict:
    """Zero stats-accumulator dict for one dense site."""
    out = {}
    sa, sg = spec.a_shape(d_in), spec.g_shape(d_out)
    if sa is not None:
        out["a"] = zeros(lead + sa, device)
    if sg is not None:
        out["g"] = zeros(lead + sg, device)
    return out


def _stat_sum(x2d: torch.Tensor, kind: str, max_dim: int, want_shape,
              backend: str) -> torch.Tensor:
    """Raw factor sum of a token matrix (n, d) in the accumulator's shape."""
    if kind == "full":
        return kfac.factor_sum(x2d, max_dim,
                               backend=backend).reshape(want_shape)
    if kind == "diag":
        return kfac.diag_factor_sum(x2d).reshape(want_shape)
    raise ValueError(kind)


def _shape(acc) -> Optional[torch.Size]:
    return None if acc is None else acc.shape


# ---------------------------------------------------------------------------
# Dense site: y = x @ w      x: (..., d_in), w: (d_in, d_out)
# ---------------------------------------------------------------------------

class _DenseSite(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, a_acc, g_acc, spec):
        ctx.save_for_backward(x, w)
        ctx.spec = spec
        ctx.shapes = (_shape(a_acc), _shape(g_acc))
        return torch.matmul(x, w)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        spec, (a_shape, g_shape) = ctx.spec, ctx.shapes
        d_in, d_out = w.shape
        x2d = x.reshape(-1, d_in)
        g2d = gy.reshape(-1, d_out)
        dx = dw = da = dg = None
        if ctx.needs_input_grad[0]:
            dx = torch.matmul(gy, w.t()).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.matmul(x2d.t(), g2d.to(x2d.dtype)).to(w.dtype)
        if a_shape is not None and ctx.needs_input_grad[2]:
            da = _stat_sum(x2d, spec.a_kind, spec.max_dim, a_shape,
                           spec.backend)
        if g_shape is not None and ctx.needs_input_grad[3]:
            dg = _stat_sum(g2d, spec.g_kind, spec.max_dim, g_shape,
                           spec.backend)
        return dx, dw, da, dg, None


def dense_site(x: torch.Tensor, w: torch.Tensor, stats: Optional[dict] = None,
               spec: FactorSpec = FactorSpec()) -> torch.Tensor:
    """Tagged dense matmul ``x @ w``; ``stats`` is the accumulator dict of
    :func:`make_stats` (None: the plain matmul)."""
    if stats is None:
        return torch.matmul(x, w)
    return _DenseSite.apply(x, w, stats.get("a"), stats.get("g"), spec)


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
# Scale-bias site (RMSNorm / LayerNorm affine): y = xhat * gamma (+ beta)
# Unit-wise 2x2 Fisher (Eq. 15-16); ``spatial`` counts trailing token axes
# within one sample, summed before the outer product (conv: H, W). The full
# (2C x 2C) BN Fisher baseline of the JAX package arrives with the ResNet
# slice that uses it.
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
        dacc = torch.stack([torch.sum(us2 * us2, 0), torch.sum(us2 * vs2, 0),
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
    return _ScaleBiasSite.apply(xhat, gamma, b, stats["uw"], spatial,
                                has_beta)


def make_scale_bias_stats(c: int, lead: tuple[int, ...] = (),
                          device=None) -> dict:
    return {"uw": zeros(lead + (c, 3), device)}


# ---------------------------------------------------------------------------
# Embedding site: y = table[ids]
#   A factor = diag(token counts); G factor = blocked gy^T gy over tokens.
# ---------------------------------------------------------------------------

class _EmbedSite(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ids, table, a_acc, g_acc, spec):
        ctx.save_for_backward(ids)
        ctx.meta = (table.shape, table.dtype, spec, _shape(a_acc),
                    _shape(g_acc))
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
        da = dg = None
        if a_shape is not None and ctx.needs_input_grad[2]:
            da = torch.bincount(flat, minlength=v).float().reshape(a_shape)
        if g_shape is not None and ctx.needs_input_grad[3]:
            dg = _stat_sum(g2d, spec.g_kind, spec.max_dim, g_shape,
                           spec.backend)
        return None, dtable.to(tdtype), da, dg, None


def embed_site(ids: torch.Tensor, table: torch.Tensor,
               stats: Optional[dict] = None,
               spec: FactorSpec = FactorSpec(a_kind="diag")) -> torch.Tensor:
    if stats is None:
        return table[ids]
    return _EmbedSite.apply(ids, table, stats.get("a"), stats.get("g"), spec)


def make_embed_stats(vocab: int, d: int, spec: FactorSpec,
                     lead: tuple[int, ...] = (), device=None) -> dict:
    out = {"a": zeros(lead + (vocab,), device)}
    sg = spec.g_shape(d)
    if sg is not None:
        out["g"] = zeros(lead + sg, device)
    return out
