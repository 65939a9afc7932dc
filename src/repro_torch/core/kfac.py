"""Kronecker-factored curvature math (counterpart of ``repro/core/kfac.py``).

Conventions as in the JAX package: weights are ``(d_in, d_out)`` and a dense
site computes ``y = x @ w``; the factors are ``A = (1/n) sum_t a_t a_t^T``
and ``G = n * sum_t (dL/ds)(dL/ds)^T``; the update is ``U = A^-1 dW G^-1``.
Large dimensions split into diagonal blocks of at most ``max_dim`` and every
factor array carries a block axis ``(nb, b, b)`` behind any leading
layer axes; all ops broadcast over leading axes.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Block partitioning
# ---------------------------------------------------------------------------

def num_blocks(d: int, max_dim: int) -> int:
    """Number of diagonal blocks a dimension of size ``d`` is split into."""
    return max(1, -(-d // max_dim))


def block_size(d: int, max_dim: int) -> int:
    """Uniform (padded) block size used for a dimension of size ``d``."""
    nb = num_blocks(d, max_dim)
    return -(-d // nb)


def padded_dim(d: int, max_dim: int) -> int:
    return num_blocks(d, max_dim) * block_size(d, max_dim)


def block_reshape(x: torch.Tensor, d: int, max_dim: int,
                  axis: int = -1) -> torch.Tensor:
    """Reshape ``axis`` (size d) into (nb, b), zero-padding to nb*b (a view
    when d divides evenly)."""
    nb = num_blocks(d, max_dim)
    b = block_size(d, max_dim)
    axis = axis % x.dim()
    pad = nb * b - d
    if pad:
        cfg = [0, 0] * (x.dim() - 1 - axis) + [0, pad]
        x = F.pad(x, cfg)
    return x.reshape(x.shape[:axis] + (nb, b) + x.shape[axis + 1:])


def block_unreshape(x: torch.Tensor, d: int, axis: int = -2) -> torch.Tensor:
    """Inverse of :func:`block_reshape`: merge (nb, b) at ``axis`` back to
    d."""
    axis = axis % x.dim()
    nb, b = x.shape[axis], x.shape[axis + 1]
    merged = x.reshape(x.shape[:axis] + (nb * b,) + x.shape[axis + 2:])
    if nb * b != d:
        merged = merged.narrow(axis, 0, d)
    return merged


# ---------------------------------------------------------------------------
# Factor statistics from token matrices
# ---------------------------------------------------------------------------

def factor_sum(x: torch.Tensor, max_dim: int, *,
               backend: Optional[str] = None) -> torch.Tensor:
    """Blocked ``sum_t x_t x_t^T`` for a token matrix (..., n, d); returns
    (..., nb, b, b) f32. Inputs stay in their storage dtype, the sums are
    f32 (``kernels.dispatch.factor_sum``)."""
    from repro_torch.kernels import dispatch
    return dispatch.factor_sum(x, max_dim, backend=backend)


def factor_sum_wire(x: torch.Tensor, max_dim: int, *, fmt: str = "e4m3",
                    backend: Optional[str] = None):
    """Fused :func:`factor_sum` + wire-format epilogue: returns
    ``(payload fp8 (..., nb, t), scale f32 (..., nb))``, the sym-packed
    per-block-quantized tile (``kernels.dispatch.factor_sum_wire``)."""
    from repro_torch.kernels import dispatch
    return dispatch.factor_sum_wire(x, max_dim, fmt=fmt, backend=backend)


def diag_factor_sum(x: torch.Tensor) -> torch.Tensor:
    """``sum_t x_t^2`` per output coordinate. (..., n, d) -> (..., d)."""
    x = x.float()
    return torch.sum(x * x, dim=-2)


# ---------------------------------------------------------------------------
# Damping + inversion (Eq. 12)
# ---------------------------------------------------------------------------

def mean_eig(f: torch.Tensor, kind: str, d: int) -> torch.Tensor:
    """Average eigenvalue of a factor over its true (unpadded) dimension d:
    the trace of a blocked factor (..., nb, b, b) summed over its blocks,
    or the sum of a diagonal one (..., d). Returns (...,)."""
    if kind == "full":
        return torch.diagonal(f, dim1=-2, dim2=-1).sum(-1).sum(-1) / d
    return f.sum(-1) / d


def pi_correction(a: torch.Tensor, g: torch.Tensor, d_a: int, d_g: int,
                  eps: float = 1e-12, *, a_kind: str = "full",
                  g_kind: str = "full") -> torch.Tensor:
    """Martens-Grosse pi: sqrt(mean_eig(A) / mean_eig(G)); either factor
    blocked ("full") or diagonal ("diag")."""
    ea = mean_eig(a, a_kind, d_a)
    eg = mean_eig(g, g_kind, d_g)
    return torch.sqrt(torch.clamp(ea, min=eps) / torch.clamp(eg, min=eps))


def damped_inverse(f: torch.Tensor, damping) -> torch.Tensor:
    """Inverse of the SPD blocked factor ``f + damping*I`` through eigh,
    negative eigenvalues clamped to 0 first; solves and returns f32.
    f: (..., nb, b, b); damping broadcastable to (..., nb)."""
    f = f.float()
    f = 0.5 * (f + f.transpose(-1, -2))
    vals, vecs = torch.linalg.eigh(f)
    d = torch.as_tensor(damping, dtype=torch.float32,
                        device=f.device)[..., None]
    inv_vals = 1.0 / (torch.clamp(vals, min=0.0) + d)
    return (vecs * inv_vals[..., None, :]) @ vecs.transpose(-1, -2)


def cholesky_inverse(f: torch.Tensor, damping) -> torch.Tensor:
    """Inverse of ``f + damping*I`` through Cholesky; needs it SPD after
    damping. Solves in f32."""
    b = f.shape[-1]
    f = f.float()
    f = 0.5 * (f + f.transpose(-1, -2))
    d = torch.as_tensor(damping, dtype=torch.float32,
                        device=f.device)[..., None, None]
    eye = torch.eye(b, dtype=torch.float32, device=f.device)
    chol = torch.linalg.cholesky(f + d * eye)
    return torch.cholesky_solve(eye.expand(f.shape), chol)


# Newton-Schulz iteration cap and tolerance, defined once here (the
# algorithm's home); the training path always runs with these.
NS_ITERS = 40   # iteration cap: covers damped condition numbers ~1e4 in f32
NS_TOL = 1e-4   # relative fixed-point residual for early exit / fallback


def newton_schulz_inverse(f: torch.Tensor, damping, *, iters: int = NS_ITERS,
                          tol: float = NS_TOL):
    """Matmul-only blocked inverse of ``f + damping*I`` (Newton-Schulz), the
    plain version of the whole method.

    ``X_{k+1} = X_k + X_k (I - M X_k)`` from ``X_0 = M^T / (||M||_1
    ||M||_inf)`` converges quadratically for SPD ``M = f + damping*I``
    (every eigenvalue of ``M X_0`` lies in (0, 1]). Per block the iterate
    freezes once the relative residual ``||I - M X_k||_F / ||I||_F`` drops
    to ``tol``; ``iters`` caps the trips.

    f: (..., nb, b, b); damping broadcastable to (..., nb) like
    :func:`damped_inverse`. Returns ``(x, res)`` with ``res`` (..., nb) the
    residual of the returned iterate: ``res > tol`` is the failed-to-
    contract predicate of ``kernels.dispatch``'s eigh fallback."""
    from repro_torch.kernels import ref
    x, res, _ = ref.ns_inverse_blocks_ref(damped_sym(f, damping), iters, tol)
    return x, res


def damped_sym(f: torch.Tensor, damping) -> torch.Tensor:
    """``M = (f + f^T)/2 + damping*I`` in f32, damping broadcast over the
    leading axes (..., nb): the input the Newton-Schulz iteration takes."""
    b = f.shape[-1]
    f = f.float()
    f = 0.5 * (f + f.transpose(-1, -2))
    d = torch.broadcast_to(torch.as_tensor(damping, dtype=torch.float32,
                                           device=f.device), f.shape[:-2])
    eye = torch.eye(b, dtype=torch.float32, device=f.device)
    return f + d[..., None, None] * eye


def family_pi(a: Optional[torch.Tensor], g: Optional[torch.Tensor],
              d_a: int, d_g: int, *, a_kind: str = "full",
              g_kind: str = "full") -> torch.Tensor:
    """A family's damping split: :func:`pi_correction` when it has both
    factors, else ones over its leading axes (pi = 1)."""
    if a is not None and g is not None:
        return pi_correction(a, g, d_a, d_g, a_kind=a_kind, g_kind=g_kind)
    f, kind = (a, a_kind) if a is not None else (g, g_kind)
    lead = f.shape[:-3] if kind == "full" else f.shape[:-1]
    return torch.ones(lead, device=f.device)


def factor_damping(pi: torch.Tensor, lam: float):
    """Eq. 12's damping of the two factors: (pi*sqrt(lam), sqrt(lam)/pi)."""
    sl = torch.sqrt(torch.as_tensor(lam, dtype=torch.float32,
                                    device=pi.device))
    return pi * sl, sl / pi


def damped_stat_inverse(f: torch.Tensor, kind: str, damp: torch.Tensor, *,
                        method: str = "eigh",
                        backend: Optional[str] = None):
    """One statistic's damped inverse: a blocked factor through
    ``kernels.dispatch.damped_inverse`` (one batched call for all its
    blocks and layers), a diagonal one elementwise as ``1/(max(x, 0) +
    d)``; ``damp`` over the leading axes. Returns ``(inverse, info)``, info
    the dispatch's per-block ``{"ns_res", "ns_converged"}`` of a blocked
    factor and None for a diagonal one. The inline refresh and the refresh
    pipeline's chunks both invert through here."""
    if kind == "full":
        from repro_torch.kernels import dispatch
        return dispatch.damped_inverse(f, damp[..., None], method=method,
                                       backend=backend, return_info=True)
    return 1.0 / (torch.clamp(f, min=0.0) + damp[..., None]), None


def damped_factor_inverses(a: Optional[torch.Tensor],
                           g: Optional[torch.Tensor], lam: float, d_a: int,
                           d_g: int, *, method: str = "eigh",
                           backend: Optional[str] = None,
                           a_kind: str = "full", g_kind: str = "full",
                           invert: Optional[Callable] = None):
    """(A + pi*sqrt(lam) I)^-1 and (G + sqrt(lam)/pi I)^-1 (Eq. 12), each
    by :func:`damped_stat_inverse`, or by ``invert(key, f, kind, damp) ->
    (inverse, info)`` when given (the optimizer's Stage-4 route, sharded
    under ``inverse_sharding``). A site with one factor passes None for
    the other: pi is then 1 and None comes back for it. Returns
    ``(a_inv, g_inv, info)``: info maps "a"/"g" of each blocked factor to
    the dispatch's per-block ``{"ns_res", "ns_converged"}``."""
    damp = factor_damping(family_pi(a, g, d_a, d_g, a_kind=a_kind,
                                    g_kind=g_kind), lam)
    info = {}
    out = []
    for key, f, kind, d in (("a", a, a_kind, damp[0]),
                            ("g", g, g_kind, damp[1])):
        if f is None:
            out.append(None)
            continue
        if invert is not None:
            inv, i = invert(key, f, kind, d)
        else:
            inv, i = damped_stat_inverse(f, kind, d, method=method,
                                         backend=backend)
        out.append(inv)
        if i is not None:
            info[key] = i
    return (*out, info)


# ---------------------------------------------------------------------------
# Preconditioning
# ---------------------------------------------------------------------------

def precondition(dw: torch.Tensor, a_inv: Optional[torch.Tensor],
                 g_inv: Optional[torch.Tensor], *,
                 backend: Optional[str] = None) -> torch.Tensor:
    """``U = A^-1 @ dW @ G^-1`` with blocked (or diagonal) inverses.

    dw: (..., d_in, d_out); a_inv: (..., nbA, bA, bA) or (..., d_in)
    diagonal or None; g_inv likewise over d_out. The blocked sides go
    through ``kernels.dispatch.block_precond_left/_right``, which take dw
    unblocked (the ragged last block is masked, not padded)."""
    from repro_torch.kernels import dispatch
    u = dw.float()
    if a_inv is not None:
        if a_inv.dim() == dw.dim() - 1:          # diagonal over d_in
            u = a_inv[..., :, None] * u
        else:
            u = dispatch.block_precond_left(a_inv, u, backend=backend)
    if g_inv is not None:
        if g_inv.dim() == dw.dim() - 1:          # diagonal over d_out
            u = u * g_inv[..., None, :]
        else:
            u = dispatch.block_precond_right(u, g_inv, backend=backend)
    return u.to(dw.dtype)


# ---------------------------------------------------------------------------
# Unit-wise 2x2 inverse (Eq. 15-17) -- scale/bias parameters
# ---------------------------------------------------------------------------

def unitwise_solve(stats: torch.Tensor, g_gamma: torch.Tensor,
                   g_beta: torch.Tensor, lam: float):
    """Per-channel damped 2x2 solve. stats (..., C, 3) rows [E[gg], E[gb],
    E[bb]]; g_gamma, g_beta (..., C). Returns the preconditioned grads."""
    aa = stats[..., 0] + lam
    ab = stats[..., 1]
    bb = stats[..., 2] + lam
    det = aa * bb - ab * ab
    det = torch.where(det <= 1e-20, torch.full_like(det, 1e-20), det)
    ug = (bb * g_gamma - ab * g_beta) / det
    ub = (-ab * g_gamma + aa * g_beta) / det
    return ug, ub


def diag_solve(stats: torch.Tensor, g: torch.Tensor,
               lam: float) -> torch.Tensor:
    """1x1 unit-wise (diagonal Fisher) solve: g / (E[g^2] + lam)."""
    return g / (stats + lam)


# ---------------------------------------------------------------------------
# Frobenius similarity (Algorithm 2's predicate)
# ---------------------------------------------------------------------------

def frob_distance(x: torch.Tensor, y: torch.Tensor,
                  eps: float = 1e-30) -> torch.Tensor:
    """||x - y||_F / ||y||_F over all axes (a whole factor family at
    once)."""
    num = torch.sqrt(torch.sum((x.float() - y.float()) ** 2))
    den = torch.sqrt(torch.sum(y.float() ** 2))
    return num / torch.clamp(den, min=eps)


# ---------------------------------------------------------------------------
# Symmetric packing (paper section 5.2): the lower triangle, row by row
# ---------------------------------------------------------------------------

def tril_indices(b: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Row and column of each packed position, in ``numpy.tril_indices``
    order (row-major over the lower triangle)."""
    return tuple(torch.tril_indices(b, b))


@functools.cache
def _pack_index(b: int, device: str, unpack: bool) -> torch.Tensor:
    """Flat gather indices, cached per (b, device, direction): packing
    reads position ``r*b + c`` of each (r >= c); unpacking reads packed
    position ``tri(max(r, c)) + min(r, c)`` for every (r, c) (33.5 MB of
    int64 at b 2048)."""
    if unpack:
        r = torch.arange(b, device=device)
        hi = torch.maximum(r[:, None], r[None, :])
        lo = torch.minimum(r[:, None], r[None, :])
        return ((hi * (hi + 1)) // 2 + lo).reshape(-1)
    i, j = torch.tril_indices(b, b, device=device)
    return i * b + j


def sym_pack(f: torch.Tensor) -> torch.Tensor:
    """Pack symmetric (..., b, b) into (..., b(b+1)/2): a gather of the
    lower triangle, any dtype, no arithmetic."""
    b = f.shape[-1]
    flat = f.reshape(f.shape[:-2] + (b * b,))
    return flat[..., _pack_index(b, str(f.device), False)]


def sym_unpack(p: torch.Tensor, b: int) -> torch.Tensor:
    """Inverse of :func:`sym_pack`. A GATHER, not a scatter: entry (r, c)
    reads packed position tri(max(r, c)) + min(r, c); exact for any dtype
    (fp8 payloads included)."""
    out = p[..., _pack_index(b, str(p.device), True)]
    return out.reshape(p.shape[:-1] + (b, b))
