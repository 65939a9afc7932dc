"""Plain PyTorch versions of the ported kernels (counterparts of
``repro/kernels/ref.py`` and of the ``ref`` implementations in
``repro/kernels/dispatch.py``). The CPU path runs them, and
``chip_smoke.py`` holds each CUDA kernel against them on the card."""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def swa_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      window: int = 0) -> torch.Tensor:
    """Causal (+ sliding window) attention with materialized scores.
    q, k, v (BH, S, hd), heads flattened into the batch axis. Key j is
    visible to query i iff ``j <= i`` and, when window > 0,
    ``j > i - window``. Returns (BH, S, hd) in q's dtype."""
    bh, s, hd = q.shape
    scores = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * hd ** -0.5
    qp = torch.arange(s, device=q.device)[:, None]
    kp = torch.arange(s, device=q.device)[None, :]
    mask = kp <= qp
    if window:
        mask &= kp > (qp - window)
    scores = torch.where(mask[None], scores, torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def swa_decode_slot_positions(pos: torch.Tensor, capacity: int
                              ) -> torch.Tensor:
    """Absolute position held by each ring slot after the token at ``pos``
    was written (slot = position % capacity).

    pos: (N,) i32; returns (N, capacity) i32 where entry s is the most recent
    position p <= pos with p % capacity == s. Slots not yet written come out
    NEGATIVE; the caller masks on ``>= 0``."""
    sl = torch.arange(capacity, dtype=torch.int32, device=pos.device)[None, :]
    posb = pos[:, None].to(torch.int32)
    r = posb % capacity
    base = posb - r
    return torch.where(sl <= r, base + sl, base - capacity + sl)


def swa_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   pos: torch.Tensor, *, window: int = 0,
                   k_scale: torch.Tensor | None = None,
                   v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Single-query decode attention with materialized scores.

    q (N, G, hd); k/v (N, C, hd) cache payload in its stored dtype (ring of
    capacity ``window`` when ``window > 0``, dense full-causal when 0);
    pos (N,) i32 query positions; k_scale/v_scale (N, C) per-row dequant
    scales or None. Key position j is visible iff ``0 <= j <= pos`` and,
    when window > 0, ``j > pos - window``. Returns (N, G, hd) in q's dtype.
    """
    n, c, hd = k.shape
    kf = k.float()
    vf = v.float()
    if k_scale is not None:
        kf = kf * k_scale[..., None].float()
    if v_scale is not None:
        vf = vf * v_scale[..., None].float()
    s = torch.einsum("ngd,ncd->ngc", q.float() * hd ** -0.5, kf)
    posb = pos[:, None].to(torch.int32)
    if window:
        if c != window:
            raise ValueError(f"ring decode needs k.shape[1] == window; got "
                             f"{c} vs {window}")
        p = swa_decode_slot_positions(pos, c)
        valid = (p >= 0) & (p <= posb) & (p > posb - window)
    else:
        p = torch.arange(c, dtype=torch.int32, device=k.device)[None, :]
        valid = p <= posb
    s = torch.where(valid[:, None, :], s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("ngc,ncd->ngd", w, vf).to(q.dtype)


def swa_attention_fwd_res_ref(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, window: int = 0):
    """GQA causal(-window) forward with the logsumexp residual.
    q (BKV, G, S, hd); k, v (BKV, S, hd), KV unexpanded.
    Returns (out (BKV, G, S, hd) in q's dtype, lse (BKV, G, S) f32)."""
    bkv, g, s, hd = q.shape
    scores = torch.einsum("bgqd,bkd->bgqk", q.float(), k.float()) * hd ** -0.5
    qp = torch.arange(s, device=q.device)[:, None]
    kp = torch.arange(s, device=q.device)[None, :]
    mask = kp <= qp
    if window:
        mask &= kp > (qp - window)
    scores = torch.where(mask[None, None], scores,
                         torch.full_like(scores, NEG_INF))
    m = scores.amax(-1)
    p = torch.exp(scores - m[..., None])
    denom = p.sum(-1)
    lse = m + torch.log(denom)
    out = torch.einsum("bgqk,bkd->bgqd", p, v.float()) / denom[..., None]
    return out.to(q.dtype), lse


def swa_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          o: torch.Tensor, lse: torch.Tensor,
                          do: torch.Tensor, *, window: int = 0):
    """Backward of :func:`swa_attention_fwd_res_ref` from its residuals,
    with materialized scores: p is rebuilt from ``lse``, ``delta =
    rowsum(do * o)``, ``ds = p * (do v^T - delta)``. Layouts as the forward;
    returns (dq (BKV, G, S, hd), dk (BKV, S, hd), dv (BKV, S, hd)), all f32,
    dk/dv summed over the query-head group."""
    bkv, g, s, hd = q.shape
    scale = hd ** -0.5
    qs = q.float() * scale
    kf, vf, dof = k.float(), v.float(), do.float()
    delta = (dof * o.float()).sum(-1)
    scores = torch.einsum("bgqd,bkd->bgqk", qs, kf)
    qp = torch.arange(s, device=q.device)[:, None]
    kp = torch.arange(s, device=q.device)[None, :]
    mask = kp <= qp
    if window:
        mask &= kp > (qp - window)
    p = torch.where(mask[None, None], torch.exp(scores - lse[..., None]),
                    torch.zeros_like(scores))
    dp = torch.einsum("bgqd,bkd->bgqk", dof, vf)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bgqk,bkd->bgqd", ds, kf) * scale
    dk = torch.einsum("bgqk,bgqd->bkd", ds, qs)
    dv = torch.einsum("bgqk,bgqd->bkd", p, dof)
    return dq, dk, dv


def factor_sum_ref(x: torch.Tensor, max_dim: int) -> torch.Tensor:
    """Blocked raw factor sum: x (..., n, d) -> (..., nb, b, b) f32, the
    einsum over ``block_reshape`` of the JAX package's ``_factor_sum_ref``
    (inputs in their storage dtype, products and sums in f32)."""
    from repro_torch.core import kfac
    xb = kfac.block_reshape(x, x.shape[-1], max_dim, axis=-1).float()
    return torch.einsum("...nka,...nkb->...kab", xb, xb)


def block_precond_left_ref(binv: torch.Tensor, w: torch.Tensor
                           ) -> torch.Tensor:
    """U[k] = Binv[k] @ W[k]: binv (..., nb, b, b), w (..., nb, b, m) ->
    (..., nb, b, m) f32."""
    return torch.einsum("...kab,...kbo->...kao", binv.float(), w.float())


def block_precond_right_ref(w: torch.Tensor, binv: torch.Tensor
                            ) -> torch.Tensor:
    """U[:, k] = W[:, k] @ Binv[k]: w (..., m, nb, b), binv (..., nb, b, b)
    -> (..., m, nb, b) f32."""
    return torch.einsum("...iko,...kop->...ikp", w.float(), binv.float())


# ---------------------------------------------------------------------------
# Newton-Schulz (Stage 4), over already-damped symmetric blocks M
# ---------------------------------------------------------------------------

def ns_tiled_residual_ref(m: torch.Tensor, x: torch.Tensor):
    """R = I - M X and ss = ||R||_F^2 per block: m, x (..., b, b) f32 ->
    (r (..., b, b), ss (...,))."""
    eye = torch.eye(m.shape[-1], dtype=torch.float32, device=m.device)
    r = eye - m @ x
    return r, torch.sum(r * r, dim=(-1, -2))


def ns_tiled_update_ref(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """X' = X + X R: x, r (..., b, b) f32 -> (..., b, b)."""
    return x + x @ r


def ns_x0(m: torch.Tensor) -> torch.Tensor:
    """The initial iterate X0 = M^T / (||M||_1 ||M||_inf) of symmetric
    blocks (..., b, b) (M^T = M): every eigenvalue of M X0 lies in (0, 1]."""
    am = m.abs()
    n1 = am.sum(-2).amax(-1)
    ninf = am.sum(-1).amax(-1)
    return m * (1.0 / (n1 * ninf))[..., None, None]


def ns_inverse_blocks_ref(m: torch.Tensor, iters: int, tol: float):
    """The whole Newton-Schulz inverse of damped symmetric blocks m
    (..., b, b) f32: X0 = M / (||M||_1 ||M||_inf), then per trip
    ``R = I - M X``, ``res = ||R||_F / sqrt(b)`` and, while ``res > tol``,
    ``X <- X + X R``; a block freezes for good once ``res <= tol``. Returns
    (x (..., b, b), res (...,), trips (...,) int32): res the residual of
    the returned iterate, trips the updates applied -- the kernels'
    contract. Stops once every block is frozen (a frozen iterate never
    changes, so the output is that of running all ``iters`` trips). On
    the meta device (the dry run) no trip can be read: all ``iters`` run,
    as ``repro``'s trip-weighted count charges a ``while`` body."""
    x = ns_x0(m)
    rnorm = 1.0 / math.sqrt(m.shape[-1])
    trips = torch.zeros(m.shape[:-2], dtype=torch.int32, device=m.device)
    for _ in range(iters):
        r, ss = ns_tiled_residual_ref(m, x)
        live = torch.sqrt(ss) * rnorm > tol
        if not live.is_meta and not bool(live.any()):
            break
        x = torch.where(live[..., None, None], ns_tiled_update_ref(x, r), x)
        trips += live
    _, ss = ns_tiled_residual_ref(m, x)
    return x, torch.sqrt(ss) * rnorm, trips


# ---------------------------------------------------------------------------
# fp8 rows codec and the factor sum with its wire epilogue
# ---------------------------------------------------------------------------

def quant_rows_ref(x: torch.Tensor, fmt: str = "e4m3",
                   scale_mode: str = "fp32"):
    """Per row of x (..., t): amax, ``scale = amax * FMT_INV_MAX`` (pow2
    optional, zero rows 1), ``x / scale`` clipped to +-FMT_MAX, the fp8
    cast. Returns (payload (..., t), scale (...,) f32)."""
    from repro_torch.quant import quant
    return quant.quantize_rows(x, fmt, scale_mode)


def dequant_rows_ref(payload: torch.Tensor, scale: torch.Tensor
                     ) -> torch.Tensor:
    """``payload.f32 * scale`` per row: (..., t), (...,) -> (..., t) f32."""
    from repro_torch.quant import quant
    return quant.dequantize_rows(payload, scale)


def factor_sum_wire_ref(x: torch.Tensor, max_dim: int, fmt: str = "e4m3",
                        scale_mode: str = "fp32"):
    """The JAX package's ``_factor_sum_wire_ref``: the blocked f32 factor
    sum, sym-packed, then quantized with one scale per block. x (..., n, d)
    -> (payload (..., nb, t), scale (..., nb))."""
    from repro_torch.core import kfac
    return quant_rows_ref(kfac.sym_pack(factor_sum_ref(x, max_dim)), fmt,
                          scale_mode)
