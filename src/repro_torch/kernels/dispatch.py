"""Kernel backend dispatch (counterpart of ``repro/kernels/dispatch.py``).

* ``"ref"``  -- the plain PyTorch versions in :mod:`repro_torch.kernels.ref`.
* ``"cuda"`` -- the hand-written Hopper kernels; CUDA tensors only.
* ``"auto"`` -- by device, not by size: a CPU tensor takes ``ref``, a CUDA
  tensor the kernel.

There is no silent fallback for a CUDA tensor: it reaches the plain version
only when the caller passes ``backend="ref"``, and an op without a kernel
raises. ``"cuda"`` with a CPU tensor raises.
"""

from __future__ import annotations

import logging
from typing import Callable

import torch

from repro_torch.configs.base import BACKENDS, check_backend
# the iteration cap and tolerance live beside the algorithm (core.kfac
# imports this module only inside functions)
from repro_torch.core.kfac import NS_ITERS, NS_TOL
from repro_torch.obs import tracing

_TABLE: dict[str, dict[str, Callable]] = {}

# (op, resolved backend) -> dispatches; lets a run show which path it took
CALLS: dict[tuple[str, str], int] = {}


def register(op: str, backend: str, fn: Callable) -> None:
    """Register ``fn`` as the ``backend`` implementation of ``op``."""
    _TABLE.setdefault(op, {})[backend] = fn


def lookup(op: str, backend: str) -> Callable:
    impls = _TABLE.get(op)
    if impls is None:
        raise KeyError(f"unregistered kernel op {op!r}; registered ops: "
                       f"{sorted(_TABLE)}")
    if backend not in impls:
        raise KeyError(f"op {op!r} has no {backend!r} implementation")
    return impls[backend]


def resolve(backend: str | None, device: torch.device) -> str:
    """Map a backend knob and the device of an op's tensors to ``"ref"`` or
    ``"cuda"``."""
    backend = backend or "auto"
    check_backend(backend)
    if backend == "ref":
        return "ref"
    if torch.device(device).type == "cuda":
        return "cuda"
    if backend == "cuda":
        raise ValueError(f"backend 'cuda' needs CUDA tensors; got tensors on "
                         f"{device}")
    return "ref"


def _call(op: str, which: str, *args, **kwargs):
    """Count the dispatch and run the resolved implementation inside its
    profiler range, ``repro.kernels.<op>[<backend>]``
    (:func:`repro_torch.obs.tracing.kernel_scope`)."""
    CALLS[(op, which)] = CALLS.get((op, which), 0) + 1
    fn = lookup(op, which)
    with tracing.kernel_scope(op, which):
        return fn(*args, **kwargs)


def reset_calls() -> None:
    CALLS.clear()


# ---------------------------------------------------------------------------
# swa_attention: causal(-window) attention in the (BH, S, hd) layout, heads
# flattened into the batch axis (a GQA caller repeats KV first). Inference
# callers only: the model layer's kernel route is swa_attention_fwd_res.
# ---------------------------------------------------------------------------

def _swa_ref(q, k, v, window: int):
    from repro_torch.kernels import ref
    return ref.swa_attention_ref(q, k, v, window=window)


def _swa_cuda(q, k, v, window: int):
    from repro_torch.kernels import swa_attention
    return swa_attention.swa_flash(q, k, v, window=window)


def swa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int = 0, backend: str | None = None) -> torch.Tensor:
    """Returns (BH, S, hd) in q's dtype. Resolves by device like every op
    here: ``repro``'s gate of ``auto`` on the sequence length is not
    ported, so a short sequence on the card takes the kernel too."""
    which = resolve(backend, q.device)
    return _call("swa_attention", which, q, k, v, window)


# ---------------------------------------------------------------------------
# swa_attention_fwd_res: GQA causal(-window) forward + logsumexp residual.
#   q (BKV, G, S, hd) with query head h = c*G + r under KV head c;
#   k, v (BKV, S, hd) unexpanded -> (out (BKV, G, S, hd), lse (BKV, G, S))
# ---------------------------------------------------------------------------

def _swa_fwd_res_ref(q, k, v, window: int):
    from repro_torch.kernels import ref
    return ref.swa_attention_fwd_res_ref(q, k, v, window=window)


def _swa_fwd_res_cuda(q, k, v, window: int):
    from repro_torch.kernels import swa_attention
    return swa_attention.swa_flash_fwd(q, k, v, window=window)


def swa_attention_fwd_res(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, window: int = 0, backend: str | None = None):
    """Returns (out, lse) in the GQA layout above."""
    which = resolve(backend, q.device)
    return _call("swa_attention_fwd_res", which, q, k, v, window)


# ---------------------------------------------------------------------------
# swa_decode: single-query flash decode over a KV cache (the serving hot
# path). q (N, G, hd), N = B * KV heads; k/v (N, C, hd) cache contents in
# the stored dtype (ring of capacity window when window > 0, dense when 0),
# or a (B, KV, C, hd) view of the serving cache, which the kernel reads in
# place; pos (N,) i32; k_scale/v_scale (N, C) or (B, KV, C) f32 per-row
# dequant scales, or None.
# ---------------------------------------------------------------------------

def _swa_decode_ref(q, k, v, pos, window: int, k_scale, v_scale):
    from repro_torch.kernels import ref
    if k.dim() == 4:                  # (B, KV, C, hd) cache view -> (N, C, hd)
        c, hd = k.shape[-2:]
        k, v = k.reshape(-1, c, hd), v.reshape(-1, c, hd)
        if k_scale is not None:
            k_scale, v_scale = k_scale.reshape(-1, c), v_scale.reshape(-1, c)
    return ref.swa_decode_ref(q, k, v, pos, window=window,
                              k_scale=k_scale, v_scale=v_scale)


def _swa_decode_cuda(q, k, v, pos, window: int, k_scale, v_scale):
    from repro_torch.kernels import swa_attention
    return swa_attention.swa_flash_decode(q, k, v, pos, window=window,
                                          k_scale=k_scale, v_scale=v_scale)


def swa_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               pos: torch.Tensor, *, window: int = 0,
               k_scale: torch.Tensor | None = None,
               v_scale: torch.Tensor | None = None,
               backend: str | None = None) -> torch.Tensor:
    """Single-query decode attention; returns (N, G, hd) (f32 from the
    kernel, q's dtype from the plain version)."""
    which = resolve(backend, q.device)
    return _call("swa_decode", which, q, k, v, pos, window, k_scale, v_scale)


# ---------------------------------------------------------------------------
# swa_attention_bwd: the fused backward from the forward's residuals.
#   q, o, do (BKV, G, S, hd); k, v (BKV, S, hd); lse (BKV, G, S) f32
#   -> (dq (BKV, G, S, hd), dk (BKV, S, hd), dv (BKV, S, hd)), all f32, dk/dv
#   summed over each KV head's query-head group
# ---------------------------------------------------------------------------

def _swa_bwd_ref(q, k, v, o, lse, do, window: int):
    from repro_torch.kernels import ref
    return ref.swa_attention_bwd_ref(q, k, v, o, lse, do, window=window)


def _swa_bwd_cuda(q, k, v, o, lse, do, window: int):
    from repro_torch.kernels import swa_attention
    return swa_attention.swa_flash_bwd(q, k, v, o, lse, do, window=window)


def swa_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                      window: int = 0, backend: str | None = None):
    """Backward from the (o, lse) residuals: returns (dq, dk, dv), f32."""
    which = resolve(backend, q.device)
    return _call("swa_attention_bwd", which, q, k, v, o, lse, do, window)


# ---------------------------------------------------------------------------
# factor_sum: blocked A = sum_t x_t x_t^T     (..., n, d) -> (..., nb, b, b)
# f32 sums from bf16 or f32 inputs; the last block's columns past d are zero.
# The cuda entry takes the leading axes (an MoE site's experts) into the same
# one launch, as repro vmaps its SYRK over them (dispatch.py:120-129).
# ---------------------------------------------------------------------------

def _factor_sum_ref(x, max_dim: int):
    from repro_torch.kernels import ref
    return ref.factor_sum_ref(x, max_dim)


def _factor_sum_cuda(x, max_dim: int):
    from repro_torch.kernels import kfac as kern
    return kern.factor_syrk(x, max_dim)


def factor_sum(x: torch.Tensor, max_dim: int, *,
               backend: str | None = None) -> torch.Tensor:
    """Blocked raw factor sum (the statistics-construction hot spot)."""
    which = resolve(backend, x.device)
    return _call("factor_sum", which, x, max_dim)


# ---------------------------------------------------------------------------
# factor_sum_wire: fused factor sum + wire-format epilogue
#   (..., n, d) -> (payload fp8 (..., nb, t=b(b+1)/2), scale f32 (..., nb))
# ref: the unfused composition factor_sum -> sym_pack -> quantize_rows.
# cuda, over every leading axis (an MoE site's experts) at once: b <=
# FACTOR_WIRE_MAX_DIM takes one fused kernel launch (factor_syrk_wire); a
# larger b takes the factor_syrk kernel (its expert axis in one launch), the
# sym_pack gather and one quant_rows launch over the flattened rows. That
# split is the JAX package's (ops.FACTOR_WIRE_MAX_DIM; its larger blocks run
# the unfused composition, dispatch.py:163-164), so the same blocks take the
# fused kernel in both.
# ---------------------------------------------------------------------------

FACTOR_WIRE_MAX_DIM = 1024


def _factor_sum_wire_ref(x, max_dim: int, fmt: str, scale_mode: str):
    from repro_torch.kernels import ref
    return ref.factor_sum_wire_ref(x, max_dim, fmt, scale_mode)


def _factor_sum_wire_cuda(x, max_dim: int, fmt: str, scale_mode: str):
    from repro_torch.core import kfac
    from repro_torch.kernels import kfac as kern
    from repro_torch.kernels import quant as qk
    if kfac.block_size(x.shape[-1], max_dim) <= FACTOR_WIRE_MAX_DIM:
        return qk.factor_syrk_wire(x, max_dim, fmt, scale_mode)
    rows = kfac.sym_pack(kern.factor_syrk(x, max_dim))   # (..., nb, t)
    lead, t = rows.shape[:-1], rows.shape[-1]
    payload, scale = qk.quant_rows(rows.reshape(-1, t), fmt, scale_mode)
    return payload.reshape(lead + (t,)), scale.reshape(lead)


def factor_sum_wire(x: torch.Tensor, max_dim: int, *, fmt: str = "e4m3",
                    scale_mode: str = "fp32", backend: str | None = None):
    """Blocked factor sum emitted in the sym-packed fp8 wire format
    (payload, per-block scale)."""
    which = resolve(backend, x.device)
    return _call("factor_sum_wire", which, x, max_dim, fmt, scale_mode)


# ---------------------------------------------------------------------------
# fp8_pack / fp8_unpack: symmetric blocked factor <-> sym-packed fp8 payload
#   f (..., b, b) -> (payload fp8 (..., t=b(b+1)/2), scale f32 (...,))
# One scale per block. The tril gather is byte movement in torch (the JAX
# package keeps it in XLA too); the kernels own the numeric passes.
# ---------------------------------------------------------------------------

def _fp8_pack_ref(f, fmt: str, scale_mode: str):
    from repro_torch.core import kfac
    from repro_torch.kernels import ref
    return ref.quant_rows_ref(kfac.sym_pack(f.float()), fmt, scale_mode)


def _fp8_pack_cuda(f, fmt: str, scale_mode: str):
    from repro_torch.core import kfac
    from repro_torch.kernels import quant as qk
    rows = kfac.sym_pack(f.float())
    lead, t = rows.shape[:-1], rows.shape[-1]
    payload, scale = qk.quant_rows(rows.reshape(-1, t), fmt, scale_mode)
    return payload.reshape(lead + (t,)), scale.reshape(lead)


def fp8_pack(f: torch.Tensor, *, fmt: str = "e4m3", scale_mode: str = "fp32",
             backend: str | None = None):
    """Quantize + sym-pack a symmetric blocked factor."""
    which = resolve(backend, f.device)
    return _call("fp8_pack", which, f, fmt, scale_mode)


def _fp8_unpack_ref(payload, scale, b: int):
    from repro_torch.core import kfac
    from repro_torch.kernels import ref
    return kfac.sym_unpack(ref.dequant_rows_ref(payload, scale), b)


def _fp8_unpack_cuda(payload, scale, b: int):
    from repro_torch.core import kfac
    from repro_torch.kernels import quant as qk
    lead, t = payload.shape[:-1], payload.shape[-1]
    # a fresh state's zero history is an expanded view: materialized here
    rows = qk.dequant_rows(payload.reshape(-1, t).contiguous(),
                           scale.reshape(-1).contiguous())
    return kfac.sym_unpack(rows, b).reshape(lead + (b, b))


def fp8_unpack(payload: torch.Tensor, scale: torch.Tensor, b: int, *,
               backend: str | None = None) -> torch.Tensor:
    """Dequantize-on-read: packed fp8 payload -> dense symmetric f32
    (..., b, b) blocks."""
    which = resolve(backend, payload.device)
    return _call("fp8_unpack", which, payload, scale, b)


# ---------------------------------------------------------------------------
# ring_hop_pack / ring_hop_unpack: the per-hop fp8 wire codec of the Stage-3
# ring reduce-scatter (repro_torch.comm). Unlike fp8_pack/fp8_unpack these
# take rows that are ALREADY sym-packed (a hop carries a chunk of packed
# triangles): (..., t) f32 <-> (payload fp8 (..., t), scale f32 (...,)), one
# scale per row, the same format as the fp8 history. cuda: the quant_rows
# and dequant_rows kernels over the rows flattened to (g, t).
# ---------------------------------------------------------------------------

def _ring_hop_pack_ref(rows, fmt: str, scale_mode: str):
    from repro_torch.quant import quant
    return quant.quantize_rows(rows, fmt, scale_mode)


def _ring_hop_pack_cuda(rows, fmt: str, scale_mode: str):
    from repro_torch.kernels import quant as qk
    lead, t = rows.shape[:-1], rows.shape[-1]
    payload, scale = qk.quant_rows(rows.float().reshape(-1, t).contiguous(),
                                   fmt, scale_mode)
    return payload.reshape(lead + (t,)), scale.reshape(lead)


def ring_hop_pack(rows: torch.Tensor, *, fmt: str = "e4m3",
                  scale_mode: str = "fp32", backend: str | None = None):
    """Quantize one ring hop's partial-sum rows to the fp8 wire format."""
    which = resolve(backend, rows.device)
    return _call("ring_hop_pack", which, rows, fmt, scale_mode)


def _ring_hop_unpack_ref(payload, scale):
    from repro_torch.quant import quant
    return quant.dequantize_rows(payload, scale)


def _ring_hop_unpack_cuda(payload, scale):
    from repro_torch.kernels import quant as qk
    lead, t = payload.shape[:-1], payload.shape[-1]
    rows = qk.dequant_rows(payload.reshape(-1, t).contiguous(),
                           scale.reshape(-1).contiguous())
    return rows.reshape(lead + (t,))


def ring_hop_unpack(payload: torch.Tensor, scale: torch.Tensor, *,
                    backend: str | None = None) -> torch.Tensor:
    """Dequantize a received hop payload back to the f32 accumulator."""
    which = resolve(backend, payload.device)
    return _call("ring_hop_unpack", which, payload, scale)


# ---------------------------------------------------------------------------
# block_precond_left:  rows of w in blocks of b:  U[k] = Binv[k] @ W[k]
#   binv (..., nb, b, b), w (..., d, m) with d <= nb*b -> (..., d, m) f32
# block_precond_right: columns of w in blocks of b:  U[:, k] = W[:, k] @ Binv[k]
#   w (..., m, d), binv (..., nb, b, b) -> (..., m, d) f32
# w is taken unblocked: the kernel masks the ragged last block where the JAX
# package pads w to nb*b (block_reshape) and slices the result back. The cuda
# entries take the leading axes (an MoE site's experts: binv (E, nb, b, b),
# w (E, d, m)) in one launch, on either side; repro folds its lead into the
# block axis instead, which covers the left side only when d is a whole
# number of blocks.
# ---------------------------------------------------------------------------

def _precond_left_ref(binv, w):
    from repro_torch.core import kfac
    from repro_torch.kernels import ref
    d = w.shape[-2]
    wb = kfac.block_reshape(w, d, binv.shape[-1], axis=-2)
    return kfac.block_unreshape(ref.block_precond_left_ref(binv, wb), d,
                                axis=-3)


def _precond_right_ref(w, binv):
    from repro_torch.core import kfac
    from repro_torch.kernels import ref
    d = w.shape[-1]
    wb = kfac.block_reshape(w, d, binv.shape[-1], axis=-1)
    return kfac.block_unreshape(ref.block_precond_right_ref(wb, binv), d,
                                axis=-2)


def _precond_left_cuda(binv, w):
    return _precond_cuda(binv, w, right=False)


def _precond_right_cuda(w, binv):
    return _precond_cuda(binv, w, right=True)


def _precond_cuda(binv, w, right: bool):
    from repro_torch.kernels import kfac as kern
    # the identity preconditioners of a fresh state are expanded views
    return kern.block_precond(binv.contiguous(), w, right=right)


def block_precond_left(binv: torch.Tensor, w: torch.Tensor, *,
                       backend: str | None = None) -> torch.Tensor:
    """Apply a blocked inverse from the left (the ``A^-1 dW`` half)."""
    which = resolve(backend, w.device)
    return _call("block_precond_left", which, binv, w)


def block_precond_right(w: torch.Tensor, binv: torch.Tensor, *,
                        backend: str | None = None) -> torch.Tensor:
    """Apply a blocked inverse from the right (the ``dW G^-1`` half)."""
    which = resolve(backend, w.device)
    return _call("block_precond_right", which, w, binv)


# ---------------------------------------------------------------------------
# damped_inverse: (F + damping I)^-1 per block -- the Stage-4 inversion.
#   f (..., b, b), damping broadcastable to f's leading axes -> f32 inverse
# "eigh" and "cholesky" are library factorizations in the JAX package too
# (jnp.linalg.eigh on every backend); their "cuda" entry is the same
# torch.linalg call, registered for CUDA tensors. "newton_schulz" is
# matmul-only: ref = the plain iteration (kfac.newton_schulz_inverse), cuda
# = the kernels of kernels/newton_schulz.py (the resident kernel for
# b <= 1024, the tiled pair above). Both share one failure contract: a block
# whose relative residual ||I - M X||_F / ||I||_F is still above NS_TOL
# after NS_ITERS trips, or whose inverse lost a positive diagonal, is
# re-solved with eigh and the count logged. Impl signature:
# fn(f, damping, method) -> (inv, res), res (...,) per block (zeros for the
# direct methods).
# ---------------------------------------------------------------------------

INVERSE_METHODS = ("eigh", "cholesky", "newton_schulz")

_log = logging.getLogger(__name__)


def _ns_eigh_fallback(f, damping, x, res):
    """Replace the blocks the iteration cannot be trusted on with the eigh
    inverse. Two triggers, both folded into the returned residual:

    * res > NS_TOL -- the capped iteration failed to contract;
    * min diag(X) <= 0 -- an SPD inverse has a positive diagonal, so the
      damped factor was indefinite (bf16-accumulation noise); Newton-Schulz
      would converge to the inverse of the indefinite matrix, while the
      contract is eigh's clamped semantics. Their residual becomes +inf.

    Only the bad blocks are re-solved, in place in x (the caller's fresh
    output), after one host read of their count. Returns (x, res)."""
    from repro_torch.core import kfac
    diag = torch.diagonal(x, dim1=-2, dim2=-1)
    res = torch.where(diag.amin(-1) > 0, res,
                      torch.full_like(res, float("inf")))
    bad = res > NS_TOL
    if bad.is_meta:
        # the dry run cannot read the count: charge the re-solve of every
        # block, as repro's analyzer walks both branches of its cond
        d = torch.broadcast_to(torch.as_tensor(damping, dtype=torch.float32,
                                               device=f.device),
                               f.shape[:-2])
        return torch.where(bad[..., None, None],
                           kfac.damped_inverse(f, d), x), res
    n_bad = int(bad.sum())
    if n_bad:
        _log.warning("damped_inverse[newton_schulz]: %d of %d block(s) "
                     "failed to contract below tol=%g (or lost SPD); "
                     "re-solved via eigh", n_bad, bad.numel(), NS_TOL)
        d = torch.broadcast_to(torch.as_tensor(damping, dtype=torch.float32,
                                               device=f.device),
                               f.shape[:-2])
        x[bad] = kfac.damped_inverse(f[bad], d[bad])
    return x, res


def _direct_inverse(f, damping, method: str):
    from repro_torch.core import kfac
    if method not in INVERSE_METHODS:
        raise ValueError(f"unknown inverse method {method!r}; expected "
                         f"{INVERSE_METHODS}")
    inv = kfac.damped_inverse if method == "eigh" else kfac.cholesky_inverse
    return inv(f, damping), torch.zeros(f.shape[:-2], device=f.device)


def _damped_inverse_ref(f, damping, method: str):
    from repro_torch.core import kfac
    if method != "newton_schulz":
        return _direct_inverse(f, damping, method)
    x, res = kfac.newton_schulz_inverse(f, damping)
    return _ns_eigh_fallback(f, damping, x, res)


def _damped_inverse_cuda(f, damping, method: str):
    from repro_torch.core import kfac
    from repro_torch.kernels import newton_schulz as ns
    if not f.is_cuda:
        raise ValueError("damped_inverse[cuda] needs a CUDA tensor")
    if method != "newton_schulz":
        return _direct_inverse(f, damping, method)
    # symmetrize and damp in plain tensor code (the JAX side's XLA prep);
    # the kernels take the damped blocks
    m = kfac.damped_sym(f, damping)
    lead, b = m.shape[:-2], m.shape[-1]
    x, res, _ = ns.ns_inverse(m.reshape(-1, b, b), NS_ITERS, NS_TOL)
    del m
    return _ns_eigh_fallback(f, damping, x.reshape(f.shape),
                             res.reshape(lead))


def damped_inverse(f: torch.Tensor, damping, *, method: str = "eigh",
                   backend: str | None = None, return_info: bool = False):
    """Stage-4 blocked damped inverse, f32. With ``return_info=True`` also
    returns ``{"ns_res", "ns_converged"}`` per block: which blocks took the
    eigh fallback (for the direct methods the residual is zero)."""
    which = resolve(backend, f.device)
    inv, res = _call("damped_inverse", which, f, damping, method)
    if return_info:
        return inv, {"ns_res": res, "ns_converged": res <= NS_TOL}
    return inv


register("factor_sum", "ref", _factor_sum_ref)
register("factor_sum", "cuda", _factor_sum_cuda)
register("factor_sum_wire", "ref", _factor_sum_wire_ref)
register("factor_sum_wire", "cuda", _factor_sum_wire_cuda)
register("fp8_pack", "ref", _fp8_pack_ref)
register("fp8_pack", "cuda", _fp8_pack_cuda)
register("fp8_unpack", "ref", _fp8_unpack_ref)
register("fp8_unpack", "cuda", _fp8_unpack_cuda)
register("ring_hop_pack", "ref", _ring_hop_pack_ref)
register("ring_hop_pack", "cuda", _ring_hop_pack_cuda)
register("ring_hop_unpack", "ref", _ring_hop_unpack_ref)
register("ring_hop_unpack", "cuda", _ring_hop_unpack_cuda)
register("block_precond_left", "ref", _precond_left_ref)
register("block_precond_left", "cuda", _precond_left_cuda)
register("block_precond_right", "ref", _precond_right_ref)
register("block_precond_right", "cuda", _precond_right_cuda)
register("damped_inverse", "ref", _damped_inverse_ref)
register("damped_inverse", "cuda", _damped_inverse_cuda)
register("swa_attention", "ref", _swa_ref)
register("swa_attention", "cuda", _swa_cuda)
register("swa_attention_bwd", "ref", _swa_bwd_ref)
register("swa_attention_bwd", "cuda", _swa_bwd_cuda)
register("swa_attention_fwd_res", "ref", _swa_fwd_res_ref)
register("swa_attention_fwd_res", "cuda", _swa_fwd_res_cuda)
register("swa_decode", "ref", _swa_decode_ref)
register("swa_decode", "cuda", _swa_decode_cuda)

__all__ = ["BACKENDS", "CALLS", "register", "lookup", "resolve",
           "reset_calls", "swa_attention", "swa_attention_fwd_res",
           "swa_attention_bwd", "swa_decode", "factor_sum",
           "factor_sum_wire", "fp8_pack",
           "fp8_unpack", "ring_hop_pack", "ring_hop_unpack",
           "block_precond_left",
           "block_precond_right", "damped_inverse"]
