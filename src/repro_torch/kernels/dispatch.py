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

from typing import Callable

import torch

from repro_torch.configs.base import BACKENDS, check_backend

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
    CALLS[(op, which)] = CALLS.get((op, which), 0) + 1
    return lookup(op, which)(*args, **kwargs)


def reset_calls() -> None:
    CALLS.clear()


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


register("swa_attention_fwd_res", "ref", _swa_fwd_res_ref)
register("swa_attention_fwd_res", "cuda", _swa_fwd_res_cuda)
register("swa_decode", "ref", _swa_decode_ref)
register("swa_decode", "cuda", _swa_decode_cuda)

__all__ = ["BACKENDS", "CALLS", "register", "lookup", "resolve",
           "reset_calls", "swa_attention_fwd_res", "swa_decode"]
