"""Selective SSM (Mamba-style) branch of the hymba hybrid blocks
(counterpart of ``repro/models/ssm.py``).

K-FAC coverage: the in/out, x->(dt, B, C) and dt projections are dense
sites; the recurrence parameters (``a_log``, ``d_skip``, the depthwise
conv kernel, the dt bias) are elementwise or depthwise, with no Kronecker
structure, and take the first-order fallback.

The recurrence is a loop of torch ops over time, as the JAX package's is
a ``lax.scan`` outside any Pallas kernel: per token, the (B, d_inner, N)
f32 state takes ``h = exp(dt a) h + (dt x) B`` and the output reads
``h C``. With ``chunk > 1`` each chunk of tokens runs under
``torch.utils.checkpoint`` (non-reentrant): the same ops, the same numbers.
A profiler sees the loop's forward under the range ``repro.scan.ssm``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core import tagging
from repro_torch.models.layers import he_normal
from repro_torch.obs import tracing

CONV_K = 4


def init_ssm(generator: torch.Generator, d_model: int, state: int, dtype,
             expand: int = 2, dt_rank: Optional[int] = None,
             conv_k: int = CONV_K, device=None) -> dict:
    """``a_log`` = log(1..N) on every inner channel and ``d_skip`` ones, in
    f32; every other leaf ``dtype``; the JAX package's distributions."""
    d_inner = expand * d_model
    dt_rank = dt_rank or max(1, d_model // 16)
    dev = device or generator.device

    def he(shape):
        return he_normal(generator, shape, dtype, device=dev)
    a = torch.arange(1, state + 1, dtype=torch.float32, device=dev)
    return {
        "in_proj": he((d_model, 2 * d_inner)),
        "conv_w": (torch.randn((conv_k, d_inner), generator=generator,
                               device=dev) * 0.1).to(dtype),
        "xdb": he((d_inner, dt_rank + 2 * state)),
        "dt_proj": he((dt_rank, d_inner)),
        "dt_bias": torch.zeros((d_inner,), dtype=dtype, device=dev),
        "a_log": torch.log(a).expand(d_inner, state).contiguous(),
        "d_skip": torch.ones((d_inner,), dtype=torch.float32, device=dev),
        "out_proj": he((d_inner, d_model)),
    }


def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor,
                           cache: Optional[torch.Tensor] = None):
    """x (B, S, C), w (K, C) -> (y (B, S, C), the new cache (B, K-1, C):
    the last K-1 inputs)."""
    k, s = w.shape[0], x.shape[1]
    hist = cache if cache is not None else torch.zeros(
        (x.shape[0], k - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xx = torch.cat([hist, x], dim=1)
    y = sum(xx[:, i:i + s, :] * w[i] for i in range(k))
    return y, (xx[:, -(k - 1):, :] if k > 1 else hist)


def _dt_bc(x, p, fs, spec, state):
    """(dt (B, S, di) f32 after softplus, B (B, S, N) f32, C (B, S, N)
    f32)."""
    def g(n):
        return fs.get(n) if fs else None
    dt_rank = p["dt_proj"].shape[0]
    xdb = tagging.dense_site(x, p["xdb"], g("xdb"), spec)
    bmat = xdb[..., dt_rank:dt_rank + state]
    cmat = xdb[..., dt_rank + state:]
    dt = tagging.dense_site(xdb[..., :dt_rank], p["dt_proj"], g("dt_proj"),
                            spec)
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    return dt, bmat.float(), cmat.float()


def _ssm_chunk(h, xc, dc, bc, cc, a):
    """The per-token steps over (B, T, ...) inputs: (state, (B, T, di))."""
    ys = []
    for xt, dtt, bt, ct in zip(xc.unbind(1), dc.unbind(1), bc.unbind(1),
                               cc.unbind(1)):
        da = torch.exp(dtt[..., None] * a)                    # (B, di, N)
        h = da * h + (dtt * xt)[..., None] * bt[:, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, ct))
    return h, torch.stack(ys, dim=1)


def _ssm_scan(xf, dt, bmat, cmat, a, h0, *, chunk: int = 0):
    """The selective scan over (B, S, ...) inputs: (final state, (B, S,
    di)). ``chunk > 1`` (dividing S, below it) recomputes each chunk's
    steps in the backward from its first state."""
    s = xf.shape[1]
    if not (chunk and chunk > 1 and s % chunk == 0 and s > chunk):
        return _ssm_chunk(h0, xf, dt, bmat, cmat, a)
    h, ys = h0, []
    for xc, dc, bc, cc in zip(*(t.split(chunk, dim=1)
                                for t in (xf, dt, bmat, cmat))):
        h, y = checkpoint(_ssm_chunk, h, xc, dc, bc, cc, a,
                          use_reentrant=False)
        ys.append(y)
    return h, torch.cat(ys, dim=1)


def ssm_branch(x_seq: torch.Tensor, p: dict, fs: Optional[dict] = None, *,
               state: int, spec: tagging.FactorSpec = tagging.FactorSpec(),
               init_state: Optional[torch.Tensor] = None,
               conv_cache: Optional[torch.Tensor] = None, chunk: int = 0,
               return_state: bool = False):
    """x_seq (B, S, d_model) -> (B, S, d_model) [+ (SSM state (B, di, N),
    conv cache (B, K-1, di))]. ``init_state`` / ``conv_cache`` carry a
    decode's state. fs keys: ``in_proj``, ``xdb``, ``dt_proj``,
    ``out_proj``."""
    def g(n):
        return fs.get(n) if fs else None
    x, z = tagging.dense_site(x_seq, p["in_proj"], g("in_proj"),
                              spec).chunk(2, dim=-1)
    x, new_conv = _causal_depthwise_conv(x, p["conv_w"], conv_cache)
    x = F.silu(x)
    dt, bmat, cmat = _dt_bc(x, p, fs, spec, state)
    a = -torch.exp(p["a_log"])                               # (di, N)
    xf = x.float()
    h0 = init_state if init_state is not None else torch.zeros(
        (x.shape[0], x.shape[-1], state), dtype=torch.float32,
        device=x.device)
    with tracing.scan_scope("ssm"):
        h_final, ys = _ssm_scan(xf, dt, bmat, cmat, a, h0, chunk=chunk)
    y = ys + xf * p["d_skip"]
    y = (y * F.silu(z.float())).to(x_seq.dtype)
    out = tagging.dense_site(y, p["out_proj"], g("out_proj"), spec)
    if return_state:
        return out, (h_final, new_conv)
    return out
