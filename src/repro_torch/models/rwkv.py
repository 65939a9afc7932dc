"""RWKV-6 ("Finch") blocks: attention-free time mix with a data-dependent
per-channel decay, and a squared-ReLU channel mix (counterpart of
``repro/models/rwkv.py``). [arXiv:2404.05892]

K-FAC coverage: the r/k/v/g/o, decay-LoRA and channel-mix matmuls are
dense sites; the token-shift interpolation vectors (``mu_*``) and the
group-norm scale are scale sites taken unit-wise (1x1); the decay base
``w0`` and the bonus ``u_bonus`` take the first-order fallback.

The WKV recurrence is a loop of torch ops over time, as the JAX package's
is a ``lax.scan`` outside any Pallas kernel: per token, the (B, h, hd, hd)
f32 state takes ``s = w * s + k v^T`` and the output reads
``r (s + u k v^T)``. With ``chunk > 1`` each chunk of tokens runs under
``torch.utils.checkpoint`` (non-reentrant), so the backward keeps only the
state at chunk boundaries and recomputes the rest: the same ops, the same
numbers as the per-token loop. A profiler sees the loop's forward under
the range ``repro.scan.wkv``.

State per layer: (last x of the time mix, last x of the channel mix, the
WKV state (B, h, hd, hd)) -- O(1) in sequence length.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core import tagging
from repro_torch.models.layers import he_normal
from repro_torch.obs import tracing

LORA_R = 32


def init_rwkv_tm(generator: torch.Generator, d: int, head_dim: int, dtype,
                 lora_r: int = LORA_R, device=None) -> dict:
    """Time-mix params: ``w0``, ``u_bonus`` and ``ln_scale`` f32, every
    other leaf ``dtype``; the JAX package's distributions."""
    h = d // head_dim
    dev = device or generator.device

    def half():
        return torch.full((d,), 0.5, dtype=dtype, device=dev)

    def he(shape):
        return he_normal(generator, shape, dtype, device=dev)
    p = {f"mu_{n}": half() for n in ("r", "k", "v", "w", "g")}
    p.update({n: he((d, d)) for n in ("wr", "wk", "wv", "wg", "wo")})
    p["w0"] = torch.zeros((d,), dtype=torch.float32, device=dev)
    p["w_lora_a"] = he((d, lora_r))
    p["w_lora_b"] = (torch.randn((lora_r, d), generator=generator,
                                 device=dev) * 0.01).to(dtype)
    p["u_bonus"] = torch.zeros((h, head_dim), dtype=torch.float32,
                               device=dev)
    p["ln_scale"] = torch.ones((d,), dtype=torch.float32, device=dev)
    return p


def init_rwkv_cm(generator: torch.Generator, d: int, d_ff: int, dtype,
                 device=None) -> dict:
    dev = device or generator.device
    return {"mu_k": torch.full((d,), 0.5, dtype=dtype, device=dev),
            "mu_r": torch.full((d,), 0.5, dtype=dtype, device=dev),
            "wk": he_normal(generator, (d, d_ff), dtype, device=dev),
            "wv": he_normal(generator, (d_ff, d), dtype, device=dev),
            "wr": he_normal(generator, (d, d), dtype, device=dev)}


def _token_shift(x: torch.Tensor, last: Optional[torch.Tensor]):
    """x (B, S, d) -> (the previous token's x, the new last (B, 1, d))."""
    if last is None:
        last = torch.zeros_like(x[:, :1])
    return torch.cat([last, x[:, :-1]], dim=1), x[:, -1:]


def _lerp(x, prev, mu, fs_key, fs):
    """Token-shift interpolation ``x + (prev - x) * mu``, mu a scale site."""
    return x + tagging.scale_bias_site(prev - x, mu, None,
                                       fs.get(fs_key) if fs else None)


def _wkv_step(st, rt, kt, vt, wt, u):
    """One WKV-6 step. st (B, h, hd, hd); the others (B, h, hd)."""
    kv = kt[..., :, None] * vt[..., None, :]
    out = torch.einsum("bhk,bhkv->bhv", rt, st + u[..., None] * kv)
    return wt[..., None] * st + kv, out


def _wkv_chunk(st, rc, kc, vc, wc, u):
    """The per-token steps over (B, T, h, hd) inputs: (state, (B, T, h, hd)).
    ``unbind`` hands each step a view whose backward is one stack."""
    outs = []
    for rt, kt, vt, wt in zip(rc.unbind(1), kc.unbind(1), vc.unbind(1),
                              wc.unbind(1)):
        st, out = _wkv_step(st, rt, kt, vt, wt, u)
        outs.append(out)
    return st, torch.stack(outs, dim=1)


def _wkv_scan(rh, kh, vh, wh, u, st0, *, chunk: int = 0):
    """WKV recurrence over (B, S, h, hd) inputs: (final state, outputs).
    ``chunk > 1`` (dividing S, below it) recomputes each chunk's steps in
    the backward from its first state."""
    s = rh.shape[1]
    if not (chunk and chunk > 1 and s % chunk == 0 and s > chunk):
        return _wkv_chunk(st0, rh, kh, vh, wh, u)
    st, outs = st0, []
    for rc, kc, vc, wc in zip(*(a.split(chunk, dim=1)
                                for a in (rh, kh, vh, wh))):
        st, out = checkpoint(_wkv_chunk, st, rc, kc, vc, wc, u,
                             use_reentrant=False)
        outs.append(out)
    return st, torch.cat(outs, dim=1)


def time_mix(x: torch.Tensor, p: dict, fs: Optional[dict] = None, *,
             head_dim: int, spec: tagging.FactorSpec = tagging.FactorSpec(),
             last_x: Optional[torch.Tensor] = None,
             wkv_state: Optional[torch.Tensor] = None, chunk: int = 0,
             return_state: bool = False):
    """RWKV-6 time mixing, x (B, S, d) -> (B, S, d) [+ (new last x, WKV
    state)]. fs keys (when tagging): the weights' names, ``mu_*`` and
    ``ln_scale``."""
    b, s, d = x.shape
    h = d // head_dim

    def g(n):
        return fs.get(n) if fs else None
    prev, new_last = _token_shift(x, last_x)
    xr, xk, xv, xw, xg = (_lerp(x, prev, p[f"mu_{n}"], f"mu_{n}", fs)
                          for n in ("r", "k", "v", "w", "g"))
    r = tagging.dense_site(xr, p["wr"], g("wr"), spec)
    k = tagging.dense_site(xk, p["wk"], g("wk"), spec)
    v = tagging.dense_site(xv, p["wv"], g("wv"), spec)
    gate = F.silu(tagging.dense_site(xg, p["wg"], g("wg"), spec))

    # data-dependent decay (Finch): w = exp(-exp(w0 + lora(xw))), in f32
    lora = tagging.dense_site(torch.tanh(
        tagging.dense_site(xw, p["w_lora_a"], g("w_lora_a"), spec)),
        p["w_lora_b"], g("w_lora_b"), spec)
    w = torch.exp(-torch.exp(p["w0"] + lora.float()))

    rh, kh, vh = (t.reshape(b, s, h, head_dim).float() for t in (r, k, v))
    wh = w.reshape(b, s, h, head_dim)
    st0 = wkv_state if wkv_state is not None else torch.zeros(
        (b, h, head_dim, head_dim), dtype=torch.float32, device=x.device)
    with tracing.scan_scope("wkv"):
        st_final, y = _wkv_scan(rh, kh, vh, wh, p["u_bonus"], st0,
                                chunk=chunk)

    # per-head group norm; its scale a unit-wise site
    mu = y.mean(-1, keepdim=True)
    var = ((y - mu) ** 2).mean(-1, keepdim=True)
    y = ((y - mu) * torch.rsqrt(var + 1e-5)).reshape(b, s, d)
    y = tagging.scale_bias_site(y.to(x.dtype), p["ln_scale"].to(x.dtype),
                                None, g("ln_scale"))
    y = y * gate.to(y.dtype)
    out = tagging.dense_site(y, p["wo"], g("wo"), spec)
    if return_state:
        return out, (new_last, st_final)
    return out


def channel_mix(x: torch.Tensor, p: dict, fs: Optional[dict] = None, *,
                spec: tagging.FactorSpec = tagging.FactorSpec(),
                last_x: Optional[torch.Tensor] = None,
                return_state: bool = False):
    """RWKV channel mixing: ``sigmoid(xr W_r) * (relu(xk W_k)^2 W_v)``
    [+ the new last x]. fs keys: ``wk``, ``wv``, ``wr``, ``cm_mu_k``,
    ``cm_mu_r``."""
    def g(n):
        return fs.get(n) if fs else None
    prev, new_last = _token_shift(x, last_x)
    xk = _lerp(x, prev, p["mu_k"], "cm_mu_k", fs)
    xr = _lerp(x, prev, p["mu_r"], "cm_mu_r", fs)
    k = torch.square(F.relu(tagging.dense_site(xk, p["wk"], g("wk"), spec)))
    kv = tagging.dense_site(k, p["wv"], g("wv"), spec)
    out = torch.sigmoid(tagging.dense_site(xr, p["wr"], g("wr"), spec)) * kv
    if return_state:
        return out, new_last
    return out
