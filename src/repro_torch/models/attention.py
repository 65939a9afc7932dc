"""GQA attention with chunked online softmax and sliding-window support
(counterpart of ``repro/models/attention.py``).

:func:`attention` takes the kernel route -- the ``swa_attention_fwd_res``
op, which launches the hand-written CUDA prefill kernel -- when the
``backend`` knob resolves to ``"cuda"`` for the tensors' device, and raises
there for a call the kernel does not cover (it covers causal
self-attention over the whole sequence); CPU tensors and ``backend="ref"``
take the chunked plain path below. The kernel route trains through
:class:`_KernelAttention`, a ``torch.autograd.Function`` (counterpart of
the JAX package's ``_pallas_attention`` custom VJP): its forward is the
residual-saving ``swa_attention_fwd_res`` and its backward the fused
``swa_attention_bwd`` from ``(o, lse)``, with KV unexpanded, so dk/dv come
back per KV head already summed over the query-head group.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _kernel_eligible(causal: bool, q_offset, kv_len, sq: int, sk: int) -> bool:
    """The kernel covers exactly causal self-attention over the full
    sequence (no KV cache slice, no decode offset)."""
    return (causal and kv_len is None and sq == sk
            and isinstance(q_offset, int) and q_offset == 0)


def _to_kernel_layout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """(B, S, H, hd) q + (B, S, KV, hd) k/v -> the kernel's GQA layout:
    q (B*KV, G, S, hd) with query head h = c*G + r grouped under KV head c,
    k/v (B*KV, S, hd) unexpanded; all contiguous."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    qg = q.permute(0, 2, 1, 3).reshape(b * kv, h // kv, s, hd).contiguous()
    kf = k.permute(0, 2, 1, 3).reshape(b * kv, s, hd).contiguous()
    vf = v.permute(0, 2, 1, 3).reshape(b * kv, s, hd).contiguous()
    return qg, kf, vf


class _KernelAttention(torch.autograd.Function):
    """(B, S, H, hd) q, (B, S, KV, hd) k/v -> (B, S, H, hd) through the
    kernel ops; saves (q, k, v, out, lse) for the backward."""

    @staticmethod
    def forward(ctx, q, k, v, window, backend):
        from repro_torch.kernels import dispatch
        b, s, h, hd = q.shape
        qg, kf, vf = _to_kernel_layout(q, k, v)
        out, lse = dispatch.swa_attention_fwd_res(qg, kf, vf, window=window,
                                                  backend=backend)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window, ctx.backend = window, backend
        return out.reshape(b, h, s, hd).permute(0, 2, 1, 3)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.kernels import dispatch
        q, k, v, out, lse = ctx.saved_tensors
        b, s, h, hd = q.shape
        kv = k.shape[2]
        qg, kf, vf = _to_kernel_layout(q, k, v)
        # the cotangent shares q's (B, S, H, hd) layout; out is already in
        # the kernel's (B*KV, G, S, hd) layout
        dog = g.permute(0, 2, 1, 3).reshape(b * kv, h // kv, s,
                                             hd).contiguous()
        dq, dk, dv = dispatch.swa_attention_bwd(qg, kf, vf, out, lse, dog,
                                                window=ctx.window,
                                                backend=ctx.backend)
        dq = dq.reshape(b, h, s, hd).permute(0, 2, 1, 3).to(q.dtype)
        dk = dk.reshape(b, kv, s, hd).permute(0, 2, 1, 3).to(k.dtype)
        dv = dv.reshape(b, kv, s, hd).permute(0, 2, 1, 3).to(v.dtype)
        return dq, dk, dv, None, None


def _kernel_attention(q, k, v, window: int,
                      backend: str = "cuda") -> torch.Tensor:
    return _KernelAttention.apply(q, k, v, window, backend)


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    b, s, kv, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, n_rep, hd).reshape(
        b, s, kv * n_rep, hd)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, q_offset=0,
              kv_len=None, chunk: int = 1024,
              backend: Optional[str] = None) -> torch.Tensor:
    """q (B, Sq, H, hd); k, v (B, Sk, KV, hd). Returns (B, Sq, H, hd).

    ``q_offset``: absolute position of q[0]; ``kv_len``: number of valid
    keys (None = all of Sk); ``window``: key j is visible to query i iff
    ``i - window < j <= i`` (0 = full causal, never "zero keys").

    Where ``backend`` resolves to ``"cuda"`` the call takes the kernel, and
    a call the kernel does not cover raises: on a CUDA tensor the plain path
    runs only under ``backend="ref"``."""
    from repro_torch.kernels import dispatch
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if dispatch.resolve(backend, q.device) == "cuda":
        if not _kernel_eligible(causal, q_offset, kv_len, sq, sk):
            raise NotImplementedError(
                "no CUDA kernel for attention with a q_offset, a kv_len or "
                "Sq != Sk (the prefill kernel covers causal self-attention "
                "over the whole sequence); pass backend='ref' for the plain "
                "path")
        return _kernel_attention(q, k, v, window)
    k = _repeat_kv(k, h // kv)
    v = _repeat_kv(v, h // kv)
    scale = hd ** -0.5
    qf = (q * scale).float()
    q_pos = q_offset + torch.arange(sq, device=q.device)

    chunk = min(chunk, sk)
    n_chunks = -(-sk // chunk)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    denom = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, hd), dtype=torch.float32, device=q.device)
    limit = kv_len if kv_len is not None else sk
    for c in range(n_chunks):
        j0 = c * chunk
        kj = k[:, j0:j0 + chunk].float()
        vj = v[:, j0:j0 + chunk].float()
        cl = kj.shape[1]
        if cl < chunk:                       # zero-pad the last chunk
            pad = (0, 0, 0, 0, 0, chunk - cl)
            kj = torch.nn.functional.pad(kj, pad)
            vj = torch.nn.functional.pad(vj, pad)
        s = torch.einsum("bqhd,bchd->bhqc", qf, kj)
        k_pos = j0 + torch.arange(chunk, device=q.device)
        valid = k_pos[None, :] < limit
        if causal:
            vis = k_pos[None, :] <= q_pos[:, None]
            if window:
                vis &= k_pos[None, :] > (q_pos[:, None] - window)
            valid = valid & vis
        s = torch.where(valid[None, None], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        denom = denom * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bhqc,bchd->bhqd", p, vj)
        m = m_new
    out = acc / torch.clamp(denom, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def attention_naive(q, k, v, *, causal=True, window=0, q_offset=0,
                    kv_len=None):
    """O(Sq*Sk) materialized-scores attention (oracle for tests)."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    k = _repeat_kv(k, h // kv)
    v = _repeat_kv(v, h // kv)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * hd ** -0.5
    q_pos = q_offset + torch.arange(sq, device=q.device)
    k_pos = torch.arange(sk, device=q.device)
    valid = k_pos[None, :] < (kv_len if kv_len is not None else sk)
    if causal:
        vis = k_pos[None, :] <= q_pos[:, None]
        if window:
            vis &= k_pos[None, :] > (q_pos[:, None] - window)
        valid = valid & vis
    s = torch.where(valid[None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)
