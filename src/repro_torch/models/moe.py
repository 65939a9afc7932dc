"""Mixture-of-Experts block with capacity-based dispatch and per-expert
Kronecker factors (counterpart of ``repro/models/moe.py``).

Every expert's matmul is a :func:`repro_torch.core.tagging.grouped_dense_site`
whose factors carry the expert axis, ``(E, nb, b, b)`` a layer; the router
is a plain dense site. Near-empty experts get near-zero factors, and the
Tikhonov damping bounds their inverses.

Dispatch is top-k with a capacity: assignments past an expert's capacity
are dropped (the residual path carries those tokens unchanged). The scatter
into the ``(E, C, d)`` buffer and the gather back are plain torch
(``index_put`` with accumulate, advanced indexing), as ``repro`` computes
them outside any kernel. ``repro``'s ``buf_hook`` argument, a pjit sharding
constraint on the buffer, has no meaning on one device and is not taken.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import tagging
from repro_torch.models.layers import activation, he_normal
from repro_torch.models.mlp import mlp


def topk_lower_first(probs: torch.Tensor, k: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of each row and their indices, ties to the
    lower index first (``jax.lax.top_k``'s order; ``torch.topk`` does not
    promise one): a stable descending sort."""
    idx = torch.sort(probs, dim=-1, descending=True, stable=True)[1][..., :k]
    return probs.gather(-1, idx), idx


def router_probs(x2d: torch.Tensor, w_router: torch.Tensor,
                 fs: Optional[dict], n_experts: int, k: int,
                 spec: tagging.FactorSpec):
    """Returns (topk_probs (T, k), topk_idx (T, k), aux_loss scalar): f32
    router logits from a dense site, softmax, top-k, the top-k
    probabilities renormalised (floor 1e-9), and the Switch load-balance
    loss from the top-1 assignment."""
    logits = tagging.dense_site(x2d, w_router, fs, spec).float()
    probs = torch.softmax(logits, dim=-1)
    topk_probs, topk_idx = topk_lower_first(probs, k)
    topk_probs = topk_probs / torch.clamp(
        topk_probs.sum(-1, keepdim=True), min=1e-9)
    me = probs.mean(0)                                   # mean router prob
    ce = F.one_hot(topk_idx[:, 0], n_experts).float().mean(0)  # top-1 share
    aux = n_experts * torch.sum(me * ce)
    return topk_probs, topk_idx, aux


def dispatch_combine(x2d: torch.Tensor, topk_probs: torch.Tensor,
                     topk_idx: torch.Tensor, n_experts: int, capacity: int,
                     expert_fn) -> torch.Tensor:
    """Scatter the tokens to (E, C, d), run ``expert_fn``, gather back
    weighted by the renormalised probabilities. Slots go in the flattened
    (token, k) order t0k0, t0k1, t1k0, ...: an assignment's slot is the
    number of earlier assignments to its expert; past ``capacity`` it is
    dropped. Empty slots stay zero rows."""
    t, d = x2d.shape
    k = topk_idx.shape[1]
    flat_idx = topk_idx.reshape(-1)                      # (T*k,)
    one_hot = F.one_hot(flat_idx, n_experts)             # (T*k, E)
    pos_in_e = (torch.cumsum(one_hot, dim=0) * one_hot).sum(-1) - 1
    keep = pos_in_e < capacity
    safe_pos = torch.where(keep, pos_in_e, capacity - 1)
    zero = torch.zeros((), dtype=x2d.dtype, device=x2d.device)
    xk = torch.where(keep[:, None], x2d.repeat_interleave(k, dim=0), zero)
    buf = x2d.new_zeros((n_experts, capacity, d)).index_put(
        (flat_idx, safe_pos), xk, accumulate=True)
    out_e = expert_fn(buf)                               # (E, C, d_out)
    gathered = out_e[flat_idx, safe_pos]                 # (T*k, d_out)
    gathered = torch.where(keep[:, None], gathered,
                           torch.zeros((), dtype=gathered.dtype,
                                       device=gathered.device))
    w = topk_probs.reshape(-1)[:, None].to(gathered.dtype)
    return (gathered * w).reshape(t, k, -1).sum(1)


def moe_block(x: torch.Tensor, p: dict, fs: Optional[dict], *,
              n_experts: int, top_k: int, act: str = "silu",
              capacity_factor: float = 1.25,
              spec: tagging.FactorSpec = tagging.FactorSpec()
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d), aux_loss). Param keys: router (d, E);
    we_up/we_gate (E, d, f), we_down (E, f, d); optional shared experts
    sh_up/sh_gate (d, sf), sh_down (sf, d), a gated MLP over every token.
    The capacity is max(1, int(cf * T * top_k / E)) for the T = B*S tokens
    of the call (at decode, the lanes)."""
    b, s, d = x.shape

    def g(name):
        return fs.get(name) if fs else None

    x2d = x.reshape(-1, d)
    t = x2d.shape[0]
    capacity = max(1, int(capacity_factor * t * top_k / n_experts))
    probs, idx, aux = router_probs(x2d, p["router"], g("router"), n_experts,
                                   top_k, spec)
    f = activation(act)

    def experts(buf):                                    # (E, C, d)
        up = tagging.grouped_dense_site(buf, p["we_up"], g("we_up"), spec)
        gate = tagging.grouped_dense_site(buf, p["we_gate"], g("we_gate"),
                                          spec)
        return tagging.grouped_dense_site(f(gate) * up, p["we_down"],
                                          g("we_down"), spec)

    y = dispatch_combine(x2d, probs, idx, n_experts, capacity, experts)
    if "sh_up" in p:              # always-on experts: silu whatever ``act``
        y = y + mlp(x2d, {"up": p["sh_up"], "gate": p["sh_gate"],
                          "down": p["sh_down"]},
                    {"up": g("sh_up"), "gate": g("sh_gate"),
                     "down": g("sh_down")} if fs else None,
                    act="silu", gated=True, spec=spec)
    return y.reshape(b, s, d), aux


def init_moe(generator: torch.Generator, d_model: int, d_ff: int,
             n_experts: int, n_shared: int, dtype, device=None) -> dict:
    """HeNormal weights (fan-in the input width, the expert axis aside),
    ``repro``'s distributions; deterministic in the generator."""
    def he(shape):
        return he_normal(generator, shape, dtype, device=device)

    p = {"router": he((d_model, n_experts)),
         "we_up": he((n_experts, d_model, d_ff)),
         "we_gate": he((n_experts, d_model, d_ff)),
         "we_down": he((n_experts, d_ff, d_model))}
    if n_shared:
        sf = n_shared * d_ff
        p["sh_up"] = he((d_model, sf))
        p["sh_gate"] = he((d_model, sf))
        p["sh_down"] = he((sf, d_model))
    return p
