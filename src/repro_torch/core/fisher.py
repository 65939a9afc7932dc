"""Fisher information estimation (counterpart of ``repro/core/fisher.py``).

* ``emp`` -- empirical Fisher: the factor statistics come out of the
  ordinary backward pass through the tagged sites (one pass).
* ``1mc`` -- one-sample Monte-Carlo Fisher: labels sampled from the model's
  predictive distribution, and one extra backward pass for the statistics.

Normalization of the RAW sums the sites return, with the mean-over-samples
loss:

    A  = raw_a / n_a    G = raw_g * n_g    d = raw_d * n_g    uw = raw_uw * n_g

(``uwf``, the full BN Fisher, scales by n_g like ``uw``). For LM sites
n_a == n_g == B*S; for conv sites n_a == B*Ho*Wo while n_g == B (Eq. 11's
1/hw spatial normalization of A).

Parameter trees are nested dicts whose ``blocks`` entry is a list of
per-layer dicts; :func:`get_path` maps over that list, so
``get_path(params, "blocks/attn/wq")`` is the list of the L layers' ``wq``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.core.tagging import FactorSpec


# ---------------------------------------------------------------------------
# Site registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SiteInfo:
    """Static metadata tying one tagged site to its parameter leaf.
    ``param`` is a '/'-joined path; ``lead`` the leading axes the factor
    arrays share with the (stacked) parameter, ``(L,)`` for block sites,
    ``(L, E)`` for an MoE block's grouped expert sites."""
    kind: str                      # dense | grouped | conv | embed | bias |
                                   # scale_bias
    param: str
    d_in: int = 0
    d_out: int = 0
    spec: FactorSpec = FactorSpec()
    lead: tuple = ()
    ksize: int = 1                 # conv: spatial kernel (d_in = cin*k*k)
    beta_param: Optional[str] = None   # scale_bias: path of the bias leaf


def get_path(tree: Any, path: str) -> Any:
    """Leaf at ``path``; a list node (the per-layer ``blocks``) maps the
    rest of the path over its items and returns a list."""
    node = tree
    parts = path.split("/")
    for i, part in enumerate(parts):
        if isinstance(node, list):
            rest = "/".join(parts[i:])
            return [get_path(item, rest) for item in node]
        node = node[part]
    return node


def set_path(tree: dict, path: str, value: Any) -> dict:
    """Functionally set ``path`` in a nested-dict tree (a list node takes a
    list of per-item values)."""
    parts = path.split("/")

    def rec(node, i, val):
        if isinstance(node, list):
            return [rec(item, i, v) for item, v in zip(node, val)]
        out = dict(node)
        if i == len(parts) - 1:
            out[parts[i]] = val
        else:
            out[parts[i]] = rec(node[parts[i]], i + 1, val)
        return out
    return rec(tree, 0, value)


def flatten(tree: Any, prefix: str = "") -> dict:
    """{'/'-joined path: leaf}, list items keyed by their index
    (``blocks/3/attn/wq``)."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def unflatten(flat: dict, like: Any, prefix: str = "") -> Any:
    """Inverse of :func:`flatten` on the structure of ``like``."""
    if isinstance(like, dict):
        return {k: unflatten(flat, v, f"{prefix}{k}/") for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return [unflatten(flat, v, f"{prefix}{i}/") for i, v in enumerate(like)]
    return flat[prefix[:-1]]


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------

def normalize_stats(raw: dict, infos: dict[str, SiteInfo],
                    counts: dict[str, tuple]) -> dict:
    """raw: {family: {"a"|"g"|"d"|"uw"|"uwf": raw sums}} -> scaled
    factors."""
    out = {}
    for fam, stats in raw.items():
        n_a, n_g = counts[fam]
        out[fam] = {key: (v / n_a if key == "a" else v * n_g)
                    for key, v in stats.items()}
    return out


# ---------------------------------------------------------------------------
# Gradient + statistics in one (emp) or two (1mc) backward passes
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _tracking(leaves: list):
    """Gradients are taken with respect to the model's own parameter
    tensors, which the serving path keeps frozen: track them for the
    duration of one step."""
    was = [p.requires_grad for p in leaves]
    try:
        with torch.enable_grad():
            for p in leaves:
                p.requires_grad_(True)
            yield
    finally:
        for p, w in zip(leaves, was):
            p.requires_grad_(w)


def _accumulators(fstats: dict) -> tuple[dict, list]:
    """Fresh zero accumulators (expanded views of a zero scalar that takes
    a gradient) in the structure and dtypes of ``fstats`` (fp8 for the
    payload of a wire-format accumulator), and their flat list."""
    flat = flatten(fstats)
    accs = {}
    for path, t in flat.items():
        z = torch.zeros((), dtype=t.dtype, device=t.device,
                        requires_grad=True)
        accs[path] = z.expand(t.shape)
    return unflatten(accs, fstats), list(accs.values())


def _detached(aux):
    if isinstance(aux, dict):
        return {k: v.detach() if isinstance(v, torch.Tensor) else v
                for k, v in aux.items()}
    return aux


def _grads(loss, leaves: list) -> list:
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, gs)]


def value_and_grad(loss_fn: Callable, params, batch):
    """(loss, aux, grads) of ``loss_fn(params, None, batch)``: the plain
    backward of the fast step, no statistics."""
    leaves = list(flatten(params).values())
    with _tracking(leaves):
        loss, aux = loss_fn(params, None, batch)
        gs = _grads(loss, leaves)
    return loss.detach(), _detached(aux), unflatten(
        dict(zip(flatten(params), gs)), params)


def emp_fisher_grads(loss_fn: Callable, params, fstats, batch):
    """One backward pass computes the gradients AND the raw factor sums
    (the paper's ``emp`` path). Returns (loss, aux, grads, raw)."""
    p_flat = flatten(params)
    leaves = list(p_flat.values())
    with _tracking(leaves):
        accs, acc_leaves = _accumulators(fstats)
        loss, aux = loss_fn(params, accs, batch)
        gs = _grads(loss, leaves + acc_leaves)
    grads = unflatten(dict(zip(p_flat, gs[:len(leaves)])), params)
    raw = unflatten(dict(zip(flatten(fstats), gs[len(leaves):])), fstats)
    return loss.detach(), _detached(aux), grads, raw


def mc_fisher_grads(loss_fn: Callable, params, fstats, batch,
                    generator: torch.Generator, label_key: str = "labels"):
    """``1mc`` estimator: gradients from the true labels, factor statistics
    from one extra backward pass against labels sampled from p_theta (drawn
    with ``generator``). ``aux`` must hold "logits"."""
    p_flat = flatten(params)
    leaves = list(p_flat.values())
    with _tracking(leaves):
        loss, aux = loss_fn(params, None, batch)
        gs = _grads(loss, leaves)
        logits = aux["logits"].detach().float()
        probs = torch.softmax(logits.reshape(-1, logits.shape[-1]), dim=-1)
        sampled = torch.multinomial(probs, 1, generator=generator)
        batch_mc = dict(batch)
        batch_mc[label_key] = sampled.reshape(batch[label_key].shape)
        accs, acc_leaves = _accumulators(fstats)
        mc_loss, _ = loss_fn(params, accs, batch_mc)
        raw_gs = torch.autograd.grad(mc_loss, acc_leaves)
    grads = unflatten(dict(zip(p_flat, gs)), params)
    raw = unflatten(dict(zip(flatten(fstats), raw_gs)), fstats)
    return loss.detach(), _detached(aux), grads, raw
