"""Momentum-SGD baseline (counterpart of ``repro/optim/sgd.py``): the
paper's first-order reference (Eq. 2), the heavy-ball form of the SP-NGD
update (Eq. 23) with the identity preconditioner, so a comparison of the
two isolates the preconditioning.

One step is one plain backward (no tagged capture, as
``SPNGD.step_fast``), then, in place as ``SPNGD._finish`` updates:

    g <- g + weight_decay * w      (if weight_decay)
    v <- mom * v - lr * g
    w <- w + v

The velocity is held in each parameter's dtype.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.fisher import flatten, value_and_grad


class SGD:
    def __init__(self, loss_fn: Callable, weight_decay: float = 0.0):
        self.loss_fn = loss_fn
        self.weight_decay = weight_decay

    def init(self, params) -> dict:
        """Zero velocity, keyed by flat parameter path as in
        ``SPNGD.init``."""
        return {"step": 0,
                "velocity": {path: torch.zeros_like(p)
                             for path, p in flatten(params).items()}}

    def step(self, params, state, batch, lr, mom):
        """One update of ``params`` and ``state["velocity"]`` in place;
        returns (params, state, {"loss"})."""
        loss, _, grads = value_and_grad(self.loss_fn, params, batch)
        flat_p, flat_g = flatten(params), flatten(grads)
        ps = list(flat_p.values())
        gs = [flat_g[k] for k in flat_p]
        vs = [state["velocity"][k] for k in flat_p]
        with torch.no_grad():
            if self.weight_decay:
                gs = torch._foreach_add(gs, torch._foreach_mul(
                    ps, self.weight_decay))
            torch._foreach_mul_(vs, mom)
            torch._foreach_sub_(vs, torch._foreach_mul(gs, lr))
            torch._foreach_add_(ps, vs)
        return params, {**state, "step": state["step"] + 1}, {"loss": loss}
