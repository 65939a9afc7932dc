"""Feed-forward blocks (counterpart of ``repro/models/mlp.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import tagging
from repro_torch.models.layers import activation, he_normal


def mlp(x: torch.Tensor, p: dict, fs: Optional[dict] = None, *,
        act: str = "silu", gated: bool = True,
        spec: tagging.FactorSpec = tagging.FactorSpec()) -> torch.Tensor:
    """fs keys (when tagging): "up", "gate", "down"."""
    def g(name):
        return fs.get(name) if fs else None

    f = activation(act)
    up = tagging.dense_site(x, p["up"], g("up"), spec)
    if gated:
        h = f(tagging.dense_site(x, p["gate"], g("gate"), spec)) * up
    else:
        h = f(up)
    return tagging.dense_site(h, p["down"], g("down"), spec)


def init_mlp(generator: torch.Generator, d_model: int, d_ff: int,
             gated: bool, dtype, device=None) -> dict:
    p = {"up": he_normal(generator, (d_model, d_ff), dtype, device=device),
         "down": he_normal(generator, (d_ff, d_model), dtype, device=device)}
    if gated:
        p["gate"] = he_normal(generator, (d_model, d_ff), dtype,
                              device=device)
    return p
