"""Feed-forward blocks (counterpart of ``repro/models/mlp.py``)."""

from __future__ import annotations

import torch

from repro_torch.core import tagging
from repro_torch.models.layers import activation, he_normal


def mlp(x: torch.Tensor, p: dict, fs=None, *, act: str = "silu",
        gated: bool = True) -> torch.Tensor:
    if fs:
        raise NotImplementedError("tagged sites arrive with the training slice")
    f = activation(act)
    up = tagging.dense_site(x, p["up"])
    h = f(tagging.dense_site(x, p["gate"])) * up if gated else f(up)
    return tagging.dense_site(h, p["down"])


def init_mlp(generator: torch.Generator, d_model: int, d_ff: int,
             gated: bool, dtype, device=None) -> dict:
    p = {"up": he_normal(generator, (d_model, d_ff), dtype, device=device),
         "down": he_normal(generator, (d_ff, d_model), dtype, device=device)}
    if gated:
        p["gate"] = he_normal(generator, (d_model, d_ff), dtype,
                              device=device)
    return p
