"""Tagged sites, untagged fast path only (counterpart of the ``stats is
None`` branches of ``repro/core/tagging.py``). The tagged sites, whose
backward captures the Kronecker factors, arrive with the training slice."""

from __future__ import annotations

import torch

_TAGGED = "tagged sites arrive with the training slice"


def dense_site(x: torch.Tensor, w: torch.Tensor, stats=None,
               spec=None) -> torch.Tensor:
    """y = x @ w with w (d_in, d_out)."""
    if stats is not None:
        raise NotImplementedError(_TAGGED)
    return torch.matmul(x, w)


def bias_site(x: torch.Tensor, b: torch.Tensor, stats=None) -> torch.Tensor:
    if stats is not None:
        raise NotImplementedError(_TAGGED)
    return x + b


def scale_bias_site(xhat: torch.Tensor, gamma: torch.Tensor,
                    beta: torch.Tensor | None, stats=None,
                    spatial: int = 0) -> torch.Tensor:
    if stats is not None:
        raise NotImplementedError(_TAGGED)
    y = xhat * gamma
    return y + beta if beta is not None else y


def embed_site(ids: torch.Tensor, table: torch.Tensor, stats=None,
               spec=None) -> torch.Tensor:
    if stats is not None:
        raise NotImplementedError(_TAGGED)
    return table[ids]
