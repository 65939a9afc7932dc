"""Shared building blocks: norms, rotary embeddings, initializers
(counterpart of ``repro/models/layers.py``)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import tagging


def he_normal(generator: torch.Generator, shape, dtype=torch.float32,
              fan_in: Optional[int] = None, device=None) -> torch.Tensor:
    """HeNormal: normal with std sqrt(2 / fan_in), drawn in f32."""
    fi = fan_in if fan_in is not None else shape[-2] if len(shape) >= 2 else shape[-1]
    std = (2.0 / fi) ** 0.5
    x = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=device or generator.device)
    return (x * std).to(dtype)


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, stats=None,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm; x-hat is cast to x's dtype before the gamma multiply."""
    xf = x.float()
    xhat = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    xhat = xhat.to(x.dtype)
    return tagging.scale_bias_site(xhat, gamma.to(x.dtype), None, stats)


def layernorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              stats=None, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    xhat = ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)
    return tagging.scale_bias_site(xhat, gamma.to(x.dtype), beta.to(x.dtype),
                                   stats)


def rope_freqs(head_dim: int, theta: float = 1e4,
               device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x (B, S, H, hd); positions (S,) or (B, S). Rotates INTERLEAVED pairs
    (x[..., ::2], x[..., 1::2]) with the angle in f32; the result is cast
    back to x's dtype."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)        # (hd/2,)
    ang = positions[..., None].float() * freqs            # (..., S, hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    if ang.dim() == 2:                                    # (S, hd/2)
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    else:                                                 # (B, S, hd/2)
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    x1, x2 = x[..., ::2].float(), x[..., 1::2].float()
    o1 = x1 * cos - x2 * sin
    o2 = x1 * sin + x2 * cos
    return torch.stack([o1, o2], dim=-1).reshape(x.shape).to(x.dtype)


def activation(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")   # jax.nn.gelu default
    if name == "relu2":                                  # squared ReLU
        return lambda x: torch.square(F.relu(x))
    if name == "relu":
        return F.relu
    raise ValueError(name)
