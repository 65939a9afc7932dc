"""Argument checks and the launch stream shared by the kernel wrappers
(:mod:`.swa_attention`, :mod:`.kfac`, :mod:`.newton_schulz`, :mod:`.quant`)."""

from __future__ import annotations

import torch


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def on_card(name: str, *ts: torch.Tensor) -> None:
    """Every tensor on one CUDA device: a wrapper never takes a CPU tensor
    (the plain versions are chosen by :mod:`repro_torch.kernels.dispatch`)."""
    for t in ts:
        require(t.is_cuda, f"{name} runs on CUDA tensors only (got one on "
                           f"{t.device}); CPU tensors take the plain version "
                           "through repro_torch.kernels.dispatch")
        require(t.device == ts[0].device,
                f"{name}: tensors on different devices")


def stream(t: torch.Tensor) -> int:
    """The current stream of ``t``'s device, as the handle the C entry
    points take."""
    return torch.cuda.current_stream(t.device).cuda_stream
