"""Argument checks, the launch stream, the SM count and the arrival
counters shared by the kernel wrappers (:mod:`.swa_attention`,
:mod:`.kfac`, :mod:`.newton_schulz`, :mod:`.quant`)."""

from __future__ import annotations

import functools

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


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


# (device index, stream handle) -> int32 counters, zero between launches
_COUNTERS: dict[tuple[int, int], torch.Tensor] = {}


def counters(t: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` int32 counters on ``t``'s device for one launch on its current
    stream: zero when the launch starts, and the kernels that take them
    (quant_rows' resident route, swa_flash_decode's merge) leave them zero,
    their last arrival clearing each. So they are zeroed once, when the
    buffer is made or grows, and no launch of a memset precedes a call.
    Launches on one stream run in order; each stream has its own buffer."""
    key = (t.device.index, stream(t))
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros((max(n, 4096),), dtype=torch.int32, device=t.device)
        _COUNTERS[key] = buf
    return buf
