"""Roofline terms of a step at H100 rates (counterpart of
``repro/launch/roofline.py``).

Three terms per (arch x shape x mesh), all in seconds:

    compute    = FLOPs / (chips * PEAK_FLOPS)
    memory     = HBM bytes / (chips * HBM_BW)
    collective = collective bytes / (chips * LINK_BW)

The rates are an NVIDIA H100 SXM's, from its data sheet (NVIDIA H100 80GB
HBM3, 700 W): 989 TFLOP/s dense bf16, 3.35 TB/s of HBM3, and 450 GB/s a
direction of NVLink 4. ``chip_smoke.py`` reads its peak rates from here.

``repro`` counts a step by parsing XLA's optimized HLO (``analyze_hlo``:
``_parse_computations``, while bodies weighted by their trip counts, and
``Compiled.cost_analysis``); none of that has a PyTorch meaning. Here
:func:`count_step` runs the step once on meta tensors under a
``TorchDispatchMode``:

* FLOPs from ``torch.utils.flop_counter``'s per-op formulas (matmuls,
  convolutions, attention): what ``repro``'s analyzer counts as dots;
* HBM bytes as every op's input and output bytes, views excluded. Nothing
  is fused in eager PyTorch, so this is an upper bound on the traffic of
  one run of the step, not what a fused program moves;
* peak live bytes beyond the arguments: each op output's storage counted
  from its creation until it is freed.

On meta tensors the kernel dispatch resolves to the plain versions
(``kernels/dispatch.py``), so the count is of the plain math, as
``repro``'s dry run counts its ``ref`` route off a TPU.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Optional

import torch

# NVIDIA H100 80GB HBM3, 700 W (data sheet)
PEAK_FLOPS = 989e12          # dense bf16 per card
HBM_BW = 3.35e12             # bytes/s per card, HBM3
LINK_BW = 450e9              # bytes/s a direction per card, NVLink 4

# NVIDIA H100 80GB HBM3, 700 W (data sheet): dense, without sparsity
PEAK_OPS_PER_S = {
    "bfloat16": PEAK_FLOPS, "float16": PEAK_FLOPS, "float32": 67e12,
    "float8_e4m3fn": 1979e12, "float8_e5m2": 1979e12,
}
# f32-accurate products on the tensor cores: each f32 operand split in two
# TF32 parts and three TF32 products (hi hi, hi lo, lo hi) per product at
# 495 TFLOP/s dense TF32 (NVIDIA H100 80GB HBM3, 700 W, data sheet), so 495
# / 3 = 165 TFLOP/s of f32 work
PEAK_SPLIT_F32_OPS_PER_S = 495e12 / 3


def roofline_terms(flops: float, hbm_bytes: float, coll_bytes: float,
                   n_chips: int) -> dict:
    compute = flops / (n_chips * PEAK_FLOPS)
    memory = hbm_bytes / (n_chips * HBM_BW)
    collective = coll_bytes / (n_chips * LINK_BW)
    terms = {"compute_s": compute, "memory_s": memory,
             "collective_s": collective}
    dom = max(terms, key=terms.get)
    terms["bottleneck"] = dom.replace("_s", "")
    return terms


def model_flops_train(n_params_active: float, n_tokens: float) -> float:
    """6*N*D rule (fwd 2ND + bwd 4ND)."""
    return 6.0 * n_params_active * n_tokens


def model_flops_decode(n_params_active: float, n_tokens: float) -> float:
    """2*N per generated token (one forward)."""
    return 2.0 * n_params_active * n_tokens


# ---------------------------------------------------------------------------
# counting one run of a step
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StepCount:
    flops: float            # flop_counter's formulas
    hbm_bytes: float        # every non-view op's inputs + outputs
    peak_live_bytes: Optional[int]  # most bytes of storages the step made
    ops: int                # aten ops dispatched


_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "detach", "lift_fresh", "alias"}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def count_step(fn, *args, **kwargs) -> tuple[StepCount, object]:
    """Run ``fn(*args, **kwargs)`` once (meta tensors: nothing is
    allocated) and count it: (:class:`StepCount`, fn's result)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import FlopCounterMode

    known = {t.untyped_storage()._cdata for t in _tensors((args, kwargs))}
    live = {"now": 0, "peak": 0}

    def freed(n, key):
        live["now"] -= n
        known.discard(key)             # the address may be reused

    class _Bytes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.hbm, self.ops = 0, 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            self.ops += 1
            name = func.overloadpacket.__name__
            if not func.is_view and name not in _NO_TRAFFIC:
                self.hbm += sum(_nbytes(t) for t in _tensors((args, kwargs)))
                self.hbm += sum(_nbytes(t) for t in _tensors(out))
            for t in _tensors(out):
                st = t.untyped_storage()
                if st._cdata in known:
                    continue
                known.add(st._cdata)
                n = st.nbytes()
                live["now"] += n
                live["peak"] = max(live["peak"], live["now"])
                weakref.finalize(st, freed, n, st._cdata)
            return out

    with FlopCounterMode(display=False) as flops, _Bytes() as mode:
        result = fn(*args, **kwargs)
    return StepCount(float(flops.get_total_flops()), float(mode.hbm),
                     int(live["peak"]), mode.ops), result
