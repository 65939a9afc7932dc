"""Stage-4 distribution: shard-local inversion and the preconditioner
gather (counterpart of ``repro/comm/stage4.py``).

After Stage 3 every rank holds a disjoint chunk of each factor family's
leading (layer) axis; under sharded Stage 4 it inverts only that chunk and
the preconditioners come back by one all-gather, so each rank's inversion
work drops to ~1/p.

* **Ownership is the reducer's chunk assignment.** Group index ``i`` over
  ``FactorReducer.scatter_axes`` inverts contiguous chunk ``i`` of the
  leading dim, whatever the Stage-3 strategy.
* **The gather is** ``FactorReducer.gather_stat``: sym-packed f32
  triangles, never quantized.
* **Observability** rides ``return_info``: the gathered per-block
  ``ns_res`` / ``ns_converged`` and an ``owner`` vector naming the group
  index that inverted each leading chunk (-1 everywhere on the replicated
  fallback).

The optimizer hands :meth:`Stage4Inverter.invert` the full statistic (the
port's dist step assembles the reduced statistics first, as ``repro``'s
shard_map ``out_specs`` do); the inverter takes this rank's chunk of it. A
statistic whose leading dim cannot scatter, or a group of one, falls back to
the replicated inverse. The chunked refresh pipeline's drain chunks call
it too, each for its own statistics.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.comm.comm import FactorReducer, all_gather
from repro_torch.obs import tracing


def _batch_damp(damp, stat_ndim: int) -> torch.Tensor:
    """Right-pad ``damp`` with singleton dims until it aligns with the
    stat's batch dims ``stat.shape[:-2]`` (leading-aligned)."""
    d = torch.as_tensor(damp, dtype=torch.float32)
    while d.dim() < stat_ndim - 2:
        d = d[..., None]
    return d


class Stage4Inverter:
    """Shard-local damped inversion over a :class:`FactorReducer` layout.
    The step builder attaches one through ``SPNGD.set_stage4`` when
    ``NGDConfig.inverse_sharding`` is on."""

    def __init__(self, reducer: FactorReducer, *, method: str = "eigh",
                 backend: str = "auto"):
        self.reducer = reducer
        self.method = method
        self.backend = backend

    def owners(self, dim0: int) -> np.ndarray:
        """Expected chunk owner (group index) per leading index, or -1
        everywhere when ``dim0`` cannot scatter (replicated inversion)."""
        axes = self.reducer.scatter_axes(dim0)
        p = self.reducer.group_size(axes) if axes else 1
        if not axes or p <= 1:
            return np.full((dim0,), -1, np.int32)
        return np.repeat(np.arange(p, dtype=np.int32), dim0 // p)

    def _inverse(self, stat, damp):
        from repro_torch.kernels import dispatch
        return dispatch.damped_inverse(
            stat, _batch_damp(damp, stat.dim()).to(stat.device),
            method=self.method, backend=self.backend, return_info=True)

    def invert(self, stat: torch.Tensor, damp, *, fam: str, key: str,
               return_info: bool = False):
        """Damped inverse of a full-kind blocked factor ``stat``
        ((lead..., nb, b, b)): this rank inverts its chunk of the leading
        dim, then the preconditioner all-gathers. Numerically the
        replicated inverse: sharding only partitions the block batch. Runs
        in the range ``spngd.stage4.inverse[sharded:<fam>.<key>]``, or
        ``[replicated:...]`` on the fallback."""
        reducer = self.reducer
        axes = reducer.scatter_axes(stat.shape[0]) if stat.dim() >= 3 else ()
        if not axes or reducer.group_size(axes) <= 1:
            with tracing.stage_scope(
                    f"{tracing.STAGE_INVERSE}[replicated:{fam}.{key}]"):
                inv, info = self._inverse(stat, damp)
            if not return_info:
                return inv
            info = dict(info, owner=torch.full(
                stat.shape[:1], -1, dtype=torch.int32, device=stat.device))
            return inv, info
        with tracing.stage_scope(
                f"{tracing.STAGE_INVERSE}[sharded:{fam}.{key}]"):
            g = reducer.group(axes)
            c = stat.shape[0] // g.size
            rows = slice(g.index * c, (g.index + 1) * c)
            damp = torch.as_tensor(damp, dtype=torch.float32)
            if damp.dim() >= 1 and damp.shape[0] == stat.shape[0]:
                damp = damp[rows]
            inv, info = self._inverse(stat[rows], damp)
            inv = reducer.gather_stat(fam, key, inv, axes)
            if not return_info:
                return inv
            gathered = {k: all_gather(v, g) for k, v in info.items()}
            gathered["owner"] = all_gather(
                torch.full((c,), g.index, dtype=torch.int32,
                           device=stat.device), g)
            return inv, gathered
