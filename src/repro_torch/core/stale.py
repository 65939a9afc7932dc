"""Stale statistics with adaptive refresh intervals (paper §4.3, Alg. 1-2);
the port's own copy of ``repro/core/stale.py``, whose controller is plain
Python. In the port the wire, per-level and gather columns of the ledger
stay zero until the comm slice fills them.

Host-side controller: per *statistic* (each factor family's "a", "g", "d",
"uw" array is one statistic X), track

    t_X       next step at which X must be refreshed
    delta     current acceptable interval
    delta_m1  previous interval

Algorithm 2, driven by Frobenius similarity measured on-device at refresh
time (``sim1 = ||X - X_-1||_F/||X_-1||_F``, ``sim2`` vs ``X_-2``). The
recurrence is over interval *generations* (§4.3): ``delta`` is the interval
that just elapsed, ``delta_m1`` (the paper's Δ₋₁) the one before it — the
last interval that was validated before the current (tentative) growth step:

    if   sim1 >= alpha:  delta <- max(1, floor(delta_m1 / 2))   # shrink
    elif sim2 >= alpha:  delta <- delta_m1                      # fall back
    else:                delta <- delta + delta_m1              # Fibonacci grow

Shrink/fall-back restart from Δ₋₁ (the just-elapsed Δ was too aggressive);
growth extends the streak, giving the Fibonacci sequence 1, 1, 2, 3, 5, …
when X keeps drifting slowly.

The device side stores X_-1 / X_-2 inside the optimizer state and evaluates
the two distances only on refresh steps (inside the optimizer's refresh); the
controller consumes them after the step and schedules the next refresh.

The controller also keeps the byte/flop ledger used by the paper's Table 2 /
Fig. 6 communication-reduction benchmark.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class StatState:
    t_next: int = 1          # Algorithm 1: t_X <- 1 initially
    delta: int = 1
    delta_m1: int = 1
    bytes_per_refresh: int = 0   # symmetric-packed storage payload
    wire_bytes_per_refresh: int = 0  # Stage-3 collective payload (the
                                     # actual wire dtype; repro.comm)
    # per-level split of the wire payload under the hierarchical ("hier")
    # strategy: intra-host full-precision scatter vs inter-host fp8 ring.
    # Both stay 0 under flat strategies (the split is then meaningless).
    wire_intra_bytes_per_refresh: int = 0
    wire_inter_bytes_per_refresh: int = 0
    # Stage-4 return leg under sharded inversion: the preconditioner
    # all-gather (sym-packed f32; repro.comm.gather_stat_bytes). 0 for
    # replicated inversion and for statistics that never shard.
    gather_bytes_per_refresh: int = 0
    refresh_count: int = 0


class IntervalController:
    """Implements Algorithm 1's bookkeeping + Algorithm 2's interval rule."""

    def __init__(self, stat_names: list[str], alpha: float = 0.1,
                 max_interval: int = 0, min_interval: int = 1,
                 bytes_per_stat: Optional[dict[str, int]] = None,
                 wire_bytes_per_stat: Optional[dict[str, int]] = None,
                 wire_level_bytes_per_stat: Optional[dict] = None,
                 gather_bytes_per_stat: Optional[dict[str, int]] = None):
        self.alpha = alpha
        self.max_interval = max_interval          # 0 = unbounded (paper)
        # Floor on Algorithm 2's shrink: with the chunked refresh pipeline
        # (repro.core.pipeline) a refresh stays in flight for K chunk steps
        # plus the activation step after its capture, so the controller must
        # not schedule the next capture before the drain completes —
        # train.py passes refresh_chunks + 1. The default (1) is the paper's
        # unconstrained rule and leaves the Fibonacci recurrence untouched.
        self.min_interval = max(1, min_interval)
        self.stats = {n: StatState() for n in stat_names}
        if bytes_per_stat:
            for n, b in bytes_per_stat.items():
                self.stats[n].bytes_per_refresh = b
        if wire_bytes_per_stat:
            for n, b in wire_bytes_per_stat.items():
                self.stats[n].wire_bytes_per_refresh = b
        if wire_level_bytes_per_stat:
            # {name: (intra, inter)} — FactorReducer.wire_bytes_per_stat_levels
            for n, (intra, inter) in wire_level_bytes_per_stat.items():
                self.stats[n].wire_intra_bytes_per_refresh = intra
                self.stats[n].wire_inter_bytes_per_refresh = inter
        if gather_bytes_per_stat:
            # Stage-4 preconditioner gather under sharded inversion —
            # FactorReducer.gather_bytes_per_stat / SPNGD.gather_bytes
            for n, b in gather_bytes_per_stat.items():
                self.stats[n].gather_bytes_per_refresh = b
        self.total_bytes = 0
        self.dense_bytes = 0                      # what refresh-every-step would cost
        self.total_wire_bytes = 0
        self.dense_wire_bytes = 0
        self.total_wire_intra_bytes = 0
        self.dense_wire_intra_bytes = 0
        self.total_wire_inter_bytes = 0
        self.dense_wire_inter_bytes = 0
        self.total_gather_bytes = 0
        self.dense_gather_bytes = 0
        self.comm_info: dict = {}                 # reducer tally (record_comm)
        self.steps = 0
        # drain() snapshot: cumulative counter values already handed out, so
        # per-step JSONL deltas sum back to the totals exactly
        self._drained: dict[str, float] = {}

    def flags(self, t: int) -> dict[str, bool]:
        """Which statistics must refresh at step t (Algorithm 1's t == t_X)."""
        return {n: t >= s.t_next for n, s in self.stats.items()}

    def update(self, t: int, flags: dict[str, bool],
               sims: dict[str, tuple[float, float]]) -> None:
        """Feed back measured similarities after the step ran.

        sims[name] = (dist_to_prev, dist_to_prev2); entries for statistics
        that did not refresh are ignored.
        """
        self.steps += 1
        for name, st in self.stats.items():
            self.dense_bytes += st.bytes_per_refresh
            self.dense_wire_bytes += st.wire_bytes_per_refresh
            self.dense_wire_intra_bytes += st.wire_intra_bytes_per_refresh
            self.dense_wire_inter_bytes += st.wire_inter_bytes_per_refresh
            self.dense_gather_bytes += st.gather_bytes_per_refresh
            if not flags.get(name, False):
                continue
            d1, d2 = sims[name]
            # Algorithm 2: shrink/fall-back compute from the PREVIOUS
            # interval Δ₋₁ (st.delta_m1), not the just-elapsed st.delta —
            # growth is tentative until the similarity check validates it
            if d1 >= self.alpha:
                delta = max(1, st.delta_m1 // 2)
            elif d2 >= self.alpha:
                delta = st.delta_m1
            else:
                delta = st.delta + st.delta_m1
            delta = max(delta, self.min_interval)
            if self.max_interval:
                delta = min(delta, self.max_interval)
            st.delta_m1 = st.delta
            st.delta = delta
            st.t_next = t + delta
            st.refresh_count += 1
            self.total_bytes += st.bytes_per_refresh
            self.total_wire_bytes += st.wire_bytes_per_refresh
            self.total_wire_intra_bytes += st.wire_intra_bytes_per_refresh
            self.total_wire_inter_bytes += st.wire_inter_bytes_per_refresh
            self.total_gather_bytes += st.gather_bytes_per_refresh

    # ---- Stage-3 comm bookkeeping (repro.comm reducer tally) ----

    def record_comm(self, info: dict) -> None:
        """Attach the reducer's scatter report (strategy, wire dtype,
        replication-fallback tally — ``FactorReducer.scatter_report()``) so
        :meth:`summary` surfaces which statistics never scattered."""
        self.comm_info.update(info)

    # ---- checkpoint continuity (Algorithm 1's intervals assume it) ----

    def state_dict(self) -> dict:
        """JSON-serializable controller state for checkpointing."""
        return {
            "alpha": self.alpha,
            "max_interval": self.max_interval,
            "min_interval": self.min_interval,
            "steps": self.steps,
            "total_bytes": self.total_bytes,
            "dense_bytes": self.dense_bytes,
            "total_wire_bytes": self.total_wire_bytes,
            "dense_wire_bytes": self.dense_wire_bytes,
            "total_wire_intra_bytes": self.total_wire_intra_bytes,
            "dense_wire_intra_bytes": self.dense_wire_intra_bytes,
            "total_wire_inter_bytes": self.total_wire_inter_bytes,
            "dense_wire_inter_bytes": self.dense_wire_inter_bytes,
            "total_gather_bytes": self.total_gather_bytes,
            "dense_gather_bytes": self.dense_gather_bytes,
            "comm_info": dict(self.comm_info),
            "drained": dict(self._drained),
            "stats": {n: dataclasses.asdict(s) for n, s in self.stats.items()},
        }

    @classmethod
    def from_state_dict(cls, state: dict) -> "IntervalController":
        # pre-PR-10 checkpoints have no pipeline floor: resume unconstrained
        ctrl = cls(list(state["stats"]), alpha=state["alpha"],
                   max_interval=state["max_interval"],
                   min_interval=state.get("min_interval", 1))
        ctrl.steps = state["steps"]
        ctrl.total_bytes = state["total_bytes"]
        ctrl.dense_bytes = state["dense_bytes"]
        # pre-PR-5 checkpoints have no wire ledger: resume at zero
        ctrl.total_wire_bytes = state.get("total_wire_bytes", 0)
        ctrl.dense_wire_bytes = state.get("dense_wire_bytes", 0)
        # pre-PR-6 checkpoints have no per-level (hier) ledger: resume at 0
        ctrl.total_wire_intra_bytes = state.get("total_wire_intra_bytes", 0)
        ctrl.dense_wire_intra_bytes = state.get("dense_wire_intra_bytes", 0)
        ctrl.total_wire_inter_bytes = state.get("total_wire_inter_bytes", 0)
        ctrl.dense_wire_inter_bytes = state.get("dense_wire_inter_bytes", 0)
        # pre-PR-7 checkpoints have no Stage-4 gather ledger: resume at zero
        ctrl.total_gather_bytes = state.get("total_gather_bytes", 0)
        ctrl.dense_gather_bytes = state.get("dense_gather_bytes", 0)
        ctrl.comm_info = dict(state.get("comm_info", {}))
        # pre-PR-8 checkpoints have no drain snapshot: next drain() re-emits
        # everything accumulated so far, which keeps the sum-of-drains ==
        # totals invariant across the resume
        ctrl._drained = dict(state.get("drained", {}))
        for n, s in state["stats"].items():
            ctrl.stats[n] = StatState(**s)
        return ctrl

    # ---- reporting (paper Table 2 "reduction", Fig. 6) ----

    def reduction_rate(self) -> float:
        """Communicated bytes as a fraction of refresh-every-step bytes."""
        if self.dense_bytes == 0:
            return 1.0
        return self.total_bytes / self.dense_bytes

    def summary(self) -> dict:
        wire_rate = (self.total_wire_bytes / self.dense_wire_bytes
                     if self.dense_wire_bytes else 1.0)
        return {
            "steps": self.steps,
            "total_stat_bytes": self.total_bytes,
            "dense_stat_bytes": self.dense_bytes,
            "reduction_rate": self.reduction_rate(),
            "comm": {
                "total_wire_bytes": self.total_wire_bytes,
                "dense_wire_bytes": self.dense_wire_bytes,
                "wire_reduction_rate": wire_rate,
                # hier per-level split; identically 0 under flat strategies
                "total_wire_intra_bytes": self.total_wire_intra_bytes,
                "dense_wire_intra_bytes": self.dense_wire_intra_bytes,
                "total_wire_inter_bytes": self.total_wire_inter_bytes,
                "dense_wire_inter_bytes": self.dense_wire_inter_bytes,
                # Stage-4 preconditioner gather (sharded inversion);
                # identically 0 under replicated Stage-4
                "total_gather_bytes": self.total_gather_bytes,
                "dense_gather_bytes": self.dense_gather_bytes,
                **self.comm_info,
            },
            "per_stat": {n: dataclasses.asdict(s) for n, s in self.stats.items()},
        }

    # ---- flat / streaming views (JSONL emission; repro.obs) ----

    def counters(self) -> dict[str, int]:
        """The cumulative integer counters, flat. Every value in
        :meth:`summary` that monotonically accumulates appears here under
        its summary name (per-level comm totals included), plus the derived
        ``refresh_events`` (sum of per-stat refresh counts)."""
        return {
            "steps": self.steps,
            "total_stat_bytes": self.total_bytes,
            "dense_stat_bytes": self.dense_bytes,
            "total_wire_bytes": self.total_wire_bytes,
            "dense_wire_bytes": self.dense_wire_bytes,
            "total_wire_intra_bytes": self.total_wire_intra_bytes,
            "dense_wire_intra_bytes": self.dense_wire_intra_bytes,
            "total_wire_inter_bytes": self.total_wire_inter_bytes,
            "dense_wire_inter_bytes": self.dense_wire_inter_bytes,
            "total_gather_bytes": self.total_gather_bytes,
            "dense_gather_bytes": self.dense_gather_bytes,
            "refresh_events": sum(s.refresh_count for s in self.stats.values()),
        }

    def summary_flat(self) -> dict:
        """:meth:`summary` flattened to one ``dict[str, int | float]`` for
        direct JSONL emission: the counters, both reduction rates, and any
        numeric reducer-tally entries. No nested values."""
        flat: dict = dict(self.counters())
        flat["reduction_rate"] = self.reduction_rate()
        flat["wire_reduction_rate"] = (
            self.total_wire_bytes / self.dense_wire_bytes
            if self.dense_wire_bytes else 1.0)
        for k, v in self.comm_info.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                flat[f"comm_{k}"] = v
        return flat

    def drain(self) -> dict[str, int]:
        """Deltas of :meth:`counters` since the previous drain. Summing every
        drained dict over a run reproduces the cumulative counters exactly —
        the per-step JSONL events are a lossless decomposition of the ledger
        (pinned by tests/test_obs.py)."""
        cur = self.counters()
        out = {k: v - self._drained.get(k, 0) for k, v in cur.items()}
        self._drained = cur
        return out


def sym_packed_bytes(shape: tuple, dtype_bytes: int = 4) -> int:
    """Bytes for one symmetric-packed factor array (paper §5.2): the last two
    axes (b, b) cost b(b+1)/2 each; leading axes multiply. Fixed element
    size."""
    if len(shape) >= 2 and shape[-1] == shape[-2]:
        b = shape[-1]
        lead = 1
        for s in shape[:-2]:
            lead *= s
        return lead * (b * (b + 1) // 2) * dtype_bytes
    n = 1
    for s in shape:
        n *= s
    return n * dtype_bytes


def stat_payload_bytes(shape: tuple, factor_dtype=torch.float32,
                       symmetric: Optional[bool] = None) -> int:
    """Sym-packed payload bytes for one statistic under its storage dtype:
    dense f32 / bf16 elements, or the fp8 payload + per-block f32 scales
    (``factor_dtype`` "fp8_e4m3" | "fp8_e5m2"; :mod:`repro_torch.quant`).
    ``symmetric=False`` forces the non-packed (row-quantized) accounting for
    square-shaped stats that are not symmetric factors."""
    from repro_torch.quant import quant
    fmt = quant.parse_factor_dtype(factor_dtype)
    if symmetric is None:
        symmetric = len(shape) >= 2 and shape[-1] == shape[-2]
    if fmt is not None:
        return quant.encoded_nbytes(shape, symmetric=symmetric)
    dtype_bytes = torch.empty((), dtype=factor_dtype).element_size()
    if not symmetric:
        n = 1
        for s in shape:
            n *= s
        return n * dtype_bytes
    return sym_packed_bytes(shape, dtype_bytes)
