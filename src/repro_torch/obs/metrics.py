"""Per-step JSONL metrics stream with a near-zero-cost disabled path
(counterpart of ``repro/obs/metrics.py``; the same schema, so
``experiments/make_report.py`` reads the stream of either package).

One :class:`MetricsLogger` owns all run-time telemetry output:

* the **JSONL event stream** (``--metrics-jsonl``): one JSON object per
  line, every event carrying ``{"v": schema version, "type": ..., "t_wall":
  unix time}``. Event types the trainer emits:

  - ``run_config`` -- once at start: arch, flags, parameter count
  - ``step``       -- per training step: loss, lr, refresh decisions,
                      grad/update norms, step-time EMA + p50/p99 over a
                      rolling window, the IntervalController's drained
                      byte-ledger deltas, Stage-4 inversion tallies. With
                      the chunked refresh pipeline (``--refresh-chunks``
                      K > 1) ``kind`` tells ``capture`` (refresh trigger,
                      no inline inversions) from ``refresh`` / ``fast``,
                      and ``refresh_inflight`` counts the steps until the
                      refresh in flight activates
  - ``span``       -- host-side phase timings (:class:`Span`); a pipeline
                      drain emits one ``spngd.pipeline.chunk[i]`` span per
                      chunk step (``[flip]`` for the activation step),
                      ``dur`` the whole step's wall time, ``stats`` the
                      statistics the chunk inverted
  - ``probe``      -- the overhead-accounting probe (stage-isolated
                      timings the report's decomposition table reads)
  - ``console``    -- a mirror of every console line
  - ``summary``    -- once at the end: the controller's flat counters

* the **console sink**: :meth:`console` prints exactly what the bare
  ``print()`` it replaces printed and mirrors the line into the stream.

Disabled (no path and no stream, the default), every emit method is one
attribute check and a return: no file is created, no event is built, and
call sites gate the device-to-host conversions a step event needs on
``logger.enabled``, so a disabled stream forces no device sync.

Losses are written by ``json.dumps`` of the Python float, whose repr
round-trips bit for bit.
"""

from __future__ import annotations

import collections
import json
import time
from typing import IO, Optional

import numpy as np
import torch

from repro_torch.obs.tracing import Span, SpanRecord

SCHEMA_VERSION = 1

_EMA_BETA = 0.9           # step-time EMA decay
_HIST_WINDOW = 256        # rolling window for p50/p99


class MetricsLogger:
    def __init__(self, path: Optional[str] = None,
                 stream: Optional[IO[str]] = None,
                 hist_window: int = _HIST_WINDOW):
        """``path`` opens (truncates) a JSONL file; ``stream`` writes to an
        existing file object, which the logger does not close; neither =
        disabled."""
        if path is not None and stream is not None:
            raise ValueError("pass path or stream, not both")
        self.path = path
        self._own = path is not None
        self._stream = open(path, "w") if path is not None else stream
        self.enabled = self._stream is not None
        self.events_written = 0
        self._dts = collections.deque(maxlen=hist_window)
        self._ema: Optional[float] = None

    # ---- lifecycle ----

    def close(self) -> None:
        if self._stream is not None and self._own:
            self._stream.close()
            self._stream = None
            self.enabled = False

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # ---- raw event emission ----

    def emit(self, type_: str, **fields) -> None:
        """Write one event line. One attribute check when disabled."""
        if not self.enabled:
            return
        evt = {"v": SCHEMA_VERSION, "type": type_, "t_wall": time.time()}
        evt.update(fields)
        self._stream.write(json.dumps(evt) + "\n")
        self._stream.flush()
        self.events_written += 1

    # ---- console sink ----

    def console(self, text: str = "", *, flush: bool = True) -> None:
        """Print ``text`` as the bare ``print()`` it replaces would have, and
        mirror it into the stream as a ``console`` event."""
        print(text, flush=flush)
        if self.enabled:
            self.emit("console", text=text)

    # ---- spans ----

    def span(self, name: str) -> Span:
        """A Span whose record lands in the stream (no sink when disabled,
        so the span costs two perf_counter calls and its range)."""
        return Span(name, sink=self._span_sink if self.enabled else None)

    def _span_sink(self, rec: SpanRecord) -> None:
        self.emit("span", name=rec.name, start=rec.start, dur=rec.dur,
                  depth=rec.depth, parent=rec.parent)

    # ---- the per-step event ----

    def log_step(self, step: int, *, loss: float, dt: Optional[float] = None,
                 **fields) -> None:
        """One ``step`` event. ``dt`` (seconds) feeds the rolling step-time
        EMA and p50/p99; the other keyword fields pass through as they
        are."""
        if not self.enabled:
            return
        evt = {"step": step, "loss": loss}
        if dt is not None:
            self._dts.append(dt)
            self._ema = (dt if self._ema is None
                         else _EMA_BETA * self._ema + (1 - _EMA_BETA) * dt)
            evt.update(dt=dt, dt_ema=self._ema, **self._quantiles())
        evt.update(fields)
        self.emit("step", **evt)

    def _quantiles(self) -> dict:
        srt = sorted(self._dts)
        n = len(srt)
        return {"dt_p50": srt[n // 2],
                "dt_p99": srt[min(n - 1, (99 * n) // 100)]}


# ---------------------------------------------------------------------------
# Stage-4 inversion tallies
# ---------------------------------------------------------------------------

def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def inverse_tally(inverse_info: dict, block_sizes: dict) -> dict:
    """Fold the per-block ``{"ns_res", "ns_converged"}`` of
    ``metrics["inverse_info"]`` (torch tensors or numpy arrays) into
    JSON-ready per-statistic counters, with a per-block-size rollup.

    ``ns_res < 0`` is the not-refreshed-this-step sentinel; those blocks
    are left out of the tallies. ``fallback_blocks`` counts the blocks that
    re-solved by eigh (residual above tolerance); for the direct methods
    the residual is 0, so there are none.
    """
    stats = {}
    by_b: dict = {}
    for name, info in inverse_info.items():
        res = _host(info["ns_res"]).astype(np.float64).reshape(-1)
        conv = _host(info["ns_converged"]).astype(bool).reshape(-1)
        refreshed = res >= 0.0
        n_ref = int(refreshed.sum())
        n_fb = int((~conv[refreshed]).sum()) if n_ref else 0
        b = int(block_sizes.get(name, 0))
        stats[name] = {
            "b": b,
            "blocks": int(res.size),
            "refreshed_blocks": n_ref,
            "fallback_blocks": n_fb,
            "max_res": float(res[refreshed].max()) if n_ref else 0.0,
        }
        if n_ref:
            agg = by_b.setdefault(b, {"refreshed_blocks": 0,
                                      "fallback_blocks": 0})
            agg["refreshed_blocks"] += n_ref
            agg["fallback_blocks"] += n_fb
    return {"stats": stats,
            "by_block_size": {str(b): v for b, v in sorted(by_b.items())}}
