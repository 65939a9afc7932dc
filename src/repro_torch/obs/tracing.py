"""Stage-level tracing: host-side spans and profiler ranges (counterpart of
``repro/obs/tracing.py``).

The paper's negligible-overhead claim (section 5.2) is a time-accounting
claim: Stage-2 statistics construction, the Stage-3 reduce and the Stage-4
inversions must stay small next to the forward/backward. This module gives
every SP-NGD stage the name it has in ``repro``'s traces:

* :class:`Span` -- a host-side phase timer (``time.perf_counter``) that also
  opens a ``torch.profiler.record_function`` range, so the same phase shows
  up in a captured trace. Spans nest; each records its depth and parent,
  which is what the metrics stream's ``span`` events carry.
* :func:`stage_scope` -- a ``record_function`` range under a ``STAGE_*``
  name around eager code. Unlike ``repro``'s ``jax.named_scope`` (trace-time
  metadata) it is a runtime call, so it opens the range only while a
  profiler records (``torch.profiler``, ``emit_nvtx``), as torch's own
  ``_RecordFunctionFast`` does: a ``record_function`` nobody records still
  costs about 10 us of host time, ~1 % of a fast step's wall over its ~290
  ranges on an H100 (PERF.md). Its kernels are those LAUNCHED inside its host
  window: backward kernels are launched on autograd's worker thread,
  outside the range's subtree in ``prof.key_averages()``, but inside its
  window.
* :func:`kernel_scope` -- the range the kernel dispatch opens around every
  op call, ``repro.kernels.<op>[<backend>]`` with the backend ``ref`` or
  ``cuda``, so an A/B of the two lines up by name.
* :func:`scan_scope` -- the range around a recurrent scan's forward (the
  WKV and SSM loops of torch ops), ``repro.scan.<name>``: the loop has no
  kernel, so no dispatch range holds its launches. Its backward runs on
  autograd's thread after the range has closed.
* :class:`ProfileCapture` -- the opt-in ``--profile-dir`` window: a
  ``torch.profiler`` trace of the first N steps, written as Chrome-trace
  JSON.

Under ``torch.autograd.profiler.emit_nvtx()`` every range here is also an
NVTX range.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable, Optional

import torch

# Canonical names of the SP-NGD stages, letter for letter ``repro``'s.
# Stage 1-2 (forward/backward + statistics capture) is one range: capture
# rides the backward, and the fast (no-capture) step never opens it.
STAGE_CAPTURE = "spngd.stage2.capture"     # grads + raw factor sums
STAGE_REDUCE = "spngd.stage3.reduce"       # factor reduce-scatter
STAGE_INVERSE = "spngd.stage4.inverse"     # damped factor inversion
STAGE_GATHER = "spngd.stage4.gather"       # preconditioner all-gather
STAGE_PRECOND = "spngd.stage4.precond"     # A^-1 dW G^-1 apply
# Chunked refresh pipeline (repro_torch.core.pipeline): one drain chunk
# inside a fast step; a sharded chunk's STAGE_INVERSE / STAGE_GATHER nest
# under it.
STAGE_CHUNK = "spngd.pipeline.chunk"       # drain chunk inside a fast step


def stage_scope(name: str):
    """A profiler range under a canonical stage name, while a profiler
    records (else a null context)."""
    if not torch.autograd._profiler_enabled():
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


def kernel_scope(op: str, which: str):
    """The range of one dispatched op call, ``repro.kernels.<op>[<backend>]``,
    while a profiler records (else a null context)."""
    if not torch.autograd._profiler_enabled():
        return contextlib.nullcontext()
    return torch.profiler.record_function(f"repro.kernels.{op}[{which}]")


def scan_scope(name: str):
    """The range of one recurrent scan's forward, ``repro.scan.<name>``,
    while a profiler records (else a null context)."""
    if not torch.autograd._profiler_enabled():
        return contextlib.nullcontext()
    return torch.profiler.record_function(f"repro.scan.{name}")


@dataclasses.dataclass
class SpanRecord:
    """One finished span, as emitted to a sink (the metrics stream)."""
    name: str
    start: float          # perf_counter seconds (monotonic, process epoch)
    dur: float            # seconds
    depth: int            # nesting depth at entry (0 = top level)
    parent: Optional[str]  # enclosing span's name, None at top level


# Host-side span stack. The training loop runs on one thread, so a
# module-level stack is enough.
_ACTIVE: list["Span"] = []


class Span:
    """Host-side phase timer, nestable, with a profiler range.

    ``sink`` (a ``SpanRecord -> None`` callable, e.g.
    ``MetricsLogger._span_sink``) receives the record at exit; without a
    sink the span still times itself (``.dur``). The ``record_function``
    range makes the phase visible in ``--profile-dir`` captures; pass
    ``annotate=False`` to skip it.
    """

    def __init__(self, name: str,
                 sink: Optional[Callable[[SpanRecord], None]] = None,
                 annotate: bool = True):
        self.name = name
        self.sink = sink
        self.start = 0.0
        self.dur = 0.0
        self.depth = 0
        self.parent: Optional[str] = None
        self._ann = (torch.profiler.record_function(name) if annotate
                     else None)

    def __enter__(self) -> "Span":
        self.depth = len(_ACTIVE)
        self.parent = _ACTIVE[-1].name if _ACTIVE else None
        _ACTIVE.append(self)
        if self._ann is not None:
            self._ann.__enter__()
        self.start = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.dur = time.perf_counter() - self.start
        if self._ann is not None:
            self._ann.__exit__(exc_type, exc, tb)
        _ACTIVE.pop()
        if self.sink is not None:
            self.sink(SpanRecord(self.name, self.start, self.dur,
                                 self.depth, self.parent))
        return False


class ProfileCapture:
    """Opt-in ``torch.profiler`` trace of the first N steps (--profile-dir).

    The loop calls :meth:`step_start` at the top of every iteration and
    :meth:`step_end` once the step's outputs are synchronized; the capture
    spans steps 1..N, stops itself and writes ``trace_dir/trace.json``
    (Chrome-trace JSON). CPU activity always, CUDA activity when ``device``
    is the card. Inert when ``trace_dir`` is None, so call sites need no
    conditionals. :meth:`stop` is the end-of-run safety net for runs
    shorter than the window.
    """

    def __init__(self, trace_dir: Optional[str], steps: int = 3,
                 device=None):
        self.trace_dir = trace_dir
        self.steps = max(1, steps)
        self.path = (os.path.join(trace_dir, "trace.json")
                     if trace_dir is not None else None)
        self._cuda = device is not None and torch.device(device).type == "cuda"
        self._prof = None
        self._seen = 0
        self.done = trace_dir is None

    def step_start(self, t: int) -> None:
        if self.done or self._prof is not None:
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self._cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()

    def step_end(self, t: int) -> None:
        if self._prof is None:
            return
        self._seen += 1
        if self._seen >= self.steps:
            self.stop()

    def stop(self) -> None:
        if self._prof is not None:
            self._prof.stop()
            os.makedirs(self.trace_dir, exist_ok=True)
            self._prof.export_chrome_trace(self.path)
            self._prof = None
        self.done = True
