"""repro_torch.obs -- telemetry: stage tracing and the metrics stream
(counterpart of ``repro.obs``, the same public names).

See :mod:`repro_torch.obs.tracing` for the span and range layer and
:mod:`repro_torch.obs.metrics` for the JSONL event stream, which
``experiments/make_report.py`` turns into the overhead decomposition.
"""

from repro_torch.obs.tracing import (
    STAGE_CAPTURE,
    STAGE_CHUNK,
    STAGE_GATHER,
    STAGE_INVERSE,
    STAGE_PRECOND,
    STAGE_REDUCE,
    ProfileCapture,
    Span,
    SpanRecord,
    kernel_scope,
    stage_scope,
)
from repro_torch.obs.metrics import (SCHEMA_VERSION, MetricsLogger,
                                     inverse_tally)

__all__ = [
    "STAGE_CAPTURE",
    "STAGE_CHUNK",
    "STAGE_GATHER",
    "STAGE_INVERSE",
    "STAGE_PRECOND",
    "STAGE_REDUCE",
    "ProfileCapture",
    "Span",
    "SpanRecord",
    "kernel_scope",
    "stage_scope",
    "SCHEMA_VERSION",
    "MetricsLogger",
    "inverse_tally",
]
