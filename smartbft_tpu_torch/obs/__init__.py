"""Flight recorder, view-change decomposition, SLOs and health.

A bounded-memory :class:`~smartbft_tpu_torch.obs.recorder.TraceRecorder`
of structured span events (injectable clock, nop when disabled — the
``DisabledProvider`` pattern, so the hot path pays one attribute check
when tracing is off), a :class:`~smartbft_tpu_torch.obs.vcphases.
ViewChangePhaseTracker` that decomposes the complain → depose → ViewData
→ new-view → first-commit pipeline into measured sub-phases, the
per-request critical path (:mod:`.critpath`), the multi-window SLO
evaluator (:mod:`.slo`) and the health monitor over it (:mod:`.health`),
the pure ``assemble_*`` helpers that fold them into bench-row JSON
blocks, the trace report (``python -m smartbft_tpu_torch.obs.report``),
the versioned bench-row schema (:mod:`.benchschema`) and the baseline
guard over it (``python -m smartbft_tpu_torch.obs.baseline pin|check``).
"""

from .critpath import (  # noqa: F401
    SEGMENTS,
    assemble_critical_path_block,
)
from .health import (  # noqa: F401
    HealthMonitor,
    aggregate_cluster_verdict,
)
from .recorder import (  # noqa: F401
    NOP_RECORDER,
    NopRecorder,
    SpanEvent,
    TraceRecorder,
    assemble_trace_block,
)
from .slo import (  # noqa: F401
    SLOEvaluator,
    SLORule,
    SLOSpec,
    default_slo_spec,
)
from .vcphases import (  # noqa: F401
    ViewChangePhaseTracker,
    assemble_viewchange_block,
)

__all__ = [
    "NOP_RECORDER",
    "NopRecorder",
    "SEGMENTS",
    "SpanEvent",
    "TraceRecorder",
    "assemble_critical_path_block",
    "assemble_trace_block",
    "ViewChangePhaseTracker",
    "assemble_viewchange_block",
    "HealthMonitor",
    "aggregate_cluster_verdict",
    "SLOEvaluator",
    "SLORule",
    "SLOSpec",
    "default_slo_spec",
]
