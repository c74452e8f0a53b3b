"""Flight-recorder telemetry (counters, spans, events, histograms),
Chrome-trace and Prometheus export, mission reports, the exchange-count
oracles, and the route-provenance auditor (:func:`audit_window_programs`).
Stdlib and numpy only."""

from repro_torch.telemetry.audit import (
    AuditError,
    AuditReport,
    AuditViolation,
    PayloadTrail,
    audit_recorder,
    audit_window_programs,
    expected_sink_weights,
)
from repro_torch.telemetry.export import (
    chrome_trace,
    metrics_snapshot,
    prometheus_text,
    trace_scope,
    write_metrics,
    write_prometheus,
    write_trace,
)
from repro_torch.telemetry.metrics import (
    Histogram,
    get_gauge,
    get_histogram,
    histograms_summary,
    observe,
    ratio_gauge,
    set_gauge,
)
from repro_torch.telemetry.report import (
    mission_report,
    render_markdown,
    write_report,
)
from repro_torch.telemetry.reconcile import (
    expected_hierarchical_collectives,
    expected_tdm_collectives,
)
from repro_torch.telemetry.recorder import (
    Event,
    Recorder,
    Span,
    counters_snapshot,
    get_recorder,
    record_scope,
    set_reconcile,
    set_tracing,
    tracing_enabled,
)

__all__ = [
    "AuditError",
    "AuditReport",
    "AuditViolation",
    "Event",
    "Histogram",
    "PayloadTrail",
    "Recorder",
    "Span",
    "audit_recorder",
    "audit_window_programs",
    "chrome_trace",
    "counters_snapshot",
    "expected_hierarchical_collectives",
    "expected_sink_weights",
    "expected_tdm_collectives",
    "get_gauge",
    "get_histogram",
    "get_recorder",
    "histograms_summary",
    "metrics_snapshot",
    "mission_report",
    "observe",
    "prometheus_text",
    "ratio_gauge",
    "record_scope",
    "render_markdown",
    "set_gauge",
    "set_reconcile",
    "set_tracing",
    "trace_scope",
    "tracing_enabled",
    "write_metrics",
    "write_prometheus",
    "write_report",
    "write_trace",
]
