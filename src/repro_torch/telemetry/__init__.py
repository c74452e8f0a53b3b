"""Flight-recorder telemetry (counters, spans, events, histograms) and the
exchange-count oracle. Stdlib and numpy only."""

from repro_torch.telemetry.metrics import (
    get_gauge,
    get_histogram,
    histograms_summary,
    observe,
    ratio_gauge,
    set_gauge,
)
from repro_torch.telemetry.reconcile import expected_tdm_collectives
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
    "Event",
    "Recorder",
    "Span",
    "counters_snapshot",
    "expected_tdm_collectives",
    "get_gauge",
    "get_histogram",
    "get_recorder",
    "histograms_summary",
    "observe",
    "ratio_gauge",
    "record_scope",
    "set_gauge",
    "set_reconcile",
    "set_tracing",
    "tracing_enabled",
]
