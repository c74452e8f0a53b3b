"""Trace + metrics export for the flight recorder.

Two artifact kinds:

- :func:`chrome_trace` / :func:`write_trace` — the Chrome Trace Event
  JSON object format (the ``{"traceEvents": [...]}`` shape), loadable in
  Perfetto (https://ui.perfetto.dev) and ``chrome://tracing``. Spans
  become ``"X"`` complete events, instant events become ``"i"``, and the
  final counter values ride in ``otherData`` plus one ``"C"`` counter
  sample per counter so they show up in the UI's counter track.
- :func:`metrics_snapshot` / :func:`write_metrics` — a flat JSON dict of
  counters, gauges, histogram percentile summaries, and per-span-name
  timing aggregates, the machine-readable summary the benchmark harness
  embeds in its ``BENCH_<name>.json`` files.
- :func:`prometheus_text` / :func:`write_prometheus` — the same metrics
  in Prometheus-style text exposition (counters/gauges as single samples,
  histograms as cumulative ``_bucket{le=...}`` series plus ``_sum`` /
  ``_count``), so a run snapshot can be pushed at a scrape endpoint or
  diffed with standard tooling.

The exported event list is sorted by timestamp; ``tests/test_telemetry.py``
checks the schema (valid JSON, required keys, monotonic non-negative
timestamps) so traces stay loadable as instrumentation grows.
"""

from __future__ import annotations

import contextlib
import json
import pathlib
from typing import Any, Dict, Iterator, List, Optional

from repro_torch.telemetry.metrics import histograms_summary
from repro_torch.telemetry.recorder import Recorder, get_recorder, record_scope

_PID = 0  # single-process flight recorder; lanes are encoded as tids


def chrome_trace(rec: Optional[Recorder] = None) -> Dict[str, Any]:
    """Render a recording as a Chrome Trace Event Format object."""
    rec = rec or get_recorder()
    events: List[Dict[str, Any]] = [
        {
            "ph": "M",
            "name": "process_name",
            "pid": _PID,
            "ts": 0.0,
            "args": {"name": "repro flight recorder"},
        }
    ]
    for s in rec.spans:
        events.append(
            {
                "ph": "X",
                "name": s.name,
                "cat": s.cat,
                "pid": _PID,
                "tid": s.tid,
                "ts": s.t_start_us,
                "dur": s.dur_us,
                "args": s.args,
            }
        )
    for e in rec.events:
        events.append(
            {
                "ph": "i",
                "s": "t",
                "name": e.name,
                "cat": e.cat,
                "pid": _PID,
                "tid": e.tid,
                "ts": e.t_us,
                "args": e.args,
            }
        )
    t_end = max((ev["ts"] + ev.get("dur", 0.0) for ev in events), default=0.0)
    for name, value in sorted(rec.counters.items()):
        events.append(
            {
                "ph": "C",
                "name": name,
                "pid": _PID,
                "ts": t_end,
                "args": {"value": value},
            }
        )
    events.sort(key=lambda ev: (ev["ts"], ev["ph"] != "M"))
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "counters": dict(sorted(rec.counters.items())),
            "gauges": dict(sorted(rec.gauges.items())),
            "meta": dict(rec.meta),
        },
    }


def write_trace(path, rec: Optional[Recorder] = None) -> pathlib.Path:
    """Write the Chrome trace JSON to ``path`` (parents created)."""
    out = pathlib.Path(path)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(chrome_trace(rec)))
    return out


def metrics_snapshot(rec: Optional[Recorder] = None) -> Dict[str, Any]:
    """Counters, gauges, histogram percentile digests, and per-span timing
    aggregates as one flat JSON-able dict."""
    rec = rec or get_recorder()
    return {
        "counters": dict(sorted(rec.counters.items())),
        "gauges": dict(sorted(rec.gauges.items())),
        "histograms": histograms_summary(rec),
        "spans": rec.span_stats(),
        "n_spans": len(rec.spans),
        "n_events": len(rec.events),
        "meta": dict(rec.meta),
    }


def write_metrics(path, rec: Optional[Recorder] = None) -> pathlib.Path:
    out = pathlib.Path(path)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(metrics_snapshot(rec), indent=1))
    return out


def _prom_name(name: str) -> str:
    """Dotted recorder names -> Prometheus metric names (``[a-zA-Z0-9_]``,
    non-digit first char — every recorder name already starts with a
    subsystem word, so prefixing is unnecessary)."""
    return "".join(c if c.isalnum() else "_" for c in name)


def _prom_value(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def prometheus_text(rec: Optional[Recorder] = None) -> str:
    """Render the recorder as Prometheus-style text exposition.

    Counters and gauges become single samples with ``# TYPE`` headers;
    histograms become the standard cumulative ``_bucket{le="..."}`` series
    (``+Inf`` bucket == ``_count``) plus ``_sum`` and ``_count`` samples.
    """
    rec = rec or get_recorder()
    lines: List[str] = []
    for name, value in sorted(rec.counters.items()):
        pn = _prom_name(name)
        lines.append(f"# TYPE {pn} counter")
        lines.append(f"{pn} {_prom_value(value)}")
    for name, value in sorted(rec.gauges.items()):
        pn = _prom_name(name)
        lines.append(f"# TYPE {pn} gauge")
        lines.append(f"{pn} {_prom_value(value)}")
    for name in sorted(rec.hists):
        h = rec.hists[name]
        pn = _prom_name(name)
        lines.append(f"# TYPE {pn} histogram")
        for bound, cum in zip(h.bounds, h.cumulative()):
            lines.append(f'{pn}_bucket{{le="{_prom_value(bound)}"}} {cum}')
        lines.append(f'{pn}_bucket{{le="+Inf"}} {h.count}')
        lines.append(f"{pn}_sum {_prom_value(h.total)}")
        lines.append(f"{pn}_count {h.count}")
    return "\n".join(lines) + ("\n" if lines else "")


def write_prometheus(path, rec: Optional[Recorder] = None) -> pathlib.Path:
    out = pathlib.Path(path)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(prometheus_text(rec))
    return out


@contextlib.contextmanager
def trace_scope(
    trace_path=None, *, reconcile: Optional[bool] = None
) -> Iterator[Recorder]:
    """:func:`record_scope` wired for CLI ``--trace out.json`` flags:
    tracing is on iff a path was given, and the Chrome trace is written
    there when the scope exits (even on error — a crashed run's trace is
    the one you want most)."""
    with record_scope(
        tracing=bool(trace_path) if trace_path else None,
        reconcile=reconcile,
    ) as rec:
        try:
            yield rec
        finally:
            if trace_path:
                out = write_trace(trace_path, rec)
                print(f"wrote trace to {out}", flush=True)
