"""Mission reports: one run, one self-describing artifact.

Gather everything the flight recorder and the route auditor know about a run — counters, gauges, histogram
percentiles, per-stage wall-clock aggregates, the audit verdict — into a
single JSON document plus a human-readable markdown rendering. Benches
emit one per run (``--report PREFIX``) and nightly CI uploads them as
artifacts, so a regression hunt starts from one file instead of four
tools.

Stdlib-only (the telemetry packages never import jax): the report is
assembled from plain dicts, so it also serves as the stable machine-read
surface for downstream dashboards.
"""

from __future__ import annotations

import json
import pathlib
import time
from typing import Any, Dict, Optional, Tuple

from repro_torch.telemetry import recorder as telemetry
from repro_torch.telemetry.export import metrics_snapshot
from repro_torch.telemetry.recorder import Recorder

SCHEMA_VERSION = 1


def mission_report(
    rec: Optional[Recorder] = None,
    *,
    audit: Optional[Any] = None,
    title: str = "mission report",
    extra: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Assemble the JSON-able report document for one run.

    ``audit`` is an :class:`repro_torch.telemetry.audit.AuditReport` (or anything
    with a ``summary()`` -> dict); ``extra`` merges caller context (bench
    config, row summaries) under its own key.
    """
    rec = rec or telemetry.get_recorder()
    snap = metrics_snapshot(rec)
    doc: Dict[str, Any] = {
        "schema_version": SCHEMA_VERSION,
        "title": title,
        "generated_unix_s": time.time(),
        "counters": snap["counters"],
        "gauges": snap["gauges"],
        "histograms": snap["histograms"],
        "stages": rec.span_stats(),
        "n_spans": snap["n_spans"],
        "n_events": snap["n_events"],
        "meta": snap["meta"],
    }
    if audit is not None:
        doc["audit"] = audit.summary() if hasattr(audit, "summary") else audit
    if extra:
        doc["extra"] = dict(extra)
    return doc


def _fmt(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return f"{float(v):.6g}"


def render_markdown(doc: Dict[str, Any]) -> str:
    """Render a mission-report document as GitHub-flavored markdown."""
    lines = [f"# {doc.get('title', 'mission report')}", ""]
    audit = doc.get("audit")
    if audit is not None:
        verdict = "PASS" if audit.get("ok") else "FAIL"
        lines += [
            f"**Route-provenance audit: {verdict}** — "
            f"{audit.get('n_windows', 0)} windows, "
            f"{audit.get('n_payloads', 0)} payloads, "
            f"{audit.get('n_hops', 0)} hops, "
            f"{audit.get('n_violations', 0)} violation(s).",
            "",
        ]
        for v in audit.get("violations", []):
            lines.append(f"- {v}")
        if audit.get("violations"):
            lines.append("")
    stages = doc.get("stages") or {}
    if stages:
        lines += [
            "## Stage walls",
            "",
            "| stage | count | total ms | mean ms | max ms |",
            "| --- | ---: | ---: | ---: | ---: |",
        ]
        for name, s in sorted(
            stages.items(), key=lambda kv: -kv[1].get("total_ms", 0)
        ):
            lines.append(
                f"| `{name}` | {int(s.get('count', 0))} "
                f"| {s.get('total_ms', 0):.3f} | {s.get('mean_ms', 0):.3f} "
                f"| {s.get('max_ms', 0):.3f} |"
            )
        lines.append("")
    hists = doc.get("histograms") or {}
    if hists:
        lines += [
            "## Distributions",
            "",
            "| metric | count | mean | p50 | p90 | p99 | max |",
            "| --- | ---: | ---: | ---: | ---: | ---: | ---: |",
        ]
        for name, h in sorted(hists.items()):
            lines.append(
                f"| `{name}` | {int(h['count'])} | {_fmt(h['mean'])} "
                f"| {_fmt(h['p50'])} | {_fmt(h['p90'])} | {_fmt(h['p99'])} "
                f"| {_fmt(h['max'])} |"
            )
        lines.append("")
    gauges = doc.get("gauges") or {}
    if gauges:
        lines += ["## Gauges", "", "| gauge | value |", "| --- | ---: |"]
        for name, v in sorted(gauges.items()):
            lines.append(f"| `{name}` | {_fmt(v)} |")
        lines.append("")
    counters = doc.get("counters") or {}
    if counters:
        lines += ["## Counters", "", "| counter | value |", "| --- | ---: |"]
        for name, v in sorted(counters.items()):
            lines.append(f"| `{name}` | {_fmt(v)} |")
        lines.append("")
    extra = doc.get("extra") or {}
    if extra:
        lines += [
            "## Run context",
            "",
            "```json",
            json.dumps(extra, indent=2, sort_keys=True, default=str),
            "```",
            "",
        ]
    lines.append(
        f"_spans: {doc.get('n_spans', 0)}, events: {doc.get('n_events', 0)}, "
        f"schema v{doc.get('schema_version', SCHEMA_VERSION)}_"
    )
    return "\n".join(lines) + "\n"


def write_report(
    prefix: str,
    rec: Optional[Recorder] = None,
    *,
    audit: Optional[Any] = None,
    title: str = "mission report",
    extra: Optional[Dict[str, Any]] = None,
) -> Tuple[pathlib.Path, pathlib.Path]:
    """Write ``PREFIX.md`` + ``PREFIX.json`` and return both paths."""
    doc = mission_report(rec, audit=audit, title=title, extra=extra)
    base = pathlib.Path(prefix)
    base.parent.mkdir(parents=True, exist_ok=True)
    md = base.with_suffix(".md")
    js = base.with_suffix(".json")
    md.write_text(render_markdown(doc))
    js.write_text(json.dumps(doc, indent=2, sort_keys=True, default=str))
    return md, js


__all__ = (
    "SCHEMA_VERSION",
    "mission_report",
    "render_markdown",
    "write_report",
)
