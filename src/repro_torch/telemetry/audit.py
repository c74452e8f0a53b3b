"""Route-provenance auditing: prove the execution followed the plan.

The paper's validation criterion is that every node's executed exchanges
match the communication plan; the companion work "Formal Verification of a
Generic Algorithm for TDM Communication Over Inter Satellite Links"
(PAPERS.md) machine-checks exactly that plan-vs-execution property. This
module is the runtime twin: given the
:class:`~repro_torch.groundseg.routing.WindowProgram` sequence a run planned —
and optionally the payload lifecycle events the flight recorder captured
while executing it — reconstruct every payload's hop-by-hop trail and
cross-check, per window:

- **conservation / misrouting** — replaying ``uplink.slot_sends`` from the
  window's initial loads must land exactly the payload sets
  ``uplink.delivered`` claims at each sink, strand nothing mid-route, and
  leave every undelivered payload parked at its own source (the
  delay-tolerant invariant the multi-window router relies on);
- **TDM legality** — per slot, uplink senders are unique (accumulate-and-
  forward out-degree <= 1) and downlink receivers have exactly one parent;
  with the window's slot relations supplied, every hop must ride an edge
  that physically exists in that slot;
- **capacity disjointness at** ``pipeline_depth=2`` — the lagged downlink
  flood may only use undirected edges the uplink relay left free, slot by
  slot;
- **age bookkeeping** — ``ages``/``delivered_ages``/``residual``/
  ``dropped`` must evolve across windows exactly as the queue discipline
  specifies (carried payloads age by one, drops exceed the horizon by
  construction, a source is never double-queued);
- **staleness weights** — the per-sink FedAvg denominators must equal
  ``1 + sum(decay ** age)`` over the delivered payloads, recomputed here
  with the same repeated-f32-multiply the aggregation engine uses;
- **lifecycle events** — the ``payload.queued/delivered/carried/dropped``
  instants a traced run emitted must match the plan payload-for-payload.

Violations come back as a structured :class:`AuditReport` (raise with
:meth:`AuditReport.raise_if_violations`); ``python -m repro_torch.telemetry.audit
--ci-smoke`` runs the auditor over a small ground-segment plan as a CI
gate. Stdlib + numpy only, so auditing never perturbs the run
it is checking.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.telemetry import metrics
from repro_torch.telemetry import recorder as telemetry
from repro_torch.telemetry.recorder import Event, Recorder

# payload lifecycle event names (emitted by launch.fl_train's pipelined
# driver, cat="payload") -> the WindowProgram attribute they must mirror
_EVENT_KINDS = ("queued", "delivered", "carried", "dropped")

WEIGHT_ATOL = 1e-5


class AuditError(RuntimeError):
    """Raised by :meth:`AuditReport.raise_if_violations`."""


@dataclasses.dataclass(frozen=True)
class AuditViolation:
    """One way the execution (or the plan itself) broke its contract."""

    kind: str        # "misroute" | "fanout" | "phantom-hop" | "no-such-link"
    #                | "stranded" | "capacity-overlap" | "age" | "weights"
    #                | "events" | "double-queue"
    window: int
    detail: str
    payload: Optional[int] = None   # source satellite id, when applicable

    def __str__(self) -> str:
        who = f" payload={self.payload}" if self.payload is not None else ""
        return f"[{self.kind}] window {self.window}{who}: {self.detail}"


@dataclasses.dataclass(frozen=True)
class PayloadTrail:
    """One payload's reconstructed provenance within one window."""

    window: int
    source: int
    age: int
    sink: Optional[int]                 # None: carried into the next window
    hops: Tuple[Tuple[int, int, int], ...]   # (slot, src, dst)


@dataclasses.dataclass
class AuditReport:
    """The auditor's verdict over a window-program sequence."""

    n_windows: int = 0
    n_payloads: int = 0
    n_hops: int = 0
    n_delivered: int = 0
    n_dropped: int = 0
    events_checked: int = 0
    violations: List[AuditViolation] = dataclasses.field(default_factory=list)
    trails: Dict[Tuple[int, int], PayloadTrail] = dataclasses.field(
        default_factory=dict
    )   # (window, source) -> trail

    @property
    def ok(self) -> bool:
        return not self.violations

    def summary(self) -> Dict[str, object]:
        """JSON-able digest for mission reports / CI logs."""
        return {
            "ok": self.ok,
            "n_windows": self.n_windows,
            "n_payloads": self.n_payloads,
            "n_hops": self.n_hops,
            "n_delivered": self.n_delivered,
            "n_dropped": self.n_dropped,
            "events_checked": self.events_checked,
            "n_violations": len(self.violations),
            "violations": [str(v) for v in self.violations],
        }

    def raise_if_violations(self) -> "AuditReport":
        if self.violations:
            head = "; ".join(str(v) for v in self.violations[:5])
            more = len(self.violations) - 5
            raise AuditError(
                f"route-provenance audit failed with "
                f"{len(self.violations)} violation(s): {head}"
                + (f"; ... {more} more" if more > 0 else "")
            )
        return self


def expected_sink_weights(wp, decay: float) -> Dict[int, float]:
    """Per-sink FedAvg denominator ``1 + sum(decay ** age)`` over the
    delivered payloads — the same repeated-f32-multiply recurrence
    :func:`repro_torch.groundseg.aggregation.staleness_sink_weights` applies, so
    a correct engine matches bit-for-bit (host-only twin)."""
    out: Dict[int, float] = {}
    for k, srcs in wp.uplink.delivered.items():
        total = np.float32(1.0)
        for s in sorted(srcs):
            ws = np.float32(1.0)
            for _ in range(int(wp.delivered_ages.get(s, 0))):
                ws = np.float32(ws * np.float32(decay))
            total = np.float32(total + ws)
        out[int(k)] = float(total)
    return out


def _undirected(sends) -> List[Tuple[int, int]]:
    return [(min(s, d), max(s, d)) for s, d in sends]


def _replay_uplink(wp, slots, report: AuditReport) -> None:
    """Re-execute the uplink send plan and diff it against the outcome the
    program claims (delivered / residual / trail shape)."""
    w = wp.window
    sinks = wp.uplink.sinks
    carrying: Dict[int, set] = {
        s: {s} for s in wp.ages if s not in sinks
    }
    hops: Dict[int, List[Tuple[int, int, int]]] = {s: [] for s in carrying}
    delivered: Dict[int, set] = {k: set() for k in sinks}
    slot_edges: Optional[List[set]] = None
    if slots is not None:
        slot_edges = [set(_undirected(r.edge_list())) for r in slots]
    for t, sends in enumerate(wp.uplink.slot_sends):
        srcs = [s for s, _ in sends]
        if len(srcs) != len(set(srcs)):
            report.violations.append(AuditViolation(
                "fanout", w,
                f"slot {t}: uplink source sends twice in one slot: {sends}",
            ))
        # TDM slot sends are simultaneous: every sender ships the load it
        # held at slot START (a same-slot receive waits for the next slot),
        # so snapshot all outgoing loads before applying any deposit.
        outgoing: List[Tuple[int, int, set]] = []
        for s, d in sends:
            if slot_edges is not None:
                if t >= len(slot_edges) or (
                    (min(s, d), max(s, d)) not in slot_edges[t]
                ):
                    report.violations.append(AuditViolation(
                        "no-such-link", w,
                        f"slot {t}: hop {s}->{d} rides a link that does "
                        "not exist in that slot's relation",
                    ))
            load = set(carrying.get(s, ()))
            if not load:
                report.violations.append(AuditViolation(
                    "phantom-hop", w,
                    f"slot {t}: {s} sends to {d} but carries no payload",
                ))
                continue
            outgoing.append((s, d, load))
        for s, _d, _load in outgoing:
            carrying.pop(s, None)
        for s, d, load in outgoing:
            for p in load:
                hops.setdefault(p, []).append((t, s, d))
            if d in sinks:
                delivered[d] |= load
            else:
                carrying.setdefault(d, set()).update(load)

    claimed = {k: set(v) for k, v in wp.uplink.delivered.items()}
    for k in sorted(set(claimed) | set(delivered)):
        got, want = delivered.get(k, set()), claimed.get(k, set())
        if got != want:
            report.violations.append(AuditViolation(
                "misroute", w,
                f"sink {k}: replay delivers {sorted(got)} but the program "
                f"claims {sorted(want)}",
            ))
    leftovers = {p for load in carrying.values() for p in load}
    for holder, load in sorted(carrying.items()):
        for p in sorted(load):
            if holder != p:
                report.violations.append(AuditViolation(
                    "stranded", w,
                    f"payload {p} ends the window at node {holder}, not at "
                    "its own source (delay-tolerant invariant broken)",
                    payload=p,
                ))
    if leftovers != set(wp.residual):
        report.violations.append(AuditViolation(
            "misroute", w,
            f"residual mismatch: replay strands {sorted(leftovers)}, the "
            f"program claims {sorted(wp.residual)}",
        ))

    all_delivered = {p for load in delivered.values() for p in load}
    for s in sorted(wp.ages):
        sink = next((k for k, load in delivered.items() if s in load), None)
        trail = PayloadTrail(
            window=w,
            source=s,
            age=int(wp.ages[s]),
            sink=sink,
            hops=tuple(hops.get(s, ())),
        )
        report.trails[(w, s)] = trail
        report.n_hops += len(trail.hops)
        metrics.observe(
            "audit.hops_per_payload",
            len(trail.hops),
            buckets=metrics.COUNT_BUCKETS,
        )
    report.n_payloads += len(wp.ages)
    report.n_delivered += len(all_delivered)


def _check_downlink(wp, slots, report: AuditReport) -> None:
    """Downlink fan-in legality + disjoint-capacity at pipeline depth 2."""
    if wp.downlink is None:
        return
    w = wp.window
    up_edges = [set(_undirected(s)) for s in wp.uplink.slot_sends]
    for t, sends in enumerate(wp.downlink.slot_sends):
        dsts = [d for _, d in sends]
        if len(dsts) != len(set(dsts)):
            report.violations.append(AuditViolation(
                "fanout", w,
                f"slot {t}: downlink receiver has two parents: {sends}",
            ))
        if wp.lagged_downlink and t < len(up_edges):
            overlap = set(_undirected(sends)) & up_edges[t]
            if overlap:
                report.violations.append(AuditViolation(
                    "capacity-overlap", w,
                    f"slot {t}: downlink floods over uplink-occupied "
                    f"edges {sorted(overlap)} (depth-2 capacity must be "
                    "disjoint)",
                ))
        if slots is not None:
            edges = set(_undirected(slots[t].edge_list())) if t < len(
                slots
            ) else set()
            for s, d in sends:
                if (min(s, d), max(s, d)) not in edges:
                    report.violations.append(AuditViolation(
                        "no-such-link", w,
                        f"slot {t}: downlink hop {s}->{d} rides a link "
                        "that does not exist in that slot's relation",
                    ))


def _check_ledger(
    wp, pending_prev: Dict[int, int], report: AuditReport
) -> Dict[int, int]:
    """Age bookkeeping across window boundaries (the queue discipline)."""
    w = wp.window
    expected_aged = {s: a + 1 for s, a in pending_prev.items()}
    for s, a in sorted(wp.dropped.items()):
        want = expected_aged.get(s)
        if want is None or a != want:
            report.violations.append(AuditViolation(
                "age", w,
                f"dropped payload {s} at age {a}, but the ledger expected "
                f"{'nothing pending' if want is None else f'age {want}'}",
                payload=s,
            ))
    carried_expected = {
        s: a for s, a in expected_aged.items() if s not in wp.dropped
    }
    for s in sorted(wp.injected):
        if s in carried_expected:
            report.violations.append(AuditViolation(
                "double-queue", w,
                f"source {s} injected a fresh payload while one is still "
                f"queued at age {carried_expected[s]}",
                payload=s,
            ))
        if wp.ages.get(s, None) != 0:
            report.violations.append(AuditViolation(
                "age", w,
                f"fresh payload {s} has age {wp.ages.get(s)!r}, want 0",
                payload=s,
            ))
    for s, a in sorted(wp.ages.items()):
        if s in wp.injected:
            continue
        want = carried_expected.get(s)
        if want is None or a != want:
            report.violations.append(AuditViolation(
                "age", w,
                f"carried payload {s} shows age {a}, ledger expected "
                f"{'no queued payload' if want is None else f'age {want}'}",
                payload=s,
            ))
    for s, a in sorted(wp.delivered_ages.items()):
        if wp.ages.get(s) != a:
            report.violations.append(AuditViolation(
                "age", w,
                f"delivered_ages[{s}]={a} disagrees with ages[{s}]="
                f"{wp.ages.get(s)!r}",
                payload=s,
            ))
    report.n_dropped += len(wp.dropped)
    return dict(wp.residual)


def _check_weights(
    wp, decay: float, weights, report: AuditReport
) -> None:
    """The staleness denominators actually used must equal decay**age."""
    want = expected_sink_weights(wp, decay)
    if weights is None:
        return
    arr = np.asarray(weights, dtype=np.float32)
    for k, wv in sorted(want.items()):
        got = float(arr[k]) if k < arr.shape[0] else float("nan")
        if not np.isfinite(got) or abs(got - wv) > WEIGHT_ATOL:
            report.violations.append(AuditViolation(
                "weights", wp.window,
                f"sink {k}: staleness weight {got!r} != decay**age "
                f"expectation {wv!r} (decay={decay})",
            ))
    for v, got in enumerate(arr.tolist()):
        if v not in want and got not in (0.0,):
            report.violations.append(AuditViolation(
                "weights", wp.window,
                f"node {v}: nonzero weight {got!r} but no deliveries "
                "landed there",
            ))


def _check_events(
    programs, events: Sequence[Event], report: AuditReport
) -> None:
    """Executed lifecycle instants must mirror the plan payload-by-payload."""
    windows = {wp.window: wp for wp in programs}
    seen: Dict[Tuple[int, str], set] = {}
    for e in events:
        if e.cat != "payload":
            continue
        kind = e.name.split(".", 1)[-1]
        if kind not in _EVENT_KINDS:
            continue
        w = e.args.get("window")
        src = e.args.get("source")
        if w not in windows:
            report.violations.append(AuditViolation(
                "events", -1 if w is None else int(w),
                f"{e.name} for source {src} in window {w!r}, which is "
                "outside the audited program sequence",
                payload=src,
            ))
            continue
        seen.setdefault((int(w), kind), set()).add(
            (int(src), e.args.get("age"))
        )
        report.events_checked += 1
    for wp in programs:
        w = wp.window
        want = {
            "queued": {(s, None) for s in wp.injected},
            "delivered": {(s, a) for s, a in wp.delivered_ages.items()},
            "carried": {(s, a) for s, a in wp.residual.items()},
            "dropped": {(s, a) for s, a in wp.dropped.items()},
        }
        for kind, expect in want.items():
            got = seen.get((w, kind), set())
            if got != expect:
                extra = sorted(got - expect)
                missing = sorted(expect - got)
                report.violations.append(AuditViolation(
                    "events", w,
                    f"payload.{kind} events diverge from the plan: "
                    f"unexpected {extra}, missing {missing}",
                ))


def audit_window_programs(
    programs: Sequence,
    *,
    decay: float = 1.0,
    slots: Optional[Sequence] = None,
    weights: Optional[Sequence] = None,
    events: Optional[Sequence[Event]] = None,
    pending_start: Optional[Dict[int, int]] = None,
) -> AuditReport:
    """Audit a consecutive :class:`WindowProgram` sequence end to end.

    ``slots`` (optional) is the per-window slot-relation list the router
    planned over — one ``Sequence[Relation]`` shared by every window, or a
    per-window list of them — enabling the does-this-link-exist check.
    ``weights`` (optional) is the per-window staleness denominator vector
    the aggregation engine actually used (one array per window).
    ``events`` (optional) are flight-recorder events from the executed run
    (non-payload categories are ignored). ``pending_start`` seeds the age
    ledger when the audited sequence does not begin at window 0.

    Results also land on the active recorder: ``audit.windows`` /
    ``audit.payloads`` / ``audit.violations`` counters and an
    ``audit.hops_per_payload`` histogram.
    """
    report = AuditReport(n_windows=len(programs))
    if not programs:
        return report
    windows = [wp.window for wp in programs]
    if windows != list(range(windows[0], windows[0] + len(programs))):
        raise ValueError(
            f"programs must be consecutive windows, got {windows}"
        )
    per_window_slots: List[Optional[Sequence]] = [None] * len(programs)
    if slots is not None:
        first = slots[0] if len(slots) > 0 else None
        if first is not None and hasattr(first, "edge_list"):
            per_window_slots = [slots] * len(programs)  # shared slot list
        else:
            if len(slots) != len(programs):
                raise ValueError(
                    "per-window slots must align 1:1 with programs"
                )
            per_window_slots = list(slots)
    if weights is not None and len(weights) != len(programs):
        raise ValueError("per-window weights must align 1:1 with programs")

    pending = dict(pending_start or {})
    first_window = programs[0].window
    for i, wp in enumerate(programs):
        wslots = per_window_slots[i]
        _replay_uplink(wp, wslots, report)
        _check_downlink(wp, wslots, report)
        if i > 0 or first_window == 0 or pending_start is not None:
            pending = _check_ledger(wp, pending, report)
        else:
            pending = dict(wp.residual)
        _check_weights(
            wp, decay, None if weights is None else weights[i], report
        )
    if events is not None:
        _check_events(programs, events, report)

    rec = telemetry.get_recorder()
    rec.counter("audit.windows", len(programs))
    rec.counter("audit.payloads", report.n_payloads)
    rec.counter("audit.violations", len(report.violations))
    return report


def audit_recorder(
    rec: Recorder,
    programs: Sequence,
    *,
    decay: float = 1.0,
    slots: Optional[Sequence] = None,
    weights: Optional[Sequence] = None,
) -> AuditReport:
    """Audit an executed run: the planned programs against the payload
    lifecycle events ``rec`` captured while executing them (requires the
    run to have traced with ``record_scope(tracing=True)``)."""
    return audit_window_programs(
        programs,
        decay=decay,
        slots=slots,
        weights=weights,
        events=rec.events,
    )


# ---------------------------------------------------------------------------
# CI gate: audit a small ground-segment plan end to end
# ---------------------------------------------------------------------------

def _ci_smoke(windows: int, report_prefix: Optional[str]) -> int:
    """Plan a small 2-plane Walker + 2-ground-station constellation, run
    the pipelined router for a few windows (with one satellite outage to
    exercise the carry/age ledger), and audit the result. Zero violations
    is the gate; the optional mission report captures the evidence."""
    from repro_torch.constellation import contact_plan, orbits
    from repro_torch.groundseg import routing

    n_sats, n_gs = 6, 2
    n = n_sats + n_gs
    sinks = frozenset(range(n_sats, n))
    geom = orbits.WalkerDelta(
        total=n_sats, planes=2, altitude_km=8062.0, inclination_deg=60.0
    )
    gs = [
        orbits.GroundStation(0.0, 0.0, name="equator"),
        orbits.GroundStation(45.0, 120.0, name="midlat"),
    ]
    plan = contact_plan.build_contact_plan(
        geom,
        duration_s=geom.period_s,
        step_s=geom.period_s / 10,
        ground_stations=gs,
        max_range_km=16_000.0,
    )
    with telemetry.record_scope(tracing=True) as rec:
        sched = plan.schedule(antennas=2, payload_bytes=1 << 20)
        rels = list(sched.tdm)
        router = routing.MultiWindowRouter(
            n, sinks, max_staleness_windows=2, pipeline_depth=2
        )
        programs = []
        for w in range(windows):
            alive = set(range(n)) - ({1} if w == 2 else set())
            programs.append(router.plan_window(rels, alive=alive))
        audit = audit_window_programs(programs, decay=0.5, slots=rels)
        print(
            f"audited {audit.n_windows} windows / {audit.n_payloads} "
            f"payloads / {audit.n_hops} hops: "
            f"{len(audit.violations)} violation(s)"
        )
        for v in audit.violations:
            print(f"  {v}")
        if report_prefix:
            from repro_torch.telemetry.report import write_report

            md, js = write_report(
                report_prefix, rec, audit=audit,
                title="groundseg audit smoke",
            )
            print(f"wrote mission report to {md} and {js}")
    return 0 if audit.ok else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument(
        "--ci-smoke", action="store_true",
        help="audit a small groundseg plan end to end (CI gate)",
    )
    p.add_argument("--windows", type=int, default=5)
    p.add_argument(
        "--report", default=None, metavar="PREFIX",
        help="also write PREFIX.md / PREFIX.json mission report",
    )
    args = p.parse_args(argv)
    if not args.ci_smoke:
        p.error("nothing to do: pass --ci-smoke")
    return _ci_smoke(args.windows, args.report)


__all__ = (
    "AuditError",
    "AuditReport",
    "AuditViolation",
    "PayloadTrail",
    "audit_recorder",
    "audit_window_programs",
    "expected_sink_weights",
)

if __name__ == "__main__":
    raise SystemExit(main())
