"""Route-provenance audit for serving runs.

The serving twin of :func:`repro_torch.telemetry.audit.audit_window_programs`:
replay the engine's per-slot provenance records against the base TDM
schedule and the request set, and return the same structured
:class:`~repro_torch.telemetry.audit.AuditReport` the mission-control layer
already knows how to render, gate on, and embed in reports.

Checks, per the store-and-forward contract:

- **no-such-link** — every send (src, dst) rides an edge present in the
  slot's scheduled relation *restricted to the recorded alive set*;
- **dead-node** — no send touches a node outside the alive set;
- **fanout** — a payload takes at most one hop per slot;
- **misroute** — each transport leg is contiguous (hop k+1 departs where
  hop k landed; a churn requeue legally resets the chain to the origin
  gateway), requests start at their gateway, responses start at the
  serving replica and end at the origin gateway;
- **lost-request / duplicate-delivery** — every submitted request is
  delivered exactly once (churn re-routes, never drops).

Violation ``window`` fields carry the engine slot index; ``payload``
carries the request id.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from repro_torch.core.relation import Relation
from repro_torch.serving import requests as rq
from repro_torch.serving.engine import SlotRecord
from repro_torch.telemetry.audit import AuditReport, AuditViolation, PayloadTrail


def audit_serving_run(
    records: Sequence[SlotRecord],
    requests: Sequence[rq.InferenceRequest],
    base_rels: Sequence[Relation],
    *,
    gateways: Sequence[int],
    replicas: Sequence[int],
) -> AuditReport:
    """Replay a serving run's provenance hop by hop."""
    epoch = len(base_rels)
    gw = set(int(g) for g in gateways)
    reps = set(int(r) for r in replicas)
    report = AuditReport(n_windows=len(records), n_payloads=len(requests))
    viol = report.violations

    by_rid: Dict[int, rq.InferenceRequest] = {r.rid: r for r in requests}
    sends_by_rid: Dict[int, List] = {r.rid: [] for r in requests}
    # chain resets, chronological: ("requeue", slot, gateway) restarts the
    # trail at the origin gateway; ("reemit", slot, replica) restarts the
    # downlink leg at the replica that held the decoded response
    resets_by_rid: Dict[int, List] = {r.rid: [] for r in requests}
    delivered_count: Dict[int, int] = {r.rid: 0 for r in requests}

    # --- per-slot legality: links exist, nodes live, fanout <= 1
    for recd in records:
        rel = base_rels[recd.t].restrict(recd.alive)
        seen_this_slot: Dict[int, int] = {}
        for send in recd.sends:
            report.n_hops += 1
            report.events_checked += 1
            if send.rid not in by_rid:
                viol.append(AuditViolation(
                    "phantom-hop", send.slot,
                    f"send for unknown request {send.rid}", send.rid,
                ))
                continue
            if send.src not in recd.alive or send.dst not in recd.alive:
                viol.append(AuditViolation(
                    "dead-node", send.slot,
                    f"hop {send.src}->{send.dst} touches a dead node",
                    send.rid,
                ))
            if (send.src, send.dst) not in rel.pairs:
                viol.append(AuditViolation(
                    "no-such-link", send.slot,
                    f"hop {send.src}->{send.dst} not in slot {recd.t}'s "
                    f"scheduled relation", send.rid,
                ))
            n = seen_this_slot.get(send.rid, 0) + 1
            seen_this_slot[send.rid] = n
            if n > 1:
                viol.append(AuditViolation(
                    "fanout", send.slot,
                    f"request took {n} hops in one slot", send.rid,
                ))
            sends_by_rid[send.rid].append(send)
        for rid, node in recd.requeued:
            report.events_checked += 1
            if rid in resets_by_rid:
                resets_by_rid[rid].append(("requeue", recd.slot, None))
        for rid, node in recd.reemitted:
            report.events_checked += 1
            if rid in resets_by_rid:
                resets_by_rid[rid].append(("reemit", recd.slot, node))
        for rid in recd.delivered:
            report.events_checked += 1
            if rid in delivered_count:
                delivered_count[rid] += 1

    # --- per-request trail contiguity and terminal checks
    for req in requests:
        sends = sorted(sends_by_rid[req.rid], key=lambda s: s.slot)
        resets = sorted(resets_by_rid[req.rid], key=lambda e: e[1])
        expect_src: Optional[int] = req.gateway
        kind_prev = "req"
        ri = 0
        for send in sends:
            # consume chain resets that took effect at or before this hop:
            # a churn requeue restarts the trail at the origin gateway, a
            # response re-emission restarts the downlink leg at the replica
            while ri < len(resets) and resets[ri][1] <= send.slot:
                what, _, node = resets[ri]
                ri += 1
                if what == "requeue":
                    expect_src, kind_prev = req.gateway, "req"
                else:
                    expect_src, kind_prev = node, "resp"
            if send.kind == "resp" and kind_prev == "req":
                # decode handoff: the downlink leg must depart a replica,
                # and specifically the replica the uplink chain ended at —
                # otherwise a request-side detour right before decode
                # would vanish into the handoff
                if send.src not in reps:
                    viol.append(AuditViolation(
                        "misroute", send.slot,
                        f"response departs non-replica node {send.src}",
                        req.rid,
                    ))
                elif expect_src is not None and send.src != expect_src:
                    viol.append(AuditViolation(
                        "misroute", send.slot,
                        f"response departs {send.src}, uplink chain ended "
                        f"at {expect_src}", req.rid,
                    ))
                expect_src = send.src
                kind_prev = "resp"
            if send.src != expect_src:
                viol.append(AuditViolation(
                    "misroute", send.slot,
                    f"hop departs {send.src}, chain expected {expect_src}",
                    req.rid,
                ))
            expect_src = send.dst
        if delivered_count[req.rid] == 0:
            viol.append(AuditViolation(
                "lost-request", req.submitted_slot,
                f"request submitted at slot {req.submitted_slot} never "
                f"delivered (status={req.status})", req.rid,
            ))
        elif delivered_count[req.rid] > 1:
            viol.append(AuditViolation(
                "double-queue", req.delivered_slot,
                f"delivered {delivered_count[req.rid]} times", req.rid,
            ))
        else:
            report.n_delivered += 1
            if sends and sends[-1].dst != req.gateway:
                viol.append(AuditViolation(
                    "misroute", sends[-1].slot,
                    f"final hop lands at {sends[-1].dst}, origin gateway is "
                    f"{req.gateway}", req.rid,
                ))
        report.trails[(req.arrival_slot, req.gateway)] = PayloadTrail(
            window=req.arrival_slot,
            source=req.gateway,
            age=req.retries,
            sink=req.replica,
            hops=tuple((s.slot, s.src, s.dst) for s in sends),
        )
    return report


__all__ = ["audit_serving_run"]
