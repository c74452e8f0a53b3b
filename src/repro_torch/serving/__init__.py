"""Constellation-scale serving: TDM-slotted inference over the ground segment.

The inference-side twin of :mod:`repro_torch.groundseg`: user
requests arrive at ground stations, ride the earliest-delivery contact-
graph routes up to satellites holding model replicas, decode there under
the TDM slot structure with fleet-level continuous batching, and the
responses descend to their origin gateways — with elastic replica
membership under orbital churn and full flight-recorder instrumentation.

- :mod:`repro_torch.serving.requests` — the request lifecycle model
  (queued → uplink → routed → decoding → downlink → delivered) and
  deterministic workload synthesis.
- :mod:`repro_torch.serving.replica`  — per-satellite decode state: the
  :class:`ReplicaFleet` continuous-batching scheduler over either a pure-
  host :class:`NullDecoder` (transport logic, fast tests, deterministic
  benchmark layer) or the :class:`ModelDecoder` (every replica's lanes
  folded into one batch on one device, one shared copy of the params).
- :mod:`repro_torch.serving.engine`   — the slot loop: transport, admission,
  decode, churn handling, per-slot provenance records, telemetry.
- :mod:`repro_torch.serving.audit`    — replay the provenance against the TDM
  schedule (slot-legal links only, contiguous trails, every request
  delivered exactly once) into a :class:`repro_torch.telemetry.AuditReport`.

Quick use::

    from repro_torch.constellation.scenario import smoke_scenario
    from repro_torch import serving

    scn = smoke_scenario()
    fleet = serving.ReplicaFleet([0, 3], batch=2,
                                 decoder=serving.NullDecoder(2, 2))
    eng = serving.ServingEngine.from_scenario(scn, fleet)
    work = serving.synthesize_workload(8, scn.ground_ids, seed=0)
    report = eng.run(work)
    verdict = serving.audit_serving_run(
        report.records, report.requests, eng.base_rels,
        gateways=eng.gateways, replicas=sorted(eng.replicas))
    assert verdict.ok and not report.undelivered
"""

from repro_torch.serving.audit import audit_serving_run
from repro_torch.serving.engine import (
    Send,
    ServeReport,
    ServingEngine,
    SlotRecord,
)
from repro_torch.serving.replica import ModelDecoder, NullDecoder, ReplicaFleet
from repro_torch.serving.requests import InferenceRequest, synthesize_workload

__all__ = [
    "InferenceRequest",
    "ModelDecoder",
    "NullDecoder",
    "ReplicaFleet",
    "Send",
    "ServeReport",
    "ServingEngine",
    "SlotRecord",
    "audit_serving_run",
    "synthesize_workload",
]
