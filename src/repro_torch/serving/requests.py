"""Request model and workload synthesis for constellation serving.

An :class:`InferenceRequest` is the unit the whole serving path moves: it
is born at a ground station, rides the uplink contact graph to a satellite
replica, decodes there under the TDM slot structure, and its response
floods back down to the *origin* gateway. The mutable fields are engine
state — the request object itself is the single source of truth for where
a payload currently sits and how far through its lifecycle it is, so the
auditor can replay the whole run from the request set plus the per-slot
provenance records.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

# Lifecycle states, in order. ``queued`` covers both "waiting at the origin
# gateway" and "waiting in a replica's admission queue" (``node`` tells
# them apart); ``uplink``/``downlink`` mean in transit on the contact graph.
QUEUED = "queued"
UPLINK = "uplink"
ROUTED = "routed"
DECODING = "decoding"
DOWNLINK = "downlink"
DELIVERED = "delivered"

LIFECYCLE = (QUEUED, UPLINK, ROUTED, DECODING, DOWNLINK, DELIVERED)


@dataclasses.dataclass
class InferenceRequest:
    """One user request plus its engine-owned lifecycle state."""

    rid: int
    gateway: int                 # origin ground-station node id
    prompt: np.ndarray           # int32 token ids
    max_new: int
    arrival_slot: int = 0

    # --- engine-owned mutable state
    status: str = QUEUED
    node: Optional[int] = None   # current holder while in transit/queued
    replica: Optional[int] = None  # serving satellite once routed
    out: List[int] = dataclasses.field(default_factory=list)
    retries: int = 0             # churn re-injections (never dropped)
    hops_up: int = 0
    hops_down: int = 0

    # --- slot timestamps (engine slot indices; -1 = not reached yet)
    submitted_slot: int = -1
    routed_slot: int = -1
    admitted_slot: int = -1
    first_token_slot: int = -1
    completed_slot: int = -1
    delivered_slot: int = -1

    @property
    def done(self) -> bool:
        """Decode finished (response exists, delivery may still be pending)."""
        return len(self.out) >= self.max_new

    @property
    def delivered(self) -> bool:
        return self.status == DELIVERED

    @property
    def latency_slots(self) -> int:
        """Submit → response-at-origin-gateway, in engine slots."""
        if self.delivered_slot < 0 or self.submitted_slot < 0:
            return -1
        return self.delivered_slot - self.submitted_slot

    @property
    def ttft_slots(self) -> int:
        """Submit → first decoded token, in engine slots."""
        if self.first_token_slot < 0 or self.submitted_slot < 0:
            return -1
        return self.first_token_slot - self.submitted_slot

    def requeue(self) -> None:
        """Churn re-injection: back to the origin gateway, decode restarts.

        Any tokens already decoded on a now-dead replica are gone with it,
        so the request re-enters the uplink from scratch — re-routed, never
        lost. Hop counters keep accumulating (the audit trail records the
        abandoned legs too)."""
        self.status = QUEUED
        self.node = self.gateway
        self.replica = None
        self.out = []
        self.retries += 1


def synthesize_workload(
    n_requests: int,
    gateways: Sequence[int],
    *,
    rate_per_slot: float = 2.0,
    prompt_len: Tuple[int, int] = (4, 12),
    max_new: int = 8,
    vocab: int = 128,
    seed: int = 0,
) -> List[InferenceRequest]:
    """Deterministic synthetic arrival process.

    Arrival slots advance at ``rate_per_slot`` requests per engine slot
    (``arrival_slot = floor(k / rate)`` — deterministic so tests and the
    benchmark baselines can reason about offered load exactly); gateways
    and prompt contents come from a seeded generator.
    """
    if not gateways:
        raise ValueError("need at least one gateway")
    if rate_per_slot <= 0:
        raise ValueError("rate_per_slot must be positive")
    rng = np.random.default_rng(seed)
    gws = sorted(int(g) for g in gateways)
    lo, hi = prompt_len
    reqs: List[InferenceRequest] = []
    for k in range(n_requests):
        plen = int(rng.integers(lo, hi + 1))
        reqs.append(
            InferenceRequest(
                rid=k,
                gateway=gws[int(rng.integers(0, len(gws)))],
                prompt=rng.integers(0, vocab, plen).astype(np.int32),
                max_new=max_new,
                arrival_slot=int(k // rate_per_slot),
            )
        )
    return reqs


__all__ = [
    "DECODING",
    "DELIVERED",
    "DOWNLINK",
    "InferenceRequest",
    "LIFECYCLE",
    "QUEUED",
    "ROUTED",
    "UPLINK",
    "synthesize_workload",
]
