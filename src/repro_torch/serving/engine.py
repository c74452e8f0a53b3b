"""TDM-slotted serving engine: the inference-side twin of the ground segment.

The engine advances in *engine slots* — the materialized TDM schedule
replayed cyclically (one schedule pass = one epoch). Each slot:

1. new requests arrive at their gateways (ground stations);
2. replica membership refreshes against the contact graph (a satellite
   that lost visibility drains its batch; its requests re-route);
3. transport: every in-transit payload takes at most one hop along the
   earliest-delivery DP policy (``groundseg/routing.py``) — requests climb
   toward the nearest in-service replica (sinks = active replicas),
   responses descend toward their *origin* gateway (sinks = {gateway});
   payloads with no useful move hold (delay-tolerant);
4. admission: idle in-service replicas admit a wave from their queue
   (prefill emits the first token);
5. decode: ``decode_steps_per_slot`` fleet ticks; requests reaching
   ``max_new`` become responses at their replica and enter the downlink
   on the *next* slot (data decoded during slot t forwards no earlier
   than t+1 — the store-and-forward contract the auditor checks).

Routing tables are the same backward DP the FL ground segment uses,
cached LRU-style per (alive-set, sink-set) exactly like
``MultiWindowRouter`` caches its window tables; a membership change mid-
epoch is safe because policy row ``t`` only depends on rows ``> t``.

Everything the run did is recorded: per-slot provenance (alive set, every
(src, dst, rid) send, requeues, deliveries) for the route-provenance
auditor in :mod:`repro_torch.serving.audit`, plus flight-recorder telemetry — lifecycle
counters (queued → routed → decoding → delivered), queue-depth / TTFT /
latency histograms, per-slot spans under tracing.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import telemetry
from repro_torch.core.relation import Relation
from repro_torch.groundseg import routing
from repro_torch.launch.elastic import ReplicaMembership
from repro_torch.serving import requests as rq
from repro_torch.serving.replica import ReplicaFleet
from repro_torch.telemetry.metrics import AGE_BUCKETS, COUNT_BUCKETS

# Bounded like groundseg.routing.TABLE_CACHE_MAX: one uplink table per
# alive-set plus one downlink table per (alive-set, gateway).
TABLE_CACHE_MAX = 16


@dataclasses.dataclass(frozen=True)
class Send:
    """One payload hop taken in one engine slot."""

    slot: int
    src: int
    dst: int
    kind: str        # "req" (uplink) | "resp" (downlink)
    rid: int


@dataclasses.dataclass(frozen=True)
class SlotRecord:
    """Provenance of one engine slot — the auditor's replay unit."""

    slot: int
    t: int                       # epoch-relative schedule index
    alive: frozenset
    active_replicas: frozenset
    sends: Tuple[Send, ...]
    requeued: Tuple[Tuple[int, int], ...]   # (rid, node it was pulled from)
    # (rid, replica) — response re-emitted at its replica after its
    # downlink relay died (tokens survive; the downlink leg restarts)
    reemitted: Tuple[Tuple[int, int], ...]
    delivered: Tuple[int, ...]
    admitted: Tuple[int, ...]


@dataclasses.dataclass
class ServeReport:
    """Outcome of a serving run: per-request records plus the summary."""

    n_slots: int
    epoch_slots: int
    requests: List[rq.InferenceRequest]
    records: List[SlotRecord]
    wall_s: float = 0.0          # simulated wall clock (slot durations)

    @property
    def delivered(self) -> List[rq.InferenceRequest]:
        return [r for r in self.requests if r.delivered]

    @property
    def undelivered(self) -> List[rq.InferenceRequest]:
        return [r for r in self.requests if not r.delivered]

    def summary(self) -> Dict[str, object]:
        done = self.delivered
        lat = np.array([r.latency_slots for r in done], np.float64)
        ttft = np.array(
            [r.ttft_slots for r in done if r.ttft_slots >= 0], np.float64
        )
        hops = [r.hops_up + r.hops_down for r in done]
        out: Dict[str, object] = {
            "n_requests": len(self.requests),
            "delivered": len(done),
            "undelivered": len(self.undelivered),
            "n_slots": self.n_slots,
            "epochs": self.n_slots / self.epoch_slots if self.epoch_slots else 0,
            "retries": sum(r.retries for r in self.requests),
            "tokens": sum(len(r.out) for r in done),
        }
        if len(done):
            out.update(
                latency_p50_slots=float(np.percentile(lat, 50)),
                latency_p99_slots=float(np.percentile(lat, 99)),
                ttft_p50_slots=float(np.percentile(ttft, 50)) if len(ttft) else -1.0,
                mean_hops=float(np.mean(hops)),
                req_per_slot=len(done) / self.n_slots,
            )
        if self.wall_s > 0 and len(done):
            out["req_per_s"] = len(done) / self.wall_s
            out["wall_s"] = self.wall_s
        return out


class ServingEngine:
    """Constellation-scale serving over a TDM slot schedule."""

    def __init__(
        self,
        slots: Sequence[Relation],
        n_nodes: int,
        gateways: Sequence[int],
        fleet: ReplicaFleet,
        *,
        slot_durations: Optional[Sequence[float]] = None,
        decode_steps_per_slot: int = 1,
        grace_slots: int = 0,
    ):
        if not slots:
            raise ValueError("need a non-empty slot schedule")
        self.base_rels: List[Relation] = list(slots)
        self.epoch = len(self.base_rels)
        self.n_nodes = n_nodes
        self.gateways = sorted(int(g) for g in gateways)
        if not self.gateways:
            raise ValueError("need at least one gateway")
        self.fleet = fleet
        self.replicas = frozenset(fleet.replica_ids)
        bad = self.replicas & set(self.gateways)
        if bad:
            raise ValueError(f"nodes {sorted(bad)} are both gateway and replica")
        self.membership = ReplicaMembership(self.replicas, grace_slots=grace_slots)
        self.alive: set = set(range(n_nodes))
        self.slot_durations = (
            [float(d) for d in slot_durations] if slot_durations else None
        )
        if self.slot_durations is not None and len(self.slot_durations) != self.epoch:
            raise ValueError("slot_durations must align with the slot schedule")
        self.decode_steps_per_slot = decode_steps_per_slot

        self.slot = 0
        self.pending: Dict[int, rq.InferenceRequest] = {}
        self.records: List[SlotRecord] = []
        self._tables: OrderedDict = OrderedDict()
        self._visible_cache: Dict[frozenset, frozenset] = {}
        self._pending_requeues: List[Tuple[int, int]] = []
        self._pending_reemits: List[Tuple[int, int]] = []

    # ------------------------------------------------------------ scenario
    @classmethod
    def from_scenario(
        cls,
        scn,
        fleet: ReplicaFleet,
        *,
        decode_steps_per_slot: int = 1,
        grace_slots: int = 0,
    ) -> "ServingEngine":
        """Wire an engine onto a :class:`~repro_torch.constellation.scenario.
        Scenario`: TDM slots from the cached schedule, gateways = ground
        stations, simulated wall clock from the per-slot durations."""
        sched = scn.schedule()
        return cls(
            list(sched.tdm),
            scn.n_nodes,
            sorted(scn.ground_ids),
            fleet,
            slot_durations=[s.duration_s for s in sched.slots],
            decode_steps_per_slot=decode_steps_per_slot,
            grace_slots=grace_slots,
        )

    # ------------------------------------------------------------- routing
    def _table(self, sinks: frozenset) -> Optional[routing.RoutingTable]:
        """Earliest-delivery DP table for the current alive set, LRU-cached
        per (alive, sinks) — the MultiWindowRouter caching discipline."""
        if not sinks:
            return None
        key = (frozenset(self.alive), sinks)
        rec = telemetry.get_recorder()
        table = self._tables.get(key)
        if table is not None:
            self._tables.move_to_end(key)
            rec.counter("serve.router.table_cache.hit")
            return table
        rec.counter("serve.router.table_cache.miss")
        rels = [r.restrict(self.alive) for r in self.base_rels]
        table = routing.earliest_delivery_routes(rels, self.n_nodes, sinks)
        self._tables[key] = table
        while len(self._tables) > TABLE_CACHE_MAX:
            self._tables.popitem(last=False)
        return table

    def _visible_replicas(self) -> frozenset:
        """Replicas alive and present on at least one slot of the epoch's
        restricted contact graph — the visibility signal membership eats."""
        key = frozenset(self.alive)
        vis = self._visible_cache.get(key)
        if vis is None:
            seen: set = set()
            for rel in self.base_rels:
                seen |= rel.restrict(key).participants() & self.replicas
            vis = frozenset(seen & key)
            self._visible_cache[key] = vis
        return vis

    # --------------------------------------------------------------- churn
    def fail(self, node: int) -> None:
        """Kill a satellite mid-run: re-route, never lose.

        Payloads held *at* the dead node re-inject at their origin gateway
        (a response whose replica is also gone restarts decode from
        scratch); if the node is a replica its batch drains. Routing
        tables for the new alive set build lazily on next use."""
        node = int(node)
        if node in self.gateways:
            raise ValueError("ground stations do not fail in this model")
        if node not in self.alive:
            return
        self.alive.discard(node)
        telemetry.get_recorder().counter("serve.churn.failed")
        self._refresh_membership()
        for req in list(self.pending.values()):
            if req.status in (rq.UPLINK, rq.QUEUED) and req.node == node:
                self._requeue(req)
            elif req.status == rq.DOWNLINK and req.node == node:
                # The response payload died with its relay. Re-emit it at
                # the replica that decoded it if that replica still serves;
                # otherwise the whole request restarts.
                if (
                    req.replica is not None
                    and req.replica in self.alive
                    and req.replica in self.membership.active
                ):
                    req.node = req.replica
                    self._pending_reemits.append((req.rid, req.replica))
                    telemetry.get_recorder().counter("serve.requests.reemitted")
                else:
                    self._requeue(req)

    def restore(self, node: int) -> None:
        """Bring a satellite back; membership re-admits it after grace."""
        self.alive.add(int(node))
        telemetry.get_recorder().counter("serve.churn.restored")
        self._refresh_membership()

    def _refresh_membership(self) -> None:
        delta = self.membership.update(self._visible_replicas())
        for sat in sorted(delta.drained):
            for req in self.fleet.drain(sat):
                self._requeue(req)
        if delta.admitted:
            telemetry.get_recorder().counter(
                "serve.churn.readmitted", len(delta.admitted)
            )
        telemetry.set_gauge(
            "serve.replicas.active", float(len(self.membership.active))
        )

    def _requeue(self, req: rq.InferenceRequest) -> None:
        pulled_from = req.node if req.node is not None else req.gateway
        req.requeue()
        self._pending_requeues.append((req.rid, int(pulled_from)))
        telemetry.get_recorder().counter("serve.requests.requeued")

    # ---------------------------------------------------------------- step
    def submit(self, req: rq.InferenceRequest) -> None:
        """Inject a request at its gateway (counted from the current slot)."""
        req.submitted_slot = self.slot
        req.status = rq.QUEUED
        req.node = req.gateway
        self.pending[req.rid] = req
        telemetry.get_recorder().counter("serve.requests.submitted")

    def step(self) -> bool:
        """Advance one engine slot. Returns True while work remains.

        Under tracing, the slot is a ``serve.slot`` span holding three spans,
        device spans where the decoder has a device: ``serve.route`` (the
        transport), ``serve.admit`` (admission, with its prefill) and
        ``serve.tick`` (the decode ticks)."""
        s, t = self.slot, self.slot % self.epoch
        rec = telemetry.get_recorder()
        sends: List[Send] = []
        delivered: List[int] = []
        admitted_rids: List[int] = []
        dev = getattr(self.fleet.decoder, "device", None)  # None: a host decoder

        with rec.span("serve.slot", cat="serve", slot=s):
            self._refresh_membership()
            serving = frozenset(self.membership.active & self.alive)

            # --- transport: snapshot positions, then move (≤1 hop/payload)
            with rec.span("serve.route", cat="serve", device=dev):
                up = self._table(serving)
                movers = [
                    r
                    for r in self.pending.values()
                    if r.status in (rq.QUEUED, rq.UPLINK, rq.DOWNLINK)
                    and r.node is not None
                ]
                for req in movers:
                    if req.status == rq.DOWNLINK:
                        table = self._table(frozenset((req.gateway,)))
                    else:
                        table = up
                    if table is None:
                        continue
                    nxt = table.policy[t][req.node]
                    if nxt is None:
                        continue
                    sends.append(Send(s, req.node, nxt, _kind(req), req.rid))
                    req.node = nxt
                    if req.status == rq.DOWNLINK:
                        req.hops_down += 1
                        if nxt == req.gateway:
                            self._deliver(req, s)
                            delivered.append(req.rid)
                    else:
                        req.hops_up += 1
                        req.status = rq.UPLINK
                        if nxt in serving:
                            req.status = rq.ROUTED
                            req.replica = nxt
                            if req.routed_slot < 0:
                                req.routed_slot = s
                            self.fleet.enqueue(nxt, req)
                            rec.counter("serve.requests.routed")

            # --- admission: idle in-service replicas start a wave
            with rec.span("serve.admit", cat="serve", device=dev):
                for sat, wave in self.fleet.admit(serving).items():
                    for req in wave:
                        req.status = rq.DECODING
                        req.admitted_slot = s
                        req.first_token_slot = s
                        admitted_rids.append(req.rid)
                        rec.counter("serve.requests.admitted")
                        telemetry.observe(
                            "serve.ttft_slots", req.ttft_slots, buckets=COUNT_BUCKETS
                        )
                        if req.done:          # max_new == 1: done at prefill
                            self._complete(req, s)

            # --- decode ticks
            with rec.span("serve.tick", cat="serve", device=dev):
                for _ in range(self.decode_steps_per_slot):
                    for sat, reqs in self.fleet.tick().items():
                        for req in reqs:
                            self._complete(req, s)

            # --- per-slot instrumentation
            depth = sum(
                1 for r in self.pending.values() if r.status == rq.QUEUED
            ) + sum(self.fleet.queued(sat) for sat in self.fleet.replica_ids)
            telemetry.observe("serve.queue_depth", depth, buckets=COUNT_BUCKETS)
            telemetry.set_gauge("serve.fleet.occupancy", self.fleet.occupancy())

        self.records.append(
            SlotRecord(
                slot=s,
                t=t,
                alive=frozenset(self.alive),
                active_replicas=serving,
                sends=tuple(sends),
                requeued=tuple(self._pending_requeues),
                reemitted=tuple(self._pending_reemits),
                delivered=tuple(delivered),
                admitted=tuple(admitted_rids),
            )
        )
        self._pending_requeues = []
        self._pending_reemits = []
        self.slot += 1
        return bool(self.pending)

    def _complete(self, req: rq.InferenceRequest, s: int) -> None:
        req.status = rq.DOWNLINK          # enters transport next slot
        req.node = req.replica
        req.completed_slot = s
        telemetry.get_recorder().counter("serve.requests.completed")

    def _deliver(self, req: rq.InferenceRequest, s: int) -> None:
        req.status = rq.DELIVERED
        req.delivered_slot = s
        req.node = None
        self.pending.pop(req.rid, None)
        rec = telemetry.get_recorder()
        rec.counter("serve.requests.delivered")
        rec.counter("serve.tokens.delivered", len(req.out))
        telemetry.observe(
            "serve.latency_slots", req.latency_slots, buckets=COUNT_BUCKETS
        )
        telemetry.observe("serve.retries", req.retries, buckets=AGE_BUCKETS)

    # ----------------------------------------------------------------- run
    def run(
        self,
        workload: Sequence[rq.InferenceRequest],
        *,
        max_slots: Optional[int] = None,
        on_slot: Optional[Callable[["ServingEngine", int], None]] = None,
    ) -> ServeReport:
        """Drive a workload to completion (or the slot budget).

        ``on_slot(engine, slot)`` runs before each slot — the hook scripted
        churn (``engine.fail`` / ``engine.restore``) plugs into."""
        by_arrival: Dict[int, List[rq.InferenceRequest]] = {}
        for req in workload:
            by_arrival.setdefault(req.arrival_slot, []).append(req)
        last_arrival = max(by_arrival) if by_arrival else 0
        budget = max_slots if max_slots is not None else 50 * self.epoch
        while self.slot < budget:
            if on_slot is not None:
                on_slot(self, self.slot)
            for req in by_arrival.pop(self.slot, ()):
                self.submit(req)
            busy = self.step()
            if not busy and self.slot > last_arrival and not by_arrival:
                break
        wall = 0.0
        if self.slot_durations is not None:
            full, rem = divmod(self.slot, self.epoch)
            wall = full * sum(self.slot_durations) + sum(self.slot_durations[:rem])
        return ServeReport(
            n_slots=self.slot,
            epoch_slots=self.epoch,
            requests=list(workload),
            records=list(self.records),
            wall_s=wall,
        )


def _kind(req: rq.InferenceRequest) -> str:
    return "resp" if req.status == rq.DOWNLINK else "req"


__all__ = ["Send", "ServeReport", "ServingEngine", "SlotRecord", "TABLE_CACHE_MAX"]
