"""Analytic wall-clock / traffic model for TDM exchanges over a plan.

Quantifies the paper's Fig. 3 comparison on *physical* link parameters
instead of testbed wall time: for a slot relation R with per-edge rates,

- ``getmeas`` (multi-antenna): the matchings of R transfer concurrently —
  slot time is the slowest single transfer,
- ``get1meas`` (single-antenna): matchings serialize — slot time is the sum
  of per-matching times.

Both ship the same bytes (every directed pair carries one payload); the
paper's constant-factor gap is exactly the serialization of the coloring.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, Iterable, List, Optional

from repro_torch.constellation.contact_plan import ContactPlan, ContactSchedule
from repro_torch.constellation.links import Edge, Link
from repro_torch.core.relation import Relation
from repro_torch.core.schedule import edge_coloring

_MODES = ("getmeas", "get1meas")


def fresh_edges(prev: Optional[Relation], cur: Relation) -> FrozenSet[Edge]:
    """Edges of ``cur`` that were not active in the previous slot and must
    re-point/acquire before carrying data (undirected (i, j), i < j). With
    no previous slot every edge is fresh."""
    cur_e = frozenset(cur.edge_list())
    if prev is None:
        return cur_e
    return cur_e - frozenset(prev.edge_list())


@dataclass(frozen=True)
class SlotCost:
    time_s: float
    bytes_on_isl: int
    n_matchings: int


@dataclass(frozen=True)
class RoundCost:
    """A whole schedule (or FL round) traversed in one mode."""

    time_s: float
    bytes_on_isl: int
    n_slots: int
    max_slot_s: float

    def __add__(self, other: "RoundCost") -> "RoundCost":
        return RoundCost(
            time_s=self.time_s + other.time_s,
            bytes_on_isl=self.bytes_on_isl + other.bytes_on_isl,
            n_slots=self.n_slots + other.n_slots,
            max_slot_s=max(self.max_slot_s, other.max_slot_s),
        )


def _edge_time_s(
    link: Link, payload_bytes: int, acquisition_s: float = 0.0
) -> float:
    return link.transfer_time_s(payload_bytes, acquisition_s)


def slot_cost(
    rel: Relation,
    links: Dict[Edge, Link],
    payload_bytes: int,
    mode: str = "getmeas",
    fresh: Optional[Iterable[Edge]] = None,
    acquisition_s: float = 0.0,
) -> SlotCost:
    """Cost of exchanging ``payload_bytes`` over relation ``rel`` whose
    physical edges are described by ``links``.

    ``acquisition_s`` charges the slew/acquisition penalty on every edge in
    ``fresh`` (undirected (i, j) keys; ``None`` = all edges fresh) —
    terminals acquire in parallel, so the penalty folds into each edge's
    completion time rather than summing across a matching."""
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
    matchings = edge_coloring(rel)
    if not matchings:
        return SlotCost(time_s=0.0, bytes_on_isl=0, n_matchings=0)
    fresh_s = None if fresh is None else {tuple(e) for e in fresh}

    def acq(e: Edge) -> float:
        if acquisition_s <= 0.0:
            return 0.0
        return acquisition_s if (fresh_s is None or e in fresh_s) else 0.0

    per_matching: List[float] = []
    for m in matchings:
        per_matching.append(
            max(
                _edge_time_s(
                    links[(min(i, j), max(i, j))],
                    payload_bytes,
                    acq((min(i, j), max(i, j))),
                )
                for i, j in m.edge_list()
            )
        )
    time_s = max(per_matching) if mode == "getmeas" else sum(per_matching)
    return SlotCost(
        time_s=time_s,
        bytes_on_isl=payload_bytes * len(rel.pairs),  # one payload per directed pair
        n_matchings=len(matchings),
    )


def plan_cost(
    plan: ContactPlan,
    payload_bytes: int,
    mode: str = "getmeas",
    alive: Optional[Iterable[int]] = None,
) -> RoundCost:
    """Traverse every time step's visibility relation once (one gossip
    exchange per step — the tdm-FL round structure)."""
    alive_s = set(alive) if alive is not None else None
    total = RoundCost(0.0, 0, 0, 0.0)
    for t in range(len(plan.times)):
        rel = plan.relation(t)
        if alive_s is not None:
            rel = rel.restrict(alive_s)
        if len(rel) == 0:
            continue
        sc = slot_cost(rel, plan.graphs[t], payload_bytes, mode)
        total = total + RoundCost(sc.time_s, sc.bytes_on_isl, 1, sc.time_s)
    return total


def schedule_cost(
    sched: ContactSchedule,
    payload_bytes: int,
    mode: str = "getmeas",
    acquisition_s: float = 0.0,
) -> RoundCost:
    """Cost of an antenna-constrained :class:`ContactSchedule`, computed
    from each slot's real per-edge links. Sub-slots produced by the antenna
    splitter always serialize (they exist because the terminals are busy);
    ``mode`` governs concurrency *within* each sub-slot. In ``getmeas``
    mode with the same payload and ``acquisition_s`` the slots were sized
    for, this equals the schedule's ``busy_s`` exactly.

    ``acquisition_s > 0`` prices terminal retargeting: an edge absent from
    the immediately preceding slot pays the slew/acquisition penalty before
    its transfer starts (edges kept warm across consecutive slots pay
    nothing). This is the oracle the schedule optimizer minimizes."""
    total = RoundCost(0.0, 0, 0, 0.0)
    prev: Optional[Relation] = None
    track_fresh = acquisition_s > 0.0
    for slot in sched.slots:
        sc = slot_cost(
            slot.relation,
            slot.links,
            payload_bytes,
            mode,
            fresh=fresh_edges(prev, slot.relation) if track_fresh else None,
            acquisition_s=acquisition_s,
        )
        total = total + RoundCost(sc.time_s, sc.bytes_on_isl, 1, sc.time_s)
        if track_fresh:
            prev = slot.relation
    return total


# ---------------------------------------------------------------------------
# Ground-segment (centralized FL) oracle — centralized vs decentralized
# ---------------------------------------------------------------------------

def _program_cost(
    sched: ContactSchedule, slot_sends, payload_bytes: int
) -> RoundCost:
    """Time/traffic of one store-and-forward program over a schedule window:
    the wall clock runs from the window start to the end of the last slot
    that carries a relay transfer; every directed hop ships ONE payload
    (relay, not exchange — half a gossip edge's traffic)."""
    used = [t for t, sends in enumerate(slot_sends) if sends]
    n_hops = sum(len(sends) for sends in slot_sends)
    if not used:
        return RoundCost(0.0, 0, 0, 0.0)
    last = sched.slots[used[-1]]
    origin = sched.slots[0].start_s
    return RoundCost(
        time_s=last.start_s + last.duration_s - origin,
        bytes_on_isl=payload_bytes * n_hops,
        n_slots=len(used),
        max_slot_s=max(sched.slots[t].duration_s for t in used),
    )


def groundseg_round_cost(
    sched: ContactSchedule,
    uplink,
    downlink,
    payload_bytes: int,
) -> RoundCost:
    """One centralized/hierarchical FL round over the ground segment:
    uplink relay over one schedule window plus downlink broadcast over the
    next identical window (orbits are periodic when the plan horizon is one
    period; inter-sink pooling rides terrestrial backhaul and is free in
    ISL terms, so centralized and hierarchical cost the same here).

    ``uplink``/``downlink`` are the static programs from
    :mod:`repro_torch.groundseg.routing` built on this schedule's slots.
    """
    return _program_cost(sched, uplink.slot_sends, payload_bytes) + _program_cost(
        sched, downlink.slot_sends, payload_bytes
    )


def groundseg_pipelined_cost(
    sched: ContactSchedule,
    uplink,
    downlink,
    payload_bytes: int,
    pipeline_depth: int = 1,
) -> RoundCost:
    """Steady-state per-round cost of a pipelined ground-segment window.

    At depth 1 the uplink and downlink traverse the window sequentially —
    identical to :func:`groundseg_round_cost`. At depth 2 they share ONE
    window on disjoint slot capacity, so the steady-state wall time per
    round is the LONGER of the two program spans (the pipeline's bottleneck
    stage), while ISL traffic and busy slots still sum — that is the
    pipelining win the throughput benchmark measures. ``downlink=None``
    (a depth-2 warm-up window) prices the uplink alone."""
    up = _program_cost(sched, uplink.slot_sends, payload_bytes)
    down = (
        _program_cost(sched, downlink.slot_sends, payload_bytes)
        if downlink is not None
        else RoundCost(0.0, 0, 0, 0.0)
    )
    if pipeline_depth == 1:
        return up + down
    return RoundCost(
        time_s=max(up.time_s, down.time_s),
        bytes_on_isl=up.bytes_on_isl + down.bytes_on_isl,
        n_slots=up.n_slots + down.n_slots,
        max_slot_s=max(up.max_slot_s, down.max_slot_s),
    )


def groundseg_schedule_cost(
    sched: ContactSchedule,
    sinks: Iterable[int],
    payload_bytes: int,
    n_nodes: Optional[int] = None,
    pipeline_depth: int = 1,
    max_staleness_windows: int = 0,
) -> RoundCost:
    """Convenience oracle: route over ``sched`` and price the round — what
    the schedule optimizer minimizes under ``objective="groundseg"``.

    ``pipeline_depth=2`` prices the steady-state pipelined round: the
    multi-window router plans a warm-up window then a steady window whose
    uplink and downlink share capacity, and the steady window's
    :func:`groundseg_pipelined_cost` is returned. ``max_staleness_windows``
    feeds the router so carried payloads (if the geometry strands any)
    shape the steady window exactly as the driver would run it."""
    from repro_torch.groundseg import routing  # lazy: groundseg imports this pkg

    sinks = sorted(int(s) for s in sinks)
    if n_nodes is None:
        n_nodes = max(
            [max(s.relation.participants(), default=0) for s in sched.slots]
            + [max(sinks, default=0)]
        ) + 1
    rels = list(sched.tdm)
    if pipeline_depth == 1 and max_staleness_windows == 0:
        table = routing.earliest_delivery_routes(rels, n_nodes, sinks)
        up = routing.build_relay_program(rels, n_nodes, sinks, table=table)
        down = routing.build_broadcast_program(rels, n_nodes, sinks)
        return groundseg_round_cost(sched, up, down, payload_bytes)
    router = routing.MultiWindowRouter(
        n_nodes,
        sinks,
        max_staleness_windows=max_staleness_windows,
        pipeline_depth=pipeline_depth,
    )
    router.plan_window(rels)          # warm-up (depth 2: no downlink yet)
    wp = router.plan_window(rels)     # steady state
    return groundseg_pipelined_cost(
        sched, wp.uplink, wp.downlink, payload_bytes, pipeline_depth
    )


def groundseg_throughput(
    sched: ContactSchedule,
    sinks: Iterable[int],
    n_nodes: Optional[int] = None,
    pipeline_depth: int = 1,
    max_staleness_windows: int = 0,
) -> Dict[str, float]:
    """Steady-state round throughput of the ground-segment engine.

    The cadence model, from the engine's own semantics: the one-shot
    engine (depth 1) traverses the materialized slot window TWICE per
    round — uplink on one window, downlink on "the next identical window"
    — so it completes one round per two window periods. The pipelined
    engine (depth 2) packs round r's downlink and round r+1's uplink into
    ONE traversal on disjoint slot capacity, completing one round per
    window. Steady-state round throughput is therefore::

        rounds_per_window x delivered_fraction / window_period

    where ``delivered_fraction`` is the share of satellites whose payload
    lands at a sink in the steady window (the uplink plans first, so
    pipelining never costs deliveries; capacity contention shows up in
    ``covered_frac`` — satellites the leftover-capacity downlink misses
    keep their local params and catch a later flood, the usual skip-slot
    semantics). All quantities are static functions of the schedule, so
    this oracle is deterministic and CI-trendable.
    """
    from repro_torch.groundseg import routing  # lazy: groundseg imports this pkg

    sinks = sorted(int(s) for s in sinks)
    if n_nodes is None:
        n_nodes = max(
            [max(s.relation.participants(), default=0) for s in sched.slots]
            + [max(sinks, default=0)]
        ) + 1
    rels = list(sched.tdm)
    n_sats = n_nodes - len(sinks)
    router = routing.MultiWindowRouter(
        n_nodes,
        sinks,
        max_staleness_windows=max_staleness_windows,
        pipeline_depth=pipeline_depth,
    )
    router.plan_window(rels)          # warm-up (depth 2: no downlink yet)
    wp = router.plan_window(rels)     # steady state
    window_s = max(sched.span_s, 1e-9)
    rounds_per_window = 1.0 if pipeline_depth == 2 else 0.5
    delivered = wp.uplink.delivered_count()
    covered = (
        len(wp.downlink.covered - frozenset(sinks))
        if wp.downlink is not None
        else 0
    )
    delivered_frac = delivered / max(n_sats, 1)
    return {
        "window_s": window_s,
        "rounds_per_window": rounds_per_window,
        "delivered": float(delivered),
        "delivered_frac": delivered_frac,
        "covered": float(covered),
        "covered_frac": covered / max(n_sats, 1),
        "carried": float(len(wp.residual)),
        "dropped": float(len(wp.dropped)),
        "round_throughput_per_s": rounds_per_window * delivered_frac / window_s,
    }


def groundseg_mode_costs(
    plan: ContactPlan,
    sinks: Iterable[int],
    payload_bytes: int,
    antennas=None,
    acquisition_s: float = 0.0,
    optimize: Optional[str] = None,
    pipeline_depth: int = 1,
) -> Dict[str, RoundCost]:
    """The centralized-vs-decentralized scoreboard for one plan window:

    - ``centralized`` / ``hierarchical`` — sink-based rounds (uplink relay
      + downlink broadcast; identical ISL cost, they differ only in what
      the sinks do terrestrially),
    - ``gossip_getmeas`` / ``gossip_get1meas`` — the decentralized TDM
      passes over the same materialized schedule.

    This is the oracle ``benchmarks/groundseg_round_time.py`` sweeps and
    the schedule optimizer scores sink-based schedules with.
    ``pipeline_depth=2`` prices the sink-based modes as pipelined rounds
    (steady-state, see :func:`groundseg_pipelined_cost`); the gossip rows
    are unaffected — gossip has no uplink/downlink phases to overlap.
    """
    sched = plan.schedule(
        antennas=antennas,
        payload_bytes=payload_bytes,
        optimize=optimize,
        acquisition_s=acquisition_s,
    )
    central = groundseg_schedule_cost(
        sched, sinks, payload_bytes, n_nodes=plan.n_nodes,
        pipeline_depth=pipeline_depth,
    )
    return {
        "centralized": central,
        "hierarchical": central,
        "gossip_getmeas": schedule_cost(
            sched, payload_bytes, "getmeas", acquisition_s
        ),
        "gossip_get1meas": schedule_cost(
            sched, payload_bytes, "get1meas", acquisition_s
        ),
    }


def fl_round_cost(
    plan: ContactPlan,
    payload_bytes: int,
    compute_s_per_step: float = 0.0,
    mode: str = "getmeas",
) -> RoundCost:
    """One decentralized-FL pass over the plan: local compute each time step
    plus the TDM exchange (paper: local ODTS measurement + getMeas)."""
    comm = plan_cost(plan, payload_bytes, mode)
    return RoundCost(
        time_s=comm.time_s + compute_s_per_step * len(plan.times),
        bytes_on_isl=comm.bytes_on_isl,
        n_slots=comm.n_slots,
        max_slot_s=comm.max_slot_s,
    )
