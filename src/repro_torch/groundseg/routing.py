"""Store-and-forward contact-graph routing over a TDM slot sequence.

The ground-segment subsystem's scheduling core: given the slot relations a
:class:`~repro_torch.constellation.contact_plan.ContactPlan` materialized (each
slot = one parallel TDM exchange opportunity), compute for every satellite
the EARLIEST slot by which its payload can reach a ground sink, allowing
multi-hop ISL relays — classic contact-graph routing (CGR) specialized to
the repo's slot algebra.

The computation is a backward DP over the time-expanded contact graph
rather than an explicit Dijkstra over (node, time) vertices: with ``T``
slots and per-slot relations, ``f[v][t]`` = earliest delivery slot for a
payload held by ``v`` at the *start* of slot ``t``. One hop per slot (a
slot is a single parallel exchange; data received during slot ``t`` can be
forwarded no earlier than slot ``t+1``):

    f[v][t] = min( f[v][t+1],                                  # hold
                   min over {v,u} in slots[t]:
                       t            if u is a sink             # deliver
                       f[u][t+1]    otherwise )                # relay

The DP runs in O(T·(V+E)) and always terminates after T steps, so an
unreachable satellite (no contact path to any sink inside the horizon) is
*reported* (``Route.sink is None``), never spun on. Ties prefer holding
(fewer transmissions) and then the lowest next-hop id, keeping every
product of this module deterministic — the property the paper's
assumption (a) (common knowledge of the schedule) needs so ground and
space segments compute identical plans independently.

On top of the per-(node, time) policy two STATIC programs are derived:

- :func:`build_relay_program` — the uplink: start every (alive, reachable)
  satellite with its own payload, replay the policy, and record the
  directed sends per slot. Payloads merge at shared relays
  (accumulate-and-forward: a carrier ships everything it holds and sheds
  it), so the per-slot digraph has out-degree <= 1 and the sink receives a
  SUM — exactly what FedAvg wants.
- :func:`build_broadcast_program` — the downlink: flood the global model
  from the sinks outward, each uncovered node adopting one covered
  neighbor per slot.

Both programs are pure Python; :mod:`repro_torch.groundseg.aggregation` runs
them as chains of row gathers over the stacked fused flat buffers (one
gather per batch; the reference issues one ``ppermute`` per batch). A batch
has unique sources and unique destinations, the legality rule of a
``ppermute``, kept so that the two count the same exchanges; it is handled by
:func:`permutation_batches`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.relation import Relation
from repro_torch.telemetry import metrics
from repro_torch.telemetry import recorder as telemetry

DirectedEdge = Tuple[int, int]


@dataclass(frozen=True)
class Hop:
    """One scheduled transfer: ``src`` sends to ``dst`` during ``slot``."""

    slot: int
    src: int
    dst: int


@dataclass(frozen=True)
class Route:
    """One satellite's earliest-delivery path to the ground segment."""

    source: int
    sink: Optional[int]            # delivering sink; None = unreachable
    delivery_slot: Optional[int]   # slot whose transfer lands at the sink
    hops: Tuple[Hop, ...]

    @property
    def reachable(self) -> bool:
        return self.sink is not None


@dataclass(frozen=True)
class RoutingTable:
    """Earliest-delivery routes for every source, plus the DP policy."""

    n_nodes: int
    n_slots: int
    sinks: FrozenSet[int]
    routes: Dict[int, Route]
    # policy[t][v]: None = hold, else the neighbor v forwards to in slot t
    policy: Tuple[Tuple[Optional[int], ...], ...]

    def reachable(self) -> List[int]:
        return sorted(s for s, r in self.routes.items() if r.reachable)

    def unreachable(self) -> List[int]:
        return sorted(s for s, r in self.routes.items() if not r.reachable)

    def max_delivery_slot(self) -> Optional[int]:
        """Latest delivery slot over the reachable sources (None if none)."""
        slots = [
            r.delivery_slot for r in self.routes.values() if r.reachable
        ]
        return max(slots) if slots else None


def _neighbors_reference(rel: Relation, v: int) -> List[int]:
    """The pre-adjacency-cache neighbor query — an O(pairs) scan per call,
    exactly as ``Relation.peers_of`` worked before the memoized adjacency
    map. The reference DP keeps it so the retained oracle measures (and
    reproduces) the code the vectorized relaxation actually replaced."""
    return sorted(j for i, j in rel.pairs if i == v)


def _check_sinks_sources(
    n_nodes: int, sinks: Iterable[int], sources: Optional[Iterable[int]]
) -> Tuple[FrozenSet[int], List[int]]:
    sink_s = frozenset(int(s) for s in sinks)
    if not sink_s:
        raise ValueError("need at least one sink node")
    bad = [s for s in sink_s if not (0 <= s < n_nodes)]
    if bad:
        raise ValueError(f"sink ids {bad} outside node range 0..{n_nodes - 1}")
    if sources is None:
        src_list = [v for v in range(n_nodes) if v not in sink_s]
    else:
        src_list = sorted(set(int(s) for s in sources))
    return sink_s, src_list


def _routes_from_policy(
    policy: Sequence[Tuple[Optional[int], ...]],
    f0: Sequence[float],
    src_list: Sequence[int],
    sink_s: FrozenSet[int],
) -> Dict[int, Route]:
    """Walk the DP policy from each source — shared by the vectorized and
    reference DPs (the policy rows fully determine the routes)."""
    T = len(policy)
    routes: Dict[int, Route] = {}
    for s in src_list:
        if s in sink_s:
            routes[s] = Route(source=s, sink=s, delivery_slot=-1, hops=())
            continue
        if not math.isfinite(float(f0[s])):
            routes[s] = Route(source=s, sink=None, delivery_slot=None, hops=())
            continue
        hops: List[Hop] = []
        v = s
        for t in range(T):
            if v in sink_s:
                break
            nxt = policy[t][v]
            if nxt is not None:
                hops.append(Hop(slot=t, src=v, dst=nxt))
                v = nxt
        assert v in sink_s, f"finite DP value but walk missed a sink for {s}"
        routes[s] = Route(
            source=s, sink=v, delivery_slot=hops[-1].slot, hops=tuple(hops)
        )
    return routes


def _dp_policy(
    slots: Sequence[Relation], n_nodes: int, sink_s: FrozenSet[int]
) -> Tuple[Tuple[Tuple[Optional[int], ...], ...], np.ndarray]:
    """The batched backward relaxation: (policy, f[.][0]).

    One segmented-min pass per slot over the slot's sorted directed pairs
    instead of nested Python loops — O(T·(V+E)) NumPy work. The
    hold-on-ties / lowest-next-hop determinism rule is reproduced exactly:
    a node forwards only on a STRICT improvement over holding, and among
    neighbors achieving the minimum the lowest id wins.
    """
    T = len(slots)
    is_sink = np.zeros(n_nodes, dtype=bool)
    is_sink[list(sink_s)] = True
    f_next = np.full(n_nodes, np.inf)
    policy: List[Tuple[Optional[int], ...]] = []
    hold_row = (None,) * n_nodes
    for t in range(T - 1, -1, -1):
        pairs = slots[t].pairs_array()
        if pairs.size == 0:
            policy.append(hold_row)
            continue
        srcs, dsts = pairs[:, 0], pairs[:, 1]
        keep = ~is_sink[srcs]            # sinks never forward
        if not keep.all():
            srcs, dsts = srcs[keep], dsts[keep]
        if srcs.size == 0:
            policy.append(hold_row)
            continue
        # value of forwarding to each neighbor: deliver now (t) at a sink,
        # else the neighbor's own earliest delivery from the next slot on
        val = np.where(is_sink[dsts], float(t), f_next[dsts])
        # pairs_array is (src, dst)-sorted, so each source is one contiguous
        # group: segmented min via reduceat (exact — min is order-free)
        # instead of the much slower buffered ufunc.at scatter
        gs = np.flatnonzero(np.concatenate(([True], srcs[1:] != srcs[:-1])))
        gmin = np.minimum.reduceat(val, gs)
        gsrc = srcs[gs]
        imp = gmin < f_next[gsrc]        # strict: hold preferred on ties
        if not imp.any():
            policy.append(hold_row)
            continue
        # among neighbors achieving the min the lowest dst wins; dsts are
        # ascending within each group, so that is the FIRST index hitting
        # the group minimum
        P = val.size
        counts = np.diff(np.concatenate((gs, [P])))
        at_min = val == np.repeat(gmin, counts)
        first = np.minimum.reduceat(np.where(at_min, np.arange(P), P), gs)
        g_imp = np.flatnonzero(imp)
        move = gsrc[g_imp]
        f_next[move] = gmin[g_imp]
        row = list(hold_row)
        for v, a in zip(move.tolist(), dsts[first[g_imp]].tolist()):
            row[v] = a
        policy.append(tuple(row))
    policy.reverse()
    return tuple(policy), f_next


def earliest_delivery_routes(
    slots: Sequence[Relation],
    n_nodes: int,
    sinks: Iterable[int],
    sources: Optional[Iterable[int]] = None,
) -> RoutingTable:
    """Earliest-delivery contact-graph routes from each source to any sink.

    ``slots`` is the materialized TDM slot sequence (e.g.
    ``ContactSchedule.tdm.slots`` or ``ContactPlan.relations()``);
    ``sources`` defaults to every non-sink node id. A source that IS a sink
    is trivially delivered (empty hop list, ``delivery_slot=-1``).

    The DP runs as a batched array relaxation (:func:`_dp_policy`) —
    bit-identical to :func:`earliest_delivery_routes_reference`, the
    retained legacy nested-loop oracle.
    """
    sink_s, src_list = _check_sinks_sources(n_nodes, sinks, sources)
    policy, f0 = _dp_policy(slots, n_nodes, sink_s)
    routes = _routes_from_policy(policy, f0, src_list, sink_s)
    return RoutingTable(
        n_nodes=n_nodes,
        n_slots=len(slots),
        sinks=sink_s,
        routes=routes,
        policy=policy,
    )


def earliest_delivery_routes_reference(
    slots: Sequence[Relation],
    n_nodes: int,
    sinks: Iterable[int],
    sources: Optional[Iterable[int]] = None,
) -> RoutingTable:
    """The legacy per-slot/per-node/per-neighbor Python DP, retained as the
    equivalence oracle for :func:`earliest_delivery_routes`.

    Faithful to the pre-vectorization implementation including its
    per-call neighbor scan (:func:`_neighbors_reference`) — which is why it
    goes quadratic at mega-constellation scale. Run it on small instances
    (the property suite) or bounded slot prefixes (the benchmark's timed
    twin), not on 1000-satellite horizons."""
    sink_s, src_list = _check_sinks_sources(n_nodes, sinks, sources)
    T = len(slots)

    # backward DP: f_next = f[.][t+1]; policy filled for t = T-1 .. 0
    f_next = [math.inf] * n_nodes
    policy: List[Tuple[Optional[int], ...]] = []
    for t in range(T - 1, -1, -1):
        rel = slots[t]
        f_cur = list(f_next)
        row: List[Optional[int]] = [None] * n_nodes
        for v in range(n_nodes):
            if v in sink_s:
                continue
            best = f_next[v]           # hold (preferred on ties)
            act: Optional[int] = None
            for u in _neighbors_reference(rel, v):
                val = t if u in sink_s else f_next[u]
                if val < best:
                    best, act = val, u
            f_cur[v] = best
            row[v] = act
        f_next = f_cur
        policy.append(tuple(row))
    policy.reverse()

    routes = _routes_from_policy(policy, f_next, src_list, sink_s)
    return RoutingTable(
        n_nodes=n_nodes,
        n_slots=T,
        sinks=sink_s,
        routes=routes,
        policy=tuple(policy),
    )


# ---------------------------------------------------------------------------
# Static uplink / downlink programs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RelayProgram:
    """The uplink as a static per-slot directed-send plan.

    ``slot_sends[t]`` holds ``(src, dst)`` transfers for slot ``t`` — src
    ships its ENTIRE accumulated payload and sheds it (out-degree <= 1 per
    node per slot by construction; fan-in merges at the receiver).
    ``delivered[k]`` is the set of payload ids (source satellites) landing
    at sink ``k``; ``unreachable`` the holders with no route this window;
    ``residual[h]`` the payload ids stranded at holder ``h`` when the
    window ends — always a subset of the unreachable holders' loads, since
    a payload only moves along a route that delivers it within the window
    (the delay-tolerant invariant the multi-window router relies on).
    """

    n_nodes: int
    sinks: FrozenSet[int]
    slot_sends: Tuple[Tuple[DirectedEdge, ...], ...]
    delivered: Dict[int, FrozenSet[int]]
    unreachable: FrozenSet[int]
    residual: Dict[int, FrozenSet[int]] = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.residual is None:
            object.__setattr__(self, "residual", {})

    @property
    def n_hops(self) -> int:
        return sum(len(s) for s in self.slot_sends)

    def delivered_count(self) -> int:
        return sum(len(v) for v in self.delivered.values())

    def residual_count(self) -> int:
        return sum(len(v) for v in self.residual.values())

    def last_used_slot(self) -> Optional[int]:
        used = [t for t, s in enumerate(self.slot_sends) if s]
        return max(used) if used else None


def build_relay_program(
    slots: Sequence[Relation],
    n_nodes: int,
    sinks: Iterable[int],
    sources: Optional[Iterable[int]] = None,
    table: Optional[RoutingTable] = None,
    initial_loads: Optional[Dict[int, Iterable[int]]] = None,
) -> RelayProgram:
    """Replay the routing policy with every reachable holder injecting its
    payload(s) at slot 0, merging payloads that meet at a relay.

    ``initial_loads`` maps holder node -> payload ids it starts the window
    with (default: every source holds exactly its own payload). Loads held
    by a sink are trivially delivered; loads at holders with no route stay
    put and come back in ``residual`` — the carry the multi-window router
    re-schedules next window.
    """
    if initial_loads is not None and sources is None:
        sources = sorted(initial_loads)
    if table is None:
        table = earliest_delivery_routes(slots, n_nodes, sinks, sources)
    sink_s = table.sinks
    if initial_loads is None:
        initial_loads = {
            s: {s} for s in table.routes if s not in sink_s
        }
    carrying: Dict[int, set] = {}
    delivered: Dict[int, set] = {k: set() for k in sorted(sink_s)}
    unreachable = set()
    residual: Dict[int, set] = {}
    for h, load in sorted(initial_loads.items()):
        load = set(load)
        if not load:
            continue
        if h in sink_s:
            delivered[h] |= load            # already on the ground
            continue
        route = table.routes.get(h)
        if route is None or not route.reachable:
            unreachable.add(h)
            residual[h] = load              # holds; re-scheduled next window
            continue
        carrying.setdefault(h, set()).update(load)
    slot_sends: List[Tuple[DirectedEdge, ...]] = []
    for t in range(table.n_slots):
        outgoing: Dict[int, int] = {}
        for v in sorted(carrying):
            if not carrying[v]:
                continue
            nxt = table.policy[t][v]
            if nxt is not None:
                outgoing[v] = nxt
        loads = {v: carrying[v] for v in outgoing}
        for v in outgoing:
            carrying[v] = set()
        for v, u in outgoing.items():
            if u in sink_s:
                delivered[u] |= loads[v]
            else:
                carrying.setdefault(u, set()).update(loads[v])
        slot_sends.append(tuple(sorted(outgoing.items())))
    leftover = {v for v, load in carrying.items() if load}
    assert not leftover, (
        f"relay left payloads stranded at {sorted(leftover)} — the routing "
        "policy must deliver every reachable holder inside the horizon"
    )
    return RelayProgram(
        n_nodes=n_nodes,
        sinks=sink_s,
        slot_sends=tuple(slot_sends),
        delivered={k: frozenset(v) for k, v in delivered.items()},
        unreachable=frozenset(unreachable),
        residual={h: frozenset(v) for h, v in residual.items()},
    )


@dataclass(frozen=True)
class BroadcastProgram:
    """The downlink as a static per-slot directed-send plan.

    Flood from the sinks: ``slot_sends[t]`` holds ``(src, dst)`` where a
    covered ``src`` hands the model to an uncovered ``dst`` (one parent per
    receiver; a node covered during slot ``t`` first forwards in ``t+1``).
    ``covered`` is every node holding the model at horizon end (sinks
    included); satellites outside it keep their local params — the paper's
    skip-slot semantics on the downlink side.
    """

    n_nodes: int
    sinks: FrozenSet[int]
    slot_sends: Tuple[Tuple[DirectedEdge, ...], ...]
    covered: FrozenSet[int]
    receive_slot: Dict[int, int]

    @property
    def n_hops(self) -> int:
        return sum(len(s) for s in self.slot_sends)

    def last_used_slot(self) -> Optional[int]:
        used = [t for t, s in enumerate(self.slot_sends) if s]
        return max(used) if used else None


def build_broadcast_program(
    slots: Sequence[Relation],
    n_nodes: int,
    sinks: Iterable[int],
) -> BroadcastProgram:
    """Earliest-arrival flood of the global model from the sinks."""
    sink_s = frozenset(int(s) for s in sinks)
    if not sink_s:
        raise ValueError("need at least one sink node")
    have = set(sink_s)
    slot_sends: List[Tuple[DirectedEdge, ...]] = []
    receive_slot: Dict[int, int] = {}
    for t, rel in enumerate(slots):
        new: Dict[int, int] = {}
        for v in sorted(rel.participants()):
            if v in have:
                continue
            parents = [u for u in rel.peers_of(v) if u in have]
            if parents:
                new[v] = min(parents)
        for v, p in new.items():
            receive_slot[v] = t
        have |= set(new)
        slot_sends.append(tuple(sorted((p, v) for v, p in new.items())))
    return BroadcastProgram(
        n_nodes=n_nodes,
        sinks=sink_s,
        slot_sends=tuple(slot_sends),
        covered=frozenset(have),
        receive_slot=receive_slot,
    )


# ---------------------------------------------------------------------------
# ppermute-legal batching
# ---------------------------------------------------------------------------

def permutation_batches(
    edges: Sequence[DirectedEdge],
) -> List[Tuple[DirectedEdge, ...]]:
    """Split directed sends into ppermute-legal batches.

    A ``ppermute`` (the reference's collective) requires unique sources AND
    unique destinations per call, and the port's row gathers keep the same
    batches; a slot's send set can violate either (fan-in at a relay on
    the uplink, fan-out at a broadcaster on the downlink). First-fit in
    the given order keeps the result deterministic; the batch count is
    bounded by the max in/out multiplicity, which the antenna budget
    already bounded at schedule time."""
    batches: List[List[DirectedEdge]] = []
    srcs: List[set] = []
    dsts: List[set] = []
    for s, d in edges:
        for batch, bs, bd in zip(batches, srcs, dsts):
            if s not in bs and d not in bd:
                batch.append((s, d))
                bs.add(s)
                bd.add(d)
                break
        else:
            batches.append([(s, d)])
            srcs.append({s})
            dsts.append({d})
    return [tuple(b) for b in batches]


def program_batch_count(
    program: "RelayProgram | BroadcastProgram",
) -> int:
    """Total ppermute batches a program lowers to (per payload buffer) —
    the static count the drivers hold the issued gathers against."""
    return sum(len(permutation_batches(s)) for s in program.slot_sends if s)


# ---------------------------------------------------------------------------
# Multi-window pipelined rounds with delay-tolerant payload persistence
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DroppedPayload:
    """A payload that aged past the staleness horizon and was discarded."""

    window: int     # window in which the drop happened
    source: int     # satellite whose snapshot it was
    age: int        # windows since the snapshot was taken (> horizon)


@dataclass(frozen=True)
class WindowProgram:
    """Everything one plan window executes, statically derived.

    ``uplink`` relays this window's payloads (fresh snapshots from
    ``injected`` plus carried-over stale ones) toward the sinks;
    ``downlink`` floods a global model back out — at pipeline depth 2 it is
    the PREVIOUS round's global (``lagged_downlink``) riding slot capacity
    the uplink left free, and it is ``None`` on the very first window (no
    global exists yet). ``ages[s]`` is payload ``s``'s age in windows at
    the start of this window (0 = snapshotted now); ``delivered_ages`` /
    ``residual`` split it by outcome, and ``dropped`` reports payloads that
    aged past the staleness horizon and were discarded this window.
    """

    window: int
    uplink: RelayProgram
    downlink: Optional[BroadcastProgram]
    lagged_downlink: bool
    injected: FrozenSet[int]
    ages: Dict[int, int]
    delivered_ages: Dict[int, int]
    residual: Dict[int, int]
    dropped: Dict[int, int]

    def max_delivered_age(self) -> int:
        return max(self.delivered_ages.values(), default=0)


def remaining_capacity(
    slots: Sequence[Relation], program: RelayProgram
) -> List[Relation]:
    """Each slot's relation minus the undirected edges the relay program
    occupies — the capacity a pipelined downlink may flood over. An ISL
    terminal busy relaying an uplink payload cannot simultaneously carry
    the broadcast, so disjointness is per-edge per-slot."""
    out: List[Relation] = []
    for rel, sends in zip(slots, program.slot_sends):
        used = {(min(s, d), max(s, d)) for s, d in sends}
        keep = [e for e in rel.edge_list() if e not in used]
        out.append(Relation.from_edges(keep, nodes=rel.nodes))
    return out


class MultiWindowRouter:
    """Plans ground-segment windows with payloads persisting across them.

    The delay-tolerant queue discipline (all static Python, so ground and
    space compute identical plans — the paper's assumption (a)):

    - every live satellite holds at most ONE pending payload: the snapshot
      of its params taken the first window it had nothing queued. While it
      is pending the satellite keeps training locally but does not enqueue
      a second snapshot (the next snapshot, taken after delivery, reflects
      all the training in between);
    - a pending payload ages one window per boundary. Because a payload
      only ever moves along a route that delivers it within the window
      (reachable holders ship everything; unreachable ones hold), an
      undelivered payload always sits at its own source — briefly
      unreachable satellites deliver as soon as geometry allows;
    - a payload whose age would exceed ``max_staleness_windows`` is dropped
      AND reported (``WindowProgram.dropped``, :attr:`dropped_log`), and
      its satellite snapshots fresh the same window;
    - at ``pipeline_depth=2`` round r's downlink flood overlaps round
      r+1's uplink relay inside one window, on disjoint slot capacity. The
      uplink plans first (training updates are the scarce resource; a
      satellite the downlink misses simply keeps its local params and
      catches the next flood — the skip-slot semantics already tolerate
      that), the broadcast floods over what remains.

    The DP policy depends only on ``(alive, slots)`` — not on which
    payloads are queued — so repeated windows over the same plan with the
    same alive set (the common steady-state case) reuse a cached policy
    instead of re-running the DP; per-source routes are rebuilt from it in
    O(sources·hops). Hits/misses land on the flight recorder as
    ``groundseg.router.table_cache.{hit,miss}``; the cache is a small
    bounded LRU (a long-running router must not grow without bound).
    """

    TABLE_CACHE_MAX = 8

    def __init__(
        self,
        n_nodes: int,
        sinks: Iterable[int],
        *,
        max_staleness_windows: int = 0,
        pipeline_depth: int = 1,
        dropped_log_max: int = 1024,
    ):
        self.n_nodes = int(n_nodes)
        self.sinks = frozenset(int(s) for s in sinks)
        if not self.sinks:
            raise ValueError("need at least one sink node")
        if max_staleness_windows < 0:
            raise ValueError(
                f"max_staleness_windows must be >= 0, got {max_staleness_windows}"
            )
        if pipeline_depth not in (1, 2):
            raise ValueError(
                "pipeline_depth must be 1 (sequential uplink->downlink) or 2 "
                f"(downlink of round r overlaps uplink of r+1), got {pipeline_depth}"
            )
        if dropped_log_max < 0:
            raise ValueError(
                f"dropped_log_max must be >= 0, got {dropped_log_max}"
            )
        self.max_staleness_windows = int(max_staleness_windows)
        self.pipeline_depth = int(pipeline_depth)
        self._pending: Dict[int, int] = {}   # source -> age of queued payload
        self._window = -1
        # dropped_log keeps the MOST RECENT dropped_log_max drop records (a
        # long-running router must not grow without bound); dropped_total
        # keeps the exact lifetime count regardless of trimming.
        self.dropped_log_max = int(dropped_log_max)
        self.dropped_log: List[DroppedPayload] = []
        self.dropped_total: int = 0
        # (alive, slots) -> (restricted rels, DP policy, f[.][0]); ordered
        # for LRU eviction at TABLE_CACHE_MAX entries
        self._table_cache: Dict[
            Tuple[FrozenSet[int], Tuple[Relation, ...]],
            Tuple[List[Relation], Tuple[Tuple[Optional[int], ...], ...], np.ndarray],
        ] = {}

    def reset_dropped_log(self) -> List[DroppedPayload]:
        """Drain the retained drop records (``dropped_total`` keeps the
        lifetime count). Returns the drained entries, oldest first."""
        out, self.dropped_log = self.dropped_log, []
        return out

    @property
    def window(self) -> int:
        """Index of the last planned window (-1 before the first)."""
        return self._window

    def pending(self) -> Dict[int, int]:
        """Snapshot of the queued payloads (source -> age)."""
        return dict(self._pending)

    def plan_window(
        self,
        slots: Sequence[Relation],
        alive: Optional[Iterable[int]] = None,
    ) -> WindowProgram:
        """Plan the next window over ``slots`` (restricted to ``alive``).

        ``alive`` is re-read per window — the per-window rerouting
        contract: dead satellites drop out of every slot relation, their
        queued payloads hold (and keep aging) until they revive or the
        staleness horizon discards them.
        """
        self._window += 1
        live = (
            set(int(v) for v in alive)
            if alive is not None
            else set(range(self.n_nodes))
        )
        live |= self.sinks
        rec = telemetry.get_recorder()
        cache_key = (frozenset(live), tuple(slots))
        cached = self._table_cache.get(cache_key)
        if cached is not None:
            rec.counter("groundseg.router.table_cache.hit")
            rels, dp_policy, dp_f0 = cached
            # refresh LRU position
            self._table_cache[cache_key] = self._table_cache.pop(cache_key)
        else:
            rec.counter("groundseg.router.table_cache.miss")
            rels = [r.restrict(live) for r in slots]
            dp_policy, dp_f0 = _dp_policy(rels, self.n_nodes, self.sinks)
            self._table_cache[cache_key] = (rels, dp_policy, dp_f0)
            while len(self._table_cache) > self.TABLE_CACHE_MAX:
                self._table_cache.pop(next(iter(self._table_cache)))
        metrics.ratio_gauge(
            "groundseg.router.table_cache.hit_rate",
            rec.get_counter("groundseg.router.table_cache.hit"),
            rec.get_counter("groundseg.router.table_cache.hit")
            + rec.get_counter("groundseg.router.table_cache.miss"),
            rec=rec,
        )

        dropped: Dict[int, int] = {}
        if self._window > 0:
            aged = {s: a + 1 for s, a in self._pending.items()}
            dropped = {
                s: a for s, a in aged.items() if a > self.max_staleness_windows
            }
            self._pending = {
                s: a for s, a in aged.items() if a <= self.max_staleness_windows
            }
            self.dropped_total += len(dropped)
            self.dropped_log.extend(
                DroppedPayload(window=self._window, source=s, age=a)
                for s, a in sorted(dropped.items())
            )
            if len(self.dropped_log) > self.dropped_log_max:
                del self.dropped_log[: len(self.dropped_log) - self.dropped_log_max]

        sat_ids = [v for v in range(self.n_nodes) if v not in self.sinks]
        injected = frozenset(
            v for v in sat_ids if v in live and v not in self._pending
        )
        ages = dict(self._pending)
        ages.update({v: 0 for v in injected})

        table = RoutingTable(
            n_nodes=self.n_nodes,
            n_slots=len(rels),
            sinks=self.sinks,
            routes=_routes_from_policy(
                dp_policy, dp_f0, sorted(ages), self.sinks
            ),
            policy=dp_policy,
        )
        uplink = build_relay_program(
            rels,
            self.n_nodes,
            self.sinks,
            table=table,
            initial_loads={v: {v} for v in sorted(ages)},
        )

        lagged = self.pipeline_depth == 2
        if lagged:
            downlink = (
                None
                if self._window == 0
                else build_broadcast_program(
                    remaining_capacity(rels, uplink), self.n_nodes, self.sinks
                )
            )
        else:
            downlink = build_broadcast_program(rels, self.n_nodes, self.sinks)

        delivered_ids = (
            set().union(*uplink.delivered.values())
            if uplink.delivered
            else set()
        )
        delivered_ages = {s: ages[s] for s in sorted(delivered_ids)}
        residual = {s: ages[s] for s in sorted(ages) if s not in delivered_ids}
        self._pending = dict(residual)
        # mission-control distributions (default-on host dict/bisect work):
        # how deep the routing queue runs per window and how stale payloads
        # are when they land / when they carry over.
        metrics.observe(
            "groundseg.router.queue_depth",
            len(ages),
            buckets=metrics.COUNT_BUCKETS,
            rec=rec,
        )
        metrics.observe(
            "groundseg.router.carried_depth",
            len(residual),
            buckets=metrics.COUNT_BUCKETS,
            rec=rec,
        )
        for age in delivered_ages.values():
            metrics.observe(
                "groundseg.router.payload_age",
                age,
                buckets=metrics.AGE_BUCKETS,
                rec=rec,
            )
        return WindowProgram(
            window=self._window,
            uplink=uplink,
            downlink=downlink,
            lagged_downlink=lagged,
            injected=injected,
            ages=ages,
            delivered_ages=delivered_ages,
            residual=residual,
            dropped=dropped,
        )
