"""Contact plans: orbital geometry → per-slot exchange relations → TDM.

The pipeline the paper assumes exists but never specifies:

1. propagate the constellation (:mod:`orbits`) over a sample grid,
2. evaluate the weighted visibility graph per step (:mod:`links`),
3. extract contact windows, and
4. emit per-slot :class:`~repro_torch.core.relation.Relation`s that honor
   per-node antenna budgets (reusing ``edge_coloring`` /
   ``antenna_constrained``) with bandwidth-aware slot sizing — a
   :class:`ContactSchedule` whose ``.tdm`` is a plain ``TDMSchedule`` every
   existing collective (``get_meas``/``get1_meas``/gossip) consumes as-is.

Occlusion is handled by construction: a satellite with no line of sight
simply has no pairs in that step's relation, which is exactly the paper's
``odata=None`` skip-slot case (and what ``Relation.restrict`` produces for
failures).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.constellation import links as links_lib
from repro_torch.constellation import orbits as orbits_lib
from repro_torch.constellation.links import Edge, Link, LinkBudget, VisibilityMatrix
from repro_torch.constellation.orbits import Geometry, GroundStation, MultiShell, WalkerDelta
from repro_torch.core.relation import Relation
from repro_torch.core.schedule import TDMSchedule, antenna_constrained
from repro_torch.telemetry import metrics
from repro_torch.telemetry import recorder as telemetry

AntennaSpec = Union[int, Dict[int, int], None]

# A colorer turns one time step's (relation, per-edge links, antenna budget,
# previous emitted sub-slot relation) into an ordered list of sub-slot
# relations. The schedule optimizer supplies rate-aware colorers; ``None``
# means the default Misra–Gries + first-fit antenna packing.
Colorer = Callable[
    [Relation, Dict[Edge, Link], Dict[int, int], Optional[Relation]],
    Sequence[Relation],
]


def _antenna_map(antennas: AntennaSpec, nodes: Iterable[int]) -> Dict[int, int]:
    if antennas is None:
        return {v: 1 for v in nodes}
    if isinstance(antennas, int):
        return {v: antennas for v in nodes}
    return {v: antennas.get(v, 1) for v in nodes}


def plus_grid_candidates(geom: Geometry, cross_plane: bool = True) -> List[Edge]:
    """The +grid ISL candidate set: each satellite's terminals point at its
    intra-plane fore/aft neighbors and (optionally) the same-slot satellite
    in each adjacent plane. Geometry still gates every candidate — a
    candidate pair with the Earth in between produces no contact.

    A :class:`MultiShell` gets the union of its shells' +grids (node ids
    offset per shell); inter-shell ISLs need an explicit candidate list."""
    if isinstance(geom, MultiShell):
        edges: List[Edge] = []
        for off, shell in zip(geom.shell_offsets(), geom.shells):
            edges.extend(
                (a + off, b + off)
                for a, b in plus_grid_candidates(shell, cross_plane)
            )
        return edges
    edges = []
    s = geom.per_plane
    for p in range(geom.planes):
        for k in range(s):
            if s > 1:
                edges.append((geom.node_id(p, k), geom.node_id(p, k + 1)))
            if cross_plane and geom.planes > 1:
                edges.append((geom.node_id(p, k), geom.node_id((p + 1) % geom.planes, k)))
    return sorted({(min(a, b), max(a, b)) for a, b in edges if a != b})


def sat_ground_candidates(geom: Geometry, n_ground: int) -> List[Edge]:
    """Every satellite × ground-station candidate pair (gateway downlinks).

    Ground stations occupy node ids ``geom.total .. geom.total+n_ground-1``
    (the :func:`repro_torch.constellation.orbits.propagate` layout). Combine with
    :func:`plus_grid_candidates` to plan a constellation whose terminals are
    fixed +grid ISLs plus steerable ground feeders — the elevation mask and
    link budget still gate every pair."""
    n = geom.total
    return [(s, n + g) for g in range(n_ground) for s in range(n)]


@dataclass(frozen=True)
class ContactWindow:
    """A maximal interval during which an edge stays feasible."""

    i: int
    j: int
    t_start_s: float
    t_end_s: float
    min_rate_bps: float
    mean_rate_bps: float

    @property
    def duration_s(self) -> float:
        return self.t_end_s - self.t_start_s


@dataclass(frozen=True)
class Slot:
    """One emitted TDM slot: a relation plus its physical sizing."""

    relation: Relation
    t_index: int          # contact-plan time step this slot came from
    start_s: float        # slot start on the wall clock
    duration_s: float     # bandwidth-aware: slowest edge's transfer + delay
    min_rate_bps: float   # bottleneck link rate inside the slot
    max_delay_s: float    # worst one-way propagation delay inside the slot
    links: Dict[Edge, Link] = None  # per-edge physics (keys (i, j), i < j)


@dataclass(frozen=True)
class ContactSchedule:
    """A ``TDMSchedule`` plus per-slot physical metadata (aligned 1:1)."""

    tdm: TDMSchedule
    slots: Tuple[Slot, ...]

    def __post_init__(self):
        if len(self.tdm) != len(self.slots):
            raise ValueError("tdm slots and metadata misaligned")

    def __len__(self) -> int:
        return len(self.slots)

    @property
    def busy_s(self) -> float:
        """Total link-occupied time (sum of slot durations, gaps excluded)."""
        return sum(s.duration_s for s in self.slots)

    @property
    def span_s(self) -> float:
        """Wall-clock span from the first slot's start to the last slot's
        end — includes the idle gaps between contact-plan steps."""
        if not self.slots:
            return 0.0
        last = self.slots[-1]
        return last.start_s + last.duration_s - self.slots[0].start_s

    def max_antennas(self) -> int:
        return self.tdm.max_antennas()

    def restrict(
        self, alive: Iterable[int], antennas: AntennaSpec = None
    ) -> "ContactSchedule":
        """Drop failed/occluded nodes and re-validate the schedule.

        ``TDMSchedule.restrict`` alone is not enough for a materialized
        (possibly optimizer-produced) schedule: the per-slot metadata would
        keep dead edges in ``links`` and stale ``min_rate_bps`` bottlenecks.
        This rebuilds each surviving slot from its surviving links, drops
        slots that went empty, keeps ``tdm`` and ``slots`` aligned, and —
        when ``antennas`` is given — re-validates the per-node budget
        (``TDMSchedule.validate_antennas``). Slot starts/durations are kept:
        the TDM grid was already committed and surviving transfers only get
        faster when a slower edge drops out."""
        alive_s = set(alive)
        slots: List[Slot] = []
        for slot in self.slots:
            r = slot.relation.restrict(alive_s)
            if len(r) == 0:
                continue
            links = {e: slot.links[e] for e in r.edge_list()}
            slots.append(
                dataclasses.replace(
                    slot,
                    relation=r,
                    links=links,
                    min_rate_bps=min(l.rate_bps for l in links.values()),
                    max_delay_s=max(l.delay_s for l in links.values()),
                )
            )
        out = ContactSchedule(
            tdm=TDMSchedule(tuple(s.relation for s in slots)), slots=tuple(slots)
        )
        if antennas is not None:
            parts = {v for s in slots for v in s.relation.participants()}
            out.tdm.validate_antennas(_antenna_map(antennas, parts))
        return out


def link_accounting(
    sched: ContactSchedule, payload_bytes: int
) -> Dict[str, object]:
    """Per-link bytes / busy-time / utilization-vs-capacity over a
    materialized schedule — the link-layer summary mission reports embed.

    For every edge: how many slots it rode, the payload bytes scheduled
    over it, the time it actually spent transferring, and its utilization
    against capacity (scheduled bytes / bytes the link could have carried
    at ``rate_bps`` during the slots it was active in). Utilization well
    below 1.0 marks links the slot sizing leaves idle (slots last as long
    as their slowest member); the schedule-level ``occupancy`` compares
    link-busy time to the full wall-clock span, gaps included. Keys are
    ``"i-j"`` strings so the dict drops straight into a JSON report.
    """
    per: Dict[Edge, Dict[str, float]] = {}
    for slot in sched.slots:
        for e, link in (slot.links or {}).items():
            d = per.setdefault(
                e,
                {"slots": 0, "bytes": 0.0, "busy_s": 0.0, "capacity_bytes": 0.0},
            )
            d["slots"] += 1
            d["bytes"] += float(payload_bytes)
            d["busy_s"] += min(
                link.transfer_time_s(payload_bytes), slot.duration_s
            )
            d["capacity_bytes"] += link.rate_bps * slot.duration_s / 8.0
    for d in per.values():
        d["utilization"] = (
            d["bytes"] / d["capacity_bytes"] if d["capacity_bytes"] > 0 else 0.0
        )
    total_bytes = sum(d["bytes"] for d in per.values())
    utils = [d["utilization"] for d in per.values()]
    return {
        "n_slots": len(sched),
        "n_links": len(per),
        "total_bytes": total_bytes,
        "busy_s": sched.busy_s,
        "span_s": sched.span_s,
        "occupancy": sched.busy_s / sched.span_s if sched.span_s > 0 else 0.0,
        "mean_utilization": sum(utils) / len(utils) if utils else 0.0,
        "min_utilization": min(utils) if utils else 0.0,
        "links": {f"{i}-{j}": d for (i, j), d in sorted(per.items())},
    }


@dataclass(frozen=True)
class ContactPlan:
    """Weighted time-varying visibility over a sample grid.

    ``graphs[t]`` is the feasible-edge map at ``times[t]``; node ids are the
    Walker layout (satellites first, then ground stations).
    """

    n_nodes: int
    times: Tuple[float, ...]
    graphs: Tuple[Dict[Edge, Link], ...]
    step_s: float
    # Batched (T, E) link physics when the plan came through the vectorized
    # pipeline — lets windows() run as an array pass instead of per-step
    # dict scans. Pure acceleration metadata: excluded from equality so a
    # plan with and without it is the same plan.
    matrix: Optional[VisibilityMatrix] = dataclasses.field(
        default=None, compare=False, repr=False
    )

    # -------------------------------------------------- lazy graph backing
    @property
    def _graphs_deferred(self) -> bool:
        """True for a matrix-backed plan built with ``with_graphs=False`` —
        windows/relations/routing run off the arrays; the per-step Link
        dicts only get materialized if something (the scheduler) needs
        them."""
        return (
            not self.graphs
            and self.matrix is not None
            and self.matrix.n_steps > 0
        )

    def with_graphs(self) -> "ContactPlan":
        """Materialize the per-step ``{edge: Link}`` dicts from the matrix
        (no-op when they are already present)."""
        if not self._graphs_deferred:
            return self
        return dataclasses.replace(self, graphs=tuple(self.matrix.graphs()))

    # ----------------------------------------------------------- relations
    def relation(self, t_index: int) -> Relation:
        """The (possibly empty) exchange relation at one time step."""
        if self._graphs_deferred:
            vm = self.matrix
            live = np.flatnonzero(vm.visible[t_index])
            edges = list(zip(vm.iu[live].tolist(), vm.ju[live].tolist()))
            return Relation.from_edges(edges, nodes=range(self.n_nodes))
        return Relation.from_edges(
            sorted(self.graphs[t_index]), nodes=range(self.n_nodes)
        )

    def relations(self) -> List[Relation]:
        """One relation per time step — the time-varying schedule FL loops
        iterate (empty relation = everyone skips the slot)."""
        return [self.relation(t) for t in range(len(self.times))]

    def link(self, t_index: int, i: int, j: int) -> Link:
        return self.graphs[t_index][(min(i, j), max(i, j))]

    # ------------------------------------------------------------- windows
    def windows(self) -> List[ContactWindow]:
        """Merge per-step feasibility into maximal contact windows.

        With a :class:`VisibilityMatrix` attached this is a run-length pass
        over the ``(T, E)`` feasibility array (per-candidate-edge
        ``flatnonzero``/``diff``); otherwise it falls back to the legacy
        per-step dict scan. Both orders end in the same total sort key, and
        the rate statistics are computed over the identical float sequence,
        so the two paths are bit-identical (equivalence suite asserts it).
        """
        if self.matrix is None:
            return self.windows_reference()
        vm = self.matrix
        if vm.n_candidates == 0 or vm.n_steps == 0:
            return []
        T = vm.n_steps
        # one run-length pass over ALL edges at once: transpose to (E, T),
        # append a False column so every run closes inside its own row, and
        # read run starts/ends off the sign changes of the flattened array
        vis = np.concatenate(
            (vm.visible.T, np.zeros((vm.n_candidates, 1), dtype=bool)), axis=1
        )
        flat = vis.ravel().view(np.int8)
        d = np.diff(flat, prepend=np.int8(0))
        starts = np.flatnonzero(d == 1)
        stops = np.flatnonzero(d == -1)        # exclusive
        rates_t = np.ascontiguousarray(vm.rate_bps.T)  # (E, T) row slices
        iu_l, ju_l = vm.iu.tolist(), vm.ju.tolist()
        out: List[ContactWindow] = []
        for s, p in zip(starts.tolist(), stops.tolist()):
            e, t0 = divmod(s, T + 1)
            t1 = t0 + (p - s) - 1
            rates = rates_t[e, t0 : t1 + 1]
            out.append(
                ContactWindow(
                    i=iu_l[e],
                    j=ju_l[e],
                    t_start_s=self.times[t0],
                    t_end_s=self.times[t1] + self.step_s,
                    min_rate_bps=float(rates.min()),
                    mean_rate_bps=float(np.mean(rates)),
                )
            )
        out.sort(key=lambda w: (w.t_start_s, w.i, w.j))
        return out

    def windows_reference(self) -> List[ContactWindow]:
        """The legacy per-step dict-scan window extraction, retained as the
        equivalence oracle for the run-length fast path."""
        open_: Dict[Edge, List] = {}   # edge -> [t_start_idx, rates]
        out: List[ContactWindow] = []

        def close(edge: Edge, start_idx: int, end_idx: int, rates: List[float]):
            out.append(
                ContactWindow(
                    i=edge[0],
                    j=edge[1],
                    t_start_s=self.times[start_idx],
                    t_end_s=self.times[end_idx] + self.step_s,
                    min_rate_bps=min(rates),
                    mean_rate_bps=float(np.mean(rates)),
                )
            )

        for t, graph in enumerate(self.graphs):
            for edge, link in graph.items():
                if edge in open_:
                    open_[edge][2].append(link.rate_bps)
                    open_[edge][1] = t
                else:
                    open_[edge] = [t, t, [link.rate_bps]]
            for edge in [e for e in open_ if e not in graph]:
                start, end, rates = open_.pop(edge)
                close(edge, start, end, rates)
        for edge, (start, end, rates) in sorted(open_.items()):
            close(edge, start, end, rates)
        out.sort(key=lambda w: (w.t_start_s, w.i, w.j))
        return out

    # ------------------------------------------------------------ schedule
    def iter_slots(
        self,
        antennas: AntennaSpec = None,
        payload_bytes: int = 1 << 20,
        alive: Optional[Iterable[int]] = None,
        acquisition_s: float = 0.0,
        colorer: Optional[Colorer] = None,
    ) -> Iterator[Slot]:
        """Stream TDM slots in wall-clock order (lazy — no materialization).

        Each time step's visibility relation is split by
        ``antenna_constrained`` into sub-slots a node's terminal count can
        realize; each sub-slot is sized so the payload clears the slowest
        link it contains (plus one-way propagation). Dead/occluded nodes are
        dropped via ``Relation.restrict`` (paper skip-slot semantics).

        ``acquisition_s > 0`` prices terminal retargeting: an edge that was
        not active in the immediately preceding sub-slot pays the slew/
        acquisition penalty before its transfer (warm edges pay nothing).
        ``colorer`` swaps the default decomposition for a rate-aware one
        (see :mod:`repro_torch.constellation.optimizer`); its output is validated
        against the antenna budget.
        """
        if self._graphs_deferred:
            # scheduling needs per-edge Link physics — materialize now
            yield from self.with_graphs().iter_slots(
                antennas, payload_bytes, alive, acquisition_s, colorer
            )
            return
        alive_s = set(alive) if alive is not None else None
        cursor = 0.0
        prev_edges: frozenset = frozenset()
        prev_rel: Optional[Relation] = None
        for t in range(len(self.times)):
            rel = self.relation(t)
            if alive_s is not None:
                rel = rel.restrict(alive_s)
            if len(rel) == 0:
                continue
            budget = _antenna_map(antennas, rel.nodes)
            # monotone cursor: sub-slots never overlap, even when the
            # previous step's payload overran its sampling interval (the
            # schedule then runs behind the plan cadence rather than
            # emitting physically impossible concurrent slots)
            cursor = max(cursor, float(self.times[t]))
            if colorer is None:
                subs = list(antenna_constrained(rel, budget))
            else:
                subs = list(colorer(rel, self.graphs[t], budget, prev_rel))
            for sub in subs:
                if len(sub) == 0:
                    continue
                if colorer is not None:
                    for v in sub.participants():
                        if sub.degree(v) > budget.get(v, 1):
                            raise ValueError(
                                f"colorer over-subscribed node {v}: "
                                f"{sub.degree(v)} links > {budget.get(v, 1)} antennas"
                            )
                links = {
                    (i, j): self.link(t, i, j) for i, j in sub.edge_list()
                }
                # slot ends when its slowest transfer lands (acquisition for
                # freshly pointed edges + serialization + propagation) — the
                # getMeas completion time of the sub-slot
                duration = max(
                    l.transfer_time_s(
                        payload_bytes,
                        acquisition_s
                        if acquisition_s > 0.0 and e not in prev_edges
                        else 0.0,
                    )
                    for e, l in links.items()
                )
                # link-layer accounting (default-on, host-side only): slot
                # occupancy plus each edge's busy fraction of the slot it
                # rides — the slot lasts as long as its slowest transfer,
                # so fast links idle for the rest. Counts cover every
                # schedule this plan materializes (the optimizer race
                # streams candidate schedules through here too).
                rec = telemetry.get_recorder()
                rec.counter("contact.slots_emitted")
                rec.counter(
                    "contact.scheduled_bytes", float(payload_bytes) * len(links)
                )
                metrics.observe(
                    "contact.slot_duration_s",
                    duration,
                    buckets=metrics.LOG_BUCKETS,
                    rec=rec,
                )
                metrics.observe(
                    "contact.slot_links",
                    len(links),
                    buckets=metrics.COUNT_BUCKETS,
                    rec=rec,
                )
                for l in links.values():
                    busy = l.transfer_time_s(payload_bytes)
                    metrics.observe(
                        "contact.link_utilization",
                        min(busy / duration, 1.0) if duration > 0 else 1.0,
                        buckets=metrics.UNIT_BUCKETS,
                        rec=rec,
                    )
                yield Slot(
                    relation=sub,
                    t_index=t,
                    start_s=cursor,
                    duration_s=duration,
                    min_rate_bps=min(l.rate_bps for l in links.values()),
                    max_delay_s=max(l.delay_s for l in links.values()),
                    links=links,
                )
                cursor += duration
                prev_edges = frozenset(links)
                prev_rel = sub

    def schedule(
        self,
        antennas: AntennaSpec = None,
        payload_bytes: int = 1 << 20,
        alive: Optional[Iterable[int]] = None,
        max_slots: Optional[int] = None,
        optimize: Optional[str] = None,
        acquisition_s: float = 0.0,
        colorer: Optional[Colorer] = None,
    ) -> ContactSchedule:
        """Materialize the stream into a validated ``ContactSchedule``.

        ``optimize`` selects the decomposition policy: ``None``/``"greedy"``
        emit the first legal coloring (Misra–Gries + first-fit packing);
        ``"rate"`` searches the full strategy portfolio of
        :func:`repro_torch.constellation.optimizer.optimize_schedule` and returns
        the schedule with the lowest oracle cost (never worse than greedy —
        the greedy schedule is always in the candidate set); any single
        strategy name (``"slow_first"``, ``"mwm"``, ``"overlap"``) races just
        that strategy against greedy."""
        if optimize not in (None, "greedy"):
            if colorer is not None:
                raise ValueError(
                    "colorer and optimize are mutually exclusive: optimize "
                    "selects its own decomposition strategies"
                )
            from repro_torch.constellation.optimizer import optimize_schedule

            return optimize_schedule(
                # materialize once — the race iterates the slots per strategy
                self.with_graphs(),
                antennas=antennas,
                payload_bytes=payload_bytes,
                alive=alive,
                acquisition_s=acquisition_s,
                mode=optimize,
                max_slots=max_slots,
            ).schedule
        slots: List[Slot] = []
        for slot in self.with_graphs().iter_slots(
            antennas, payload_bytes, alive, acquisition_s, colorer
        ):
            slots.append(slot)
            if max_slots is not None and len(slots) >= max_slots:
                break
        return ContactSchedule(
            tdm=TDMSchedule(tuple(s.relation for s in slots)), slots=tuple(slots)
        )


def build_contact_plan(
    geom: Geometry,
    duration_s: float,
    step_s: float,
    budget: LinkBudget = LinkBudget(),
    ground_stations: Sequence[GroundStation] = (),
    candidates: Union[str, Sequence[Edge]] = "all",
    max_range_km: Optional[float] = None,
    min_rate_bps: float = 0.0,
    with_graphs: bool = True,
) -> ContactPlan:
    """Propagate, evaluate links, and package the time-varying graph.

    ``candidates`` is ``"all"`` (any pair may link — phased-array/optical
    gimbal), ``"plus_grid"`` (fixed fore/aft + cross-plane terminals), or an
    explicit edge list. Ground stations (node ids after the satellites)
    participate only in ``"all"`` mode or when listed explicitly; their
    links use the budget's elevation mask instead of limb occlusion.

    ``with_graphs=False`` skips materializing the per-step ``{edge: Link}``
    dicts — at mega-constellation scale building the Link objects costs
    more than the batched physics itself, and windows / relations / routing
    all run straight off the :class:`VisibilityMatrix`. Anything that does
    need the dicts (``schedule``) materializes them lazily via
    :meth:`ContactPlan.with_graphs`.
    """
    times = orbits_lib.sample_times(duration_s, step_s)
    tracks = orbits_lib.propagate(geom, times, ground_stations)
    if isinstance(candidates, str):
        if candidates == "all":
            cand = None
        elif candidates == "plus_grid":
            cand = plus_grid_candidates(geom)
        else:
            raise ValueError(f"unknown candidate mode {candidates!r}")
    else:
        cand = list(candidates)
    ground_nodes = range(geom.total, tracks.shape[1])
    vm = links_lib.visibility_matrix(
        tracks, budget, cand, max_range_km, min_rate_bps, ground_nodes
    )
    return ContactPlan(
        n_nodes=tracks.shape[1],
        times=tuple(float(t) for t in times),
        graphs=tuple(vm.graphs()) if with_graphs else (),
        step_s=float(step_s),
        matrix=vm,
    )


