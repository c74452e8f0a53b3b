"""TDM schedules: sequences of per-slot exchange relations.

Two schedule families correspond to the paper's two primitives:

- ``round_robin_tournament(n)`` — the paper's get1meas evaluation schedule: a
  clique decomposed into perfect matchings via the circle method, one pairwise
  matching per time slot (single-antenna satellites).
- ``clique_multilink(n)`` — the paper's getMeas evaluation schedule: the whole
  clique relation in ONE slot; every node lists all other node IDs as peers
  (multi-antenna satellites, simultaneous links).

Between these extremes, ``edge_coloring`` decomposes an arbitrary exchange
relation R into matchings (Misra–Gries, ≤ Δ+1 colors by Vizing's theorem).
The number of colors used = number of antennas a satellite needs to realize R
in a single slot; a schedule generator can also respect *per-node* antenna
budgets by splitting R across slots (``antenna_constrained``).

Time-varying visibility relations for real constellations are produced by
the :mod:`repro_torch.constellation` subsystem (orbital propagation, Earth
occlusion, link budgets) — start from
``repro_torch.constellation.scenario.build_scenario``. The old
``WalkerConstellation`` duty-cycle toy was removed (module ``__getattr__``
below raises a hard ImportError with the migration hint).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


from repro_torch.core.relation import Relation

Pair = Tuple[int, int]


@dataclass(frozen=True)
class TDMSchedule:
    """A sequence of per-slot exchange relations R_1 .. R_T."""

    slots: Tuple[Relation, ...]

    def __post_init__(self):
        for t, r in enumerate(self.slots):
            if not r.is_valid_exchange():
                raise ValueError(f"slot {t}: not a valid exchange relation")

    def __len__(self) -> int:
        return len(self.slots)

    def __iter__(self):
        return iter(self.slots)

    def __getitem__(self, t: int) -> Relation:
        return self.slots[t]

    def union(self) -> Relation:
        """All exchanges realized over the schedule (ignoring multiplicity)."""
        out = Relation.empty()
        for r in self.slots:
            out = out | r
        return out

    def total_pairs(self) -> int:
        return sum(len(r) for r in self.slots)

    def max_antennas(self) -> int:
        """Max simultaneous links any node needs in any single slot."""
        return max((r.max_degree() for r in self.slots), default=0)

    def restrict(self, alive: Iterable[int]) -> "TDMSchedule":
        """Elastic rescheduling after node failure (paper skip-slot semantics)."""
        alive = list(alive)
        return TDMSchedule(tuple(r.restrict(alive) for r in self.slots))

    def validate_antennas(
        self, antennas: "int | Dict[int, int]"
    ) -> "TDMSchedule":
        """Check every slot against per-node antenna budgets.

        Raises ``ValueError`` on the first over-subscribed node; returns
        ``self`` so the call chains. Restriction can only shrink degrees, but
        optimizer-produced or hand-edited schedules must be re-checked after
        any transformation — this is that check."""
        for t, r in enumerate(self.slots):
            for v in r.participants():
                cap = antennas if isinstance(antennas, int) else antennas.get(v, 1)
                if r.degree(v) > cap:
                    raise ValueError(
                        f"slot {t}: node {v} needs {r.degree(v)} simultaneous "
                        f"links but has {cap} antennas"
                    )
        return self


# --------------------------------------------------------------------------
# Paper evaluation schedules
# --------------------------------------------------------------------------

def round_robin_tournament(n: int, nodes: Sequence[int] | None = None) -> TDMSchedule:
    """Circle-method round-robin: decomposes K_n into perfect matchings.

    The paper's get1meas schedule: "we generated the schedule as a round robin
    tournament, resulting in a deterministic communication inside time slots
    for every node". For even n this is n-1 slots of n/2 disjoint pairs; for
    odd n it is n slots with one bye per slot.
    """
    if nodes is None:
        nodes = list(range(n))
    nodes = list(nodes)
    if len(nodes) != n:
        raise ValueError("len(nodes) != n")
    bye = None
    if n % 2 == 1:
        bye = object()
        nodes = nodes + [bye]
        n += 1
    half = n // 2
    arr = list(nodes)
    slots: List[Relation] = []
    for _ in range(n - 1):
        edges = []
        for i in range(half):
            a, b = arr[i], arr[n - 1 - i]
            if a is not bye and b is not bye:
                edges.append((a, b))
        slots.append(Relation.from_edges(edges, nodes=[x for x in nodes if x is not bye]))
        # rotate all but the first element
        arr = [arr[0]] + [arr[-1]] + arr[1:-1]
    return TDMSchedule(tuple(slots))


def clique_multilink(n: int, nodes: Sequence[int] | None = None) -> TDMSchedule:
    """The paper's getMeas schedule: one slot, every node peers with all others."""
    if nodes is None:
        nodes = list(range(n))
    return TDMSchedule((Relation.clique(list(nodes)),))


# --------------------------------------------------------------------------
# Edge coloring: R -> matchings  (Misra & Gries, Δ+1 colors)
# --------------------------------------------------------------------------

def edge_coloring(rel: Relation) -> List[Relation]:
    """Decompose a valid exchange relation into matchings.

    Misra–Gries edge coloring (constructive Vizing): any simple graph is edge
    colorable with ≤ Δ+1 colors. Each color class is a matching = one physical
    ppermute / one antenna-pairing round. Falls back to the greedy (≤ 2Δ-1)
    coloring if the Δ+1 invariant is ever violated (defensive; property tests
    exercise the main path).

    Cliques on an even node count are special-cased to the circle-method
    decomposition, which is OPTIMAL (Δ = n-1 colors, vs Misra–Gries' Δ+1):
    one fewer matching = one fewer ppermute on the collective path.
    """
    parts = sorted(rel.participants())
    # O(E) pair-count guard before the O(V^2) clique materialization — at
    # mega-constellation sizes the set build would dominate the coloring.
    if (
        len(parts) % 2 == 0
        and len(parts) >= 2
        and len(rel.pairs) == len(parts) * (len(parts) - 1)
    ):
        want = {(i, j) for i in parts for j in parts if i != j}
        if rel.pairs == frozenset(want):  # exact clique on participants
            return list(round_robin_tournament(len(parts), nodes=parts))
    try:
        matchings = _misra_gries(rel)
    except AssertionError:  # pragma: no cover - defensive fallback
        matchings = greedy_edge_coloring(rel)
    for m in matchings:
        if not m.is_matching():  # pragma: no cover - defensive fallback
            return greedy_edge_coloring(rel)
    return matchings


def _misra_gries(rel: Relation) -> List[Relation]:
    edges = rel.edge_list()
    if not edges:
        return []
    delta = rel.max_degree()
    ncolors = delta + 1
    # adj[u][c] = v  <=>  edge {u,v} has color c
    adj: Dict[int, Dict[int, int]] = {v: {} for v in rel.nodes}

    def free(u: int) -> int:
        for c in range(ncolors):
            if c not in adj[u]:
                return c
        raise AssertionError("no free color (Vizing bound violated)")

    def is_free(u: int, c: int) -> bool:
        return c not in adj[u]

    def set_color(u: int, v: int, c: int) -> None:
        assert is_free(u, c) and is_free(v, c), "color collision"
        adj[u][c] = v
        adj[v][c] = u

    def unset_color(u: int, v: int, c: int) -> None:
        assert adj[u].get(c) == v and adj[v].get(c) == u
        del adj[u][c]
        del adj[v][c]

    def color_of(u: int, v: int):
        for c, w in adj[u].items():
            if w == v:
                return c
        return None

    for (u, v) in edges:
        # 1. Maximal fan F of u starting at v: F[i+1] is the u-neighbor whose
        #    edge color is free on F[i].
        fan = [v]
        while True:
            c = free(fan[-1])
            w = adj[u].get(c)
            if w is None or w in fan:
                break
            fan.append(w)
        c_u = free(u)
        d = free(fan[-1])
        if not is_free(u, d):
            # 2. Invert the maximal (d, c_u)-alternating path starting at u.
            x, col = u, d
            path = []
            seen = {u}
            while col in adj[x]:
                y = adj[x][col]
                if y in seen:  # pragma: no cover - cannot happen on a path
                    break
                path.append((x, y, col))
                seen.add(y)
                x, col = y, (c_u if col == d else d)
            for (a, b, col) in path:
                unset_color(a, b, col)
            for (a, b, col) in path:
                set_color(a, b, c_u if col == d else d)
            assert is_free(u, d), "path inversion must free d at u"
        # 3. Truncate the fan at the first w with d free (prefix of a fan that
        #    satisfies the fan property after inversion).
        k = None
        for i, w in enumerate(fan):
            if is_free(w, d):
                # verify prefix fan property still holds up to i
                ok = True
                for j in range(i):
                    cj = color_of(u, fan[j + 1])
                    if cj is None or not is_free(fan[j], cj):
                        ok = False
                        break
                if ok:
                    k = i
                    break
        assert k is not None, "Misra–Gries: no rotatable fan prefix"
        fan = fan[: k + 1]
        # 4. Rotate the fan: shift each colored edge (u, F[j+1])'s color onto
        #    (u, F[j]); the last edge (u, F[k]) takes color d.
        for j in range(len(fan) - 1):
            cj = color_of(u, fan[j + 1])
            unset_color(u, fan[j + 1], cj)
            set_color(u, fan[j], cj)  # (u, fan[j]) is uncolored at this point
        set_color(u, fan[-1], d)

    by_color: Dict[int, List[Tuple[int, int]]] = {}
    seen_pairs = set()
    for uu in adj:
        for c, vv in adj[uu].items():
            e = (min(uu, vv), max(uu, vv))
            if e not in seen_pairs:
                seen_pairs.add(e)
                by_color.setdefault(c, []).append(e)
    assert seen_pairs == set(edges), "every edge must be colored exactly once"
    matchings = []
    for c in sorted(by_color):
        m = Relation.from_edges(by_color[c], nodes=rel.nodes)
        assert m.is_matching(), f"color class {c} is not a matching"
        matchings.append(m)
    return matchings


def greedy_edge_coloring(rel: Relation) -> List[Relation]:
    """Simple greedy fallback (≤ 2Δ-1 colors). Kept for cross-checking."""
    edges = rel.edge_list()
    color: Dict[Tuple[int, int], int] = {}
    for (u, v) in edges:
        used = {c for e, c in color.items() if u in e or v in e}
        c = 0
        while c in used:
            c += 1
        color[(u, v)] = c
    by_color: Dict[int, List[Tuple[int, int]]] = {}
    for e, c in color.items():
        by_color.setdefault(c, []).append(e)
    return [Relation.from_edges(by_color[c], nodes=rel.nodes) for c in sorted(by_color)]


def weighted_edge_coloring(
    rel: Relation, weights: Dict[Pair, float]
) -> List[Relation]:
    """Rate-aware decomposition: group edges of similar cost into matchings.

    ``weights`` maps undirected edges (i, j), i < j, to a cost (e.g. transfer
    time — higher = slower). Edges are placed slowest-first into the first
    matching with both endpoints free, so slow edges share color classes and
    fast edges are not held hostage by a slot-straggler. Classes come out in
    slowest-first order (≤ 2Δ-1 of them); each is a matching and their union
    is exactly ``rel``. Missing edges weigh 0.
    """
    edges = rel.edge_list()
    if not edges:
        return []
    order = sorted(edges, key=lambda e: (-float(weights.get(e, 0.0)), e))
    classes: List[List[Pair]] = []
    busy: List[set] = []
    for (u, v) in order:
        for cls, used in zip(classes, busy):
            if u not in used and v not in used:
                cls.append((u, v))
                used.update((u, v))
                break
        else:
            classes.append([(u, v)])
            busy.append({u, v})
    return [Relation.from_edges(cls, nodes=rel.nodes) for cls in classes]


def pack_matchings(
    matchings: Sequence[Relation],
    antennas: Dict[int, int],
    nodes: Iterable[int],
) -> List[Relation]:
    """First-fit pack matchings into antenna-feasible slots, in the given
    order — callers control grouping by ordering the matchings (e.g.
    slowest-first from ``weighted_edge_coloring``). A node with a
    zero/negative budget that appears in any matching is a contradiction
    and raises (it could never be placed)."""
    dead = sorted(
        {v for m in matchings for v in m.participants() if antennas.get(v, 1) < 1}
    )
    if dead:
        raise ValueError(
            f"nodes {dead} have edges in R but no antennas; drop them from "
            "the relation first (Relation.restrict)"
        )
    slots: List[List[Relation]] = []
    budgets: List[Dict[int, int]] = []
    for m in matchings:
        placed = False
        for slot, budget in zip(slots, budgets):
            if all(budget.get(v, antennas.get(v, 1)) >= 1 for v in m.participants()):
                slot.append(m)
                for v in m.participants():
                    budget[v] = budget.get(v, antennas.get(v, 1)) - 1
                placed = True
                break
        if not placed:
            slots.append([m])
            budgets.append({v: antennas.get(v, 1) - 1 for v in m.participants()})
    out = []
    for group in slots:
        r = Relation.empty(nodes)
        for m in group:
            r = r | m
        out.append(r)
    return out


def antenna_constrained(
    rel: Relation,
    antennas: Dict[int, int],
    weights: Optional[Dict[Pair, float]] = None,
) -> TDMSchedule:
    """Split R across slots so node v never uses more than antennas[v] links
    per slot. Matchings are packed first-fit into slots; with ``weights``
    (per-edge costs) the rate-aware ``weighted_edge_coloring`` replaces the
    Misra–Gries decomposition, grouping similar-cost edges. A node with a
    zero/negative antenna budget cannot realize any exchange, so its
    presence in R is a contradiction and raises (in ``pack_matchings``)."""
    if weights is None:
        matchings = edge_coloring(rel)
    else:
        matchings = weighted_edge_coloring(rel, weights)
    return TDMSchedule(tuple(pack_matchings(matchings, antennas, rel.nodes)))


# --------------------------------------------------------------------------
# Walker-delta constellation visibility — REMOVED (was a deprecated shim)
# --------------------------------------------------------------------------

def __getattr__(name: str):
    if name == "WalkerConstellation":
        raise ImportError(
            "WalkerConstellation (the duty-cycle toy) was removed: build a "
            "geometry-driven schedule via repro_torch.constellation.scenario."
            "build_scenario(ScenarioSpec(...)).slots() instead."
        )
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


# --------------------------------------------------------------------------
# Ring / torus schedules (hierarchical TDM for the multi-pod mesh)
# --------------------------------------------------------------------------

def ring(n: int, stride: int = 1) -> Relation:
    """Bidirectional ring relation with the given stride (n > 2 for validity;
    n == 2 degenerates to a single pair)."""
    edges = {(min(i, (i + stride) % n), max(i, (i + stride) % n)) for i in range(n)}
    edges = {(a, b) for a, b in edges if a != b}
    return Relation.from_edges(sorted(edges), nodes=range(n))


def hypercube_schedule(n: int) -> TDMSchedule:
    """log2(n) slots of dimension-exchange matchings — the classic gossip
    schedule; after all slots every node's data has propagated everywhere
    (paper Property 2 applied log n times)."""
    if n & (n - 1):
        raise ValueError("hypercube needs power-of-two n")
    slots = []
    for bit in range(n.bit_length() - 1):
        edges = [(i, i ^ (1 << bit)) for i in range(n) if i < (i ^ (1 << bit))]
        slots.append(Relation.from_edges(edges, nodes=range(n)))
    return TDMSchedule(tuple(slots))
