"""The paper's algebraic model of collective TDM data exchange.

Paper §II: a set A = {a_1 .. a_m} of application instances participating in
the TDM data exchange of the current time slot, and a relation R ⊆ A×A with
the semantics ``aRb`` ⇔ *a sends its data to b and receives b's data from b*.
A valid exchange relation is symmetric (exchange needs both directions) and
anti-reflexive (a node does not exchange with itself).

This module makes R a first-class object with the paper's five properties
(P1 inverse, P2 composition/propagation, P3 special properties, P4 symmetric
closure, P5 graph representation) implemented and testable.

Nodes are integers (the paper's node IDs). Everything here is pure Python /
numpy — the JAX lowering lives in :mod:`repro_torch.core.tdm`.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, FrozenSet, Iterable, Iterator, List, Sequence, Set, Tuple

import numpy as np

Pair = Tuple[int, int]


@dataclass(frozen=True)
class Relation:
    """A relation R on a node set, per paper §II.

    ``pairs`` holds ordered pairs (i, j) meaning "i sends to j and receives
    from j". ``nodes`` is the universe A (a node may be in A yet isolated in
    R — the paper's `odata=None` skip case).
    """

    nodes: FrozenSet[int]
    pairs: FrozenSet[Pair]

    # ------------------------------------------------------ adjacency cache
    # Scheduling and routing interrogate a relation many times per slot
    # (peers_of / degree / edge_list in inner loops); recomputing them by
    # scanning ``pairs`` is O(E) per call and turns the contact-plan colorer
    # and the routing DP into O(V·E) per step. The adjacency map is derived
    # once per instance and memoized directly in ``__dict__`` (legal on a
    # frozen dataclass — only ``__setattr__`` is blocked), keeping the
    # public API and the value semantics unchanged.
    def _adjacency(self) -> Dict[int, Tuple[int, ...]]:
        cached = self.__dict__.get("_adj_cache")
        if cached is None:
            by_src: Dict[int, List[int]] = {}
            for i, j in self.pairs:
                by_src.setdefault(i, []).append(j)
            cached = {v: tuple(sorted(ps)) for v, ps in by_src.items()}
            self.__dict__["_adj_cache"] = cached
        return cached

    # ---------------------------------------------------------------- build
    @staticmethod
    def from_pairs(pairs: Iterable[Pair], nodes: Iterable[int] | None = None) -> "Relation":
        ps = frozenset((int(i), int(j)) for i, j in pairs)
        ns = set(nodes) if nodes is not None else set()
        for i, j in ps:
            ns.add(i)
            ns.add(j)
        return Relation(frozenset(ns), ps)

    @staticmethod
    def from_edges(edges: Iterable[Tuple[int, int]], nodes: Iterable[int] | None = None) -> "Relation":
        """Build a valid exchange relation from undirected edges (P5 inverse map)."""
        ps: Set[Pair] = set()
        for a, b in edges:
            if a == b:
                raise ValueError(f"self-edge {a} is not a valid exchange (R is anti-reflexive)")
            ps.add((int(a), int(b)))
            ps.add((int(b), int(a)))
        return Relation.from_pairs(ps, nodes)

    @staticmethod
    def clique(nodes: Sequence[int]) -> "Relation":
        """The paper's R3-style relation: every instance exchanges with all others."""
        return Relation.from_edges(itertools.combinations(nodes, 2), nodes)

    @staticmethod
    def empty(nodes: Iterable[int] = ()) -> "Relation":
        return Relation(frozenset(nodes), frozenset())

    # ------------------------------------------------------------ validity
    def is_valid_exchange(self) -> bool:
        """A relation supports data exchange iff it is symmetric and anti-reflexive."""
        return self.is_symmetric() and self.is_antireflexive()

    def validate(self) -> "Relation":
        if not self.is_antireflexive():
            bad = [p for p in self.pairs if p[0] == p[1]]
            raise ValueError(f"R must be anti-reflexive; got self-pairs {bad}")
        if not self.is_symmetric():
            bad = [(i, j) for (i, j) in self.pairs if (j, i) not in self.pairs]
            raise ValueError(
                f"exchange needs both aRb and bRa (paper §II); one-sided pairs: {bad}"
            )
        return self

    # ------------------------------------------------ P1: inverse relation
    def inverse(self) -> "Relation":
        return Relation(self.nodes, frozenset((j, i) for i, j in self.pairs))

    # ------------------------------------------- P2: composition/propagation
    def compose(self, other: "Relation") -> "Relation":
        """R1 ∘ R2 = {(a, c) : ∃b. aR1b ∧ bR2c}, excluding self-pairs.

        Paper §II.B: compositions of exchange relations model multi-hop data
        propagation. The composition itself need not be a valid exchange
        relation; the union with its reverse composition is (paper's R23).
        """
        by_src: Dict[int, Set[int]] = {}
        for b, c in other.pairs:
            by_src.setdefault(b, set()).add(c)
        out: Set[Pair] = set()
        for a, b in self.pairs:
            for c in by_src.get(b, ()):
                if a != c:
                    out.add((a, c))
        return Relation(self.nodes | other.nodes, frozenset(out))

    def propagation(self, other: "Relation") -> "Relation":
        """The paper's R23 = R1∘R2 ∪ R2∘R1 — a valid exchange relation."""
        return self.compose(other).union(other.compose(self))

    def union(self, other: "Relation") -> "Relation":
        return Relation(self.nodes | other.nodes, self.pairs | other.pairs)

    # --------------------------------------------- P3: special properties
    def is_reflexive(self) -> bool:
        return all((a, a) in self.pairs for a in self.participants())

    def is_antireflexive(self) -> bool:
        return all(i != j for i, j in self.pairs)

    def is_symmetric(self) -> bool:
        return all((j, i) in self.pairs for i, j in self.pairs)

    def is_transitive(self) -> bool:
        by_src: Dict[int, Set[int]] = {}
        for i, j in self.pairs:
            by_src.setdefault(i, set()).add(j)
        return all(
            (a, c) in self.pairs
            for a, b in self.pairs
            for c in by_src.get(b, ())
        )

    def is_antisymmetric(self) -> bool:
        return all(not ((j, i) in self.pairs and i != j) for i, j in self.pairs)

    # --------------------------------------------- P4: symmetric closure
    def symmetric_closure(self) -> "Relation":
        return self.union(self.inverse())

    # ------------------------------------------- P5: graph representation
    def edges(self) -> Set[FrozenSet[int]]:
        """E = {{a, b} : (a, b) ∈ R} (valid because R is symmetric anti-reflexive)."""
        return {frozenset(p) for p in self.pairs}

    def edge_list(self) -> List[Tuple[int, int]]:
        cached = self.__dict__.get("_edge_list_cache")
        if cached is None:
            cached = tuple(
                sorted({(min(a, b), max(a, b)) for a, b in self.pairs})
            )
            self.__dict__["_edge_list_cache"] = cached
        return list(cached)

    def participants(self) -> Set[int]:
        """Nodes that take part in this slot (paper: the set A, m ≤ n)."""
        return set(self._adjacency())

    def peers_of(self, node: int) -> List[int]:
        """The node's `peer_ids` argument to getMeas, in sorted order."""
        return list(self._adjacency().get(node, ()))

    def degree(self, node: int) -> int:
        """Number of simultaneous links node needs = number of antennas used."""
        return len(self._adjacency().get(node, ()))

    def max_degree(self) -> int:
        return max((len(ps) for ps in self._adjacency().values()), default=0)

    def pairs_array(self) -> np.ndarray:
        """The directed pairs as a sorted (P, 2) intp array — the form the
        vectorized routing DP consumes. Memoized like the adjacency map
        (ascending (src, dst) order, so scatter-min tie-breaks reproduce the
        legacy ascending-neighbor iteration)."""
        arr = self.__dict__.get("_pairs_array_cache")
        if arr is None:
            if self.pairs:
                # chain.from_iterable keeps the flattening in C — a Python
                # genexpr here dominated the whole routing DP at mega scale
                flat = np.fromiter(
                    itertools.chain.from_iterable(self.pairs),
                    dtype=np.intp,
                    count=2 * len(self.pairs),
                )
                arr = flat.reshape(-1, 2)
                arr = arr[np.lexsort((arr[:, 1], arr[:, 0]))]
            else:
                arr = np.empty((0, 2), dtype=np.intp)
            self.__dict__["_pairs_array_cache"] = arr
        return arr

    def adjacency(self, n: int | None = None) -> np.ndarray:
        """Boolean adjacency matrix over node IDs 0..n-1."""
        if n is None:
            n = (max(self.nodes) + 1) if self.nodes else 0
        A = np.zeros((n, n), dtype=bool)
        for i, j in self.pairs:
            A[i, j] = True
        return A

    # --------------------------------------------------- scheduling helpers
    def is_matching(self) -> bool:
        """True iff every participant has exactly one peer (a pairwise slot —
        what the original get1meas primitive supports)."""
        return all(self.degree(v) == 1 for v in self.participants())

    def restrict(self, alive: Iterable[int]) -> "Relation":
        """Drop pairs touching failed/occluded nodes (fault tolerance: the
        paper's skip-slot semantics applied by the scheduler)."""
        alive_s = set(alive)
        return Relation(
            frozenset(self.nodes & alive_s),
            frozenset((i, j) for i, j in self.pairs if i in alive_s and j in alive_s),
        )

    # ------------------------------------------------------------- dunder
    def __contains__(self, pair: Pair) -> bool:
        return tuple(pair) in self.pairs

    def __iter__(self) -> Iterator[Pair]:
        return iter(sorted(self.pairs))

    def __len__(self) -> int:
        return len(self.pairs)

    def __or__(self, other: "Relation") -> "Relation":
        return self.union(other)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Relation(n={len(self.nodes)}, pairs={sorted(self.pairs)})"
