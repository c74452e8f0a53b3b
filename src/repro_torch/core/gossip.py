"""Gossip-averaging theory on top of the paper's relation model.

The paper's Property 2 (data propagation by composition of per-slot
relations) is, in FL terms, the statement that decentralized averaging over
a TDM schedule mixes information across the constellation. This module makes
that quantitative: mixing matrices W(R), their spectral gap (the convergence
rate of decentralized FL over the schedule), and the propagation closure
(which node's data has reached whom after slots R_1..R_T — paper §II.B).
"""

from __future__ import annotations


import numpy as np

from repro_torch.core.relation import Relation
from repro_torch.core.schedule import TDMSchedule


def metropolis_weights(rel: Relation, n: int) -> np.ndarray:
    """Metropolis–Hastings mixing matrix for exchange relation R.

    W[i,j] = 1/(1+max(d_i,d_j)) for (i,j) in R; W[i,i] = 1 - sum_j W[i,j].
    Symmetric, doubly stochastic, diagonalizable — the standard choice for
    decentralized averaging on an undirected graph (= R, by paper P5).
    """
    rel.validate()
    W = np.zeros((n, n))
    deg = {v: rel.degree(v) for v in range(n)}
    for i, j in rel.pairs:
        W[i, j] = 1.0 / (1.0 + max(deg.get(i, 0), deg.get(j, 0)))
    for i in range(n):
        W[i, i] = 1.0 - W[i].sum()
    return W


def uniform_neighbor_weights(rel: Relation, n: int, self_weight: float | None = None) -> np.ndarray:
    """W[i,j] = (1-w_self)/d_i over neighbors. Doubly stochastic only for
    regular graphs; used for the clique (paper's evaluation scenario) where
    it equals exact averaging in one slot when self_weight = 1/n."""
    W = np.zeros((n, n))
    for i in range(n):
        peers = rel.peers_of(i)
        if not peers:
            W[i, i] = 1.0
            continue
        w_self = self_weight if self_weight is not None else 1.0 / (len(peers) + 1)
        W[i, i] = w_self
        for j in peers:
            W[i, j] = (1.0 - w_self) / len(peers)
    return W


def spectral_gap(W: np.ndarray) -> float:
    """1 - |λ₂(W)|: per-slot contraction rate of disagreement."""
    eig = np.linalg.eigvals(W)
    eig = sorted(np.abs(eig), reverse=True)
    if len(eig) < 2:
        return 1.0
    return float(1.0 - eig[1])


def schedule_mixing_matrix(schedule: TDMSchedule, n: int) -> np.ndarray:
    """Product of per-slot Metropolis matrices — the effective mixing of one
    full TDM schedule period (composition of relations, paper P2)."""
    W = np.eye(n)
    for rel in schedule:
        W = metropolis_weights(rel, n) @ W
    return W


def propagation_closure(schedule: TDMSchedule, n: int) -> np.ndarray:
    """reach[i, j] = True iff node i's slot-0 data can have reached node j by
    the end of the schedule via the slot-ordered path relation (paper §II.B:
    evaluating the sequence of R compositions left to right)."""
    reach = np.eye(n, dtype=bool)
    for rel in schedule:
        A = rel.adjacency(n)
        reach = reach | (reach @ A)
    return reach


def slots_to_full_propagation(schedule_gen, n: int, max_periods: int = 64) -> int:
    """How many slots until every node's data reached every other node
    (diameter of the time-expanded graph). ``schedule_gen(t)`` -> Relation."""
    reach = np.eye(n, dtype=bool)
    t = 0
    while not reach.all():
        rel = schedule_gen(t)
        reach = reach | (reach @ rel.adjacency(n))
        t += 1
        if t > max_periods * n:
            return -1  # never propagates fully (disconnected schedule)
    return t
