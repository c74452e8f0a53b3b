"""The paper's getMeas/get1meas over a stacked node axis.

Counterpart of the JAX package's ``core/tdm.py``. There, one node runs per
device under ``shard_map`` and each matching of a slot relation lowers to one
``ppermute``. On one GPU the port stacks the ``n`` nodes on a leading tensor
axis: an exchange over a matching is a row gather by the matching's
permutation, and rows of nodes outside the matching receive zeros, exactly
what ``ppermute`` returns. Per-node scalars (``w[axis_index]`` in the
reference) become one value per row, cast from the float64 numpy weights to
the payload dtype as the reference casts them.

``get1_meas`` issues the matchings one after another; the reference's
``optimization_barrier`` chain only orders them and has no numeric effect.
Summation orders are the reference's: matching order for getMeas-based
gossip, peer order for get1meas.

Every row gather is counted (:func:`gather_count`), so a round's exchanges can
be held against :func:`repro_torch.telemetry.expected_tdm_collectives`.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.gossip import metropolis_weights
from repro_torch.core.relation import Relation
from repro_torch.core.schedule import edge_coloring

__all__ = [
    "ChocoState",
    "choco_init",
    "edge_coloring",
    "exchange_matching",
    "gather_count",
    "gather_rows",
    "get1_meas",
    "get_meas",
    "gossip_avg",
    "gossip_avg_serial",
    "matching_permutation",
    "matching_weight_vectors",
    "metropolis_weights",
    "neighbor_sum",
    "node_scalars",
    "peer_slot_table",
]

_GATHERS = [0]


def gather_count() -> int:
    """Row gathers issued by :func:`exchange_matching` in this process."""
    return _GATHERS[0]


# ---------------------------------------------------------------------------
# Static (Python-side) schedule preprocessing
# ---------------------------------------------------------------------------

def matching_permutation(matching: Relation) -> List[Tuple[int, int]]:
    """(src, dst) pairs of one matching: every (i, j) in M means "i sends to
    j"; M symmetric, so both directions are present."""
    return sorted(matching.pairs)


def peer_slot_table(rel: Relation, n: int) -> Tuple[np.ndarray, List[Relation]]:
    """``table[i, p]`` = matching that carries node i's exchange with its
    p-th peer (``rel.peers_of(i)`` order), or -1 past the node's degree."""
    matchings = edge_coloring(rel)
    max_deg = rel.max_degree()
    table = -np.ones((n, max(max_deg, 1)), dtype=np.int32)
    for i in range(n):
        for p, j in enumerate(rel.peers_of(i)):
            for c, m in enumerate(matchings):
                if (i, j) in m:
                    table[i, p] = c
                    break
            if table[i, p] < 0:
                raise ValueError(f"edge ({i},{j}) missing from coloring")
    return table, matchings


def node_scalars(values, like: torch.Tensor) -> torch.Tensor:
    """Per-node numpy values -> shape (n, 1, ..., 1) in ``like``'s dtype, to
    broadcast over a stacked (n, ...) tensor."""
    t = torch.as_tensor(np.array(values), dtype=like.dtype, device=like.device)
    return t.reshape((-1,) + (1,) * (like.dim() - 1))


# ---------------------------------------------------------------------------
# Exchange primitives (stacked node axis = dim 0)
# ---------------------------------------------------------------------------

def exchange_matching(x: torch.Tensor, matching: Relation) -> torch.Tensor:
    """One pairwise exchange: row j of the result is row i of ``x`` for every
    (i, j) in the matching; rows of non-participants are zero."""
    perm = matching_permutation(matching)
    if not perm:
        return torch.zeros_like(x)
    n = x.shape[0]
    src = np.arange(n)
    idle = np.ones(n, dtype=bool)
    for i, j in perm:
        src[j] = i
        idle[j] = False
    out = x.index_select(0, torch.as_tensor(src, device=x.device))
    if idle.any():
        out[torch.as_tensor(np.nonzero(idle)[0], device=x.device)] = 0
    _GATHERS[0] += 1
    return out


def gather_rows(x: torch.Tensor, pairs) -> torch.Tensor:
    """One directed exchange of a batch of ``(src, dst)`` sends with unique
    sources and destinations (the reference's ``ppermute`` of one batch),
    as the rows that arrive: row k of the result is row ``src_k`` of ``x``,
    bound for ``dst_k``. Non-destinations receive nothing; the caller puts
    each row where it lands. Counted as one gather."""
    src = torch.as_tensor([s for s, _ in pairs], dtype=torch.int64, device=x.device)
    out = x.index_select(0, src)
    _GATHERS[0] += 1
    return out


def _peer_data(received: torch.Tensor, table: np.ndarray):
    """received (M, n, ...) -> (peer_data (n, max_deg, ...), mask (n, max_deg))."""
    n = table.shape[0]
    dev = received.device
    mask = torch.as_tensor(table >= 0, device=dev)
    safe = torch.as_tensor(np.maximum(table, 0).astype(np.int64), device=dev)
    rows = torch.arange(n, device=dev)[:, None]
    peer = received[safe, rows]                      # (n, max_deg, ...)
    keep = mask.reshape(mask.shape + (1,) * (received.dim() - 2))
    return torch.where(keep, peer, torch.zeros_like(peer)), mask


def get_meas(
    x: torch.Tensor,
    rel: Relation,
    n: int,
    participate: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Universal TDM exchange (paper Algorithm 1), multi-link.

    Every node sends its row of ``x`` to all its peers in ``rel``. Returns
    ``(peer_data (n, max_deg, ...), peer_mask (n, max_deg))``: entry
    ``[i, p]`` is what node i received from its p-th peer, zeros past its
    degree. ``participate`` (n,) bool: a skipping node sends zeros.
    """
    if participate is not None:
        keep = participate.reshape((-1,) + (1,) * (x.dim() - 1))
        x = torch.where(keep, x, torch.zeros_like(x))
    table, matchings = peer_slot_table(rel, n)
    if rel.max_degree() == 0:
        return (
            torch.zeros((n, 1) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device),
            torch.zeros((n, 1), dtype=torch.bool, device=x.device),
        )
    received = torch.stack([exchange_matching(x, m) for m in matchings])
    return _peer_data(received, table)


def get1_meas(x: torch.Tensor, rel: Relation, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The single-antenna primitive: same exchanges as :func:`get_meas`,
    matchings issued one after another."""
    table, matchings = peer_slot_table(rel, n)
    if rel.max_degree() == 0:
        return (
            torch.zeros((n, 1) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device),
            torch.zeros((n, 1), dtype=torch.bool, device=x.device),
        )
    received = []
    for m in matchings:
        received.append(exchange_matching(x, m))
    return _peer_data(torch.stack(received), table)


def neighbor_sum(x: torch.Tensor, rel: Relation) -> torch.Tensor:
    """Sum over each node's neighbours, one gather per matching."""
    out = torch.zeros_like(x)
    for m in edge_coloring(rel):
        out = out + exchange_matching(x, m)
    return out


def matching_weight_vectors(rel: Relation, n: int) -> Tuple[np.ndarray, List[np.ndarray]]:
    """``(diag, [w_m, ...])``: node i's Metropolis self weight and the weight
    it applies to what arrives over matching m (0 outside m), in
    :func:`edge_coloring` order."""
    W = metropolis_weights(rel, n)
    vecs = []
    for m in edge_coloring(rel):
        w_m = np.zeros((n,))
        for (i, j) in m.pairs:
            w_m[i] = W[i, j]
        vecs.append(w_m)
    return np.diag(W).copy(), vecs


def gossip_avg(x: torch.Tensor, rel: Relation, n: int) -> torch.Tensor:
    """One Metropolis gossip step x_i <- W_ii x_i + sum_j W_ij x_j, one
    gather per matching, added in matching order."""
    diag, per_matching = matching_weight_vectors(rel, n)
    out = node_scalars(diag, x) * x
    for m, w_m in zip(edge_coloring(rel), per_matching):
        recv = exchange_matching(x, m)
        out.add_(node_scalars(w_m, x) * recv)   # in place: out is ours
    return out


def gossip_avg_serial(x: torch.Tensor, rel: Relation, n: int) -> torch.Tensor:
    """Metropolis gossip through :func:`get1_meas`, received values added in
    peer order."""
    if len(rel) == 0:
        return x
    W = metropolis_weights(rel, n)
    out = node_scalars(np.diag(W), x) * x
    peer_data, _ = get1_meas(x, rel, n)
    max_deg = rel.max_degree()
    wmat = np.zeros((n, max_deg))
    for i in range(n):
        for p, j in enumerate(rel.peers_of(i)):
            wmat[i, p] = W[i, j]
    w_row = torch.as_tensor(wmat, dtype=x.dtype, device=x.device)
    w_row = w_row.reshape(w_row.shape + (1,) * (x.dim() - 1))
    return out + torch.sum(w_row * peer_data.to(x.dtype), dim=1)


class ChocoState(NamedTuple):
    """CHOCO-Gossip state of a stacked tensor: x_hat, each node's public
    copy, and s, the running sum_j W_ij x_hat_j."""

    x_hat: torch.Tensor
    s: torch.Tensor


def choco_init(x: torch.Tensor) -> ChocoState:
    """Zero state. Both fields share one zeros tensor: nothing updates a
    ChocoState in place, and it halves the memory of a fresh state."""
    zero = torch.zeros_like(x)
    return ChocoState(x_hat=zero, s=zero)
