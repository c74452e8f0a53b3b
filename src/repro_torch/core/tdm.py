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

The per-leaf compressed exchange (int8 and CHOCO top-k, one payload per
node and tensor, :mod:`repro_torch.core.compress`) and the two-level
(pod x data) gossip, whose levels are lifted onto the node axis by
:func:`level_weight_vectors`, follow the same rules.

Every row gather is counted (:func:`gather_count`), so a round's exchanges can
be held against :func:`repro_torch.telemetry.expected_tdm_collectives`.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import compress as compress_lib
from repro_torch.core.gossip import metropolis_weights
from repro_torch.core.relation import Relation
from repro_torch.core.schedule import TDMSchedule, edge_coloring
from repro_torch.pytree import tree_map

__all__ = [
    "ChocoState",
    "choco_gossip_round",
    "choco_init",
    "edge_coloring",
    "exchange_matching",
    "gather_count",
    "gather_rows",
    "get1_meas",
    "get_meas",
    "gossip_avg",
    "gossip_avg_serial",
    "gossip_avg_tree",
    "gossip_matchings",
    "hierarchical_gossip",
    "level_weight_vectors",
    "matching_permutation",
    "matching_weight_vectors",
    "metropolis_weights",
    "neighbor_sum",
    "neighbor_sum_int8",
    "neighbor_sum_topk",
    "node_scalars",
    "peer_slot_table",
    "run_gossip_schedule",
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
    return gossip_matchings(x, diag, edge_coloring(rel), per_matching)


def gossip_matchings(x: torch.Tensor, diag, matchings, per_matching) -> torch.Tensor:
    """:func:`gossip_avg` over given matchings and per-row weight vectors."""
    out = node_scalars(diag, x) * x
    for m, w_m in zip(matchings, per_matching):
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



def gossip_avg_tree(params, rel: Relation, n: int):
    """:func:`gossip_avg` over every leaf of a stacked pytree."""
    return tree_map(lambda p: gossip_avg(p, rel, n), params)


# ---------------------------------------------------------------------------
# Compressed exchange, one payload per node and tensor
# ---------------------------------------------------------------------------

def neighbor_sum_int8(x: torch.Tensor, rel: Relation) -> torch.Tensor:
    """:func:`neighbor_sum` of int8 payloads with one absmax scale per row;
    codes and scales travel as two gathers per matching."""
    payload = compress_lib.int8_compress(x)
    out = torch.zeros_like(x, dtype=torch.float32)
    for m in edge_coloring(rel):
        q = exchange_matching(payload.q, m)
        s = exchange_matching(payload.scale, m)
        out.add_(q.to(torch.float32) * s.reshape((-1,) + (1,) * (x.dim() - 1)))
    return out.to(x.dtype)


def _scatter_rows(vals: torch.Tensor, idxs: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Per row, a float32 zeros vector of ``like``'s row size with ``vals``
    added at ``idxs`` (the reference's ``zeros.at[idxs].add(vals)``)."""
    out = torch.zeros((like.shape[0], like[0].numel()), dtype=torch.float32, device=like.device)
    return out.scatter_add_(1, idxs.to(torch.int64), vals.to(torch.float32))


def neighbor_sum_topk(
    x: torch.Tensor, residual: torch.Tensor, rel: Relation, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`neighbor_sum` of top-k payloads with error feedback, for
    additive deltas (absolute values gossip through
    :func:`choco_gossip_round`). Per matching three gathers: values,
    indices and a participation flag. Returns (sum of the decompressed
    neighbour payloads, new residual)."""
    payload, new_residual = compress_lib.topk_with_error_feedback(x, residual, k)
    out = torch.zeros((x.shape[0], x[0].numel()), dtype=torch.float32, device=x.device)
    ones = torch.ones(x.shape[0], dtype=torch.float32, device=x.device)
    for m in edge_coloring(rel):
        vals = exchange_matching(payload.values, m)
        idxs = exchange_matching(payload.indices, m)
        got_any = exchange_matching(ones, m)
        out.add_(got_any[:, None] * _scatter_rows(vals, idxs, x))
    return out.reshape(x.shape).to(x.dtype), new_residual


def choco_gossip_round(
    x: torch.Tensor,
    state: ChocoState,
    rel: Relation,
    n: int,
    k: int,
    gamma: float = 0.4,
) -> Tuple[torch.Tensor, ChocoState]:
    """One CHOCO-Gossip round (Koloskova et al., ICML 2019) with per-row
    top-k payloads, the reference's recursion as written:

        q_i   = top_k(x_i - x_hat_i)
        x_hat_i += q_i ;  s_i += sum_j W_ij q_j   (per-matching weights)
        x_i   += gamma (s_i - d_i x_hat_i)         d_i = sum_j W_ij in float32

    Values and indices travel as two gathers per matching. The relation must
    be the same every round (``s`` is tied to W)."""
    W = metropolis_weights(rel, n)
    payload = compress_lib.topk_compress(x - state.x_hat, k)
    q_dense = compress_lib.topk_decompress(payload, tuple(x.shape), x.dtype)
    new_x_hat = state.x_hat + q_dense
    _, per_matching = matching_weight_vectors(rel, n)
    s = state.s
    for m, w_m in zip(edge_coloring(rel), per_matching):
        vals = exchange_matching(payload.values, m)
        idxs = exchange_matching(payload.indices, m)
        contrib = _scatter_rows(vals, idxs, x).reshape(x.shape)
        s = s + node_scalars(w_m, x) * contrib.to(x.dtype)
    deg_w = np.zeros((n,), dtype=np.float32)
    for i in range(n):
        deg_w[i] = sum(W[i, j] for j in rel.peers_of(i))
    d_i = node_scalars(deg_w, x)
    new_x = x + float(np.float32(gamma)) * (s - d_i * new_x_hat)
    return new_x, ChocoState(x_hat=new_x_hat, s=s)


# ---------------------------------------------------------------------------
# Whole-schedule execution and two-level (pod x data) TDM
# ---------------------------------------------------------------------------

def run_gossip_schedule(x: torch.Tensor, schedule: TDMSchedule, n: int) -> torch.Tensor:
    """One gossip step per slot, in slot order; empty slots are skipped."""
    for rel in schedule:
        if len(rel) == 0:
            continue
        x = gossip_avg(x, rel, n)
    return x


def level_weight_vectors(
    rel: Relation, level: str, n_data: int, n_pods: int
) -> Tuple[np.ndarray, List[Relation], List[np.ndarray]]:
    """One level of the two-level exchange, lifted onto the stacked node
    axis, where row ``pod * n_data + data`` is a node (the reference's
    ``P(("pod", "data"))`` layout).

    ``rel`` is coloured at its own size (``n_data`` nodes for ``level ==
    "data"``, ``n_pods`` for ``"pod"``) and each matching is lifted whole, so
    the matchings, their order and the weights are the reference's. A
    data-level matching pairs rows within every pod at once; a pod-level
    matching pairs the rows of equal ``data`` across pods. Returns the
    lifted ``(diag, matchings, per-matching weights)``."""
    if level == "data":
        n_level = n_data

        def lift_pair(i, j):
            return [(p * n_data + i, p * n_data + j) for p in range(n_pods)]

        def lift_w(w):
            return np.tile(w, n_pods)
    elif level == "pod":
        n_level = n_pods

        def lift_pair(i, j):
            return [(i * n_data + d, j * n_data + d) for d in range(n_data)]

        def lift_w(w):
            return np.repeat(w, n_data)
    else:
        raise ValueError(f"level must be 'data' or 'pod', got {level!r}")
    diag, per_matching = matching_weight_vectors(rel, n_level)
    nodes = range(n_data * n_pods)
    matchings = [
        Relation.from_pairs([q for i, j in m.pairs for q in lift_pair(i, j)], nodes=nodes)
        for m in edge_coloring(rel)
    ]
    return lift_w(diag), matchings, [lift_w(w) for w in per_matching]


def hierarchical_gossip(
    x: torch.Tensor,
    intra_rel: Relation,
    inter_rel: Relation,
    n_data: int,
    n_pods: int,
) -> torch.Tensor:
    """Two-level TDM on a stacked ``(n_pods * n_data, ...)`` tensor: gossip
    within each pod over ``intra_rel`` (dense links), then between pods over
    ``inter_rel`` (the sparse inter-satellite links)."""
    x = gossip_matchings(x, *level_weight_vectors(intra_rel, "data", n_data, n_pods))
    if len(inter_rel) > 0:
        x = gossip_matchings(x, *level_weight_vectors(inter_rel, "pod", n_data, n_pods))
    return x
