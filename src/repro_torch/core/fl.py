"""The three PTB-FLA generic algorithms, as first-class framework features.

Counterpart of the JAX package's ``core/fl.py``, in its two forms:

1. **Simulator form** (``*_sim``): message passing over the paper-faithful
   discrete-event testbed (:mod:`repro_torch.core.ptbfla_sim`) with the
   paper's callback structure. Host code, copied from the reference; the
   callbacks take whatever values the caller passes.
2. **Collective form** on a stacked node axis: every node's tensor is one
   row, and an exchange over a matching is a row gather
   (:mod:`repro_torch.core.tdm`).

:func:`tdm_mix` covers all three compression modes per leaf: Metropolis
gossip, int8 with one absmax scale per node and tensor (weight
``1 / (1 + max_degree)``), and CHOCO top-k. The fused engine
(:mod:`repro_torch.core.fused`, the default) carries the same modes on
flat buffers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import tdm
from repro_torch.core.ptbfla_sim import PTBFLASimulator, _Node, _as_gen
from repro_torch.core.relation import Relation
from repro_torch.core.schedule import TDMSchedule
from repro_torch.pytree import tree_flatten, tree_map, tree_unflatten


# ===========================================================================
# Simulator (oracle) forms: the paper's callback-style generic algorithms
# ===========================================================================

def centralized_fla_sim(
    n_nodes: int,
    server_id: int,
    client_fn: Callable[[Any, Any], Any],
    server_fn: Callable[[Any, List[Any]], Any],
    client_data: Dict[int, Any],
    server_data: Any,
    n_rounds: int = 1,
    seed: int = 0,
) -> Any:
    """Generic centralized FLA (star topology), per round:

    1. server sends its current model to every client,
    2. client i computes ``client_fn(model, client_data[i])``,
    3. clients send updates back; server sets
       ``model = server_fn(model, updates)``.

    Communication uses the same sendMsg/rcvMsg substrate as Algorithm 1 (the
    star is the materialization of the abstract graph in centralized mode).
    Returns the server's final model.
    """
    sim = PTBFLASimulator(n_nodes, seed=seed)
    clients = [i for i in range(n_nodes) if i != server_id]

    def server_prog(node: _Node):
        model = server_data
        for _ in range(n_rounds):
            for c in clients:
                sim.send_msg(node.node_id, c, [node.time_slot, node.node_id, model])
            updates = []
            for _ in clients:
                while not node.inbox:
                    yield None  # block on recv
                msg = node.inbox.popleft()
                node.n_received += 1
                updates.append(msg[2])
            model = server_fn(model, updates)
            node.time_slot += 1
        return model

    def make_client(cid: int):
        def prog(node: _Node):
            result = None
            for _ in range(n_rounds):
                while not node.inbox:
                    yield None
                msg = node.inbox.popleft()
                node.n_received += 1
                model = msg[2]
                result = client_fn(model, client_data.get(cid))
                sim.send_msg(cid, server_id, [node.time_slot, cid, result])
                node.time_slot += 1
            return result

        return prog

    programs = {server_id: server_prog}
    for c in clients:
        programs[c] = make_client(c)
    results = sim.run(programs)
    return results[server_id]


def decentralized_fla_sim(
    n_nodes: int,
    update_fn: Callable[[Any, List[Any]], Any],
    node_data: Dict[int, Any],
    n_rounds: int = 1,
    seed: int = 0,
) -> Dict[int, Any]:
    """Generic decentralized FLA: the clique materialization. Every round,
    every node exchanges its value with all others (this is exactly getMeas
    over the clique relation — the paper's evaluation scenario) and applies
    ``update_fn(own, peer_values)``. Returns each node's final value."""
    sim = PTBFLASimulator(n_nodes, seed=seed)
    rel = Relation.clique(list(range(n_nodes)))

    def make_prog(node_id: int):
        def prog(node: _Node):
            value = node_data[node_id]
            peer_ids = rel.peers_of(node_id)
            for _ in range(n_rounds):
                got = yield from _as_gen(sim.get_meas(node, peer_ids, value))
                value = update_fn(value, got)
            return value

        return prog

    return sim.run({i: make_prog(i) for i in range(n_nodes)})


def tdm_fla_sim(
    schedule: TDMSchedule,
    n_nodes: int,
    local_fn: Callable[[int, int, Any], Any],
    mix_fn: Callable[[Any, List[Any]], Any],
    init: Dict[int, Any],
    seed: int = 0,
) -> Tuple[Dict[int, Any], PTBFLASimulator]:
    """The paper's contribution as an FL algorithm: per slot t, each node

    1. runs its local computation ``local_fn(node, t, value)`` (e.g. a local
       SGD step on its own data / its own orbital measurement),
    2. exchanges the result with its slot-t peers via **getMeas** (skipping
       the slot when it has no peers — the `odata=None` case),
    3. mixes: ``value = mix_fn(own, peer_values)``.

    Returns each node's final value plus the simulator (message stats).
    """
    sim = PTBFLASimulator(n_nodes, seed=seed)

    def make_prog(node_id: int):
        def prog(node: _Node):
            value = init[node_id]
            for t, rel in enumerate(schedule):
                value = local_fn(node_id, t, value)
                peer_ids = rel.peers_of(node_id)
                odata = value if peer_ids else None
                got = yield from _as_gen(sim.get_meas(node, peer_ids, odata))
                if got is not None:
                    value = mix_fn(value, got)
            return value

        return prog

    results = sim.run({i: make_prog(i) for i in range(n_nodes)})
    return results, sim


# ===========================================================================
# Collective forms on the stacked node axis
# ===========================================================================

def centralized_round(update: Any) -> Any:
    """FedAvg aggregation: every node gets the mean over the node axis."""
    return tree_map(lambda x: x.mean(dim=0, keepdim=True).expand_as(x).clone(), update)


def decentralized_round(value: Any, n: int) -> Any:
    """Decentralized FLA round over the clique: each node averages its value
    with all peers' (uniform 1/n), as the TDM clique exchange (n-1 gathers)."""
    rel = Relation.clique(list(range(n)))

    def avg(x):
        total = tdm.neighbor_sum(x, rel) + x
        return total / n

    return tree_map(avg, value)


@dataclass(frozen=True)
class TDMFLAConfig:
    """Config of the universal TDM FLA (collective form).

    comm: 'getmeas' (multi-link) | 'get1meas' (single-link, serialized)
    compression: 'none' | 'int8' | 'topk'
    topk_k: payload size for 'topk' (per leaf; the fused engine scales it)
    fused: mix through the flat-buffer engine (M gathers per round instead
           of L x M); uncompressed results are bit-identical.
    """

    comm: str = "getmeas"
    compression: str = "none"
    topk_k: int = 64
    choco_gamma: float = 0.4
    local_steps: int = 1
    fused: bool = True

    def __post_init__(self):
        if self.comm not in ("getmeas", "get1meas"):
            raise ValueError(f"unknown comm mode {self.comm}")
        if self.compression not in ("none", "int8", "topk"):
            raise ValueError(f"unknown compression {self.compression}")


def tdm_mix(
    x: torch.Tensor,
    rel: Relation,
    n: int,
    cfg: TDMFLAConfig = TDMFLAConfig(),
    residual: Optional[Any] = None,
) -> Tuple[torch.Tensor, Optional[Any]]:
    """One TDM-FLA mixing step for a single stacked tensor over ``rel``:
    Metropolis gossip through the selected primitive, optionally compressed.
    Isolated nodes keep their value (paper skip-slot). Returns (mixed, new
    residual); the residual is the CHOCO state under top-k."""
    if len(rel) == 0:
        return x, residual
    if cfg.compression == "topk":
        state = residual if isinstance(residual, tdm.ChocoState) else tdm.choco_init(x)
        return tdm.choco_gossip_round(
            x, state, rel, n, cfg.topk_k, gamma=cfg.choco_gamma
        )
    if cfg.compression == "int8":
        w = float(np.float32(1.0 / (1.0 + rel.max_degree())))
        summed = tdm.neighbor_sum_int8(x, rel)
        deg = tdm.node_scalars([rel.degree(v) for v in range(n)], x)
        return x + w * (summed - deg * x), residual
    if cfg.comm == "getmeas":
        return tdm.gossip_avg(x, rel, n), residual
    return tdm.gossip_avg_serial(x, rel, n), residual


def tdm_fla_round(
    params: Any,
    rel: Relation,
    n: int,
    cfg: TDMFLAConfig = TDMFLAConfig(),
    residuals: Any = None,
    *,
    quant_impl: str = "auto",
) -> Tuple[Any, Any]:
    """One TDM-FLA mixing round over a stacked parameter pytree: through the
    fused engine (default), or :func:`tdm_mix` leaf by leaf (L x M gathers;
    bit-identical to the fused engine when uncompressed).

    The ``residuals`` carry (CHOCO state) is path-specific: per-leaf returns
    a pytree of per-leaf states, fused returns per-buffer states. Pass back
    only what the same path returned."""
    if cfg.fused:
        from repro_torch.core import fused as fused_lib

        return fused_lib.fused_tdm_fla_round(
            params, rel, n, cfg, residuals, quant_impl=quant_impl
        )
    leaves, treedef = tree_flatten(params)
    if residuals is None:
        res_leaves = [None] * len(leaves)
    else:
        res_leaves = tree_flatten(
            residuals, is_leaf=lambda r: isinstance(r, tdm.ChocoState)
        )[0]
    out, new_res = [], []
    for leaf, res in zip(leaves, res_leaves):
        mixed, r = tdm_mix(leaf, rel, n, cfg, res)
        out.append(mixed)
        new_res.append(r)
    return tree_unflatten(treedef, out), tree_unflatten(treedef, new_res)


# ===========================================================================
# Convergence math
# ===========================================================================

def consensus_error(values: Sequence[np.ndarray]) -> float:
    """Max_i ||x_i - mean|| / ||mean|| — disagreement across the node set."""
    stack = np.stack([np.asarray(v, dtype=np.float64) for v in values])
    mean = stack.mean(axis=0)
    denom = max(float(np.linalg.norm(mean)), 1e-30)
    return float(np.max(np.linalg.norm(stack - mean, axis=tuple(range(1, stack.ndim))))) / denom


def rounds_to_consensus(
    W: np.ndarray, tol: float = 1e-6, max_rounds: int = 100_000
) -> int:
    """Rounds of mixing with matrix W until worst-case disagreement < tol
    (from the spectral gap: (1-gap)^t < tol)."""
    from repro_torch.core.gossip import spectral_gap

    gap = spectral_gap(W)
    if gap <= 0:
        return -1
    t = int(np.ceil(np.log(tol) / np.log(max(1e-12, 1.0 - gap))))
    return min(t, max_rounds)
