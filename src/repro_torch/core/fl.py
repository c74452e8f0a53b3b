"""The PTB-FLA generic algorithms in collective form, on a stacked node axis.

Counterpart of the collective half of the JAX package's ``core/fl.py``. The
simulator forms (``*_fla_sim``) stay in the reference, where the tests use
them as oracles. The per-leaf compressed exchange (int8 and CHOCO top-k per
leaf, ``core/compress.py``) is not ported yet and raises; the fused engine
(:mod:`repro_torch.core.fused`, the default) carries both compressions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch

from repro_torch.core import tdm
from repro_torch.core.relation import Relation
from repro_torch.pytree import tree_flatten, tree_map, tree_unflatten

PER_LEAF_COMPRESSED = (
    "the per-leaf compressed exchange (compression={!r} with fused=False) is "
    "not ported yet (ROADMAP queue 1, per-leaf compressed exchange); use the "
    "fused engine"
)


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
    """One TDM-FLA mixing step for a single stacked tensor (uncompressed):
    Metropolis gossip through the selected primitive. Isolated nodes keep
    their value (paper skip-slot)."""
    if len(rel) == 0:
        return x, residual
    if cfg.compression != "none":
        raise NotImplementedError(PER_LEAF_COMPRESSED.format(cfg.compression))
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
    fused engine (default), or :func:`tdm_mix` leaf by leaf."""
    if cfg.fused:
        from repro_torch.core import fused as fused_lib

        return fused_lib.fused_tdm_fla_round(
            params, rel, n, cfg, residuals, quant_impl=quant_impl
        )
    leaves, treedef = tree_flatten(params)
    if residuals is None:
        res_leaves = [None] * len(leaves)
    else:
        res_leaves = tree_flatten(residuals)[0]
    out, new_res = [], []
    for leaf, res in zip(leaves, res_leaves):
        mixed, r = tdm_mix(leaf, rel, n, cfg, res)
        out.append(mixed)
        new_res.append(r)
    return tree_unflatten(treedef, out), tree_unflatten(treedef, new_res)
