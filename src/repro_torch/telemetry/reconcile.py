"""Static exchange-count oracles for one fused TDM-FLA round.

Copied from the JAX package's ``telemetry/reconcile.py``
(``expected_tdm_collectives``, ``expected_hierarchical_collectives``). There it is checked against the
collective-permutes in the compiled HLO; the port checks it against the row
gathers :func:`repro_torch.core.tdm.exchange_matching` actually issues.
"""

from __future__ import annotations

from typing import Dict


def expected_tdm_collectives(
    rel,
    n_buckets: int,
    *,
    compression: str = "none",
) -> Dict[str, int]:
    """Exchanges in ONE fused TDM-FLA gossip round: each of the relation's
    matchings costs one exchange per dtype bucket — two for int8 (payload
    and blockwise scales travel separately), ONE for top-k/CHOCO (values and
    block-local indices packed into a single int32 payload) — independent of
    the model's leaf count."""
    from repro_torch.core.schedule import edge_coloring

    if len(rel) == 0:
        return {"collective-permute": 0}
    per = 2 if compression == "int8" else 1
    matchings = len(edge_coloring(rel))
    return {"collective-permute": matchings * per * int(n_buckets)}


def expected_hierarchical_collectives(
    intra_rel,
    inter_rel,
    n_buckets: int,
    *,
    compression: str = "none",
) -> Dict[str, int]:
    """Exchanges in one fused hierarchical (pod x data) round: the two
    levels gossip independently, so their per-level TDM counts add,
    ``(M_intra + M_inter) x per x n_buckets`` with ``per = 2`` for int8
    (:func:`repro_torch.core.fused.fused_hierarchical_round`)."""
    if compression not in ("none", "int8"):
        raise ValueError(
            f"hierarchical gossip has no oracle for compression "
            f"{compression!r} (only 'none'/'int8' are lowered)"
        )
    intra = expected_tdm_collectives(
        intra_rel, n_buckets, compression=compression
    )
    inter = expected_tdm_collectives(
        inter_rel, n_buckets, compression=compression
    )
    return {
        "collective-permute": intra["collective-permute"]
        + inter["collective-permute"]
    }
