"""Static exchange-count oracle for one fused TDM-FLA round.

Copied from the JAX package's ``telemetry/reconcile.py``
(``expected_tdm_collectives``). There it is checked against the
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
