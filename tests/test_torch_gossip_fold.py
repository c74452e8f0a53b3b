"""The int8 gossip's receive side as one fold, on the CPU (torch only).

``ops.gossip_fold(impl="ref")`` and the engine around it
(``fused.int8_gossip_matchings``) against the chain they replace, copied
here: per matching the arriving codes and scales gathered by
``tdm.exchange_matching``, folded into an accumulator of zeros by the plain
dequant-accumulate, then ``+ diag * x``; bit for bit. The row plan is cached
per relation (``fused.row_plan.*`` counters), and a matching still counts
two row gathers (codes and scales). The kernel itself is held to the same
chain on the card (``tests/test_torch_cuda.py``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import telemetry
from repro_torch.core import fused, tdm
from repro_torch.core.relation import Relation
from repro_torch.kernels.tdm_compress import ops, ref

N = 8
# 0 to 3 matchings; idle rows (7, or 1 and 3) and rows of degree 2 and 3
RELATIONS = {
    "none": [],
    "one": [(0, 5), (1, 4), (2, 7), (3, 6)],
    "two": [(0, 5), (0, 6), (2, 4), (2, 7)],
    "three": [(0, 1), (1, 2), (2, 0), (3, 4), (4, 5)],
}
# the FL launcher's eight-satellite plan: six distinct relations, cycled twice
PLAN = [
    [(0, 5), (0, 6), (2, 4), (2, 7)],
    [(0, 5), (1, 4), (2, 7), (3, 6)],
    [(0, 4), (1, 7), (2, 6), (3, 5)],
    [(1, 6), (1, 7), (3, 4), (3, 5)],
    [(0, 7), (1, 6), (2, 5), (3, 4)],
    [(0, 6), (1, 5), (2, 4), (3, 7)],
] * 2


def _rel(edges, n=N):
    return Relation.from_edges(edges, nodes=range(n))


def _weights(edges, n=N):
    rel = _rel(edges, n)
    matchings = tdm.edge_coloring(rel) if edges else []
    if not edges:
        return np.full(n, 1.0), matchings, []
    diag, per_matching = tdm.matching_weight_vectors(rel, n, matchings)
    return diag, matchings, per_matching


def _x(n_cols, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(N, n_cols, generator=g) * torch.rand(N, 1, generator=g) * 3
    return x.to(dtype)


def _chain(x, diag, matchings, per_matching, block):
    """The receive side before the fold, as ``int8_gossip_matchings`` ran it."""
    x32 = x.to(torch.float32)
    q, scales = ref.quantize_ref(x32, block)
    acc = None
    for m, w_m in zip(matchings, per_matching):
        q_r = tdm.exchange_matching(q, m)
        s_r = tdm.exchange_matching(scales, m)
        acc = ref.dequant_acc_ref(q_r, s_r, torch.zeros_like(x32) if acc is None else acc,
                                  fused._row_weights(w_m, x), block)
    if acc is None:
        acc = torch.zeros_like(x32)
    return acc.add_(fused._row_weights(diag, x)[:, None] * x32).to(x.dtype)


@pytest.mark.parametrize("block", [1024, 256])
@pytest.mark.parametrize("name", sorted(RELATIONS))
def test_gossip_fold_ref_equals_unfused_chain(name, block):
    diag, matchings, per_matching = _weights(RELATIONS[name])
    x = _x(5 * 1024, seed=block)
    q, scales = ops.quantize(x, block=block, impl="ref")
    plan = fused.row_plan([tdm.matching_sources(m, N) for m in matchings], per_matching,
                          diag, x.device)
    got = ops.gossip_fold(x, q, scales, plan.src, plan.w, plan.diag, block=block, impl="ref")
    assert torch.equal(got, _chain(x, diag, matchings, per_matching, block))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(RELATIONS))
def test_int8_gossip_matchings_equals_unfused_chain(name, dtype):
    diag, matchings, per_matching = _weights(RELATIONS[name])
    x = _x(3 * 1024, dtype, seed=len(matchings))
    got = fused.int8_gossip_matchings(x, diag, matchings, per_matching)
    assert got.dtype == dtype
    assert torch.equal(got, _chain(x, diag, matchings, per_matching, fused.DEFAULT_BLOCK))


def test_row_plan_misses_once_per_relation_then_hits():
    fused.clear_row_plans()
    x = _x(1024)
    with telemetry.record_scope() as rec:
        for edges in PLAN:
            fused.int8_gossip(x, _rel(edges), N)
        assert rec.get_counter("fused.row_plan.misses") == 6
        assert rec.get_counter("fused.row_plan.hits") == 6
        fused.int8_gossip(x[:4], _rel([(0, 1), (2, 3)], 4), 4)
        assert rec.get_counter("fused.row_plan.misses") == 7
        fused.clear_row_plans()
        assert "fused.row_plan.misses" not in rec.counters


def test_row_plan_holds_sources_and_weights_as_the_reference_casts():
    diag, matchings, per_matching = _weights(RELATIONS["two"])
    src = [tdm.matching_sources(m, N) for m in matchings]
    plan = fused.row_plan(src, per_matching, diag, torch.device("cpu"))
    assert plan.src.dtype == torch.int32 and plan.src.tolist() == np.array(src).tolist()
    assert torch.equal(plan.w, torch.as_tensor(np.array(per_matching), dtype=torch.float32))
    assert torch.equal(plan.diag, torch.as_tensor(diag, dtype=torch.float32))
    assert fused.row_plan(src, per_matching, diag, torch.device("cpu")) is plan


@pytest.mark.parametrize("name", sorted(RELATIONS))
def test_int8_gossip_counts_two_gathers_per_matching(name):
    diag, matchings, per_matching = _weights(RELATIONS[name])
    before = tdm.gather_count()
    fused.int8_gossip_matchings(_x(1024), diag, matchings, per_matching)
    assert tdm.gather_count() - before == 2 * len(matchings)


def test_matching_sources_and_ship_matching():
    m = _rel([(0, 5), (1, 4)])
    assert tdm.matching_sources(m, N).tolist() == [5, 4, -1, -1, 1, 0, -1, -1]
    before = tdm.gather_count()
    assert tdm.ship_matching(m, N, payloads=2).tolist() == [5, 4, -1, -1, 1, 0, -1, -1]
    assert tdm.gather_count() - before == 2
    assert (tdm.ship_matching(_rel([]), N, payloads=2) == -1).all()
    assert tdm.gather_count() - before == 2          # an empty matching moves nothing
