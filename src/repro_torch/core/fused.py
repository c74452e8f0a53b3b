"""Fused flat-buffer TDM exchange: O(matchings) gathers per round.

Counterpart of the JAX package's ``core/fused.py``. The parameter pytree
(stacked: every leaf has the node axis first) is flattened ONCE per round
into dtype-bucketed, block-padded ``(n, padded)`` buffers; the whole mixing
step runs on those buffers; the result is unflattened. Per bucket a round
costs M gathers for an M-matching relation (2M for int8: payload and scales;
M for CHOCO top-k, whose values and block-local indices travel packed in one
int32 payload), independent of the leaf count.

The compressed modes run on the ``tdm_compress`` functions: a quantize (or
top-k) launch over the whole stacked buffer on the send side. On the receive
side int8 makes one gossip-fold launch, which reads every row's arrivals
from the senders' codes by a cached row plan (:func:`row_plan`) and adds the
self term; top-k one scatter-accumulate launch per matching covering all
nodes, with one weight per row. ``quant_impl="auto"`` takes the CUDA kernels
for CUDA tensors and the plain PyTorch versions for CPU tensors; ``"ref"``
forces the plain versions (the yardstick on the card).

Numerical contract, as in the reference: ``none`` is bit-identical to the
per-leaf path (same elementwise gossip on the concatenation); ``int8`` and
``topk`` differ from per-leaf by quantization/selection granularity.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import tdm
from repro_torch.core.relation import Relation
from repro_torch.kernels.tdm_compress import ops
from repro_torch.pytree import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.telemetry import recorder as telemetry

DEFAULT_BLOCK = 1024


def dtype_name(dtype: torch.dtype) -> str:
    """torch dtype -> numpy-style name ("float32", "bfloat16", ...)."""
    return str(dtype).replace("torch.", "")


# ---------------------------------------------------------------------------
# Flat-buffer spec: static layout of a stacked pytree
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LeafSlot:
    """Where one (per-node) leaf lives inside its bucket's flat buffer."""

    bucket: str                 # dtype name, e.g. "float32"
    offset: int                 # element offset into the bucket buffer
    size: int                   # number of elements per node
    shape: Tuple[int, ...]      # per-node shape (node axis dropped)


@dataclasses.dataclass(frozen=True)
class FlatSpec:
    """Leaf -> (bucket, offset) plus padded bucket sizes (per node).

    Buffers are padded to a multiple of ``block`` so blockwise compression
    tiles them exactly; padding lanes hold zeros and never travel back.
    """

    treedef: Any
    slots: Tuple[LeafSlot, ...]
    bucket_sizes: Tuple[Tuple[str, int], ...]   # (bucket, padded elements)
    bucket_leaves: Tuple[Tuple[str, int], ...]  # (bucket, n leaves)
    block: int

    @property
    def buckets(self) -> List[str]:
        return [b for b, _ in self.bucket_sizes]

    def padded_size(self, bucket: str) -> int:
        return dict(self.bucket_sizes)[bucket]

    def n_leaves(self, bucket: str) -> int:
        return dict(self.bucket_leaves)[bucket]


def build_spec(params: Any, block: int = DEFAULT_BLOCK) -> FlatSpec:
    """Lay out a stacked pytree's leaves into dtype-bucketed buffers.

    Leaves keep tree order (dict keys sorted) within their bucket; buckets
    are sorted by dtype name, so the layout equals the reference's.
    """
    leaves, treedef = tree_flatten(params)
    by_bucket: Dict[str, int] = {}
    counts: Dict[str, int] = {}
    slots = []
    for leaf in leaves:
        bucket = dtype_name(leaf.dtype)
        shape = tuple(leaf.shape[1:])
        size = int(np.prod(shape)) if shape else 1
        off = by_bucket.get(bucket, 0)
        slots.append(LeafSlot(bucket, off, size, shape))
        by_bucket[bucket] = off + size
        counts[bucket] = counts.get(bucket, 0) + 1
    sizes = tuple((b, -(-by_bucket[b] // block) * block) for b in sorted(by_bucket))
    return FlatSpec(
        treedef=treedef,
        slots=tuple(slots),
        bucket_sizes=sizes,
        bucket_leaves=tuple((b, counts[b]) for b in sorted(by_bucket)),
        block=block,
    )


# Specs depend only on (tree structure, leaf shapes/dtypes, block); FL loops
# see the same layout every round. Bounded FIFO cache; hit/miss counts go to
# the active recorder under this prefix.
_SPEC_CACHE: Dict[Any, FlatSpec] = {}
_SPEC_CACHE_MAX = 128
SPEC_CACHE_COUNTER = "fused.spec_cache"


def _spec_key(params: Any, block: int):
    leaves, treedef = tree_flatten(params)
    return (
        treedef,
        int(block),
        tuple((dtype_name(l.dtype), tuple(l.shape[1:])) for l in leaves),
    )


def cached_spec(params: Any, block: int = DEFAULT_BLOCK) -> FlatSpec:
    """:func:`build_spec` behind a cache keyed by (treedef, per-node leaf
    shapes/dtypes, block)."""
    key = _spec_key(params, block)
    rec = telemetry.get_recorder()
    spec = _SPEC_CACHE.get(key)
    if spec is None:
        rec.counter(f"{SPEC_CACHE_COUNTER}.misses")
        spec = build_spec(params, block=block)
        if len(_SPEC_CACHE) >= _SPEC_CACHE_MAX:
            _SPEC_CACHE.pop(next(iter(_SPEC_CACHE)))
        _SPEC_CACHE[key] = spec
    else:
        rec.counter(f"{SPEC_CACHE_COUNTER}.hits")
    return spec


def spec_cache_stats() -> Dict[str, int]:
    """Hit and miss counts of the active recorder's run scope, and the
    size of the process-wide layout cache."""
    rec = telemetry.get_recorder()
    return {
        "hits": int(rec.get_counter(f"{SPEC_CACHE_COUNTER}.hits")),
        "misses": int(rec.get_counter(f"{SPEC_CACHE_COUNTER}.misses")),
        "size": len(_SPEC_CACHE),
    }


def clear_spec_cache() -> None:
    """Empty the layout cache and drop its counters from the active recorder."""
    _SPEC_CACHE.clear()
    telemetry.get_recorder().pop_counters(SPEC_CACHE_COUNTER)


def flatten_pytree(spec: FlatSpec, params: Any) -> Dict[str, torch.Tensor]:
    """Stacked pytree -> {dtype name: (n, padded) buffer}."""
    leaves, treedef = tree_flatten(params)
    if treedef != spec.treedef:
        raise ValueError(f"tree mismatch: {treedef} != {spec.treedef}")
    n = leaves[0].shape[0]
    parts: Dict[str, List[torch.Tensor]] = {b: [] for b in spec.buckets}
    used: Dict[str, int] = {b: 0 for b in spec.buckets}
    for slot, leaf in zip(spec.slots, leaves):
        parts[slot.bucket].append(leaf.reshape(n, -1))
        used[slot.bucket] += slot.size
    out = {}
    for bucket in spec.buckets:
        pad = spec.padded_size(bucket) - used[bucket]
        like = parts[bucket][0]
        if pad:
            parts[bucket].append(like.new_zeros((n, pad)))
        out[bucket] = torch.cat(parts[bucket], dim=1)
    return out


def unflatten_pytree(spec: FlatSpec, buffers: Dict[str, torch.Tensor]) -> Any:
    """Inverse of :func:`flatten_pytree`; leaves are views of the buffers."""
    leaves = []
    for slot in spec.slots:
        buf = buffers[slot.bucket]
        leaves.append(
            buf[:, slot.offset:slot.offset + slot.size].reshape((buf.shape[0],) + slot.shape)
        )
    return tree_unflatten(spec.treedef, leaves)


# ---------------------------------------------------------------------------
# Fused buffer mixing
# ---------------------------------------------------------------------------

def _resolve_impl(impl: str, x: torch.Tensor) -> str:
    """'auto' -> 'cuda' for CUDA tensors, 'ref' for CPU tensors. 'ref' on a
    CUDA tensor only when asked for explicitly."""
    if impl == "auto":
        return "cuda" if x.is_cuda else "ref"
    if impl not in ("cuda", "ref"):
        raise ValueError(f"unknown quant impl {impl!r}")
    return impl


def _row_weights(values, x: torch.Tensor) -> torch.Tensor:
    """float64 numpy weights -> (n,) float32, cast as the reference casts."""
    return torch.as_tensor(np.array(values), dtype=torch.float32, device=x.device)


@dataclasses.dataclass(frozen=True)
class RowPlan:
    """What each row of a stacked buffer receives in one gossip step, on the
    buffer's device: ``src[m, i]`` the row that node i reads over matching m
    (-1 outside it), ``w[m, i]`` its weight, ``diag[i]`` the self weight."""

    src: torch.Tensor     # (M, n) int32
    w: torch.Tensor       # (M, n) float32
    diag: torch.Tensor    # (n,) float32


# A slot schedule cycles through a few relations; each one's plan is uploaded
# once. Bounded FIFO cache keyed by the rows' sources, the weights, n and the
# device; hit/miss counts go to the active recorder under this prefix.
_ROW_PLANS: Dict[Any, RowPlan] = {}
_ROW_PLANS_MAX = 128
ROW_PLAN_COUNTER = "fused.row_plan"


def row_plan(sources, per_matching, diag, device) -> RowPlan:
    """The :class:`RowPlan` of matchings whose :func:`repro_torch.core.tdm.
    matching_sources` are ``sources``, with per-row weights ``per_matching``
    and self weights ``diag`` (float64 numpy, cast as the reference casts),
    from the cache or uploaded to ``device`` once."""
    n = len(diag)
    src = np.array(sources, dtype=np.int32).reshape(len(sources), n)
    w = np.array(per_matching, dtype=np.float64).reshape(len(sources), n)
    d = np.array(diag, dtype=np.float64)
    key = (torch.device(device), n, src.tobytes(), w.tobytes(), d.tobytes())
    rec = telemetry.get_recorder()
    plan = _ROW_PLANS.get(key)
    if plan is None:
        rec.counter(f"{ROW_PLAN_COUNTER}.misses")
        plan = RowPlan(
            src=torch.as_tensor(src, device=device),
            w=torch.as_tensor(w, dtype=torch.float32, device=device),
            diag=torch.as_tensor(d, dtype=torch.float32, device=device),
        )
        if len(_ROW_PLANS) >= _ROW_PLANS_MAX:
            _ROW_PLANS.pop(next(iter(_ROW_PLANS)))
        _ROW_PLANS[key] = plan
    else:
        rec.counter(f"{ROW_PLAN_COUNTER}.hits")
    return plan


def clear_row_plans() -> None:
    """Empty the row-plan cache and drop its counters from the active recorder."""
    _ROW_PLANS.clear()
    telemetry.get_recorder().pop_counters(ROW_PLAN_COUNTER)


def int8_gossip(
    x: torch.Tensor,
    rel: Relation,
    n: int,
    *,
    block: int = DEFAULT_BLOCK,
    impl: str = "auto",
) -> torch.Tensor:
    """One Metropolis gossip step with blockwise-int8 payloads.

    The send side quantizes the whole (n, padded) buffer once; each matching
    ships (int8 payload, f32 scales), two gathers, and the receive side
    folds every arrival and the self term in one pass over all rows.
    ``x.shape[1] % block == 0`` (the FlatSpec contract).
    """
    if len(rel) == 0:
        return x
    diag, per_matching = tdm.matching_weight_vectors(rel, n)
    return int8_gossip_matchings(
        x, diag, tdm.edge_coloring(rel), per_matching, block=block, impl=impl
    )


def int8_gossip_matchings(
    x: torch.Tensor,
    diag,
    matchings,
    per_matching,
    *,
    block: int = DEFAULT_BLOCK,
    impl: str = "auto",
) -> torch.Tensor:
    """:func:`int8_gossip` over given matchings and per-row weight vectors.

    Under tracing, each phase is a device span: ``tdm.quantize``; per
    matching ``tdm.gather``, the host side of its exchange (the row each
    node receives, counted as two gathers: codes and scales; no stream
    work); ``tdm.fold``, the row plan's lookup and the one pass that reads
    every row's arrivals where they lie and adds the self term; ``tdm.self``,
    the cast back to ``x``'s dtype."""
    impl = _resolve_impl(impl, x)
    rec = telemetry.get_recorder()
    dev = x.device
    with rec.span("tdm.quantize", cat="exchange", device=dev):
        x32 = x.to(torch.float32)
        q, scales = ops.quantize(x32, block=block, impl=impl)
    sources = []
    for m in matchings:
        with rec.span("tdm.gather", cat="exchange", device=dev):
            sources.append(tdm.ship_matching(m, x.shape[0], payloads=2))
    with rec.span("tdm.fold", cat="exchange", device=dev):
        plan = row_plan(sources, per_matching, diag, dev)
        out = ops.gossip_fold(x32, q, scales, plan.src, plan.w, plan.diag,
                              block=block, impl=impl)
    with rec.span("tdm.self", cat="exchange", device=dev):
        return out.to(x.dtype)


def choco_fused_round(
    buf: torch.Tensor,
    state: tdm.ChocoState,
    rel: Relation,
    n: int,
    k_total: int,
    *,
    gamma: float = 0.4,
    block: int = DEFAULT_BLOCK,
    impl: str = "auto",
    matchings: Optional[List[Relation]] = None,
) -> Tuple[torch.Tensor, tdm.ChocoState]:
    """One CHOCO-Gossip round on a fused (n, padded) buffer.

    Selection: one top-k pass picks ``ceil(k_total/nb)`` coordinates per
    block and emits the dense sparsified update plus the payload; values
    (viewed as int32) and indices are packed into one ``(n, nb, 2, k_b)``
    payload, one gather per matching; each arrival folds into ``s`` with one
    scatter-accumulate pass. State is carried in float32. ``matchings``:
    ``rel``'s :func:`~repro_torch.core.tdm.edge_coloring`, where the caller
    already has it.
    """
    if buf.shape[1] % block:
        raise ValueError(
            f"fused CHOCO needs a block-padded buffer: {buf.shape[1]} % {block} != 0"
        )
    impl = _resolve_impl(impl, buf)
    nb = buf.shape[1] // block
    k_b = max(1, min(block, -(-int(k_total) // nb)))
    x32 = buf.to(torch.float32)
    x_hat = state.x_hat.to(torch.float32)
    s = state.s.to(torch.float32)

    dense_q, vals, idxs = ops.topk_sparsify(x32 - x_hat, k=k_b, block=block, impl=impl)
    new_x_hat = x_hat + dense_q
    del dense_q
    payload = torch.stack([vals.view(torch.int32), idxs], dim=2)  # (n, nb, 2, k_b)
    del vals, idxs

    W = tdm.metropolis_weights(rel, n)
    matchings = tdm.edge_coloring(rel) if matchings is None else matchings
    _, per_matching = tdm.matching_weight_vectors(rel, n, matchings)
    for m, w_m in zip(matchings, per_matching):
        p_r = tdm.exchange_matching(payload, m)
        v_r = p_r[:, :, 0, :].contiguous().view(torch.float32)
        i_r = p_r[:, :, 1, :].contiguous()
        s = ops.scatter_accumulate(v_r, i_r, s, _row_weights(w_m, buf), block=block, impl=impl)

    deg_w = np.zeros((n,), dtype=np.float32)
    for i in range(n):
        deg_w[i] = sum(W[i, j] for j in rel.peers_of(i))
    neg_d = torch.as_tensor(-deg_w, device=buf.device)[:, None]
    # x + gamma * (s - d * x_hat) in one temporary: (-d) * x_hat + s rounds
    # exactly as s - d * x_hat (negation is exact)
    new_x = (neg_d * new_x_hat).add_(s).mul_(float(np.float32(gamma))).add_(x32)
    return new_x.to(buf.dtype), tdm.ChocoState(x_hat=new_x_hat, s=s)


def mix_wire_bytes(
    n_elems: int,
    itemsize: int,
    compression: str,
    *,
    k: int = 0,
    block: int = DEFAULT_BLOCK,
) -> int:
    """Wire bytes ONE node ships per matching for one buffer: the raw buffer
    (none), int8 payload plus one f32 scale per block (int8), or ``k`` packed
    (value, index) pairs per block (topk)."""
    nb = -(-int(n_elems) // int(block))
    if compression == "topk":
        return nb * int(k) * 8
    if compression == "int8":
        return int(n_elems) + nb * 4
    return int(n_elems) * int(itemsize)


def _account_exchange(
    n_matchings: int, n_elems: int, itemsize: int, compression: str, k: int, block: int
) -> None:
    """Host-side exchange-size accounting: the link bytes of one buffer's
    mix over ``n_matchings`` matchings, counted on the active recorder."""
    wire = n_matchings * mix_wire_bytes(n_elems, itemsize, compression, k=k, block=block)
    telemetry.get_recorder().counter("fused.exchange.wire_bytes_per_round", wire)


def fused_buffer_mix(
    buf: torch.Tensor,
    rel: Relation,
    n: int,
    cfg,
    residual: Optional[tdm.ChocoState] = None,
    *,
    n_leaves: int = 1,
    block: int = DEFAULT_BLOCK,
    quant_impl: str = "auto",
) -> Tuple[torch.Tensor, Optional[tdm.ChocoState]]:
    """One TDM-FLA mixing step for one (n, padded) buffer. ``cfg`` is a
    :class:`repro_torch.core.fl.TDMFLAConfig`; ``n_leaves`` scales the top-k
    budget so fused CHOCO ships what the per-leaf path would."""
    if len(rel) == 0:
        return buf, residual
    length = buf.shape[1]
    k = min(cfg.topk_k * max(n_leaves, 1), length) if cfg.compression == "topk" else 0
    matchings = tdm.edge_coloring(rel)
    _account_exchange(len(matchings), length, buf.element_size(), cfg.compression, k, block)
    if cfg.compression == "topk":
        state = (
            residual
            if isinstance(residual, tdm.ChocoState)
            else tdm.choco_init(buf.to(torch.float32))
        )
        return choco_fused_round(
            buf, state, rel, n, k, gamma=cfg.choco_gamma, block=block, impl=quant_impl,
            matchings=matchings,
        )
    if cfg.compression == "int8":
        diag, per_matching = tdm.matching_weight_vectors(rel, n, matchings)
        return int8_gossip_matchings(
            buf, diag, matchings, per_matching, block=block, impl=quant_impl
        ), residual
    if cfg.comm == "get1meas":
        return tdm.gossip_avg_serial(buf, rel, n), residual
    diag, per_matching = tdm.matching_weight_vectors(rel, n, matchings)
    return tdm.gossip_matchings(buf, diag, matchings, per_matching), residual


def fused_tdm_fla_round(
    params: Any,
    rel: Relation,
    n: int,
    cfg,
    residuals: Any = None,
    *,
    block: int = DEFAULT_BLOCK,
    quant_impl: str = "auto",
) -> Tuple[Any, Any]:
    """One TDM-FLA round over a whole stacked pytree: flatten, mix each
    dtype bucket, unflatten. Residuals (CHOCO state) are keyed by bucket.
    Under tracing, the round is a ``tdm.round`` device span holding
    ``tdm.flatten``, the mix's spans and ``tdm.unflatten``."""
    if len(rel) == 0:
        return params, residuals
    rec = telemetry.get_recorder()
    dev = tree_leaves(params)[0].device if rec.tracing else None
    with rec.span("tdm.round", cat="exchange", device=dev):
        spec = cached_spec(params, block=block)
        with rec.span("tdm.flatten", cat="exchange", device=dev):
            buffers = flatten_pytree(spec, params)
        res_in = residuals if isinstance(residuals, dict) else {}
        mixed, res_out = {}, {}
        for bucket in spec.buckets:
            buf = buffers.pop(bucket)
            mixed[bucket], res_out[bucket] = fused_buffer_mix(
                buf, rel, n, cfg, res_in.get(bucket),
                n_leaves=spec.n_leaves(bucket), block=block, quant_impl=quant_impl,
            )
            del buf
        with rec.span("tdm.unflatten", cat="exchange", device=dev):
            out = unflatten_pytree(spec, mixed)
    return out, res_out


# ---------------------------------------------------------------------------
# Two-level (pod x data) gossip on fused buffers
# ---------------------------------------------------------------------------

_HIERARCHICAL_COMPRESSIONS = ("none", "int8")


def hierarchical_buffer_mix(
    buf: torch.Tensor,
    intra_rel: Relation,
    inter_rel: Relation,
    n_data: int,
    n_pods: int,
    *,
    compression: str = "none",
    block: int = DEFAULT_BLOCK,
    quant_impl: str = "auto",
) -> torch.Tensor:
    """Two-level TDM mixing of one ``(n_pods * n_data, padded)`` buffer:
    gossip within each pod over ``intra_rel``, then between pods over
    ``inter_rel`` (:func:`repro_torch.core.tdm.hierarchical_gossip` on the
    fused engine). Row ``pod * n_data + data`` is a node; each level's
    matchings are coloured at the level's size and lifted onto the rows
    (:func:`repro_torch.core.tdm.level_weight_vectors`), so one gather
    serves every pod at once. Under int8 each level quantizes once, each of
    its matchings ships codes and scales, and one gossip-fold pass takes
    them in.

    ``compression`` is ``"none"`` or ``"int8"``: top-k/CHOCO state is tied
    to one fixed relation and does not fit a two-level schedule.
    """
    if compression not in _HIERARCHICAL_COMPRESSIONS:
        raise ValueError(
            "hierarchical gossip compression must be one of "
            f"{_HIERARCHICAL_COMPRESSIONS}, got {compression!r} (topk/CHOCO "
            "state is tied to one fixed relation, not a two-level schedule)"
        )
    for rel, level in ((intra_rel, "data"), (inter_rel, "pod")):
        if len(rel) == 0:
            continue
        diag, matchings, per_matching = tdm.level_weight_vectors(rel, level, n_data, n_pods)
        if compression == "int8":
            buf = int8_gossip_matchings(
                buf, diag, matchings, per_matching, block=block, impl=quant_impl
            )
        else:
            buf = tdm.gossip_matchings(buf, diag, matchings, per_matching)
    return buf


def fused_hierarchical_round(
    params: Any,
    intra_rel: Relation,
    inter_rel: Relation,
    n_data: int,
    n_pods: int,
    *,
    compression: str = "none",
    block: int = DEFAULT_BLOCK,
    quant_impl: str = "auto",
) -> Any:
    """Two-level (pod x data) TDM round over a whole stacked pytree: flatten
    once, mix each dtype bucket at both levels, unflatten. ``"none"`` is
    bit-identical to per-leaf :func:`repro_torch.core.tdm.hierarchical_gossip`;
    a round issues ``(M_intra + M_inter) x per x n_buckets`` gathers with
    ``per = 2`` for int8
    (:func:`repro_torch.telemetry.expected_hierarchical_collectives`).
    """
    spec = cached_spec(params, block=block)
    buffers = flatten_pytree(spec, params)
    mixed = {}
    for bucket in spec.buckets:
        buf = buffers.pop(bucket)
        mixed[bucket] = hierarchical_buffer_mix(
            buf, intra_rel, inter_rel, n_data, n_pods,
            compression=compression, block=block, quant_impl=quant_impl,
        )
        del buf
    return unflatten_pytree(spec, mixed)
