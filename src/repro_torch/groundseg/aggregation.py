"""Centralized / hierarchical FedAvg over the ground segment, on fused flat
buffers stacked over the node axis.

Counterpart of the JAX package's ``groundseg/aggregation.py``. There one node
runs per device under ``shard_map`` and the relay programs of
:mod:`repro_torch.groundseg.routing` lower to collectives; here the ``n``
nodes (satellites and ground sinks) are the rows of every ``(n, padded)``
buffer of :mod:`repro_torch.core.fused`, and each collective has a stacked
form:

- a ``ppermute`` of one batch of sends is one row gather
  (:func:`repro_torch.core.tdm.gather_rows`, counted by
  :func:`repro_torch.core.tdm.gather_count`): the rows that arrive, put
  where they land;
- the ``pmax`` that agrees the int8 relay's shared scales is an ``amax``
  over ALL n rows (sinks, idle and dead satellites included, as the
  reference's all-reduce runs on every device), NaN propagating;
- the masked ``psum`` that pools the sinks is a row sum of the sink rows.

Both reductions are counted by :func:`reduction_count`, so a round's issued
gathers and reductions can be held against :func:`expected_collectives`.

Where the reference's arithmetic is exact the port matches it bit for bit,
so each step keeps the reference's order. The uplink gathers every batch of
a slot from the pre-slot buffer and adds arrivals in batch order onto the
buffer with its senders zeroed; rows that receive nothing in a batch get the
``+ 0.0`` the reference's ``acc + ppermute(...)`` gives them (it turns
``-0.0`` into ``+0.0``). The downlink gathers each batch from the buffer as
the previous batch left it and overwrites only the receivers. The int8
uplink is quantize-once: codes with the shared scales, exact int16 sums on
the wire, one dequant-accumulate at the end. The reference passes that
fold the constant weight 1.0, and under jit XLA drops the multiply by it and
fuses ``acc + q * s`` into one multiply-add; the port's unit-weight
accumulate (``w=None``) rounds once in the same way. (The reference's Pallas
kernel takes the weight as an operand and rounds the product first; the port
follows the jitted plain path.)

Memory: unlike the reference's pure functions, every step updates what it is
given in place: the buffer steps overwrite the buffers passed to them (use
what they return), and the round functions write into ``params`` (and
``carry`` and ``pending``). A caller that needs its inputs afterwards clones
them first. Row gathers copy only the rows that travel.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import fused, tdm
from repro_torch.groundseg.routing import (
    BroadcastProgram,
    RelayProgram,
    permutation_batches,
    program_batch_count,
)
from repro_torch.kernels.tdm_compress import ops
from repro_torch.kernels.tdm_compress import ref as q_ref
from repro_torch.pytree import tree_leaves

Buffers = Dict[str, torch.Tensor]

_COMPRESSIONS = ("none", "int8")
_REDUCTIONS = [0]


def reduction_count() -> int:
    """All-node reductions (the reference's ``pmax``/``psum``) issued by
    this module in this process."""
    return _REDUCTIONS[0]


def _check_compression(compression: str) -> None:
    if compression not in _COMPRESSIONS:
        raise ValueError(
            f"groundseg relay compression must be one of {_COMPRESSIONS}, "
            f"got {compression!r} (topk/CHOCO is stateful per relation and "
            "does not fit a one-shot relay hop)"
        )


def _scalar(value, like: torch.Tensor) -> torch.Tensor:
    """A float32 scalar as a 0-dim tensor on ``like``'s device. On the card
    a CPU scalar divisor would be turned into a multiply by its reciprocal;
    a device tensor keeps the true division."""
    return torch.tensor(np.float32(value), device=like.device)


def shared_scales(x32: torch.Tensor, block: int) -> torch.Tensor:
    """The relay's shared blockwise scales: each row's
    ``blockwise_scales_ref``, then the max over all rows (the reference's
    ``pmax``; NaN propagates). One row at a time, so the temporaries stay
    one row wide."""
    s = q_ref.blockwise_scales_ref(x32[0], block=block)
    for r in range(1, x32.shape[0]):
        s = torch.maximum(s, q_ref.blockwise_scales_ref(x32[r], block=block))
    _REDUCTIONS[0] += 1
    return s


def _relay_none(buf: torch.Tensor, program: RelayProgram) -> torch.Tensor:
    n = buf.shape[0]
    for sends in program.slot_sends:
        if not sends:
            continue
        batches = permutation_batches(sends)
        arrivals = [tdm.gather_rows(buf, batch) for batch in batches]
        senders = sorted({s for s, _ in sends})
        for s in senders:
            buf[s].zero_()
        plus_zero = set(senders)      # rows holding no -0.0
        for batch, recv in zip(batches, arrivals):
            dst = {d: k for k, (_, d) in enumerate(batch)}
            for r in range(n):
                if r in dst:
                    buf[r].add_(recv[dst[r]])
                elif r not in plus_zero:
                    buf[r].add_(0.0)
                    plus_zero.add(r)
    return buf


def int8_uplink_sums(x32: torch.Tensor, program: RelayProgram, *,
                     block: int = fused.DEFAULT_BLOCK, impl: str = "auto"):
    """The int8 uplink's wire channel: ``(shared scales (nb,), z)``, where
    z (n, len) int16 holds each row's post-relay sum of codes. Every node
    that ever sends encodes its row once with the shared scales; other rows
    start at 0; per slot the senders' pre-slot sums are gathered (one
    gather per batch), the senders shed theirs, and arrivals add exactly."""
    impl = fused._resolve_impl(impl, x32)
    sources = sorted({s for sends in program.slot_sends for s, _ in sends})
    s_shared = shared_scales(x32, block)
    q = ops.quantize_scaled(x32, s_shared, block=block, impl=impl)
    z = torch.zeros(q.shape, dtype=torch.int16, device=q.device)
    for s in sources:
        z[s].copy_(q[s])
    del q
    for sends in program.slot_sends:
        if not sends:
            continue
        batches = permutation_batches(sends)
        arrivals = [tdm.gather_rows(z, batch) for batch in batches]
        for s in sorted({s for s, _ in sends}):
            z[s].zero_()
        for batch, recv in zip(batches, arrivals):
            for k, (_, d) in enumerate(batch):
                z[d].add_(recv[k])
        del arrivals
    return s_shared, z


def _relay_int8(buf: torch.Tensor, program: RelayProgram, sources: Sequence[int],
                block: int, impl: str) -> torch.Tensor:
    n = buf.shape[0]
    x32 = buf.to(torch.float32)     # owned: buf itself, or its float32 copy
    s_shared, z = int8_uplink_sums(x32, program, block=block, impl=impl)
    f = x32                         # the float32 channel: never-senders' models
    for s in sources:
        f[s].zero_()
    scales = s_shared.reshape(1, -1).expand(n, -1).contiguous()
    out = ops.dequant_accumulate(z, scales, f, None, block=block, impl=impl)
    return out.to(buf.dtype)


def relay_uplink(
    buffers: Buffers,
    program: RelayProgram,
    *,
    compression: str = "none",
    block: int = fused.DEFAULT_BLOCK,
    quant_impl: str = "auto",
) -> Buffers:
    """Execute the uplink relay program on stacked fused buffers.

    Per slot every scheduled sender ships its whole accumulated buffer and
    sheds it; arrivals (also at a sender, which keeps them for its next hop)
    accumulate. Nodes outside the program are untouched.

    int8 is quantize-once: shared blockwise scales (the max over all rows,
    one reduction per bucket), every node that ever sends encodes once with
    ``quantize_scaled``, int16 partial sums ride the gathers (one per batch
    per bucket), and one dequant-accumulate at the end folds them onto the
    float32 channel that holds the never-sent models (the sinks' anchors).
    """
    _check_compression(compression)
    out = dict(buffers)
    sources = sorted({s for sends in program.slot_sends for s, _ in sends})
    for bucket, buf in out.items():
        if compression == "int8" and sources:
            impl = fused._resolve_impl(quant_impl, buf)
            out[bucket] = _relay_int8(buf, program, sources, block, impl)
        elif compression == "none":
            out[bucket] = _relay_none(buf, program)
    return out


def sink_weights(program: RelayProgram) -> np.ndarray:
    """Static FedAvg denominators: per node, the number of payloads its
    post-uplink buffer sums (delivered satellites + the sink's own model
    for sinks; 0 elsewhere — non-sinks never divide)."""
    w = np.zeros((program.n_nodes,), dtype=np.float32)
    for k, srcs in program.delivered.items():
        w[k] = 1.0 + len(srcs)
    return w


def staleness_sink_weights(
    program: RelayProgram,
    delivered_ages: Dict[int, int],
    decay: float,
) -> np.ndarray:
    """Per-sink FedAvg denominators with per-satellite staleness weighting.

    A payload delivered at age ``a`` (windows since its snapshot) carries
    weight ``decay ** a``: the carry channel multiplies a queued buffer by
    ``decay`` once per window boundary, so by delivery the payload VALUE is
    scaled ``decay ** a`` and this denominator matches it exactly. At age 0
    (or ``decay == 1``) every weight is 1.0 and this reduces bit-for-bit to
    :func:`sink_weights` — exact FedAvg."""
    w = np.zeros((program.n_nodes,), dtype=np.float32)
    for k, srcs in program.delivered.items():
        total = np.float32(1.0)
        for s in sorted(srcs):
            # repeated f32 multiply, mirroring the per-window buffer scaling
            ws = np.float32(1.0)
            for _ in range(int(delivered_ages.get(s, 0))):
                ws = np.float32(ws * np.float32(decay))
            total = np.float32(total + ws)
        w[k] = total
    return w


def sink_fedavg(
    buffers: Buffers,
    program: RelayProgram,
    *,
    pool: bool,
    weights: Optional[np.ndarray] = None,
) -> Buffers:
    """FedAvg at the sinks: regional mean of (own model + delivered sums).

    ``pool=True`` reconciles the sinks over terrestrial backhaul: the sink
    rows are summed (one reduction per bucket) and every sink takes the
    identical global FedAvg. The reference divides that sum by a constant,
    which XLA compiles to a multiply by its float32 reciprocal; the port
    multiplies by the same reciprocal. ``pool=False`` leaves per-sink
    regional models, each sink row divided by its own weight (a true
    division, as in the reference). Satellite rows pass through untouched.

    ``weights`` overrides the static per-node denominators (default:
    payload counts via :func:`sink_weights`; the pipelined engine passes
    :func:`staleness_sink_weights`)."""
    w = sink_weights(program) if weights is None else np.asarray(weights)
    sinks = sorted(program.sinks)
    total_w = float(w.sum())
    my_w = np.maximum(w, 1.0)
    out = dict(buffers)
    for bucket, buf in out.items():
        f32 = buf.to(torch.float32)
        if pool:
            pooled = torch.zeros_like(f32[0])
            for k in sinks:               # the masked psum, in row order
                pooled.add_(f32[k])
            _REDUCTIONS[0] += 1
            inv = np.float32(1.0) / np.float32(max(total_w, 1.0))
            pooled.mul_(_scalar(inv, pooled))
            for k in sinks:
                buf[k].copy_(pooled)
        else:
            for k in sinks:
                buf[k].copy_(f32[k] / _scalar(my_w[k], f32))
    return out


def _broadcast_int8(buf: torch.Tensor, program: BroadcastProgram,
                    receivers: Sequence[int], block: int, impl: str) -> torch.Tensor:
    x32 = buf.to(torch.float32)
    q, s = ops.quantize(x32, block=block, impl=impl)
    for sends in program.slot_sends:
        if not sends:
            continue
        for batch in permutation_batches(sends):
            q_r = tdm.gather_rows(q, batch)
            s_r = tdm.gather_rows(s, batch)
            for k, (_, d) in enumerate(batch):
                q[d].copy_(q_r[k])
                s[d].copy_(s_r[k])
    rows = torch.as_tensor(list(receivers), dtype=torch.int64, device=q.device)
    q_c = q.index_select(0, rows)
    del q
    dec = ops.dequant_accumulate(
        q_c, s.index_select(0, rows),
        torch.zeros(q_c.shape, dtype=torch.float32, device=q_c.device),
        None, block=block, impl=impl,
    )
    for k, r in enumerate(receivers):
        buf[r].copy_(dec[k])
    return buf


def broadcast_downlink(
    buffers: Buffers,
    program: BroadcastProgram,
    *,
    compression: str = "none",
    block: int = fused.DEFAULT_BLOCK,
    quant_impl: str = "auto",
) -> Buffers:
    """Execute the downlink flood on stacked fused buffers: each receiver
    adopts its (single) parent's buffer the slot it is first covered.

    int8 is quantize-once: every row is encoded once up front (only the
    flood roots' codes matter), the (payload, scales) pair is forwarded
    verbatim (two gathers per batch per bucket), and every receiver decodes
    once with the unit-weight dequant-accumulate onto zeros."""
    _check_compression(compression)
    out = dict(buffers)
    receivers = sorted({d for sends in program.slot_sends for _, d in sends})
    for bucket, buf in out.items():
        if compression == "int8":
            if receivers:
                impl = fused._resolve_impl(quant_impl, buf)
                out[bucket] = _broadcast_int8(buf, program, receivers, block, impl)
            continue
        for sends in program.slot_sends:
            if not sends:
                continue
            for batch in permutation_batches(sends):
                recv = tdm.gather_rows(buf, batch)
                for k, (_, d) in enumerate(batch):
                    buf[d].copy_(recv[k])
    return out


def expected_collectives(
    uplink: RelayProgram,
    downlink: Optional[BroadcastProgram],
    n_buckets: int,
    *,
    compression: str = "none",
    pool: bool = True,
) -> Dict[str, int]:
    """Static exchange counts of one ground-segment round: gathers
    (``collective-permute``, one per batch per buffer; int8 uplinks ship one
    int16 payload per batch, int8 downlinks two, payload and scales) and
    all-node reductions (``all-reduce``: the int8 uplink's shared scales
    and the sink pool, one per buffer each). ``downlink=None`` (the first
    window of a depth-2 pipeline) adds nothing. The reference holds its
    compiled HLO against the same counts."""
    up_batches = program_batch_count(uplink)
    down_batches = (
        program_batch_count(downlink) if downlink is not None else 0
    )
    uplink_sends = any(uplink.slot_sends)
    if compression == "int8":
        permutes = (up_batches + 2 * down_batches) * n_buckets
        all_reduce = (n_buckets if uplink_sends else 0) + (
            n_buckets if pool else 0
        )
    else:
        permutes = (up_batches + down_batches) * n_buckets
        all_reduce = n_buckets if pool else 0
    return {
        "collective-permute": permutes,
        "all-reduce": all_reduce,
    }


def expected_window_collectives(
    wp,
    n_buckets: int,
    *,
    compression: str = "none",
    pool: bool = True,
) -> Dict[str, int]:
    """:func:`expected_collectives` for a
    :class:`~repro_torch.groundseg.routing.WindowProgram`."""
    return expected_collectives(
        wp.uplink, wp.downlink, n_buckets, compression=compression, pool=pool
    )


def _adopt(spec, buffers: Buffers, params, rows: Sequence[int]):
    """Rows ``rows`` of every leaf of ``params`` take the mixed buffers'
    values, in place (the reference's ``where(adopt, mixed, params)``);
    other rows keep theirs."""
    mixed = fused.unflatten_pytree(spec, buffers)
    for dst, src in zip(tree_leaves(params), tree_leaves(mixed)):
        for r in rows:
            dst[r].copy_(src[r])
    return params


def groundseg_round(
    params,
    uplink: RelayProgram,
    downlink: BroadcastProgram,
    *,
    pool: bool,
    compression: str = "none",
    block: int = fused.DEFAULT_BLOCK,
    quant_impl: str = "auto",
):
    """One full ground-segment exchange for a stacked parameter pytree:
    flatten -> uplink relay -> sink FedAvg (optionally pooled) -> downlink
    broadcast, and the rows in ``downlink.covered`` adopt the result,
    written into ``params``' own tensors, which are returned. Satellites
    outside it keep their params bit for bit."""
    spec = fused.cached_spec(params, block=block)
    buffers = fused.flatten_pytree(spec, params)
    buffers = relay_uplink(
        buffers, uplink, compression=compression, block=block,
        quant_impl=quant_impl,
    )
    buffers = sink_fedavg(buffers, uplink, pool=pool)
    buffers = broadcast_downlink(
        buffers, downlink, compression=compression, block=block,
        quant_impl=quant_impl,
    )
    return _adopt(spec, buffers, params, sorted(downlink.covered))


# ---------------------------------------------------------------------------
# Pipelined multi-window rounds with a delay-tolerant carry channel
# ---------------------------------------------------------------------------

def stacked_zero_buffers(spec, n_nodes: int, device=None) -> Buffers:
    """Driver-side initial state for the carry / pending-global channels:
    one zeroed fused buffer per dtype bucket, stacked over the node axis."""
    return {
        b: torch.zeros((n_nodes, spec.padded_size(b)), dtype=getattr(torch, b), device=device)
        for b in spec.buckets
    }


def pipelined_window_round(
    params,
    carry: Buffers,
    pending: Buffers,
    wp,
    *,
    pool: bool,
    staleness_decay: float = 1.0,
    compression: str = "none",
    block: int = fused.DEFAULT_BLOCK,
    quant_impl: str = "auto",
):
    """One pipelined, delay-tolerant ground-segment window on stacked fused
    buffers.

    ``wp`` is a :class:`~repro_torch.groundseg.routing.WindowProgram`;
    ``carry`` holds each satellite's still-queued payload buffer (zeros
    where none), ``pending`` the previous round's global model at the sink
    rows (used only when ``wp.lagged_downlink``). Steps:

    1. payload assembly: injecting satellites snapshot their params;
       carriers re-offer their queued buffer times ``staleness_decay`` in
       float32 (so a payload delivered at age ``a`` arrives scaled
       ``decay**a``, matching :func:`staleness_sink_weights`); sinks offer
       their own model as the FedAvg anchor;
    2. uplink relay + staleness-weighted sink FedAvg (pooled per ``pool``);
    3. the new carry is read off the post-relay buffers (an undelivered
       payload never moves, so it sits at its source's row); other rows 0;
    4. downlink: at depth 1 the new global floods (identical to
       :func:`groundseg_round`, bit for bit when nothing is carried); at
       depth 2 the previous round's global (``pending``) floods and the new
       one becomes the next window's pending; the first window of depth 2
       has no downlink. Sinks always adopt the new global.

    Returns ``(params, carry, pending)``, the three updated in place (the
    FL loop keeps carry and pending on the device for the whole run).
    """
    _check_compression(compression)
    spec = fused.cached_spec(params, block=block)
    payload = fused.flatten_pytree(spec, params)
    sinks = sorted(wp.uplink.sinks)

    carriers = sorted(s for s, a in wp.ages.items() if a > 0)
    for b, buf in payload.items():
        if carriers:
            decay = _scalar(staleness_decay, buf)
            for s in carriers:
                buf[s].copy_(carry[b][s].to(torch.float32) * decay)

    post = relay_uplink(
        payload, wp.uplink, compression=compression, block=block,
        quant_impl=quant_impl,
    )
    del payload
    holds = sorted(wp.residual)
    for b, buf in post.items():
        carry[b].zero_()
        for h in holds:
            carry[b][h].copy_(buf[h])

    weights = staleness_sink_weights(wp.uplink, wp.delivered_ages, staleness_decay)
    agg = sink_fedavg(post, wp.uplink, pool=pool, weights=weights)
    new_global = {b: buf[sinks] for b, buf in agg.items()}     # a copy
    if wp.downlink is not None and wp.lagged_downlink:
        # the channel floods last round's global from the sinks
        for b, buf in agg.items():
            for k in sinks:
                buf[k].copy_(pending[b][k])
    for b in pending:
        pending[b].zero_()
        for i, k in enumerate(sinks):
            pending[b][k].copy_(new_global[b][i])

    if wp.downlink is None:
        final = agg
        adopt = sinks
    else:
        final = broadcast_downlink(
            agg, wp.downlink, compression=compression, block=block,
            quant_impl=quant_impl,
        )
        if wp.lagged_downlink:
            for b, buf in final.items():
                for i, k in enumerate(sinks):
                    buf[k].copy_(new_global[b][i])
        adopt = sorted(wp.downlink.covered | wp.uplink.sinks)
    del new_global
    params = _adopt(spec, final, params, adopt)
    return params, carry, pending
