"""Mixture-of-Experts FFN with sort-based capacity dispatch (GShard-style
groups, Switch-style capacity).

Counterpart of the JAX package's ``models/moe.py``, step by step:

- routing: a float32 router product on ``x.float()`` (TF32 switched off for
  it, whatever the caller's setting: routing is discontinuous), the
  softmax, the top-K and the renormalisation ``top_w / max(sum, 1e-9)``.
  The top-K is a stable descending sort, so ties go to the lower expert
  index as ``jax.lax.top_k``'s do (``torch.topk`` promises no order);
- aux losses: the Switch/GShard load balance ``E * sum(me * ce) *
  aux_loss`` and the router z-loss ``mean(logsumexp(logits)^2) *
  router_z_loss``;
- dispatch, per group: a stable argsort of the expert ids, each
  assignment's rank among its expert's, ``keep = rank < C``, the slot
  ``e * C + rank`` (or the sentinel ``E * C``), the ``(G, E*C)`` token and
  weight tables, and the gather of ``x`` padded with one zero row;
- the expert FFN as three batched products in the compute dtype (the
  reference computes them outside any Pallas kernel, so they are plain
  products here too);
- combine: each token's kept contributions added in slot order into a zero
  buffer of the compute dtype, rounding after each add. That is the order
  and rounding of the reference's scatter-add, and it needs no atomics, so
  the card gives the same bits run after run.

Groups are batch rows. At decode (``S == 1`` and ``B > 1``) the reference
merges the batch into one group; ``groups`` says how many groups such a
batch holds (a serving decoder that folds several replicas' lanes into one
batch passes its number of replicas, each replica one group as under the
reference's per-replica ``shard_map``).

A config with ``moe.dropless`` (nemotron-h; the port's own, no counterpart
in the JAX package) takes the second path, :func:`moe_dropless`, where no
assignment is dropped and groups do not matter:

- routing: the float32 router product (TF32 off), the scores
  ``sigmoid(logits)``, the top-K chosen by ``scores + router_bias`` (a
  stable descending sort) and weighted by the chosen unbiased scores over
  their sum (+ 1e-20), times ``routed_scale``;
- experts: the T*K assignments sorted by expert (a stable sort), each
  expert's run one group of :func:`grouped_mm` (``torch._grouped_mm``: the
  group sizes are cumulative offsets on the device, so nothing waits for the
  host, and an expert no token chose reads no weight), each
  ``down(act(up(x)))`` (no gate: a dropless config with ``gated_mlp``
  raises);
- combine: each token's K outputs times their weights summed in float32,
  rounded once to the compute dtype, plus the shared expert's output
  (``shared_d_ff``).

:func:`count_routes` tallies each call's assignments, the experts they hit
and the dropped ones (none), on the device. :func:`tallied` keeps a call's
tally entries in a record of its own, which a CUDA graph that captured the
call appends to the open tallies on each replay.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional, Tuple, TypeVar

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import activation, dtype_of, truncated_normal

Params = Dict[str, torch.Tensor]
T = TypeVar("T")


def init_moe(gen: torch.Generator, cfg: ModelConfig) -> Params:
    m = cfg.moe
    D, E, F = cfg.d_model, m.n_experts, m.d_ff
    dt = dtype_of(cfg.param_dtype)
    std_in, std_out = D ** -0.5, F ** -0.5
    if not m.dropless:
        return {
            "router": truncated_normal(gen, (D, E), std_in, torch.float32),
            "wi": truncated_normal(gen, (E, D, F), std_in, dt),
            "wg": truncated_normal(gen, (E, D, F), std_in, dt),
            "wo": truncated_normal(gen, (E, F, D), std_out, dt),
        }
    _no_gate(cfg)
    # the selection bias is trained to balance the load; drawn small here
    # (its published init is 0)
    p = {"router": truncated_normal(gen, (D, E), std_in, torch.float32),
         "router_bias": truncated_normal(gen, (E,), 0.05, torch.float32)}
    p.update(_init_expert(gen, (E,), D, F, dt))
    if m.shared_d_ff:
        p["shared"] = _init_expert(gen, (), D, m.shared_d_ff, dt)
    return p


def _no_gate(cfg: ModelConfig) -> None:
    if cfg.gated_mlp:
        raise ValueError(f"{cfg.name}: a dropless MoE takes experts without a gate "
                         "(gated_mlp must be False)")


def _init_expert(gen, lead, D: int, F: int, dt) -> Params:
    return {"wi": truncated_normal(gen, lead + (D, F), D ** -0.5, dt),
            "wo": truncated_normal(gen, lead + (F, D), F ** -0.5, dt)}


def capacity(tokens_per_group: int, cfg: ModelConfig) -> int:
    m = cfg.moe
    c = math.ceil(tokens_per_group * m.top_k * m.capacity_factor / m.n_experts)
    # pad to 8 only when the capacity is already large; decode groups
    # (a few tokens) must not inflate E*C slots 8x
    if c >= 8:
        return 8 * math.ceil(c / 8)
    return max(c, 1)


@contextmanager
def _ieee_f32() -> Iterator[None]:
    """float32 matmuls at full precision inside the block (TF32 off)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class Routing(NamedTuple):
    logits: torch.Tensor   # (G, S, E) float32
    probs: torch.Tensor    # (G, S, E) float32
    top_w: torch.Tensor    # (G, S, K) float32, renormalised
    top_e: torch.Tensor    # (G, S, K) int64, best first, ties to the lower index


def route(router: torch.Tensor, x: torch.Tensor, k: int) -> Routing:
    with _ieee_f32():
        logits = torch.einsum("gsd,de->gse", x.to(torch.float32), router.to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = order.values[..., :k], order.indices[..., :k]
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)
    return Routing(logits, probs, top_w, top_e)


class Dispatch(NamedTuple):
    table: torch.Tensor    # (G, E*C) int64: the token in each slot, S where empty
    wtab: torch.Tensor     # (G, E*C) float32: its routing weight, 0 where empty
    slots: torch.Tensor    # (G, S, K) int64: each token's slots ascending, E*C if dropped
    counts: torch.Tensor   # (G, E) int64: assignments per expert, kept or not
    dropped: torch.Tensor  # () int64: assignments over their expert's capacity


def dispatch(top_e: torch.Tensor, top_w: torch.Tensor, n_experts: int, cap: int) -> Dispatch:
    """Sort-based capacity dispatch of each group's (S, K) assignments."""
    G, S, K = top_e.shape
    E, C, TK = n_experts, cap, S * K
    dev = top_e.device
    expert_flat = top_e.reshape(G, TK)
    token_idx = torch.arange(S, device=dev).repeat_interleave(K)            # (TK,)
    order = torch.argsort(expert_flat, dim=-1, stable=True)
    sorted_e = torch.gather(expert_flat, 1, order)
    sorted_t = token_idx[order]
    sorted_w = torch.gather(top_w.reshape(G, TK), 1, order)
    experts = torch.arange(E, device=dev).expand(G, E).contiguous()
    offsets = torch.searchsorted(sorted_e, experts)                         # (G, E) exclusive
    counts = torch.searchsorted(sorted_e, experts, right=True) - offsets
    rank = torch.arange(TK, device=dev) - torch.gather(offsets, 1, sorted_e)
    keep = rank < C
    slot = torch.where(keep, sorted_e * C + rank, E * C)
    table = torch.full((G, E * C + 1), S, dtype=torch.long, device=dev)
    table = table.scatter(1, slot, sorted_t)[:, :E * C]
    wtab = torch.zeros((G, E * C + 1), dtype=sorted_w.dtype, device=dev)
    wtab = wtab.scatter(1, slot, sorted_w)[:, :E * C]
    slots = torch.empty_like(slot).scatter_(1, order, slot)
    slots = torch.sort(slots.view(G, S, K), dim=-1).values
    return Dispatch(table, wtab, slots, counts, (~keep).sum())


def combine(y: torch.Tensor, d: Dispatch) -> torch.Tensor:
    """The experts' outputs y (G, E, C, D), weighted, back in token order
    (G, S, D): each token's kept slots added in slot order into zeros of
    y's dtype, rounding after each add, as the reference's scatter-add
    does; a dropped assignment's sentinel slot adds zero."""
    G, E, C, D = y.shape
    y_w = y.reshape(G, E * C, D) * d.wtab[:, :, None].to(y.dtype)
    y_w = torch.cat([y_w, y_w.new_zeros((G, 1, D))], dim=1)
    rows = torch.arange(G, device=y.device)[:, None]
    out = torch.zeros(d.slots.shape[:2] + (D,), dtype=y.dtype, device=y.device)
    for k in range(d.slots.shape[2]):
        out = out + y_w[rows, d.slots[:, :, k]]
    return out


# the drop tally of :func:`count_drops`, None outside it
_TALLY: Optional[Dict[str, List[torch.Tensor]]] = None


@contextmanager
def count_drops() -> Iterator[Dict[str, List[torch.Tensor]]]:
    """Inside the block every :func:`moe_apply` appends its routed
    assignments and those dropped over capacity, an int64 tensor
    ``[assignments, dropped]`` on the input's device (no wait for the
    device), to the list under ``"prefill"`` (S > 1) or ``"decode"``
    (S == 1) of the yielded dict, in call order: a model call's entries
    are its MoE layers in order. A call replayed from a CUDA graph runs no
    Python: its entries are copies that the replay appends (:func:`tallied`),
    equal to those of the call run eagerly."""
    global _TALLY
    prev, _TALLY = _TALLY, {}
    try:
        yield _TALLY
    finally:
        _TALLY = prev


# the routing tally of :func:`count_routes`, None outside it
_ROUTES: Optional[Dict[str, List[torch.Tensor]]] = None


@contextmanager
def count_routes() -> Iterator[Dict[str, List[torch.Tensor]]]:
    """Inside the block every :func:`moe_dropless` appends an int64 tensor
    ``[assignments, experts hit, dropped]`` on the input's device (no wait
    for the device) to the list under ``"prefill"`` (S > 1) or ``"decode"``
    (S == 1) of the yielded dict, in call order. A call replayed from a
    CUDA graph runs no Python: its entries are copies that the replay
    appends (:func:`tallied`), equal to those of the call run eagerly."""
    global _ROUTES
    prev, _ROUTES = _ROUTES, {}
    try:
        yield _ROUTES
    finally:
        _ROUTES = prev


def tallied(fn: Callable[[], T]) -> Tuple[T, Callable[[], None]]:
    """``fn()`` with the MoE tallies diverted, for a call that a CUDA graph
    captures: whatever its MoE calls append to :func:`count_routes`' or
    :func:`count_drops`' tally, open or not, goes to a record of the call's
    own, each of its lists stacked into one tensor before the call ends (so
    the graph holds it as a static tensor); the open tallies get nothing.
    Returns fn's output and ``retally``, which appends copies of the
    recorded entries to the tallies open when it is called, in the order
    the call made them: one copy per list, no wait for the device. Called
    after each replay, it gives a tally the entries of an eager call. A
    call with no MoE layer records nothing, and its ``retally`` does
    nothing."""
    global _ROUTES, _TALLY
    prev = _ROUTES, _TALLY
    _ROUTES, _TALLY = routes, drops = {}, {}
    try:
        out = fn()
        routes, drops = ({kind: torch.stack(calls) for kind, calls in rec.items()}
                         for rec in (routes, drops))
    finally:
        _ROUTES, _TALLY = prev

    def retally() -> None:
        for tally, rec in ((_ROUTES, routes), (_TALLY, drops)):
            if tally is not None:
                for kind, stacked in rec.items():
                    tally.setdefault(kind, []).extend(stacked.clone().unbind(0))

    return out, retally


def grouped_mm(a: torch.Tensor, b: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """Rows of ``a`` (A, K) in runs, run g ending at ``offs[g]`` ((G,) int32,
    cumulative, ``offs[-1] == A``), each times its ``b[g]`` (G, K, N): (A, N)
    in a's dtype. An empty run reads nothing of its ``b[g]``."""
    return torch._grouped_mm(a, b, offs=offs)


def _expert_ffn(p: Params, x: torch.Tensor, cfg: ModelConfig,
                offs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``down(act(up(x)))``: the routed experts over runs ``offs`` of x
    (A, D), or, with ``offs`` None, one expert on every row."""
    cdt = x.dtype

    def mm(t, w):
        w = w.to(cdt)
        return t @ w if offs is None else grouped_mm(t, w, offs)

    return mm(activation(mm(x, p["wi"]), cfg.act), p["wo"])


def route_dropless(p: Params, x: torch.Tensor, cfg: ModelConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dropless router on x (T, D): (weights (T, K) float32, experts
    (T, K) int64, best first, ties to the lower index)."""
    m = cfg.moe
    K = m.top_k
    with _ieee_f32():
        logits = x.to(torch.float32) @ p["router"].to(torch.float32)
    scores = torch.sigmoid(logits)
    choice = scores + p["router_bias"].to(torch.float32)
    top_e = torch.sort(choice, dim=-1, descending=True, stable=True).indices[:, :K]
    top_w = scores.gather(1, top_e)
    top_w = top_w / (top_w.sum(-1, keepdim=True) + 1e-20) * m.routed_scale
    return top_w, top_e


def moe_dropless(p: Params, x: torch.Tensor, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, D) -> (out (B, S, D), zero aux losses): every token's K
    assignments computed (see the module docstring); nothing here waits for
    the host."""
    m = cfg.moe
    _no_gate(cfg)
    B, S, D = x.shape
    E, K = m.n_experts, m.top_k
    x2 = x.reshape(B * S, D)
    T, A = B * S, B * S * K
    top_w, top_e = route_dropless(p, x2, cfg)
    flat = top_e.reshape(A)
    order = torch.sort(flat, stable=True).indices
    sorted_e = flat[order]
    experts = torch.arange(E, device=x.device)
    offs = torch.searchsorted(sorted_e, experts, right=True)            # (E,) cumulative
    if _ROUTES is not None:
        counts = torch.diff(offs, prepend=offs.new_zeros(1))
        _ROUTES.setdefault("decode" if S == 1 else "prefill", []).append(torch.stack([
            offs.new_full((), A), (counts > 0).sum(), A - offs[-1]]))
    ys = _expert_ffn(p, x2[order // K], cfg, offs.to(torch.int32))      # (A, D) by expert
    y = torch.empty_like(ys)
    y[order] = ys                                                        # (T*K, D) by token
    out = (y.view(T, K, D).to(torch.float32) * top_w[..., None]).sum(1).to(x.dtype)
    if m.shared_d_ff:
        out = out + _expert_ffn(p["shared"], x2, cfg)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return out.view(B, S, D), {"moe_aux": zero, "moe_zloss": zero}


def moe_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, groups: Optional[int] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, D) -> (out (B, S, D), {"moe_aux", "moe_zloss"}). Routing,
    capacity and the gather and combine are per group: a batch row, or at
    decode (S == 1, B > 1) one of ``groups`` equal runs of rows (one group
    when None, as the reference). A dropless config goes to
    :func:`moe_dropless`."""
    m = cfg.moe
    if m.dropless:
        return moe_dropless(p, x, cfg)
    B, S, D = x.shape
    decode, orig_shape = S == 1, None
    if decode and B > 1:
        n_groups = groups or 1
        if B % n_groups:
            raise ValueError(f"{B} decode lanes do not split into {n_groups} groups")
        orig_shape = (B, S, D)
        x = x.reshape(n_groups, B // n_groups, D)
        B, S = x.shape[:2]
    E, K = m.n_experts, m.top_k
    C = capacity(S, cfg)
    cdt = x.dtype

    r = route(p["router"], x, K)
    d = dispatch(r.top_e, r.top_w, E, C)
    if _TALLY is not None:
        _TALLY.setdefault("decode" if decode else "prefill", []).append(
            torch.stack([d.dropped.new_full((), B * S * K), d.dropped]))

    # aux losses (Switch/GShard load balance + router z-loss)
    me = r.probs.mean(dim=(0, 1))
    ce = d.counts.sum(0).to(torch.float32) / (B * S * K)
    aux = E * torch.sum(me * ce) * m.aux_loss
    zl = torch.mean(torch.logsumexp(r.logits, dim=-1) ** 2) * m.router_z_loss

    # dispatch: (G, E, C, D), empty slots gather the zero row
    rows = torch.arange(B, device=x.device)[:, None]
    x_pad = torch.cat([x, x.new_zeros((B, 1, D))], dim=1)
    xg = x_pad[rows, d.table].view(B, E, C, D)

    # expert FFN
    gate = activation(torch.einsum("becd,edf->becf", xg, p["wg"].to(cdt)), cfg.act)
    up = torch.einsum("becd,edf->becf", xg, p["wi"].to(cdt))
    y = torch.einsum("becf,efd->becd", gate * up, p["wo"].to(cdt))

    out = combine(y, d)
    if orig_shape is not None:
        out = out.reshape(orig_shape)
    return out, {"moe_aux": aux, "moe_zloss": zl}
