"""PTB-FLA training over TDM schedules: satellites are FL nodes, each training
on its own data, communicating only through the paper's generic algorithms.

Counterpart of the TDM and constellation half of the JAX package's
``launch/fl_train.py``. There one node runs per device under ``shard_map``;
here the ``n`` nodes are stacked on a leading tensor axis of every state leaf
on one device. A round runs ``local_steps`` AdamW steps per node (a loop over
nodes; each node keeps its own optimizer state, step count and gradient-norm
clip), then one exchange over the round's relation:

- ``centralized``   -- FedAvg (mean over the node axis)
- ``decentralized`` -- clique gossip
- ``tdm``           -- gossip over the slot relation through the fused
                       engine, optionally int8 / top-k (CHOCO) compressed

The round updates the stacked state in place: local steps write each node's
new parameters and moments into its row, and the exchange's result is
copied back into the parameter tensors. One copy of the stacked state then
lives on the device, however many callers still hold the state they passed
in. As in the reference, a round discards the CHOCO state the exchange
returns, so CHOCO restarts from zeros every round.

Each round checks that the row gathers it issued equal the static oracle
:func:`repro_torch.telemetry.expected_tdm_collectives` (the reference checks
its compiled HLO's collective-permutes against the same oracle).
:func:`build_hierarchical_fl_round` is the two-level (pod x data) round, and
``run_constellation_fl(optimize=...)`` runs on the schedule optimizer's
antenna-constrained schedule instead of the raw visibility relations.

The ground-segment half (:func:`run_groundseg_fl`) drives sink-based FL:
satellites train, their params relay to ground sinks along contact-graph
routes, the sinks FedAvg, and the global model floods back
(:mod:`repro_torch.groundseg.aggregation`), one-shot or in pipelined,
delay-tolerant windows. Its rounds hold both the gathers and the all-node
reductions they issue against
:func:`repro_torch.groundseg.aggregation.expected_collectives`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.core import fl, fused, tdm
from repro_torch.core.relation import Relation
from repro_torch.device import resolve_device
from repro_torch.groundseg import aggregation, routing
from repro_torch.models import registry
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.pytree import tree_flatten, tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class FLConfig:
    mode: str = "tdm"               # centralized | decentralized | tdm
    local_steps: int = 1            # H: optimizer steps between exchanges
    comm: str = "getmeas"           # getmeas | get1meas (paper primitives)
    compression: str = "none"       # none | int8 | topk
    topk_k: int = 64
    fused: bool = True              # flat-buffer exchange engine (core/fused)


def _stack_init(seed: int, cfg: ModelConfig, opt_cfg, n_nodes: int, device=None):
    """Per-node states stacked on a leading node axis, every node starting
    from the same init (drawn once from a generator seeded with ``seed`` on
    ``device``, then copied to every row)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = registry.bundle(cfg).init(gen)
    state = {
        "params": params,
        "opt": adamw.init_opt_state(params, opt_cfg),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }
    return tree_map(lambda x: x.unsqueeze(0).repeat((n_nodes,) + (1,) * x.dim()), state)


def batch_to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v), device=device) for k, v in batch.items()}


def local_train(b, opt_cfg, state: Dict[str, Any], batch: Dict[str, torch.Tensor],
                local_steps: int, rows: Optional[Sequence[int]] = None) -> torch.Tensor:
    """``local_steps`` AdamW steps per node on its own batches, written
    into the stacked ``state`` rows in place (each node's tree is a view of
    its row). ``rows`` limits the training to those nodes (default all);
    the others keep their state and report a NaN loss. Returns each node's mean loss over its steps, (n,)."""
    n = tree_leaves(state["params"])[0].shape[0]
    dev = tree_leaves(state["params"])[0].device
    losses = torch.full((n, local_steps), float("nan"), dtype=torch.float32, device=dev)
    for i in range(n) if rows is None else rows:
        node = tree_map(lambda t: t[i], state)
        for h in range(local_steps):
            mb = {k: v[i, h] for k, v in batch.items()}
            p_leaves, treedef = tree_flatten(node["params"])
            p_leaves = [t.detach().requires_grad_(True) for t in p_leaves]
            loss, _ = b.loss_fn(tree_unflatten(treedef, p_leaves), mb)
            grads = torch.autograd.grad(loss, p_leaves)
            with torch.no_grad():
                adamw.apply_updates_(node["params"], list(grads), node["opt"], opt_cfg)
                node["step"].add_(1)
            losses[i, h] = loss.detach()
    return losses.mean(dim=1)


def _sync_if_tracing(rec, tree) -> None:
    """With tracing on, wait for the device so a span's wall time covers the
    work it launched; untraced runs stay asynchronous."""
    dev = tree_leaves(tree)[0].device
    if rec.tracing and dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build_fl_round(
    cfg: ModelConfig,
    opt_cfg: adamw.OptConfig,
    n_nodes: int,
    fl_cfg: FLConfig,
    rel: Relation,
) -> Callable:
    """One FL round = ``local_steps`` AdamW steps per node + one exchange
    over ``rel``. Returns ``(stacked_state, stacked_batch) -> (stacked_state,
    losses (n,))``; the batch holds (n, local_steps, B, S) tensors. The
    state is updated in place (the mixed params are copied back into its
    tensors) and returned."""
    b = registry.bundle(cfg)
    tdm_cfg = fl.TDMFLAConfig(
        comm=fl_cfg.comm,
        compression=fl_cfg.compression,
        topk_k=fl_cfg.topk_k,
        fused=fl_cfg.fused,
    )

    def fl_round(state, batch):
        rec = telemetry.get_recorder()
        params = state["params"]
        with rec.span("fl.local_steps", cat="compute"):
            local_loss = local_train(b, opt_cfg, state, batch, fl_cfg.local_steps)
            _sync_if_tracing(rec, params)
        with rec.span("fl.exchange", cat="exchange"), torch.no_grad():
            if fl_cfg.mode == "centralized":
                mixed = fl.centralized_round(params)
            elif fl_cfg.mode == "decentralized":
                mixed = fl.decentralized_round(params, n_nodes)
            else:
                # the CHOCO state is dropped, as the reference does
                mixed, _ = fl.tdm_fla_round(params, rel, n_nodes, tdm_cfg)
            tree_map(lambda dst, src: dst.copy_(src), params, mixed)
            _sync_if_tracing(rec, params)
        return state, local_loss

    return fl_round


def build_hierarchical_fl_round(
    cfg: ModelConfig,
    opt_cfg: adamw.OptConfig,
    n_pods: int,
    n_data: int,
    fl_cfg: FLConfig,
    intra_rel: Relation,
    inter_rel: Relation,
) -> Callable:
    """One two-level (pod x data) FL round: ``local_steps`` AdamW steps per
    node, then one fused two-level mix
    (:func:`repro_torch.core.fused.fused_hierarchical_round`): ``intra_rel``
    over the ``n_data`` nodes of each pod, then ``inter_rel`` across the
    ``n_pods`` pods. Node row ``pod * n_data + data`` (pod-major, the
    reference's ``P(("pod", "data"))``). ``fl_cfg.compression`` is ``"none"``
    or ``"int8"`` (the ``tdm_compress`` kernels on CUDA tensors; 2 gathers per
    matching per bucket, the
    :func:`repro_torch.telemetry.expected_hierarchical_collectives` oracle).
    The contract is :func:`build_fl_round`'s: ``(stacked_state,
    stacked_batch) -> (stacked_state, losses (n,))``, the state updated in
    place."""
    b = registry.bundle(cfg)
    if fl_cfg.compression not in ("none", "int8"):
        raise ValueError(
            f"hierarchical FL supports compression 'none'/'int8', "
            f"got {fl_cfg.compression!r}"
        )

    def fl_round(state, batch):
        rec = telemetry.get_recorder()
        params = state["params"]
        with rec.span("fl.local_steps", cat="compute"):
            local_loss = local_train(b, opt_cfg, state, batch, fl_cfg.local_steps)
            _sync_if_tracing(rec, params)
        with rec.span("fl.exchange", cat="exchange"), torch.no_grad():
            mixed = fused.fused_hierarchical_round(
                params, intra_rel, inter_rel, n_data, n_pods,
                compression=fl_cfg.compression,
            )
            tree_map(lambda dst, src: dst.copy_(src), params, mixed)
            _sync_if_tracing(rec, params)
        return state, local_loss

    return fl_round


def _rel_key(rel: Relation):
    return tuple(sorted(rel.pairs))


class RoundFnCache:
    """FL-round functions keyed by slot relation (orbits revisit
    topologies). Misses and hits land on the flight recorder
    (``fl.round_cache.*`` plus a ``retrace`` event)."""

    def __init__(self, cfg: ModelConfig, opt_cfg, n_nodes: int, fl_cfg: FLConfig):
        self.args = (cfg, opt_cfg, n_nodes, fl_cfg)
        self.n_nodes = n_nodes
        self._fns: Dict[Any, Callable] = {}
        self._expected: Dict[Any, Optional[Dict[str, int]]] = {}

    def expected_collectives(self, rel: Relation, state: Any) -> Optional[Dict[str, int]]:
        """Exchanges the fused getMeas TDM round issues over ``rel``
        (``matchings x per x n_buckets``); ``None`` for configs no oracle
        covers. Memoized on the relation."""
        key = _rel_key(rel)
        if key in self._expected:
            return self._expected[key]
        fl_cfg = self.args[3]
        exp = None
        if fl_cfg.mode == "tdm" and fl_cfg.fused and fl_cfg.comm == "getmeas":
            n_buckets = len({str(leaf.dtype) for leaf in tree_leaves(state["params"])})
            exp = telemetry.expected_tdm_collectives(
                rel, n_buckets, compression=fl_cfg.compression
            )
        self._expected[key] = exp
        return exp

    def __call__(self, rel: Relation) -> Callable:
        key = _rel_key(rel)
        rec = telemetry.get_recorder()
        fn = self._fns.get(key)
        if fn is None:
            rec.counter("fl.round_cache.misses")
            rec.event("retrace", cat="compile", kind="fl_round",
                      links=len(rel) // 2, cache_size=len(self._fns))
            fn = build_fl_round(*self.args, rel)
            self._fns[key] = fn
        else:
            rec.counter("fl.round_cache.hits")
        return fn

    def __len__(self) -> int:
        return len(self._fns)


@dataclasses.dataclass(frozen=True)
class RoundLog:
    round: int
    loss: float
    consensus: float
    n_links: int        # undirected ISLs active this round
    alive: int          # participating satellites


def run_tdm_rounds(
    cache: RoundFnCache,
    state: Any,
    relations: Sequence[Relation],
    batch_fn: Callable[[int], Any],
    alive: Optional[set] = None,
    on_round: Optional[Callable[[RoundLog], None]] = None,
    log_every: int = 1,
):
    """Drive one FL round per slot relation. ``alive`` is read each round
    (callers may mutate it to model failures); dead nodes drop out of the
    round's relation (``Relation.restrict``, skip-slot semantics) while their
    local training continues. ``log_every``: loss/consensus only every k-th
    round (0: never). Returns ``(state, [RoundLog, ...])``."""
    rec = telemetry.get_recorder()
    n_nodes = cache.n_nodes
    device = tree_leaves(state["params"])[0].device
    logs = []
    for rnd, rel in enumerate(relations):
        live = set(alive) if alive is not None else set(range(n_nodes))
        rel_t = rel.restrict(live)
        batch = batch_to_device(batch_fn(rnd), device)
        with rec.span("fl.round", cat="slot", round=rnd, links=len(rel_t) // 2,
                      alive=len(live)):
            fn = cache(rel_t)
            before = tdm.gather_count()
            state, losses = fn(state, batch)
            issued = tdm.gather_count() - before
            _sync_if_tracing(rec, state["params"])
        rec.counter("fl.rounds")
        rec.counter("fl.exchange.gathers", issued)
        expected = cache.expected_collectives(rel_t, state)
        if expected:
            if issued != expected["collective-permute"]:
                raise RuntimeError(
                    f"round {rnd}: issued {issued} exchanges, the oracle "
                    f"expects {expected['collective-permute']}"
                )
            for kind, count in expected.items():
                rec.counter(f"fl.collectives.{kind}", count)
        log_this = log_every > 0 and rnd % log_every == 0
        log = RoundLog(
            round=rnd,
            loss=float(losses.mean()) if log_this else float("nan"),
            consensus=consensus_distance(state["params"]) if log_this else float("nan"),
            n_links=len(rel_t) // 2,
            alive=len(live),
        )
        logs.append(log)
        if on_round is not None:
            on_round(log)
    return state, logs


def run_constellation_fl(
    cfg: ModelConfig,
    opt_cfg,
    n_nodes: int,
    fl_cfg: FLConfig,
    plan,
    state: Any,
    batch_fn: Callable[[int], Any],
    rounds: Optional[int] = None,
    alive: Optional[set] = None,
    on_round: Optional[Callable[[RoundLog], None]] = None,
    optimize: Optional[str] = None,
    antennas=None,
    payload_bytes: int = 1 << 20,
    acquisition_s: float = 0.0,
    log_every: int = 1,
):
    """Constellation-driven FL: one round per contact-plan time step; the
    plan repeats when ``rounds`` exceeds its horizon.

    ``optimize`` switches the rounds from the raw per-step visibility
    relations to a materialized antenna-constrained ``ContactSchedule``:
    ``"greedy"`` for the first legal colouring, ``"rate"`` for the cheapest
    schedule of the optimizer's portfolio
    (:mod:`repro_torch.constellation.optimizer`), built under the
    ``fl.build_schedule`` span; one round then runs per sub-slot.
    ``antennas``, ``payload_bytes`` and ``acquisition_s`` size and price the
    schedule. With zero slew penalty and an antenna budget that covers each
    step's degree, greedy and rate emit the same relations, so training is
    bit for bit the same. A plan with no feasible contacts falls back to the
    per-step relations (all empty): local training continues."""
    if optimize is None:
        relations = plan.relations()
    else:
        with telemetry.get_recorder().span(
            "fl.build_schedule", cat="schedule", optimize=optimize
        ):
            sched = plan.schedule(
                antennas=antennas,
                payload_bytes=payload_bytes,
                optimize=optimize,
                acquisition_s=acquisition_s,
            )
        relations = list(sched.tdm)
        if not relations:
            relations = plan.relations()
    if rounds is not None:
        reps = -(-rounds // max(len(relations), 1))
        relations = (relations * reps)[:rounds]
    cache = RoundFnCache(cfg, opt_cfg, n_nodes, fl_cfg)
    return run_tdm_rounds(cache, state, relations, batch_fn, alive, on_round,
                          log_every=log_every)


# ===========================================================================
# Ground-segment (centralized / hierarchical) FL over contact-graph routes
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class GroundSegConfig:
    """Config for sink-based FL over the ground segment.

    mode: 'centralized'  -- sinks pool every round over terrestrial backhaul
                           (one reduction of the sink rows per buffer);
                           every satellite the downlink reaches gets the
                           same global.
          'hierarchical' -- sinks keep regional FedAvg models and pool only
                           every ``sink_sync_every`` rounds.
    compression: relay payload encoding ('none' | 'int8' -- blockwise via
                 the tdm_compress kernels, quantized ONCE end to end: shared
                 scales, exact int16 relay sums, one dequant at the sink).
    quant_impl: 'auto' (the CUDA kernels for CUDA tensors, the plain
                versions for CPU ones) | 'cuda' | 'ref'.
    pipeline_depth: 1 -- one-shot rounds: uplink then downlink traverse the
                    window one after the other. 2 -- pipelined: round r's
                    downlink flood overlaps round r+1's uplink relay inside
                    one window, on disjoint slot capacity.
    max_staleness_windows: delay-tolerant horizon -- an undelivered payload
                    persists (and keeps aging) this many windows before it
                    is dropped and reported; 0 disables persistence.
    staleness_decay: sink FedAvg weight of a payload delivered at age
                    ``a`` is ``staleness_decay ** a``.
    """

    mode: str = "centralized"
    sink_sync_every: int = 2
    compression: str = "none"
    block: int = 1024
    quant_impl: str = "auto"
    pipeline_depth: int = 1
    max_staleness_windows: int = 0
    staleness_decay: float = 0.5

    def __post_init__(self):
        if self.mode not in ("centralized", "hierarchical"):
            raise ValueError(f"unknown groundseg mode {self.mode!r}")
        if self.compression not in ("none", "int8"):
            raise ValueError(
                f"groundseg compression must be 'none' or 'int8', "
                f"got {self.compression!r}"
            )
        if self.pipeline_depth not in (1, 2):
            raise ValueError(
                f"pipeline_depth must be 1 or 2, got {self.pipeline_depth}"
            )
        if self.max_staleness_windows < 0:
            raise ValueError(
                f"max_staleness_windows must be >= 0, "
                f"got {self.max_staleness_windows}"
            )
        if not (0.0 < self.staleness_decay <= 1.0):
            raise ValueError(
                f"staleness_decay must be in (0, 1], got {self.staleness_decay}"
            )

    @property
    def pipelined(self) -> bool:
        """Does this config need the multi-window engine? The trivial
        config (depth 1, no persistence) takes the one-shot path, which the
        pipelined engine reproduces bit for bit."""
        return self.pipeline_depth > 1 or self.max_staleness_windows > 0

    def pool_round(self, rnd: int) -> bool:
        """Do the sinks reconcile over backhaul this round?"""
        if self.mode == "centralized":
            return True
        return self.sink_sync_every > 0 and rnd % self.sink_sync_every == 0


def _sat_rows(n_nodes: int, sinks) -> List[int]:
    return [v for v in range(n_nodes) if v not in sinks]


def _train_satellites(rec, b, opt_cfg, state, batch, local_steps: int,
                      rows: List[int]) -> torch.Tensor:
    """The ``groundseg.local_steps`` span: the satellites' local steps (sinks
    hold their state), ending in a synchronize when tracing."""
    with rec.span("groundseg.local_steps", cat="compute"):
        loss = local_train(b, opt_cfg, state, batch, local_steps, rows=rows)
        _sync_if_tracing(rec, state["params"])
    return loss


def build_groundseg_round(
    cfg: ModelConfig,
    opt_cfg: adamw.OptConfig,
    n_nodes: int,
    fl_cfg: FLConfig,
    gs_cfg: GroundSegConfig,
    uplink,
    downlink,
    pool: bool,
) -> Callable:
    """One ground-segment FL round: satellites run ``local_steps`` AdamW
    steps on their own data (sinks hold their state; the reference computes
    their steps and discards them, the port skips them), then the uplink
    relay -> sink FedAvg -> downlink broadcast exchange of
    :func:`repro_torch.groundseg.aggregation.groundseg_round`, in place.
    Same ``(stacked_state, stacked_batch) -> (stacked_state, losses)``
    contract as :func:`build_fl_round`; sinks' losses are NaN."""
    b = registry.bundle(cfg)
    train_rows = _sat_rows(n_nodes, uplink.sinks)

    def gs_round(state, batch):
        rec = telemetry.get_recorder()
        params = state["params"]
        local_loss = _train_satellites(rec, b, opt_cfg, state, batch,
                                       fl_cfg.local_steps, train_rows)
        with rec.span("groundseg.exchange", cat="exchange"), torch.no_grad():
            aggregation.groundseg_round(
                params, uplink, downlink, pool=pool,
                compression=gs_cfg.compression, block=gs_cfg.block,
                quant_impl=gs_cfg.quant_impl,
            )
            _sync_if_tracing(rec, params)
        return state, local_loss

    return gs_round


def build_pipelined_groundseg_round(
    cfg: ModelConfig,
    opt_cfg: adamw.OptConfig,
    n_nodes: int,
    fl_cfg: FLConfig,
    gs_cfg: GroundSegConfig,
    wp,
    pool: bool,
) -> Callable:
    """One pipelined / delay-tolerant window: local training (sinks hold),
    then :func:`repro_torch.groundseg.aggregation.pipelined_window_round`.
    Contract: ``(stacked_state, aux, stacked_batch) -> (stacked_state, aux,
    losses)``, where ``aux = {"carry": .., "pending": ..}`` are the stacked
    payload-queue and pending-global buffers, kept on the device across
    windows and updated in place."""
    b = registry.bundle(cfg)
    train_rows = _sat_rows(n_nodes, wp.uplink.sinks)

    def window_round(state, aux, batch):
        rec = telemetry.get_recorder()
        params = state["params"]
        local_loss = _train_satellites(rec, b, opt_cfg, state, batch,
                                       fl_cfg.local_steps, train_rows)
        with rec.span("groundseg.exchange", cat="exchange"), torch.no_grad():
            aggregation.pipelined_window_round(
                params, aux["carry"], aux["pending"], wp, pool=pool,
                staleness_decay=gs_cfg.staleness_decay,
                compression=gs_cfg.compression, block=gs_cfg.block,
                quant_impl=gs_cfg.quant_impl,
            )
            _sync_if_tracing(rec, params)
        return state, aux, local_loss

    return window_round


@dataclasses.dataclass(frozen=True)
class GroundSegRoundLog:
    round: int
    loss: float          # mean over live satellites (sinks excluded)
    consensus: float     # consensus distance over satellite params
    delivered: int       # satellite payloads landing at sinks this round
    covered: int         # satellites the downlink reached
    unreachable: int     # live satellites with no route to any sink
    alive: int           # live satellites
    pooled: bool         # sinks reconciled over backhaul this round
    carried: int = 0     # payloads persisting to the next window
    dropped: int = 0     # payloads discarded past the staleness horizon
    max_age: int = 0     # oldest delivered payload's age (windows)


def _record_exchanges(rec, rnd: int, issued: Dict[str, int],
                      expected: Dict[str, int]) -> None:
    """The round's gathers and reductions must equal the static oracle (the
    reference holds its compiled HLO's collectives against it); both are
    counted on the recorder."""
    for kind, count in expected.items():
        if issued[kind] != count:
            raise RuntimeError(
                f"round {rnd}: issued {issued[kind]} {kind} exchanges, the "
                f"oracle expects {count}"
            )
    rec.counter("groundseg.exchange.gathers", issued["collective-permute"])
    rec.counter("groundseg.exchange.reductions", issued["all-reduce"])
    for kind, count in expected.items():
        rec.counter(f"groundseg.collectives.{kind}", count)


def _exchange_counts() -> Dict[str, int]:
    """Gathers and all-node reductions issued so far in this process."""
    return {"collective-permute": tdm.gather_count(),
            "all-reduce": aggregation.reduction_count()}


def _sat_metrics(losses: torch.Tensor, params, live_sats: List[int], log_this: bool):
    if not (log_this and live_sats):
        return float("nan"), float("nan")
    rows = torch.as_tensor(live_sats, device=losses.device)
    return (float(losses.index_select(0, rows).mean()),
            consensus_distance(params, rows=live_sats))


def run_groundseg_fl(
    cfg: ModelConfig,
    opt_cfg,
    n_nodes: int,
    fl_cfg: FLConfig,
    gs_cfg: GroundSegConfig,
    plan,
    state: Any,
    batch_fn: Callable[[int], Any],
    sinks,
    rounds: int,
    alive: Optional[set] = None,
    on_round: Optional[Callable[[GroundSegRoundLog], None]] = None,
    optimize: Optional[str] = None,
    antennas=None,
    payload_bytes: int = 1 << 20,
    acquisition_s: float = 0.0,
    log_every: int = 1,
):
    """Centralized/hierarchical FL with ground stations as aggregation
    sinks, routed over the plan's antenna-constrained TDM schedule.

    ``plan`` must include the ground stations; ``sinks`` are their node ids
    (satellites first, then ground). Each round: local training, the
    store-and-forward uplink of every reachable satellite's params along
    its earliest-delivery route, sink FedAvg (pooled per
    :meth:`GroundSegConfig.pool_round`), and the global (or regional) model
    flooding back on the downlink. ``alive`` is read every round (mutable
    mid-flight); sinks are ground infrastructure and always up. Routing
    programs are cached per alive set and rebuilt when it changes; round
    functions per (alive set, pool flag). Every round's gathers and
    reductions are held against :func:`aggregation.expected_collectives`.
    When ``gs_cfg.pipelined`` the multi-window engine drives the loop.
    ``optimize`` picks the schedule as :meth:`ContactPlan.schedule` does
    (None or "greedy": the first legal colouring; "rate" or a strategy
    name: :mod:`repro_torch.constellation.optimizer`).
    Returns ``(state, [GroundSegRoundLog, ...])``."""
    sinks_s = frozenset(int(s) for s in sinks)
    if not sinks_s:
        raise ValueError("run_groundseg_fl needs at least one sink node id")
    sched = plan.schedule(
        antennas=antennas,
        payload_bytes=payload_bytes,
        optimize=optimize,
        acquisition_s=acquisition_s,
    )
    base_rels = list(sched.tdm)
    sat_ids = _sat_rows(n_nodes, sinks_s)
    if gs_cfg.pipelined:
        return _run_groundseg_pipelined(
            cfg, opt_cfg, n_nodes, fl_cfg, gs_cfg, base_rels, state,
            batch_fn, sinks_s, sat_ids, rounds, alive, on_round, log_every,
        )
    rec = telemetry.get_recorder()
    device = tree_leaves(state["params"])[0].device
    n_buckets = len(fused.cached_spec(state["params"], block=gs_cfg.block).buckets)
    prog_cache: Dict[Any, Any] = {}
    fn_cache: Dict[Any, Any] = {}      # key -> (round fn, expected exchanges)
    logs: list = []
    for rnd in range(rounds):
        live = set(alive) if alive is not None else set(range(n_nodes))
        live |= sinks_s
        pool = gs_cfg.pool_round(rnd)
        live_key = frozenset(live)
        if live_key not in prog_cache:
            rec.counter("groundseg.route_cache.misses")
            rec.event("reroute", cat="routing", round=rnd, alive=len(live))
            with rec.span("groundseg.route", cat="routing", alive=len(live)):
                rels = [r.restrict(live) for r in base_rels]
                table = routing.earliest_delivery_routes(
                    rels, n_nodes, sinks_s, sources=[v for v in sat_ids if v in live],
                )
                up = routing.build_relay_program(rels, n_nodes, sinks_s, table=table)
                down = routing.build_broadcast_program(rels, n_nodes, sinks_s)
            prog_cache[live_key] = (up, down)
        else:
            rec.counter("groundseg.route_cache.hits")
        up, down = prog_cache[live_key]
        fn_key = (live_key, pool)
        batch = batch_to_device(batch_fn(rnd), device)
        if fn_key not in fn_cache:
            rec.counter("groundseg.round_cache.misses")
            rec.event("retrace", cat="compile", kind="groundseg_round", round=rnd,
                      pool=pool, cache_size=len(fn_cache))
            fn_cache[fn_key] = (
                build_groundseg_round(cfg, opt_cfg, n_nodes, fl_cfg, gs_cfg,
                                      up, down, pool),
                aggregation.expected_collectives(
                    up, down, n_buckets, compression=gs_cfg.compression, pool=pool),
            )
        else:
            rec.counter("groundseg.round_cache.hits")
        fn, expected = fn_cache[fn_key]
        with rec.span("groundseg.round", cat="window", round=rnd, pool=pool,
                      alive=len(live), delivered=up.delivered_count(),
                      unreachable=len(up.unreachable)):
            before = _exchange_counts()
            state, losses = fn(state, batch)
            issued = {k: v - before[k] for k, v in _exchange_counts().items()}
            _sync_if_tracing(rec, state["params"])
        _record_exchanges(rec, rnd, issued, expected)
        rec.counter("groundseg.rounds")
        rec.counter("groundseg.payloads.delivered", up.delivered_count())
        rec.counter("groundseg.payloads.unreachable", len(up.unreachable))
        live_sats = [v for v in sat_ids if v in live]
        loss_v, cons_v = _sat_metrics(losses, state["params"], live_sats,
                                      log_every > 0 and rnd % log_every == 0)
        log = GroundSegRoundLog(
            round=rnd,
            loss=loss_v,
            consensus=cons_v,
            delivered=up.delivered_count(),
            covered=len(down.covered - sinks_s),
            unreachable=len(up.unreachable),
            alive=len(live_sats),
            pooled=pool,
        )
        logs.append(log)
        if on_round is not None:
            on_round(log)
    return state, logs


def _run_groundseg_pipelined(
    cfg: ModelConfig,
    opt_cfg,
    n_nodes: int,
    fl_cfg: FLConfig,
    gs_cfg: GroundSegConfig,
    base_rels,
    state: Any,
    batch_fn: Callable[[int], Any],
    sinks_s,
    sat_ids,
    rounds: int,
    alive: Optional[set],
    on_round: Optional[Callable[[GroundSegRoundLog], None]],
    log_every: int,
):
    """The multi-window loop behind :func:`run_groundseg_fl`: one window
    per round, payload queues persisting in carry buffers on the device, the
    previous round's global staged in a pending buffer when pipelining."""
    rec = telemetry.get_recorder()
    router = routing.MultiWindowRouter(
        n_nodes,
        sinks_s,
        max_staleness_windows=gs_cfg.max_staleness_windows,
        pipeline_depth=gs_cfg.pipeline_depth,
    )
    device = tree_leaves(state["params"])[0].device
    spec = fused.cached_spec(state["params"], block=gs_cfg.block)
    n_buckets = len(spec.buckets)
    aux = {
        "carry": aggregation.stacked_zero_buffers(spec, n_nodes, device),
        "pending": aggregation.stacked_zero_buffers(spec, n_nodes, device),
    }
    fn_cache: Dict[Any, Any] = {}      # key -> (window fn, expected exchanges)
    logs: list = []
    for rnd in range(rounds):
        live = set(alive) if alive is not None else set(range(n_nodes))
        live |= sinks_s
        pool = gs_cfg.pool_round(rnd)
        with rec.span("groundseg.plan_window", cat="routing", window=rnd):
            wp = router.plan_window(base_rels, alive=live)
        key = (frozenset(live), tuple(sorted(wp.ages.items())), pool, wp.downlink is None)
        batch = batch_to_device(batch_fn(rnd), device)
        if key not in fn_cache:
            rec.counter("groundseg.window_cache.misses")
            rec.event("retrace", cat="compile", kind="groundseg_window",
                      window=wp.window, pool=pool, ages=dict(wp.ages),
                      cache_size=len(fn_cache))
            fn_cache[key] = (
                build_pipelined_groundseg_round(cfg, opt_cfg, n_nodes, fl_cfg,
                                                gs_cfg, wp, pool),
                aggregation.expected_window_collectives(
                    wp, n_buckets, compression=gs_cfg.compression, pool=pool),
            )
        else:
            rec.counter("groundseg.window_cache.hits")
        fn, expected = fn_cache[key]
        with rec.span("groundseg.window", cat="window", window=wp.window, pool=pool,
                      alive=len(live), queued=len(wp.injected),
                      delivered=wp.uplink.delivered_count(),
                      carried=len(wp.residual), dropped=len(wp.dropped)):
            before = _exchange_counts()
            state, aux, losses = fn(state, aux, batch)
            issued = {k: v - before[k] for k, v in _exchange_counts().items()}
            _sync_if_tracing(rec, state["params"])
        _record_exchanges(rec, rnd, issued, expected)
        # payload lifecycle: queued -> relayed -> delivered | carried |
        # dropped. Counters are default-on; per-payload instants (with
        # staleness ages) exist only while tracing.
        rec.counter("groundseg.rounds")
        rec.counter("groundseg.payloads.queued", len(wp.injected))
        rec.counter("groundseg.payloads.delivered", wp.uplink.delivered_count())
        rec.counter("groundseg.payloads.carried", len(wp.residual))
        rec.counter("groundseg.payloads.dropped", len(wp.dropped))
        rec.counter("groundseg.payloads.unreachable", len(wp.uplink.unreachable))
        rec.set_counter(
            "groundseg.payloads.max_delivered_age",
            max(rec.get_counter("groundseg.payloads.max_delivered_age"),
                wp.max_delivered_age()),
        )
        if rec.tracing:
            for src in sorted(wp.injected):
                rec.event("payload.queued", cat="payload", window=wp.window, source=src)
            for kind, items in (("delivered", wp.delivered_ages), ("carried", wp.residual),
                                ("dropped", wp.dropped)):
                for src, age in sorted(items.items()):
                    rec.event(f"payload.{kind}", cat="payload", window=wp.window,
                              source=src, age=age)
        live_sats = [v for v in sat_ids if v in live]
        loss_v, cons_v = _sat_metrics(losses, state["params"], live_sats,
                                      log_every > 0 and rnd % log_every == 0)
        log = GroundSegRoundLog(
            round=rnd,
            loss=loss_v,
            consensus=cons_v,
            delivered=wp.uplink.delivered_count(),
            covered=(len(wp.downlink.covered - sinks_s) if wp.downlink is not None else 0),
            unreachable=len(wp.uplink.unreachable),
            alive=len(live_sats),
            pooled=pool,
            carried=len(wp.residual),
            dropped=len(wp.dropped),
            max_age=wp.max_delivered_age(),
        )
        logs.append(log)
        if on_round is not None:
            on_round(log)
    return state, logs


CONSENSUS_CHUNK = 1 << 24   # elements per node summed at once, in float64


def consensus_distance(stacked_params, rows: Optional[Sequence[int]] = None) -> float:
    """Relative L2 distance of the nodes' params from their mean, in float64
    on the params' device (``CONSENSUS_CHUNK`` elements per node at a time).
    ``rows`` restricts it to those nodes, copying one chunk of their rows at
    a time, never the rows whole."""
    chunk = CONSENSUS_CHUNK
    num = 0.0
    den = 0.0
    for leaf in tree_leaves(stacked_params):
        flat = leaf.detach().reshape(leaf.shape[0], -1)
        sel = None if rows is None else torch.as_tensor(list(rows), device=flat.device)
        for start in range(0, flat.shape[1], chunk):
            arr = flat[:, start:start + chunk]
            if sel is not None:
                arr = arr.index_select(0, sel)
            arr = arr.to(torch.float64)
            mean = arr.mean(dim=0, keepdim=True)
            num += float(torch.square(arr - mean).sum())
            den += float(torch.square(mean).sum()) * arr.shape[0]
    return (num / max(den, 1e-30)) ** 0.5


# ---------------------------------------------------------------------------
# One driver entry point: run(cfg) dispatches on config type
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TDMRun:
    """Config for :func:`run_tdm_rounds`: one FL round per slot relation."""

    cache: RoundFnCache
    state: Any
    relations: Sequence[Relation]
    batch_fn: Callable[[int], Any]
    alive: Optional[set] = None
    on_round: Optional[Callable[[RoundLog], None]] = None
    log_every: int = 1


@dataclasses.dataclass
class ConstellationRun:
    """Config for :func:`run_constellation_fl`: geometry-driven rounds."""

    cfg: ModelConfig
    opt_cfg: Any
    n_nodes: int
    fl_cfg: FLConfig
    plan: Any
    state: Any
    batch_fn: Callable[[int], Any]
    rounds: Optional[int] = None
    alive: Optional[set] = None
    on_round: Optional[Callable[[RoundLog], None]] = None
    optimize: Optional[str] = None
    antennas: Any = None
    payload_bytes: int = 1 << 20
    acquisition_s: float = 0.0
    log_every: int = 1


@dataclasses.dataclass
class GroundSegRun:
    """Config for :func:`run_groundseg_fl`: ground stations as sinks."""

    cfg: ModelConfig
    opt_cfg: Any
    n_nodes: int
    fl_cfg: FLConfig
    gs_cfg: GroundSegConfig
    plan: Any
    state: Any
    batch_fn: Callable[[int], Any]
    sinks: Any = ()
    rounds: int = 1
    alive: Optional[set] = None
    on_round: Optional[Callable[[GroundSegRoundLog], None]] = None
    optimize: Optional[str] = None
    antennas: Any = None
    payload_bytes: int = 1 << 20
    acquisition_s: float = 0.0
    log_every: int = 1


@dataclasses.dataclass
class RunResult:
    """Shared return shape of :func:`run`: mode tag + final state + logs."""

    mode: str                    # "tdm" | "constellation" | "groundseg"
    state: Any
    logs: List[Any]

    @property
    def n_rounds(self) -> int:
        return len(self.logs)

    @property
    def final(self) -> Any:
        """Last round's log (None for a zero-round run)."""
        return self.logs[-1] if self.logs else None


def run(run_cfg) -> RunResult:
    """One driver entry point: :class:`TDMRun` -> :func:`run_tdm_rounds`,
    :class:`ConstellationRun` -> :func:`run_constellation_fl`,
    :class:`GroundSegRun` -> :func:`run_groundseg_fl`."""
    if isinstance(run_cfg, TDMRun):
        state, logs = run_tdm_rounds(
            run_cfg.cache, run_cfg.state, run_cfg.relations, run_cfg.batch_fn,
            alive=run_cfg.alive, on_round=run_cfg.on_round,
            log_every=run_cfg.log_every,
        )
        return RunResult("tdm", state, logs)
    if isinstance(run_cfg, ConstellationRun):
        state, logs = run_constellation_fl(
            run_cfg.cfg, run_cfg.opt_cfg, run_cfg.n_nodes, run_cfg.fl_cfg,
            run_cfg.plan, run_cfg.state, run_cfg.batch_fn,
            rounds=run_cfg.rounds, alive=run_cfg.alive,
            on_round=run_cfg.on_round, optimize=run_cfg.optimize,
            antennas=run_cfg.antennas, payload_bytes=run_cfg.payload_bytes,
            acquisition_s=run_cfg.acquisition_s, log_every=run_cfg.log_every,
        )
        return RunResult("constellation", state, logs)
    if isinstance(run_cfg, GroundSegRun):
        state, logs = run_groundseg_fl(
            run_cfg.cfg, run_cfg.opt_cfg, run_cfg.n_nodes, run_cfg.fl_cfg,
            run_cfg.gs_cfg, run_cfg.plan, run_cfg.state, run_cfg.batch_fn,
            run_cfg.sinks, run_cfg.rounds, alive=run_cfg.alive,
            on_round=run_cfg.on_round, optimize=run_cfg.optimize,
            antennas=run_cfg.antennas, payload_bytes=run_cfg.payload_bytes,
            acquisition_s=run_cfg.acquisition_s, log_every=run_cfg.log_every,
        )
        return RunResult("groundseg", state, logs)
    raise TypeError(
        f"run() takes a TDMRun / ConstellationRun / GroundSegRun config, "
        f"got {type(run_cfg).__name__}"
    )
