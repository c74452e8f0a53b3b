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
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.core import fl, tdm
from repro_torch.core.relation import Relation
from repro_torch.device import resolve_device
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
                local_steps: int) -> torch.Tensor:
    """``local_steps`` AdamW steps per node on its own batches; writes the
    results into the stacked ``state`` rows in place. Returns each node's
    mean loss over its steps, shape (n,)."""
    n = tree_leaves(state["params"])[0].shape[0]
    dev = tree_leaves(state["params"])[0].device
    losses = torch.zeros((n, local_steps), dtype=torch.float32, device=dev)
    for i in range(n):
        node = tree_map(lambda t: t[i], state)
        for h in range(local_steps):
            mb = {k: v[i, h] for k, v in batch.items()}
            p_leaves, treedef = tree_flatten(node["params"])
            p_leaves = [t.detach().requires_grad_(True) for t in p_leaves]
            loss, _ = b.loss_fn(tree_unflatten(treedef, p_leaves), mb)
            grads = torch.autograd.grad(loss, p_leaves)
            with torch.no_grad():
                new_p, new_opt, _ = adamw.apply_updates(
                    tree_unflatten(treedef, [t.detach() for t in p_leaves]),
                    tree_unflatten(treedef, list(grads)),
                    node["opt"],
                    opt_cfg,
                )
            node = {"params": new_p, "opt": new_opt, "step": node["step"] + 1}
            losses[i, h] = loss.detach()
        with torch.no_grad():
            tree_map(lambda dst, src: dst[i].copy_(src), state, node)
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
    log_every: int = 1,
):
    """Constellation-driven FL: one round per contact-plan time step; the
    plan repeats when ``rounds`` exceeds its horizon. Only the raw per-step
    visibility relations (``optimize=None``) are ported."""
    if optimize is not None:
        raise NotImplementedError(
            f"optimize={optimize!r}: antenna-constrained schedule optimization "
            "is not ported yet (ROADMAP queue 1, constellation optimizer)"
        )
    relations = plan.relations()
    if rounds is not None:
        reps = -(-rounds // max(len(relations), 1))
        relations = (relations * reps)[:rounds]
    cache = RoundFnCache(cfg, opt_cfg, n_nodes, fl_cfg)
    return run_tdm_rounds(cache, state, relations, batch_fn, alive, on_round,
                          log_every=log_every)


CONSENSUS_CHUNK = 1 << 24   # elements per node summed at once, in float64


def consensus_distance(stacked_params) -> float:
    """Relative L2 distance of the nodes' params from their mean, in float64
    on the params' device (``CONSENSUS_CHUNK`` elements per node at a time)."""
    chunk = CONSENSUS_CHUNK
    num = 0.0
    den = 0.0
    for leaf in tree_leaves(stacked_params):
        flat = leaf.detach().reshape(leaf.shape[0], -1)
        for start in range(0, flat.shape[1], chunk):
            arr = flat[:, start:start + chunk].to(torch.float64)
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
    log_every: int = 1


@dataclasses.dataclass
class RunResult:
    """Shared return shape of :func:`run`: mode tag + final state + logs."""

    mode: str                    # "tdm" | "constellation"
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
    :class:`ConstellationRun` -> :func:`run_constellation_fl`. (The
    ground-segment mode is not ported yet.)"""
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
            log_every=run_cfg.log_every,
        )
        return RunResult("constellation", state, logs)
    raise TypeError(
        f"run() takes a TDMRun / ConstellationRun config, got {type(run_cfg).__name__}"
    )
