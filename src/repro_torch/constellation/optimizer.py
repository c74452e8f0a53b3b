"""Rate-aware TDM schedule optimization: search, scored by the cost oracle.

PR 1's contact plans emit the *first* legal coloring — Misra–Gries matchings
packed first-fit into antenna-feasible sub-slots, blind to link rates. This
module searches over feasible schedules instead. Each *strategy* is a
complete decomposition policy applied uniformly across the plan:

- ``greedy``     — the rate-blind baseline, exactly what
  ``ContactPlan.schedule()`` emits today (always in the candidate set).
- ``slow_first`` — ``weighted_edge_coloring`` on per-edge transfer times:
  slow edges grouped into shared color classes so a fast edge's sub-slot is
  never sized by a slot-straggler.
- ``mwm``        — peel maximum-weight matchings (weight = link rate, via
  networkx blossom): each sub-slot carries the highest aggregate rate the
  remaining edges allow — the fastest exchanges complete earliest.
- ``overlap``    — ``slow_first`` grouping, then sub-slots reordered at step
  boundaries to keep links warm (edges active in consecutive sub-slots skip
  the slew/acquisition penalty).

Every strategy materializes a real :class:`ContactSchedule` through
``ContactPlan.iter_slots`` (so antenna budgets, monotone wall clock, and
skip-slot semantics all still hold) and the winner is chosen by
:func:`repro_torch.constellation.cost.schedule_cost` — the same analytic oracle
the property tests check against. Because the greedy baseline is scored with
the identical oracle and kept when nothing beats it, the optimizer provably
never loses to greedy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch import telemetry
from repro_torch.constellation import cost as cost_lib
from repro_torch.telemetry import metrics
from repro_torch.constellation.contact_plan import (
    AntennaSpec,
    Colorer,
    ContactPlan,
    ContactSchedule,
)
from repro_torch.constellation.links import Edge, Link
from repro_torch.core.relation import Relation
from repro_torch.core.schedule import TDMSchedule, pack_matchings, weighted_edge_coloring

STRATEGIES = ("greedy", "slow_first", "mwm", "overlap")


def edge_times_s(links: Dict[Edge, Link], payload_bytes: int) -> Dict[Edge, float]:
    """Per-edge completion time (``Link.transfer_time_s``, the same formula
    slot sizing and the cost oracle use) — the weights the rate-aware
    colorings group by."""
    return {e: l.transfer_time_s(payload_bytes) for e, l in links.items()}


def mwm_peeling(rel: Relation, rates: Dict[Edge, float]) -> List[Relation]:
    """Decompose ``rel`` by repeatedly extracting the maximum-weight matching
    of the remaining edges (weight = link rate). The first color classes
    carry the highest aggregate throughput, so fast exchanges finish before
    any slow edge gets to straggle. Each class is a matching and the classes
    partition ``rel``'s edge set."""
    import networkx as nx

    remaining = set(rel.edge_list())
    out: List[Relation] = []
    while remaining:
        g = nx.Graph()
        g.add_weighted_edges_from(
            (u, v, float(rates.get((u, v), 0.0))) for u, v in remaining
        )
        picked = {
            (min(a, b), max(a, b))
            for a, b in nx.max_weight_matching(g, maxcardinality=True)
        }
        if not picked:  # pragma: no cover - blossom always matches >= 1 edge
            picked = {min(remaining)}
        out.append(Relation.from_edges(sorted(picked), nodes=rel.nodes))
        remaining -= picked
    return out


def order_for_overlap(
    subs: Sequence[Relation], prev: Optional[Relation]
) -> List[Relation]:
    """Greedily chain sub-slots so each keeps the most edges warm from its
    predecessor (ties break toward the original order). Within one time step
    sub-slots are edge-disjoint, so in practice this picks which sub-slot
    inherits the previous *step*'s pointing."""
    rest = list(subs)
    out: List[Relation] = []
    warm = set(prev.edge_list()) if prev is not None else set()
    while rest:
        scores = [len(warm & set(r.edge_list())) for r in rest]
        best = scores.index(max(scores))
        chosen = rest.pop(best)
        out.append(chosen)
        warm = set(chosen.edge_list())
    return out


def _slow_first_colorer(payload_bytes: int) -> Colorer:
    def colorer(rel, links, budget, prev):
        times = edge_times_s(links, payload_bytes)
        return pack_matchings(weighted_edge_coloring(rel, times), budget, rel.nodes)

    return colorer


def _mwm_colorer(payload_bytes: int) -> Colorer:
    def colorer(rel, links, budget, prev):
        rates = {e: l.rate_bps for e, l in links.items()}
        return pack_matchings(mwm_peeling(rel, rates), budget, rel.nodes)

    return colorer


def _overlap_colorer(payload_bytes: int) -> Colorer:
    slow = _slow_first_colorer(payload_bytes)

    def colorer(rel, links, budget, prev):
        return order_for_overlap(slow(rel, links, budget, prev), prev)

    return colorer


_COLORER_FACTORIES = {
    "greedy": None,  # ContactPlan.iter_slots' built-in path, bit-for-bit
    "slow_first": _slow_first_colorer,
    "mwm": _mwm_colorer,
    "overlap": _overlap_colorer,
}


@dataclass(frozen=True)
class OptimizationResult:
    """The winning schedule plus the full per-strategy scoreboard."""

    schedule: ContactSchedule
    strategy: str
    costs: Dict[str, cost_lib.RoundCost]

    @property
    def baseline(self) -> cost_lib.RoundCost:
        return self.costs["greedy"]

    @property
    def chosen(self) -> cost_lib.RoundCost:
        return self.costs[self.strategy]

    @property
    def speedup(self) -> float:
        """Greedy round time over the chosen schedule's (>= 1 by construction)."""
        if self.chosen.time_s <= 0.0:
            return 1.0
        return self.baseline.time_s / self.chosen.time_s


def optimize_schedule(
    plan: ContactPlan,
    antennas: AntennaSpec = None,
    payload_bytes: int = 1 << 20,
    alive: Optional[Iterable[int]] = None,
    acquisition_s: float = 0.0,
    mode: str = "rate",
    comm_mode: str = "getmeas",
    max_slots: Optional[int] = None,
    objective: str = "gossip",
    sinks: Optional[Iterable[int]] = None,
    pipeline_depth: int = 1,
    max_staleness_windows: int = 0,
    strategies: Optional[Sequence[str]] = None,
) -> OptimizationResult:
    """Pick the cheapest feasible schedule for ``plan`` under the cost oracle.

    ``mode`` is ``"rate"`` (race the whole strategy portfolio) or a single
    strategy name from :data:`STRATEGIES` (raced against greedy).
    ``strategies`` overrides ``mode`` with an explicit portfolio subset —
    greedy is injected regardless (mega-constellation plans subset away
    ``"mwm"``, whose O(V³) blossom dominates at 1000+ nodes). The greedy
    baseline is *always* a candidate and wins ties, so the returned
    schedule's ``schedule_cost`` is never above the baseline's — the
    invariant ``tests/test_schedule_optimizer.py`` proves on random plans.

    ``objective`` selects what the oracle prices: ``"gossip"`` (default)
    scores one decentralized TDM pass (``cost.schedule_cost``);
    ``"groundseg"`` scores a sink-based centralized round — uplink relays
    + downlink broadcast routed over each candidate's slots
    (``cost.groundseg_schedule_cost``; requires ``sinks``). With
    ``pipeline_depth=2`` (and optionally ``max_staleness_windows``) the
    groundseg objective prices the steady-state PIPELINED round, so the
    optimizer picks the schedule whose bottleneck stage is shortest. The
    never-worse-than-greedy guarantee holds per objective, since every
    candidate is scored by the same oracle.

    Candidates are always scored over the FULL plan (equal work — every
    candidate realizes the same exchanges). ``max_slots`` then caps the
    *returned winner's* materialized slots, exactly like
    ``ContactPlan.schedule(max_slots=)``; truncating before scoring would
    let a "winner" look fast by simply skipping expensive exchanges.
    """
    if objective not in ("gossip", "groundseg"):
        raise ValueError(
            f"objective must be 'gossip' or 'groundseg', got {objective!r}"
        )
    if objective == "groundseg" and sinks is None:
        raise ValueError("objective='groundseg' needs the sink node ids")
    if strategies is not None:
        bad = sorted(set(strategies) - set(_COLORER_FACTORIES))
        if bad:
            raise ValueError(
                f"unknown strategies {bad}; choose from {sorted(_COLORER_FACTORIES)}"
            )
        # greedy is always raced (the never-worse anchor); order preserved
        names: Tuple[str, ...] = tuple(dict.fromkeys(("greedy", *strategies)))
    elif mode == "rate":
        names = STRATEGIES
    elif mode in _COLORER_FACTORIES:
        names = ("greedy", mode) if mode != "greedy" else ("greedy",)
    else:
        raise ValueError(
            f"optimize mode must be 'rate' or one of {sorted(_COLORER_FACTORIES)}, "
            f"got {mode!r}"
        )
    plan = plan.with_graphs()   # materialize Link dicts once, not per strategy
    candidates: Dict[str, ContactSchedule] = {}
    costs: Dict[str, cost_lib.RoundCost] = {}
    for name in names:
        factory = _COLORER_FACTORIES[name]
        colorer = None if factory is None else factory(payload_bytes)
        sched = plan.schedule(
            antennas=antennas,
            payload_bytes=payload_bytes,
            alive=alive,
            acquisition_s=acquisition_s,
            colorer=colorer,
        )
        candidates[name] = sched
        if objective == "groundseg":
            costs[name] = cost_lib.groundseg_schedule_cost(
                sched, sinks, payload_bytes, n_nodes=plan.n_nodes,
                pipeline_depth=pipeline_depth,
                max_staleness_windows=max_staleness_windows,
            )
        else:
            costs[name] = cost_lib.schedule_cost(
                sched, payload_bytes, comm_mode, acquisition_s
            )
    best = "greedy"
    for name in names:
        if costs[name].time_s < costs[best].time_s:
            best = name
    # flight-recorder note of the race outcome: every candidate's cost,
    # the winner, and its margin over the greedy baseline
    rec = telemetry.get_recorder()
    rec.counter("optimizer.races")
    rec.counter(f"optimizer.winner.{best}")
    greedy_t = costs["greedy"].time_s
    best_t = costs[best].time_s
    rec.event(
        "optimizer.race",
        cat="optimizer",
        objective=objective,
        winner=best,
        costs_s={n: costs[n].time_s for n in names},
        margin_vs_greedy_s=greedy_t - best_t,
        speedup=(greedy_t / best_t) if best_t > 0 else 1.0,
    )
    winner = candidates[best]
    if max_slots is not None and len(winner) > max_slots:
        winner = ContactSchedule(
            tdm=TDMSchedule(winner.tdm.slots[:max_slots]),
            slots=winner.slots[:max_slots],
        )
    return OptimizationResult(schedule=winner, strategy=best, costs=costs)


class WindowedOptimizer:
    """Incremental schedule optimization across consecutive plan windows.

    Re-racing the full strategy portfolio every window repeats work that
    consecutive windows almost always agree on (orbital geometry drifts
    slowly relative to a plan window). This warm-starts each window from
    the previous window's winning strategy:

    - window 0 (and any window after a winner change) races the FULL
      portfolio — recorded as ``optimizer.warm_start.race``;
    - subsequent windows race only {greedy, previous winner}. If the
      previous winner still wins, that cheap race is the answer —
      ``optimizer.warm_start.hit``. If it lost its edge (the geometry
      shifted), the full portfolio is re-raced immediately, so a stale
      warm start costs one extra cheap race, never a worse schedule.

    Greedy is a candidate in every race, so the per-window
    never-worse-than-greedy guarantee of :func:`optimize_schedule` is
    preserved verbatim. ``full_race_every=k`` (optional) forces a full
    re-race every k windows, bounding how long a greedy-winning streak can
    mask a newly profitable strategy.
    """

    def __init__(
        self,
        portfolio: Sequence[str] = STRATEGIES,
        full_race_every: int = 0,
        **optimize_kwargs,
    ):
        bad = sorted(set(portfolio) - set(_COLORER_FACTORIES))
        if bad:
            raise ValueError(
                f"unknown strategies {bad}; choose from {sorted(_COLORER_FACTORIES)}"
            )
        if full_race_every < 0:
            raise ValueError(f"full_race_every must be >= 0, got {full_race_every}")
        if "strategies" in optimize_kwargs or "mode" in optimize_kwargs:
            raise ValueError(
                "pass the portfolio positionally; WindowedOptimizer owns the "
                "per-window strategy selection"
            )
        self.portfolio = tuple(dict.fromkeys(("greedy", *portfolio)))
        self.full_race_every = int(full_race_every)
        self.optimize_kwargs = optimize_kwargs
        self._prev_winner: Optional[str] = None
        self._window = -1

    @property
    def window(self) -> int:
        """Index of the last optimized window (-1 before the first)."""
        return self._window

    def optimize(
        self, plan: ContactPlan, alive: Optional[Iterable[int]] = None
    ) -> OptimizationResult:
        """Optimize the next window's plan, warm-starting from the last."""
        self._window += 1
        rec = telemetry.get_recorder()
        due_full = (
            self._prev_winner is None
            or (
                self.full_race_every > 0
                and self._window % self.full_race_every == 0
            )
        )
        if not due_full:
            warm = optimize_schedule(
                plan,
                alive=alive,
                strategies=("greedy", self._prev_winner),
                **self.optimize_kwargs,
            )
            if warm.strategy == self._prev_winner:
                rec.counter("optimizer.warm_start.hit")
                self._update_hit_rate(rec)
                return warm
            # previous winner dethroned — the window changed character;
            # fall through to a full portfolio race
        rec.counter("optimizer.warm_start.race")
        self._update_hit_rate(rec)
        result = optimize_schedule(
            plan, alive=alive, strategies=self.portfolio, **self.optimize_kwargs
        )
        self._prev_winner = result.strategy
        return result

    @staticmethod
    def _update_hit_rate(rec) -> None:
        """Keep the warm-start hit-rate gauge current (hits over all
        windows optimized so far in this recording scope)."""
        hits = rec.get_counter("optimizer.warm_start.hit")
        races = rec.get_counter("optimizer.warm_start.race")
        metrics.ratio_gauge(
            "optimizer.warm_start.hit_rate", hits, hits + races, rec=rec
        )
