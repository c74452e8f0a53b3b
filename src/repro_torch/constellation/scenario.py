"""Unified scenario factory: one setup path for examples, benchmarks, tests.

Before this module every driver rebuilt the same geometry by hand —
``examples/train_fl_constellation.py``, ``examples/serve_constellation.py``,
and the groundseg benchmarks each carried their own Walker-shell +
ground-station + contact-plan boilerplate, with subtly diverging defaults
(two benchmarks even held two different ``GROUND_SITES`` lists). A
:class:`ScenarioSpec` names the whole deployment — shells, ground stations,
link budget, horizon, seed — and :func:`build_scenario` turns it into a
:class:`Scenario` holding the propagated geometry, the contact plan, and a
cached TDM schedule, so training and serving provably run the same sky.

Quick use::

    from repro_torch.constellation.scenario import (
        ScenarioSpec, ShellSpec, build_scenario,
    )

    scn = build_scenario(ScenarioSpec(
        shells=(ShellSpec(planes=2, per_plane=3),), n_ground=2,
    ))
    sched = scn.schedule()            # cached ContactSchedule
    rels = scn.slots()                # per-slot TDM Relations
    sinks = scn.ground_ids            # frozenset of ground-station node ids
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Tuple

from repro_torch.constellation.contact_plan import (
    ContactPlan,
    ContactSchedule,
    build_contact_plan,
)
from repro_torch.constellation.links import LinkBudget
from repro_torch.constellation.orbits import (
    R_EARTH_KM,
    Geometry,
    GroundStation,
    MultiShell,
    WalkerDelta,
)
from repro_torch.core.relation import Relation

# Canonical ground segment: the union of the site lists that used to live,
# duplicated and diverging, in benchmarks/groundseg_round_time.py and
# benchmarks/groundseg_pipeline.py. ``n_ground`` selects a prefix.
GROUND_SITES: Tuple[GroundStation, ...] = (
    GroundStation(0.0, 0.0, name="equator"),
    GroundStation(45.0, 120.0, name="midlat-e"),
    GroundStation(-30.0, -60.0, name="midlat-s"),
    GroundStation(60.0, 10.0, name="highlat"),
)


@dataclass(frozen=True)
class ShellSpec:
    """One Walker shell of a (possibly multi-shell) constellation."""

    planes: int = 2
    per_plane: int = 3
    altitude_km: float = 8062.0   # MEO: whole-period plans stay small
    inclination_deg: float = 60.0
    phasing: int = 1
    pattern: str = "delta"

    @property
    def total(self) -> int:
        return self.planes * self.per_plane

    def walker(self) -> WalkerDelta:
        return WalkerDelta(
            total=self.total,
            planes=self.planes,
            phasing=self.phasing,
            inclination_deg=self.inclination_deg,
            altitude_km=self.altitude_km,
            pattern=self.pattern,
        )


@dataclass(frozen=True)
class ScenarioSpec:
    """Everything that defines a deployment, in one hashable record.

    ``shells`` stacks Walker shells (one → plain :class:`WalkerDelta`
    geometry, several → :class:`MultiShell`); ``ground_stations`` overrides
    the canonical :data:`GROUND_SITES` prefix selected by ``n_ground``.
    ``duration_s=None`` defaults the horizon to one orbital period of the
    first shell; ``max_range_km=None`` defaults to the diameter bound
    ``2·(R⊕ + max altitude)`` the benchmarks always used.
    """

    shells: Tuple[ShellSpec, ...] = (ShellSpec(),)
    n_ground: int = 2
    ground_stations: Optional[Tuple[GroundStation, ...]] = None
    budget: LinkBudget = LinkBudget()
    duration_s: Optional[float] = None
    steps: int = 16
    candidates: str = "all"
    max_range_km: Optional[float] = None
    min_rate_bps: float = 0.0
    antennas: int = 2
    payload_bytes: int = 1 << 20
    acquisition_s: float = 0.0
    optimize: Optional[str] = None
    seed: int = 0

    def __post_init__(self):
        if not self.shells:
            raise ValueError("ScenarioSpec needs at least one shell")
        if self.ground_stations is None and not (
            0 <= self.n_ground <= len(GROUND_SITES)
        ):
            raise ValueError(
                f"n_ground must be in 0..{len(GROUND_SITES)} "
                f"(got {self.n_ground}); pass ground_stations= for more"
            )

    @property
    def sites(self) -> Tuple[GroundStation, ...]:
        if self.ground_stations is not None:
            return tuple(self.ground_stations)
        return GROUND_SITES[: self.n_ground]

    @property
    def n_sats(self) -> int:
        return sum(s.total for s in self.shells)

    def geometry(self) -> Geometry:
        if len(self.shells) == 1:
            return self.shells[0].walker()
        return MultiShell(shells=tuple(s.walker() for s in self.shells))

    def horizon_s(self) -> float:
        if self.duration_s is not None:
            return float(self.duration_s)
        return self.shells[0].walker().period_s

    def range_km(self) -> float:
        if self.max_range_km is not None:
            return float(self.max_range_km)
        return 2.0 * (R_EARTH_KM + max(s.altitude_km for s in self.shells))


@dataclass(frozen=True)
class Scenario:
    """A realized deployment: geometry + contact plan + cached schedule."""

    spec: ScenarioSpec
    geom: Geometry
    ground_stations: Tuple[GroundStation, ...]
    plan: ContactPlan

    @property
    def n_sats(self) -> int:
        return self.geom.total

    @property
    def n_nodes(self) -> int:
        return self.plan.n_nodes

    @property
    def sat_ids(self) -> range:
        return range(self.n_sats)

    @property
    def ground_ids(self) -> frozenset:
        """Ground-station node ids (satellites first, then ground — the
        Walker layout contract)."""
        return frozenset(range(self.n_sats, self.n_nodes))

    def relations(self) -> List[Relation]:
        """Raw per-step visibility relations (no antenna decomposition)."""
        return self.plan.relations()

    def schedule(self, **overrides) -> ContactSchedule:
        """Antenna-constrained TDM schedule; the no-override call is cached
        (memoized in ``__dict__`` — legal on a frozen dataclass)."""
        if overrides:
            return self.plan.schedule(**{**self._schedule_kwargs(), **overrides})
        cached = self.__dict__.get("_sched_cache")
        if cached is None:
            cached = self.plan.schedule(**self._schedule_kwargs())
            self.__dict__["_sched_cache"] = cached
        return cached

    def slots(self) -> List[Relation]:
        """Per-slot exchange relations of the cached TDM schedule."""
        return list(self.schedule().tdm)

    def _schedule_kwargs(self) -> dict:
        return dict(
            antennas=self.spec.antennas,
            payload_bytes=self.spec.payload_bytes,
            optimize=self.spec.optimize,
            acquisition_s=self.spec.acquisition_s,
        )

    def describe(self) -> dict:
        """Identity fields for BENCH rows / mission reports."""
        return dict(
            shells=len(self.spec.shells),
            n_sats=self.n_sats,
            n_gs=len(self.ground_stations),
            steps=self.spec.steps,
            seed=self.spec.seed,
        )


def build_scenario(spec: ScenarioSpec) -> Scenario:
    """Propagate the spec's geometry and package the contact plan."""
    geom = spec.geometry()
    horizon = spec.horizon_s()
    plan = build_contact_plan(
        geom,
        duration_s=horizon,
        step_s=horizon / spec.steps,
        budget=spec.budget,
        ground_stations=spec.sites,
        candidates=spec.candidates,
        max_range_km=spec.range_km(),
        min_rate_bps=spec.min_rate_bps,
    )
    return Scenario(
        spec=spec, geom=geom, ground_stations=spec.sites, plan=plan
    )


def smoke_scenario(**overrides) -> Scenario:
    """The small Walker shell CI smoke jobs and fast tests share: 6 sats /
    2 planes / 2 ground stations, 12-step period horizon."""
    kw = dict(
        shells=(ShellSpec(planes=2, per_plane=3),), n_ground=2, steps=12
    )
    kw.update(overrides)
    return build_scenario(ScenarioSpec(**kw))


def replace_spec(scn: Scenario, **changes) -> Scenario:
    """Rebuild a scenario with some spec fields changed (sweep helper)."""
    return build_scenario(dataclasses.replace(scn.spec, **changes))


__all__ = [
    "GROUND_SITES",
    "Scenario",
    "ScenarioSpec",
    "ShellSpec",
    "build_scenario",
    "replace_spec",
    "smoke_scenario",
]
