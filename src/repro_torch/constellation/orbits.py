"""Circular-orbit propagation for Walker constellations and ground stations.

Everything is pure NumPy and deterministic: positions are closed-form
functions of time (no integrator state), so a contact plan generated twice
from the same geometry is bit-identical — the property the TDM scheduler
relies on when satellites compute the schedule independently (paper
assumption (a): common knowledge of the schedule).

Conventions: kilometres and seconds; ECI frame with the z-axis through the
north pole; a Walker pattern ``i:t/p/f`` is ``WalkerDelta(total=t, planes=p,
phasing=f, inclination_deg=i)``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Sequence, Tuple, Union

import numpy as np

MU_EARTH_KM3_S2 = 398600.4418      # standard gravitational parameter
R_EARTH_KM = 6371.0                # mean Earth radius
EARTH_ROT_RAD_S = 7.2921159e-5     # sidereal rotation rate


def _rot_x(a: float) -> np.ndarray:
    c, s = math.cos(a), math.sin(a)
    return np.array([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]])


def _rot_z(a: float) -> np.ndarray:
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


@dataclass(frozen=True)
class WalkerDelta:
    """Walker constellation i:t/p/f on circular orbits.

    ``pattern="delta"`` spreads the ascending nodes over 360° (Kuiper/
    Starlink style); ``pattern="star"`` over 180° (Iridium style, polar
    seams). Satellite (plane p, slot k) has node id ``p * per_plane + k`` —
    the node ids the rest of the repo's relations/schedules use.
    """

    total: int = 24
    planes: int = 4
    phasing: int = 1
    inclination_deg: float = 53.0
    altitude_km: float = 550.0
    pattern: str = "delta"

    def __post_init__(self):
        if self.total % self.planes:
            raise ValueError("total must be divisible by planes")
        if self.pattern not in ("delta", "star"):
            raise ValueError(f"unknown Walker pattern {self.pattern!r}")

    # ------------------------------------------------------------- layout
    @property
    def per_plane(self) -> int:
        return self.total // self.planes

    def node_id(self, plane: int, slot: int) -> int:
        return (plane % self.planes) * self.per_plane + (slot % self.per_plane)

    def plane_of(self, node: int) -> int:
        return node // self.per_plane

    # ----------------------------------------------------------- dynamics
    @property
    def orbit_radius_km(self) -> float:
        return R_EARTH_KM + self.altitude_km

    @property
    def period_s(self) -> float:
        return 2.0 * math.pi * math.sqrt(self.orbit_radius_km ** 3 / MU_EARTH_KM3_S2)

    @property
    def mean_motion_rad_s(self) -> float:
        return 2.0 * math.pi / self.period_s

    def raan_rad(self, plane: int) -> float:
        spread = 2.0 * math.pi if self.pattern == "delta" else math.pi
        return spread * plane / self.planes

    def phase_rad(self, plane: int, slot: int) -> float:
        """Argument of latitude at t=0 (in-plane spacing + inter-plane
        phasing f: adjacent planes offset by 2π·f/total)."""
        return (
            2.0 * math.pi * slot / self.per_plane
            + 2.0 * math.pi * self.phasing * plane / self.total
        )

    def positions(self, t: float | np.ndarray) -> np.ndarray:
        """ECI positions at time(s) ``t`` (seconds).

        Scalar ``t`` -> (total, 3); array (T,) -> (T, total, 3). Km.

        One batched (T, N, 3) array program — no per-plane/per-satellite
        Python loops, so a 1000+ satellite shell propagates in one shot.
        Bit-identical to :meth:`positions_reference` (the retained legacy
        loop), which the mega-constellation equivalence suite asserts.
        """
        ts = np.atleast_1d(np.asarray(t, dtype=np.float64))
        r = self.orbit_radius_km
        n = self.mean_motion_rad_s
        inc = math.radians(self.inclination_deg)
        ci, si = math.cos(inc), math.sin(inc)
        node = np.arange(self.total)
        plane = node // self.per_plane
        slot = node % self.per_plane
        # raan_rad / phase_rad, evaluated for every node at once with the
        # same scalar operation order as the per-satellite originals
        spread = 2.0 * math.pi if self.pattern == "delta" else math.pi
        raan = spread * plane / self.planes                         # (N,)
        phase = (
            2.0 * math.pi * slot / self.per_plane
            + 2.0 * math.pi * self.phasing * plane / self.total
        )                                                           # (N,)
        u = phase[None, :] + n * ts[:, None]                        # (T, N)
        x = r * np.cos(u)
        y = r * np.sin(u)
        z = np.zeros_like(u)
        # rot = Rz(raan) @ Rx(inc) in closed form; out = in_plane @ rot.T
        # with the zero third component kept so the flop sequence (and
        # therefore every rounding) matches the legacy matmul exactly
        ca, sa = np.cos(raan), np.sin(raan)
        out = np.empty((ts.shape[0], self.total, 3))
        out[..., 0] = x * ca + y * (-sa * ci) + z * (sa * si)
        out[..., 1] = x * sa + y * (ca * ci) + z * (-ca * si)
        out[..., 2] = x * 0.0 + y * si + z * ci
        return out if np.ndim(t) else out[0]

    def positions_reference(self, t: float | np.ndarray) -> np.ndarray:
        """The per-plane/per-satellite propagation loop, retained as the
        equivalence oracle for :meth:`positions` (every
        fast path keeps its legacy twin). The rotation is applied with
        explicit component products rather than ``@`` so the flop sequence
        is FMA-free on every platform — the batched path then reproduces it
        bit for bit (BLAS contracts the tiny matmul with fused
        multiply-adds, which rounds differently by ~1 ulp)."""
        ts = np.atleast_1d(np.asarray(t, dtype=np.float64))
        r = self.orbit_radius_km
        n = self.mean_motion_rad_s
        inc = math.radians(self.inclination_deg)
        out = np.empty((ts.shape[0], self.total, 3))
        for p in range(self.planes):
            rot = _rot_z(self.raan_rad(p)) @ _rot_x(inc)
            for k in range(self.per_plane):
                u = self.phase_rad(p, k) + n * ts  # (T,)
                x = r * np.cos(u)
                y = r * np.sin(u)
                z = np.zeros_like(u)
                nid = self.node_id(p, k)
                for axis in range(3):
                    out[:, nid, axis] = (
                        x * rot[axis, 0] + y * rot[axis, 1] + z * rot[axis, 2]
                    )
        return out if np.ndim(t) else out[0]


@dataclass(frozen=True)
class MultiShell:
    """A stack of Walker shells — the mega-constellation layout.

    Starlink-class systems fly several shells at different altitudes and
    inclinations; node ids run shell by shell in the given order (shell 0's
    Walker layout first, then shell 1 offset by ``shells[0].total``, ...),
    so one :class:`MultiShell` drops into every relation/schedule/routing
    API that takes a flat node-id universe. ``positions`` is the batched
    concatenation of the per-shell array programs.
    """

    shells: Tuple[WalkerDelta, ...]

    def __post_init__(self):
        if not self.shells:
            raise ValueError("MultiShell needs at least one shell")

    @property
    def total(self) -> int:
        return sum(s.total for s in self.shells)

    def shell_offsets(self) -> Tuple[int, ...]:
        """Node id of each shell's first satellite."""
        offs: List[int] = []
        acc = 0
        for s in self.shells:
            offs.append(acc)
            acc += s.total
        return tuple(offs)

    def shell_of(self, node: int) -> int:
        acc = 0
        for idx, s in enumerate(self.shells):
            acc += s.total
            if node < acc:
                return idx
        raise ValueError(f"node {node} outside 0..{self.total - 1}")

    def positions(self, t: float | np.ndarray) -> np.ndarray:
        """ECI positions: scalar ``t`` -> (total, 3); (T,) -> (T, total, 3)."""
        ts = np.atleast_1d(np.asarray(t, dtype=np.float64))
        out = np.concatenate([s.positions(ts) for s in self.shells], axis=1)
        return out if np.ndim(t) else out[0]


Geometry = Union["WalkerDelta", "MultiShell"]


@dataclass(frozen=True)
class GroundStation:
    """A fixed Earth-surface terminal, rotated into ECI with the planet."""

    lat_deg: float
    lon_deg: float
    alt_km: float = 0.0
    name: str = ""

    def positions(self, t: float | np.ndarray) -> np.ndarray:
        ts = np.atleast_1d(np.asarray(t, dtype=np.float64))
        lat = math.radians(self.lat_deg)
        r = R_EARTH_KM + self.alt_km
        lon = math.radians(self.lon_deg) + EARTH_ROT_RAD_S * ts  # (T,)
        out = np.stack(
            [
                r * math.cos(lat) * np.cos(lon),
                r * math.cos(lat) * np.sin(lon),
                np.full_like(lon, r * math.sin(lat)),
            ],
            axis=-1,
        )
        return out if np.ndim(t) else out[0]


def propagate(
    geom: Geometry,
    times: Sequence[float] | np.ndarray,
    ground_stations: Sequence[GroundStation] = (),
) -> np.ndarray:
    """Stack satellite + ground-station ECI tracks: (T, total + G, 3).

    Node ids 0..total-1 are satellites (Walker layout); total..total+G-1 are
    the ground stations in the given order.
    """
    times = np.asarray(times, dtype=np.float64)
    tracks = [geom.positions(times)]
    for gs in ground_stations:
        tracks.append(gs.positions(times)[:, None, :])
    return np.concatenate(tracks, axis=1)


def sample_times(duration_s: float, step_s: float) -> np.ndarray:
    """Uniform sample grid [0, duration) — one contact-plan time step each."""
    if step_s <= 0 or duration_s <= 0:
        raise ValueError("duration_s and step_s must be positive")
    return np.arange(0.0, duration_s, step_s, dtype=np.float64)
