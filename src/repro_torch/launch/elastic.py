"""Fault tolerance and elasticity: the host-side mechanisms.

Counterpart of the numpy part of the JAX package's ``launch/elastic.py``
(copied, with imports rewritten). Hardware failure itself is simulated.

1. **TDM rescheduling on node loss** — the paper's skip-slot semantics:
   a dead/occluded satellite is dropped from every slot's relation
   (``Relation.restrict``); remaining exchanges stay valid (tested
   property), and gossip re-mixes the survivors.
2. **Straggler mitigation** — slot-deadline policy: a node that misses the
   slot deadline is treated as ``odata=None`` (participate=False masks its
   payload in tdm.get_meas).
3. **Elastic replica membership** — the serving twin of (1):
   ``ReplicaMembership`` tracks which model-replica satellites are in
   service under orbital churn. A replica losing visibility is *drained*
   (the serving engine abandons its batch and re-routes the requests);
   one regaining visibility is re-admitted after ``grace_slots`` of
   continuous visibility.

4. **Elastic restart** -- :func:`restore_for_mesh` restores the latest
   checkpoint into the trainer's state. The reference reshards it onto a
   mesh of any size; on one card "for mesh" is placement onto a device.
   Anything across cards waits for more than one card.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterable, Optional, Set

import numpy as np

from repro_torch.checkpoint import checkpoint as ckpt_lib
from repro_torch.core.schedule import TDMSchedule
from repro_torch.device import resolve_device
from repro_torch.launch import steps as steps_lib
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw


@dataclasses.dataclass
class HealthTracker:
    """Heartbeat bookkeeping for the node set (satellites / hosts)."""

    n_nodes: int
    deadline_s: float = 10.0
    last_seen: Dict[int, float] = dataclasses.field(default_factory=dict)

    def beat(self, node: int, t: Optional[float] = None) -> None:
        self.last_seen[node] = time.monotonic() if t is None else t

    def alive(self, now: Optional[float] = None) -> Set[int]:
        now = time.monotonic() if now is None else now
        return {
            i for i in range(self.n_nodes)
            if now - self.last_seen.get(i, -1e18) <= self.deadline_s
        }

    def dead(self, now: Optional[float] = None) -> Set[int]:
        return set(range(self.n_nodes)) - self.alive(now)


def reschedule(schedule: TDMSchedule, alive: Iterable[int]) -> TDMSchedule:
    """Drop failed nodes from every slot (paper skip-slot semantics)."""
    return schedule.restrict(alive)


@dataclasses.dataclass(frozen=True)
class SlotDeadline:
    """Straggler policy: who participates in the current slot.

    ``participate(progress, slot_deadline)`` returns the boolean mask the
    TDM collective consumes — late nodes ship zeros and are masked by their
    peers, exactly the paper's `odata=None` assumption (b)."""

    deadline_steps: int

    def participate(self, node_progress: np.ndarray, slot_step: int) -> np.ndarray:
        return node_progress >= slot_step - self.deadline_steps


@dataclasses.dataclass(frozen=True)
class MembershipDelta:
    """One membership update: replicas drained / (re-)admitted this step."""

    drained: frozenset
    admitted: frozenset

    @property
    def changed(self) -> bool:
        return bool(self.drained or self.admitted)


class ReplicaMembership:
    """Elastic replica membership under orbital churn.

    ``update(visible)`` moves replicas between in-service and drained based
    on the visibility set the caller computes (alive + reachable on the
    contact graph). Draining is immediate — a replica that cannot uplink
    or downlink must abandon its batch *now* so requests re-route; re-
    admission waits for ``grace_slots`` consecutive visible updates, which
    damps flapping at a contact-window edge (a replica seen for a single
    step of a grazing pass is not worth re-prefetching a wave onto).
    """

    def __init__(self, replicas: Iterable[int], grace_slots: int = 0):
        self.replicas = frozenset(int(r) for r in replicas)
        self.grace_slots = int(grace_slots)
        self._active: Set[int] = set(self.replicas)
        self._streak: Dict[int, int] = {r: 0 for r in self.replicas}

    @property
    def active(self) -> frozenset:
        """Replicas currently in service (admission-eligible)."""
        return frozenset(self._active)

    @property
    def drained(self) -> frozenset:
        return self.replicas - self.active

    def update(self, visible: Iterable[int]) -> MembershipDelta:
        vis = set(visible) & self.replicas
        drained = frozenset(self._active - vis)
        self._active -= drained
        admitted: Set[int] = set()
        for r in self.replicas:
            if r in vis:
                self._streak[r] += 1
                if r not in self._active and self._streak[r] > self.grace_slots:
                    admitted.add(r)
            else:
                self._streak[r] = 0
        self._active |= admitted
        return MembershipDelta(drained=drained, admitted=frozenset(admitted))


def restore_for_mesh(ckpt_dir: str, cfg: ModelConfig, opt_cfg: adamw.OptConfig,
                     device=None, step: Optional[int] = None):
    """Elastic restart: ``(step, state)``, the checkpoint at ``step`` (the
    latest by default) restored into the train state that
    :func:`~repro_torch.launch.steps.init_state` builds for ``cfg`` /
    ``opt_cfg`` (its structure and dtypes), on ``device`` (the card unless
    asked otherwise)."""
    target = steps_lib.state_target(cfg, opt_cfg)
    return ckpt_lib.restore(ckpt_dir, step=step, target=target,
                            device=resolve_device(device))
