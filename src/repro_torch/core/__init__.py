"""TDM relations, schedules, gossip weights, the paper-faithful simulator,
the stacked TDM exchange with its compressors, and the fused flat-buffer
engine."""

from repro_torch.core.relation import Relation
from repro_torch.core.schedule import TDMSchedule

__all__ = ["Relation", "TDMSchedule"]
