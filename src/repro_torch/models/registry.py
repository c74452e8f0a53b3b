"""Model registry: a config -> callable bundle (init and training loss).

Counterpart of ``bundle`` in the JAX package's ``models/registry.py``.
Prefill, decode and the dry-run input specs come with later slices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig


@dataclass(frozen=True)
class ModelBundle:
    cfg: ModelConfig

    def init(self, gen: torch.Generator) -> Any:
        """Random params on ``gen``'s device."""
        return transformer.init_params(gen, self.cfg)

    def loss_fn(self, params, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        return transformer.loss_fn(params, batch, self.cfg)


def bundle(cfg: ModelConfig) -> ModelBundle:
    return ModelBundle(cfg)
