"""Model registry: a config -> callable bundle (init, training loss,
prefill, decode and the decode cache).

Counterpart of ``bundle`` in the JAX package's ``models/registry.py``. The
dry-run input specs (``input_specs``, ``cache_specs``) have no counterpart:
they feed the reference's AOT dry run, which the port does not have.
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

    def loss_fn(self, params, batch, impl: str = "auto"
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Training loss; ``impl="ref"`` runs attention's plain versions."""
        return transformer.loss_fn(params, batch, self.cfg, impl)

    def prefill_fn(self, params, batch, max_len: int):
        return transformer.prefill(params, batch["tokens"], self.cfg, max_len)

    def decode_fn(self, params, cache, batch):
        return transformer.decode_step(params, cache, batch["token"], self.cfg)

    def init_cache(self, batch: int, max_len: int, device=None):
        return transformer.init_cache(self.cfg, batch, max_len, device)


def bundle(cfg: ModelConfig) -> ModelBundle:
    return ModelBundle(cfg)
