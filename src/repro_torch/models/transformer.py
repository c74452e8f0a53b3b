"""The LM decoder stack, ssm family (mamba2): init, training forward, loss.

Counterpart of the JAX package's ``models/transformer.py``. Only the ssm
family is ported so far; the attention, MoE, hybrid and encoder-decoder
families raise ``NotImplementedError``. Units are stacked on a leading layer
axis as in the reference (its ``lax.scan`` layout), and the forward loops
over them. ``cfg.remat`` is a memory setting with no numeric effect and is
ignored: activations are kept for autograd.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.models import mamba2 as mamba_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    dtype_of,
    embed_tokens,
    init_embedding,
    init_rmsnorm,
    lm_logits,
    rmsnorm,
)
from repro_torch.pytree import tree_map

Params = Dict[str, Any]


@dataclass(frozen=True)
class LayerDesc:
    mixer: str                  # "mamba" (attention mixers come with their families)
    ffn: Optional[str] = None   # "dense" | "moe" | None


def _unported(cfg: ModelConfig):
    return NotImplementedError(
        f"model family {cfg.family!r} ({cfg.name}) is not ported yet; the "
        "port covers the ssm family (ROADMAP queue 1, model zoo)"
    )


def scan_unit(cfg: ModelConfig) -> List[LayerDesc]:
    """The per-unit layer pattern (ssm: one mamba layer, no FFN)."""
    if cfg.family == "ssm":
        return [LayerDesc("mamba", ffn=None if cfg.no_ffn else "dense")]
    raise _unported(cfg)


def n_units(cfg: ModelConfig) -> int:
    return cfg.n_layers // len(scan_unit(cfg))


def init_unit(gen: torch.Generator, cfg: ModelConfig) -> Params:
    p = {}
    for j, d in enumerate(scan_unit(cfg)):
        if d.mixer != "mamba" or d.ffn is not None:
            raise _unported(cfg)
        p[f"L{j}"] = {
            "ln": init_rmsnorm(cfg.d_model, dtype_of(cfg.param_dtype), gen.device),
            "mamba": mamba_lib.init_mamba(gen, cfg),
        }
    return p


def init_params(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random params on ``gen``'s device; units stacked on a layer axis."""
    params: Params = {"embed": init_embedding(gen, cfg)}
    units = [init_unit(gen, cfg) for _ in range(n_units(cfg))]
    params["units"] = tree_map(lambda *xs: torch.stack(xs, dim=0), *units)
    params["final_ln"] = init_rmsnorm(cfg.d_model, dtype_of(cfg.param_dtype), gen.device)
    return params


def _unit_forward(h: torch.Tensor, unit_p: Params, cfg: ModelConfig) -> torch.Tensor:
    """Apply one unit (mamba branch)."""
    for j, d in enumerate(scan_unit(cfg)):
        p = unit_p[f"L{j}"]
        hn = rmsnorm(h, p["ln"], cfg.norm_eps)
        h = h + mamba_lib.mamba_forward(p["mamba"], hn, cfg)
    return h


def forward_train(params: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Decoder forward: hidden states (B, S, D)."""
    h = embed_tokens(params["embed"], tokens, cfg)
    for u in range(n_units(cfg)):
        unit_p = tree_map(lambda t: t[u], params["units"])
        h = _unit_forward(h, unit_p, cfg)
    return rmsnorm(h, params["final_ln"], cfg.norm_eps)


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Token-mean cross-entropy, the vocab projection taken ``loss_chunk``
    positions at a time (the logits of one chunk at once, as the reference's
    chunk scan)."""
    tokens, labels = batch["tokens"], batch["labels"]
    h = forward_train(params, tokens, cfg)
    B, S, _ = h.shape
    chunk = min(cfg.loss_chunk, S)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(S // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        logits = lm_logits(params["embed"], h[:, sl], cfg)       # (B,chunk,V) f32
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.take_along_dim(logits, labels[:, sl, None].long(), dim=-1)[..., 0]
        total = total + torch.sum(lse - gold)
    loss = total / (B * S)
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    return loss, {"ce_loss": loss, "moe_aux": zero, "moe_zloss": zero}
