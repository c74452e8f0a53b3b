"""The LM decoder stack, ssm family (mamba2): init, training forward, loss,
prefill and decode.

Counterpart of the JAX package's ``models/transformer.py``. Only the ssm
family is ported so far; the attention, MoE, hybrid and encoder-decoder
families raise ``NotImplementedError``. Units are stacked on a leading layer
axis as in the reference (its ``lax.scan`` layout), and the forward loops
over them. ``cfg.remat`` is a memory setting with no numeric effect and is
ignored: activations are kept for autograd.

The decode cache is ``{"pos", "units"}`` as in the reference: per mamba layer
a :class:`~repro_torch.models.mamba2.MambaCache`, stacked on the layer axis.
``pos`` is the number of tokens the cache holds; the ssm family only counts
it (there are no positions to encode).
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


def init_unit_cache(cfg: ModelConfig, batch: int, max_len: int, device=None) -> Dict:
    """Zero cache for ONE unit (to be stacked over units). ``max_len`` sizes
    attention caches; the ssm family's state does not grow with it."""
    cdt = dtype_of(cfg.compute_dtype)
    cache: Dict[str, Any] = {}
    for j, d in enumerate(scan_unit(cfg)):
        if d.mixer != "mamba":
            raise _unported(cfg)
        mb = cfg.mamba
        Hm = mb.n_heads(cfg.d_model)
        conv_dim = mb.d_inner(cfg.d_model) + 2 * mb.n_groups * mb.d_state
        cache[f"mamba{j}"] = mamba_lib.MambaCache(
            ssm=torch.zeros((batch, Hm, mb.head_dim, mb.d_state), dtype=torch.float32,
                            device=device),
            conv=torch.zeros((batch, mb.d_conv - 1, conv_dim), dtype=cdt, device=device),
        )
    return cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None) -> Dict:
    """Zero decode cache, units stacked on the layer axis."""
    one = init_unit_cache(cfg, batch, max_len, device)
    U = n_units(cfg)
    units = tree_map(lambda x: x[None].expand((U,) + tuple(x.shape)).contiguous(), one)
    return {"pos": torch.zeros((), dtype=torch.int32, device=device), "units": units}


def _stack_units(caches: List[Dict]) -> Dict:
    return tree_map(lambda *xs: torch.stack(xs, dim=0), *caches)


def prefill(params: Params, tokens: torch.Tensor, cfg: ModelConfig, max_len: int,
            ssd_impl: str = "auto") -> Tuple[torch.Tensor, Dict]:
    """Run the prompt, build the decode cache. Returns (last-token logits
    (B, 1, V) f32, cache). ``ssd_impl`` picks the SSD scan's implementation
    (``ssd_ops.ssd_scan``: "auto", "cuda" or "ref")."""
    B, S = tokens.shape
    descs = scan_unit(cfg)
    h = embed_tokens(params["embed"], tokens, cfg)
    caches = []
    for u in range(n_units(cfg)):
        unit_p = tree_map(lambda t: t[u], params["units"])
        entries = {}
        for j, d in enumerate(descs):
            p = unit_p[f"L{j}"]
            hn = rmsnorm(h, p["ln"], cfg.norm_eps)
            out, entries[f"mamba{j}"] = mamba_lib.mamba_prefill(p["mamba"], hn, cfg,
                                                                ssd_impl)
            h = h + out
        caches.append(entries)
    h = rmsnorm(h, params["final_ln"], cfg.norm_eps)
    logits = lm_logits(params["embed"], h[:, -1:], cfg)
    pos = torch.full((), S, dtype=torch.int32, device=tokens.device)
    return logits, {"pos": pos, "units": _stack_units(caches)}


def decode_step(params: Params, cache: Dict, token: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, Dict]:
    """One serving step: next-token logits (B, 1, V) f32 and the updated
    cache. ``token`` is (B, 1). ``pos`` is a count, a scalar or one value per
    replica of a folded batch; each is advanced by one."""
    descs = scan_unit(cfg)
    h = embed_tokens(params["embed"], token, cfg)
    caches = []
    for u in range(n_units(cfg)):
        unit_p = tree_map(lambda t: t[u], params["units"])
        unit_c = tree_map(lambda t: t[u], cache["units"])
        new_c = dict(unit_c)
        for j, d in enumerate(descs):
            p = unit_p[f"L{j}"]
            hn = rmsnorm(h, p["ln"], cfg.norm_eps)
            out, new_c[f"mamba{j}"] = mamba_lib.mamba_decode_step(
                p["mamba"], hn, unit_c[f"mamba{j}"], cfg)
            h = h + out
        caches.append(new_c)
    h = rmsnorm(h, params["final_ln"], cfg.norm_eps)
    logits = lm_logits(params["embed"], h, cfg)
    return logits, {"pos": cache["pos"] + 1, "units": _stack_units(caches)}


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
