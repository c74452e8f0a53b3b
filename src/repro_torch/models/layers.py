"""Base layers for the port: norms, embedding, tied LM head, init.

Counterpart of the JAX package's ``models/layers.py``. Params are plain
dicts of tensors. Inits draw from an explicit
``torch.Generator`` and allocate on its device; they cannot reproduce
``jax.random`` draws, so parity tests load the reference's params instead
(:mod:`repro_torch.weights`).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}[name]


def truncated_normal(gen: torch.Generator, shape, stddev: float, dtype) -> torch.Tensor:
    """stddev * N(0, 1) truncated to [-2, 2], drawn on ``gen``'s device."""
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * stddev).to(dtype)


def init_rmsnorm(d: int, dtype, device) -> torch.Tensor:
    return torch.zeros((d,), dtype=dtype, device=device)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    # zero-centred scale: the weight is stored as an offset from 1
    return (x * (1.0 + scale.to(torch.float32))).to(dt)


def init_embedding(gen: torch.Generator, cfg: ModelConfig) -> Params:
    dt = dtype_of(cfg.param_dtype)
    p = {"tok": truncated_normal(gen, (cfg.vocab_size, cfg.d_model), 1.0, dt)}
    if not cfg.tie_embeddings:
        p["head"] = truncated_normal(
            gen, (cfg.d_model, cfg.vocab_size), cfg.d_model ** -0.5, dt
        )
    return p


def embed_tokens(params: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = params["tok"].to(dtype_of(cfg.compute_dtype))[tokens]
    if cfg.embed_scale:
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype)
    return h


def matmul_f32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum with float32 products and accumulation and a float32 result:
    the reference's ``preferred_element_type=float32`` on (possibly bf16)
    inputs. bf16 values are exact in float32, so upcasting first loses
    nothing; it needs full-precision float32 matmuls (TF32 off)."""
    return torch.einsum(eq, a.to(torch.float32), b.to(torch.float32))


def lm_logits(params: Params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Final projection to float32 logits; final softcap when set."""
    if cfg.tie_embeddings:
        logits = matmul_f32("...d,vd->...v", h, params["tok"].to(h.dtype))
    else:
        logits = matmul_f32("...d,dv->...v", h, params["head"].to(h.dtype))
    if cfg.final_softcap is not None:
        c = cfg.final_softcap
        logits = c * torch.tanh(logits / c)
    return logits


# ---------------------------------------------------------------------------
# RoPE and M-RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponents)  # (hd/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, N, hd); positions: (B, S) integer. Angles in float32."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    ang = positions[..., None].to(torch.float32) * freqs        # (B, S, hd/2)
    return _rotate(x, ang)


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """Rotate the halves of x (B, S, N, hd) by the float32 angles (B, S,
    hd/2)."""
    sin, cos = torch.sin(ang)[:, :, None, :], torch.cos(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: Tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL's multimodal RoPE: the rotary frequency pairs split into
    (temporal, height, width) sections of ``sections`` pairs (summing to
    hd/2), each rotated by its own position stream. x: (B, S, N, hd);
    positions3: (B, S, 3) integer. Angles in float32."""
    hd = x.shape[-1]
    if sum(sections) != hd // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to hd/2 = {hd // 2}")
    freqs = rope_freqs(hd, theta, x.device)
    comp = torch.cat([torch.full((n,), i, dtype=torch.long, device=x.device)
                      for i, n in enumerate(sections)])            # (hd/2,)
    pos = positions3.to(torch.float32)[..., comp]                 # (B, S, hd/2)
    return _rotate(x, pos * freqs)


# ---------------------------------------------------------------------------
# gated MLP (SwiGLU / GeGLU), or the 2-matrix MLP
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, cfg: ModelConfig, d_ff: int) -> Params:
    dt = dtype_of(cfg.param_dtype)
    D = cfg.d_model
    std_in, std_out = D ** -0.5, d_ff ** -0.5
    p = {"wi": truncated_normal(gen, (D, d_ff), std_in, dt)}
    if cfg.gated_mlp:
        p["wg"] = truncated_normal(gen, (D, d_ff), std_in, dt)
    p["wo"] = truncated_normal(gen, (d_ff, D), std_out, dt)
    return p


def activation(x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "silu":
        return torch.nn.functional.silu(x)
    if act == "gelu":
        return torch.nn.functional.gelu(x, approximate="tanh")
    if act == "relu2":                      # nemotron-h: relu(x)^2
        return torch.square(torch.relu(x))
    raise ValueError(act)


def mlp_apply(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = x.dtype
    up = torch.einsum("...d,df->...f", x, params["wi"].to(dt))
    if cfg.gated_mlp:
        gate = activation(torch.einsum("...d,df->...f", x, params["wg"].to(dt)), cfg.act)
        h = gate * up
    else:
        h = activation(up, cfg.act)
    return torch.einsum("...f,fd->...d", h, params["wo"].to(dt))
