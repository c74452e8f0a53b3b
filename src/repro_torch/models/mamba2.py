"""Mamba-2 (SSD) mixer, chunked, in PyTorch ops: the training forward.

Counterpart of the JAX package's ``models/mamba2.py`` (its pure-JAX path,
which the reference model runs; the Pallas ``ssd_scan`` kernel is not on any
running path there and is not ported yet). The chunk loop is a Python loop
carrying the (B, H, P, N) float32 state, where the reference uses
``lax.scan``. Prefill and decode come with the serving slice.

Layout: x (B,S,D) -> z, xc (B,S,di), B, C (B,S,G,N), dt (B,S,Hm); the
Hm = di / P heads share B/C within each of the G groups.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dtype_of, matmul_f32, rmsnorm, truncated_normal


def init_mamba(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    mb = cfg.mamba
    D = cfg.d_model
    di = mb.d_inner(D)
    Hm = mb.n_heads(D)
    G, N, K = mb.n_groups, mb.d_state, mb.d_conv
    dt = dtype_of(cfg.param_dtype)
    dev = gen.device
    std = D ** -0.5

    # dt bias: inverse softplus of dt drawn log-uniform in [dt_min, dt_max]
    u = torch.rand((Hm,), generator=gen, device=dev)
    dt_init = torch.exp(u * (math.log(mb.dt_max) - math.log(mb.dt_min)) + math.log(mb.dt_min))
    dt_bias = dt_init + torch.log(-torch.expm1(-dt_init))
    a_init = 1.0 + 15.0 * torch.rand((Hm,), generator=gen, device=dev)
    return {
        "wz": truncated_normal(gen, (D, di), std, dt),
        "wx": truncated_normal(gen, (D, di), std, dt),
        "wB": truncated_normal(gen, (D, G, N), std, dt),
        "wC": truncated_normal(gen, (D, G, N), std, dt),
        "wdt": truncated_normal(gen, (D, Hm), std, dt),
        "dt_bias": dt_bias.to(torch.float32),
        # separate depthwise convs per stream (x / B / C), as the reference
        "conv_wx": truncated_normal(gen, (K, di), di ** -0.5, dt),
        "conv_bx": torch.zeros((di,), dtype=dt, device=dev),
        "conv_wB": truncated_normal(gen, (K, G * N), (G * N) ** -0.5, dt),
        "conv_bB": torch.zeros((G * N,), dtype=dt, device=dev),
        "conv_wC": truncated_normal(gen, (K, G * N), (G * N) ** -0.5, dt),
        "conv_bC": torch.zeros((G * N,), dtype=dt, device=dev),
        "A_log": torch.log(a_init).to(torch.float32),
        "D_skip": torch.ones((Hm,), dtype=torch.float32, device=dev),
        "norm": torch.zeros((di,), dtype=dt, device=dev),
        "out": truncated_normal(gen, (di, D), di ** -0.5, dt),
    }


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x: (B,S,C); w: (K,C) depthwise. Left-padded causal convolution, taps
    added in the reference's order."""
    K = w.shape[0]
    S = x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = 0
    for i in range(K):
        out = out + xp[:, i:i + S, :] * w[i][None, None, :]
    return out + b[None, None, :]


def _project(p, x: torch.Tensor):
    cdt = x.dtype
    z = torch.einsum("bsd,di->bsi", x, p["wz"].to(cdt))
    xc = torch.einsum("bsd,di->bsi", x, p["wx"].to(cdt))
    Bv = torch.einsum("bsd,dgn->bsgn", x, p["wB"].to(cdt))
    Cv = torch.einsum("bsd,dgn->bsgn", x, p["wC"].to(cdt))
    dt_raw = torch.einsum("bsd,dh->bsh", x, p["wdt"].to(cdt))
    return z, xc, Bv, Cv, dt_raw


def _conv_mix(p, xc, Bv, Cv, cfg: ModelConfig):
    """Per-stream causal convs (x / B / C) then SiLU."""
    B_, S = xc.shape[:2]
    G, N = cfg.mamba.n_groups, cfg.mamba.d_state
    cdt = xc.dtype
    xc = F.silu(causal_conv(xc, p["conv_wx"].to(cdt), p["conv_bx"].to(cdt)))
    Bf = F.silu(causal_conv(
        Bv.reshape(B_, S, G * N), p["conv_wB"].to(cdt), p["conv_bB"].to(cdt)
    ))
    Cf = F.silu(causal_conv(
        Cv.reshape(B_, S, G * N), p["conv_wC"].to(cdt), p["conv_bC"].to(cdt)
    ))
    return xc, Bf.reshape(B_, S, G, N), Cf.reshape(B_, S, G, N)


def _expand_groups(t: torch.Tensor, Hm: int) -> torch.Tensor:
    """(B,Q,G,N) -> (B,Q,Hm,N): each group broadcast over its heads."""
    B_, Q, G, N = t.shape
    r = Hm // G
    return t[:, :, :, None, :].expand(B_, Q, G, r, N).reshape(B_, Q, Hm, N)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as ``jax.nn.softplus`` computes it (logaddexp(x, 0))."""
    return torch.logaddexp(x, torch.zeros_like(x))


def ssd_chunked(
    xh: torch.Tensor,      # (B, S, Hm, P)
    dt: torch.Tensor,      # (B, S, Hm) f32, post softplus
    A: torch.Tensor,       # (Hm,) f32, negative
    Bv: torch.Tensor,      # (B, S, G, N)
    Cv: torch.Tensor,      # (B, S, G, N)
    chunk: int,
    init_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan. Returns (y (B,S,Hm,P), final_state (B,Hm,P,N))."""
    B_, S, Hm, P = xh.shape
    N = Bv.shape[3]
    nc = S // chunk
    if nc * chunk != S:
        raise ValueError(f"sequence {S} is not a multiple of the chunk {chunk}")
    state = init_state
    if state is None:
        state = torch.zeros((B_, Hm, P, N), dtype=torch.float32, device=xh.device)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=xh.device))
    ys = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        xq, dtq = xh[:, sl], dt[:, sl]
        Bh = _expand_groups(Bv[:, sl], Hm)       # (B,Q,H,N)
        Ch = _expand_groups(Cv[:, sl], Hm)
        l = dtq * A[None, None, :]                # (B,Q,H) negative decays
        cum = torch.cumsum(l, dim=1)              # inclusive within-chunk
        decay_chunk = torch.exp(cum[:, -1])       # (B,H)
        # inter-chunk: Y_t += exp(cum_t) * C_t . S_prev
        y_inter = torch.einsum(
            "bqhn,bhpn->bqhp", Ch.to(torch.float32), state
        ) * torch.exp(cum)[..., None]
        # intra-chunk: W[t,s] = (C_t . B_s) exp(cum_t - cum_s) dt_s for s <= t
        CB = matmul_f32("bqhn,bshn->bhqs", Ch, Bh)
        cum_t = cum.permute(0, 2, 1)              # (B,H,Q)
        # mask the exponent, not only its product: above the diagonal
        # cum_t - cum_s is a growing positive sum, and exp overflows to inf
        # once it passes ~88 (chunk 256 at init); the reference masks after
        # exp, so its backward gets 0 * inf = NaN there. Forward values are
        # the reference's bit for bit.
        seg = cum_t[:, :, :, None] - cum_t[:, :, None, :]
        Ldec = torch.exp(torch.where(tri[None, None], seg, torch.full_like(seg, -float("inf"))))
        W = torch.where(tri[None, None], CB * Ldec, torch.zeros((), device=xh.device))
        W = W * dtq.permute(0, 2, 1)[:, :, None, :]
        y_intra = matmul_f32("bhqs,bshp->bqhp", W.to(xq.dtype), xq)
        # S = decay_chunk * S + sum_s exp(cum_Q - cum_s) dt_s B_s x_s
        decay_to_end = torch.exp(cum[:, -1:, :] - cum) * dtq
        dB = Bh.to(torch.float32) * decay_to_end[..., None]
        state = decay_chunk[:, :, None, None] * state + torch.einsum(
            "bqhn,bqhp->bhpn", dB, xq.to(torch.float32)
        )
        ys.append((y_inter + y_intra).to(xq.dtype))
    return torch.cat(ys, dim=1), state


def mamba_forward(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Training mixer: project -> conv -> SSD -> gate -> out. x: (B,S,D)."""
    mb = cfg.mamba
    D = cfg.d_model
    di, Hm = mb.d_inner(D), mb.n_heads(D)
    B_, S, _ = x.shape
    z, xc, Bv, Cv, dt_raw = _project(p, x)
    xc, Bv, Cv = _conv_mix(p, xc, Bv, Cv, cfg)
    dt = softplus(dt_raw.to(torch.float32) + p["dt_bias"][None, None])
    A = -torch.exp(p["A_log"])
    xh = xc.reshape(B_, S, Hm, mb.head_dim)
    y, _ = ssd_chunked(xh, dt, A, Bv, Cv, min(mb.chunk, S))
    y = y + xh * p["D_skip"][None, None, :, None].to(y.dtype)
    y = y.reshape(B_, S, di)
    y = rmsnorm(y * F.silu(z.to(torch.float32)).to(y.dtype), p["norm"], cfg.norm_eps)
    return torch.einsum("bsi,id->bsd", y, p["out"].to(y.dtype))
