"""Mamba-2 (SSD) mixer: training forward, prefill and one-step decode.

Counterpart of the JAX package's ``models/mamba2.py``.

- Training (:func:`mamba_forward`) runs :func:`ssd_chunked`, the reference
  model's own pure-JAX path in PyTorch ops, with autograd: a Python loop over
  the chunks carries the (B, H, P, N) float32 state where the reference uses
  ``lax.scan``.
- Prefill (:func:`mamba_prefill`) runs the prompt's scan through
  :func:`repro_torch.kernels.ssd_scan.ops.ssd_scan`: the CUDA kernel on the
  card, its plain version on the CPU. The scan keeps the intra-chunk weights
  W in float32, as the Pallas kernel does; the reference's ``ssd_chunked``
  rounds W to the compute dtype first, so in bf16 the two differ by bf16
  rounding (ROADMAP queue 3).
- Decode (:func:`mamba_decode_step`) advances the (ssm, conv) cache
  (:class:`MambaCache`) one token.

Layout: x (B,S,D) -> z, xc (B,S,di), B, C (B,S,G,N), dt (B,S,Hm); the
Hm = di / P heads share B/C within each of the G groups.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ops as ssd_ops
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


def conv_step(x_t: torch.Tensor, conv_state: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single decode step. x_t: (B,C); conv_state: (B,K-1,C). Returns
    (out (B,C), new_state)."""
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)   # (B,K,C)
    out = torch.einsum("bkc,kc->bc", window, w) + b[None, :]
    return out, window[:, 1:, :]


class MambaCache(NamedTuple):
    ssm: torch.Tensor     # (B, Hm, P, N) f32 recurrent state
    conv: torch.Tensor    # (B, K-1, conv_dim): last K-1 pre-conv [x|B|C] inputs


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


def mamba_prefill(p, x: torch.Tensor, cfg: ModelConfig, ssd_impl: str = "auto"
                  ) -> Tuple[torch.Tensor, MambaCache]:
    """Prefill: the mixer over the whole prompt, its scan through
    ``ssd_ops.ssd_scan`` (``ssd_impl`` as there: the kernel for CUDA tensors),
    plus the decode cache (final state and the conv tail)."""
    mb = cfg.mamba
    D = cfg.d_model
    di, Hm = mb.d_inner(D), mb.n_heads(D)
    G, N = mb.n_groups, mb.d_state
    B_, S, _ = x.shape
    z, xc0, Bv0, Cv0, dt_raw = _project(p, x)
    # decode conv state: the last K-1 pre-conv inputs, concat layout [x|B|C]
    K = mb.d_conv
    conv_tail = torch.cat(
        [xc0, Bv0.reshape(B_, S, G * N), Cv0.reshape(B_, S, G * N)], dim=-1
    )[:, S - (K - 1):, :]
    xc, Bv, Cv = _conv_mix(p, xc0, Bv0, Cv0, cfg)
    dt = softplus(dt_raw.to(torch.float32) + p["dt_bias"][None, None])
    A = -torch.exp(p["A_log"])
    xh = xc.reshape(B_, S, Hm, mb.head_dim)
    y, final_state = ssd_ops.ssd_scan(xh, dt, A, Bv, Cv, chunk=min(mb.chunk, S),
                                      impl=ssd_impl)
    y = y + xh * p["D_skip"][None, None, :, None].to(y.dtype)
    y = y.reshape(B_, S, di)
    y = rmsnorm(y * F.silu(z.to(torch.float32)).to(y.dtype), p["norm"], cfg.norm_eps)
    out = torch.einsum("bsi,id->bsd", y, p["out"].to(y.dtype))
    return out, MambaCache(ssm=final_state, conv=conv_tail.contiguous())


def mamba_decode_step(p, x_t: torch.Tensor, cache: MambaCache, cfg: ModelConfig
                      ) -> Tuple[torch.Tensor, MambaCache]:
    """One recurrent step. x_t: (B,1,D) -> (B,1,D)."""
    mb = cfg.mamba
    D = cfg.d_model
    di, Hm = mb.d_inner(D), mb.n_heads(D)
    P, N, G = mb.head_dim, mb.d_state, mb.n_groups
    B_ = x_t.shape[0]
    f32 = torch.float32
    z, xc, Bv, Cv, dt_raw = _project(p, x_t)
    cat = torch.cat(
        [xc[:, 0], Bv.reshape(B_, 1, G * N)[:, 0], Cv.reshape(B_, 1, G * N)[:, 0]],
        dim=-1,
    )
    window = torch.cat([cache.conv, cat[:, None, :]], dim=1)   # (B,K,C)
    new_conv = window[:, 1:, :]
    # per-stream convs applied to the shared [x|B|C] window
    wx = window[..., :di]
    wB = window[..., di:di + G * N]
    wC = window[..., di + G * N:]
    cdt = cat.dtype
    xc = F.silu(torch.einsum("bkc,kc->bc", wx, p["conv_wx"].to(cdt))
                + p["conv_bx"].to(cdt)[None])
    Bv = F.silu(torch.einsum("bkc,kc->bc", wB, p["conv_wB"].to(cdt))
                + p["conv_bB"].to(cdt)[None]).reshape(B_, G, N)
    Cv = F.silu(torch.einsum("bkc,kc->bc", wC, p["conv_wC"].to(cdt))
                + p["conv_bC"].to(cdt)[None]).reshape(B_, G, N)
    dt = softplus(dt_raw[:, 0].to(f32) + p["dt_bias"][None])
    A = -torch.exp(p["A_log"])

    xh = xc.reshape(B_, Hm, P)
    r = Hm // G
    Bh = Bv[:, :, None, :].expand(B_, G, r, N).reshape(B_, Hm, N)
    Ch = Cv[:, :, None, :].expand(B_, G, r, N).reshape(B_, Hm, N)
    decay = torch.exp(dt * A[None])                            # (B,H)
    new_ssm = decay[:, :, None, None] * cache.ssm + torch.einsum(
        "bhn,bhp,bh->bhpn", Bh.to(f32), xh.to(f32), dt
    )
    y = torch.einsum("bhn,bhpn->bhp", Ch.to(f32), new_ssm)
    y = y + xh.to(f32) * p["D_skip"][None, :, None]
    y = y.reshape(B_, 1, di).to(x_t.dtype)
    y = rmsnorm(y * F.silu(z.to(f32)).to(y.dtype), p["norm"], cfg.norm_eps)
    out = torch.einsum("bsi,id->bsd", y, p["out"].to(y.dtype))
    return out, MambaCache(ssm=new_ssm, conv=new_conv.contiguous())
