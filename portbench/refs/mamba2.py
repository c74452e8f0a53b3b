"""Plain Mamba-2 language model in float32: the forward pass, logits and
loss, written from the published block with plain PyTorch operations.

It imports nothing of the program. It reads the weights' tree the benchmark
makes (:mod:`portbench.weights`), one model at a time (no node axis). The
SSD is computed chunk by chunk (the chunk size bounds the quadratic term's
memory only; any sequence length works), which is the recurrence
``S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T``, ``y_t = S_t C_t + D x_t``
regrouped. Float32 products need TF32 off: :func:`exact_matmuls`.

``prec="fp8"`` is the control: every product that the configuration computes
in bfloat16 (projections, the SSD's weighted sum of x, the logits) takes its
operands rounded to float8 e4m3 with one scale per tensor, the step below
bfloat16; sums and elementwise work stay float32.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


@contextlib.contextmanager
def exact_matmuls():
    """Full float32 products (TF32 off) inside the block."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c
        torch.set_float32_matmul_precision(prec)


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one absmax scale, back in float32."""
    t = t.float()
    scale = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def mm(eq: str, a: torch.Tensor, b: torch.Tensor, prec: str = "f32") -> torch.Tensor:
    a, b = a.float(), b.float()
    if prec == "fp8":
        a, b = fp8(a), fp8(b)
    elif prec != "f32":
        raise ValueError(f"unknown precision {prec!r}")
    return torch.einsum(eq, a, b)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with its weight stored as an offset from 1."""
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + w.float())


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over the sequence: x (B, S, C), w (K, C), b (C,).
    Output t sums taps k = 0..K-1 of input t - (K-1) + k."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    return sum(xp[:, k:k + S] * w[k] for k in range(K)) + b


def ssd(x, dt, A, Bm, Cm, chunk: int, prec: str = "f32"):
    """x (B, S, H, P), dt (B, S, H), A (H,), Bm / Cm (B, S, G, N) shared by
    the H / G heads of each group. Returns y (B, S, H, P) float32."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    R = H // G
    x = x.float().reshape(Bsz, S, G, R, P)
    dt = dt.float().reshape(Bsz, S, G, R)
    A = A.float().reshape(G, R)
    Bm, Cm = Bm.float(), Cm.float()
    state = x.new_zeros((Bsz, G, R, P, N))
    ys = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, min(S, c0 + chunk))
        xq, dq, Bq, Cq = x[:, sl], dt[:, sl], Bm[:, sl], Cm[:, sl]
        Q = xq.shape[1]
        cum = torch.cumsum(dq * A, dim=1)                              # (B, Q, G, R)
        # carried state read at each position
        y = torch.einsum("bqgn,bgrpn->bqgrp", Cq, state) * torch.exp(cum)[..., None]
        # within the chunk: W[t, s] = C_t.B_s exp(cum_t - cum_s) dt_s, s <= t
        cb = torch.einsum("bqgn,bsgn->bgqs", Cq, Bq)
        ct = cum.permute(0, 2, 3, 1)                                    # (B, G, R, Q)
        seg = ct[..., :, None] - ct[..., None, :]
        tri = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
        decay = torch.exp(seg.masked_fill(~tri, float("-inf")))
        W = cb[:, :, None] * decay * dq.permute(0, 2, 3, 1)[..., None, :]
        y = y + mm("bgrqs,bsgrp->bqgrp", W, xq, prec)
        # state at the chunk's end
        to_end = torch.exp(cum[:, -1:] - cum) * dq                      # (B, Q, G, R)
        state = (torch.exp(cum[:, -1])[..., None, None] * state
                 + torch.einsum("bqgn,bqgr,bqgrp->bgrpn", Bq, to_end, xq))
        ys.append(y)
    return torch.cat(ys, dim=1).reshape(Bsz, S, H, P)


def mixer(p: dict, x: torch.Tensor, sizes, eps: float, prec: str = "f32") -> torch.Tensor:
    """One Mamba-2 block's mixer on x (B, S, D); ``p`` one layer's weights."""
    Bsz, S, _ = x.shape
    H, P, G, N = sizes.n_heads, sizes.headdim, sizes.ngroups, sizes.d_state
    z = mm("bsd,di->bsi", x, p["wz"], prec)
    xc = mm("bsd,di->bsi", x, p["wx"], prec)
    Bv = mm("bsd,dgn->bsgn", x, p["wB"], prec).reshape(Bsz, S, G * N)
    Cv = mm("bsd,dgn->bsgn", x, p["wC"], prec).reshape(Bsz, S, G * N)
    dt_raw = mm("bsd,dh->bsh", x, p["wdt"], prec)
    xc = F.silu(causal_conv(xc, p["conv_wx"].float(), p["conv_bx"].float()))
    Bv = F.silu(causal_conv(Bv, p["conv_wB"].float(), p["conv_bB"].float()))
    Cv = F.silu(causal_conv(Cv, p["conv_wC"].float(), p["conv_bC"].float()))
    dt = F.softplus(dt_raw + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    xh = xc.reshape(Bsz, S, H, P)
    y = ssd(xh, dt, A, Bv.reshape(Bsz, S, G, N), Cv.reshape(Bsz, S, G, N),
            sizes.chunk_size, prec)
    y = (y + xh * p["D_skip"].float()[:, None]).reshape(Bsz, S, H * P)
    y = rmsnorm(y * F.silu(z), p["norm"], eps)
    return mm("bsi,id->bsd", y, p["out"], prec)


def layer(params: dict, i: int) -> dict:
    unit = params["units"]["L0"]
    return {"ln": unit["ln"][i], **{k: v[i] for k, v in unit["mamba"].items()}}


def hidden(params: dict, tokens: torch.Tensor, sizes, eps: float,
           prec: str = "f32") -> torch.Tensor:
    """Final-normed hidden states (B, S, D) of ``tokens`` (B, S)."""
    h = params["embed"]["tok"].float()[tokens]
    for i in range(sizes.n_layer):
        p = layer(params, i)
        h = h + mixer(p, rmsnorm(h, p["ln"], eps), sizes, eps, prec)
    return rmsnorm(h, params["final_ln"], eps)


def logits(params: dict, h: torch.Tensor, prec: str = "f32") -> torch.Tensor:
    """Tied LM head: float32 logits (B, S, V)."""
    return mm("bsd,vd->bsv", h, params["embed"]["tok"], prec)


def loss(params: dict, tokens: torch.Tensor, labels: torch.Tensor, sizes, eps: float,
         prec: str = "f32") -> torch.Tensor:
    """Token-mean cross-entropy."""
    lg = logits(params, hidden(params, tokens, sizes, eps, prec), prec)
    return F.cross_entropy(lg.reshape(-1, lg.shape[-1]), labels.reshape(-1).long())
