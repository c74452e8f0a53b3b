"""Plain NVIDIA-Nemotron-3-Nano (``nemotron_h``) language model in float32:
the whole-sequence forward pass and its logits, written from the published
config and modeling code with plain PyTorch operations.

It imports nothing of the program. It reads the weights' tree the program
uses (``{"embed": {"tok", "head"}, "units": {"L<j>": ...}, "final_ln"}``,
each layer's leaves on a leading unit axis) and the configuration under the
published config.json's key names (``hybrid_override_pattern``,
``mamba_num_heads``, ``n_routed_experts``, ...). It computes one layer at a
time, upcasting that layer's weights to float32, so on the card it needs one
layer in float32 beside the stored weights. No cache, no kernels, no
batching tricks: every token of the sequence goes through every layer.

The layers, each one block ``h + mixer(RMSNorm(h))``:

- ``M`` Mamba-2: in-projections to z, x, B, C (``n_groups`` groups) and dt
  (one per head), a depthwise causal conv (with bias) over x, B and C, then
  SiLU, the SSD recurrence ``S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T``,
  ``y_t = S_t C_t + D x_t`` (computed chunk by chunk, a regrouping), the
  gate ``y * silu(z)``, an RMSNorm over each group's ``d_inner / n_groups``
  channels, the out-projection; d_inner is ``mamba_num_heads *
  mamba_head_dim``;
- ``*`` attention: GQA, no bias, causal, scale ``head_dim ** -0.5``, no
  rotary embedding (the published ``nemotron_h`` attention applies none);
- ``E`` MoE: a float32 router, ``sigmoid`` scores, the top
  ``num_experts_per_tok`` of ``scores + e_score_correction_bias``, their
  unbiased scores over their sum (+ 1e-20) times ``routed_scaling_factor``;
  experts ``down(relu(up(x))^2)``, each expert's weighted output added into a
  float32 sum in expert order; plus the shared expert of the same form;
- ``-`` a dense ``down(relu(up(x))^2)`` MLP;

then a final RMSNorm and the untied head.

Departures, each from the published model as it is stored: every norm's
weight is held as an offset from 1 (``x * (1 + w)``, the program's
convention; the published stores ``w``); the selection bias is the weights'
``router_bias``; ``n_group`` and ``topk_group`` are 1, so the group step of
the published router is left out (it selects every expert).

``prec="fp8"`` is the control: every product that the configuration computes
in bfloat16 (projections, the experts, attention's two products, the SSD's
weighted sum of x, the head) takes its operands rounded to float8 e4m3 with
one scale per tensor; the router, sums and elementwise work stay float32.
``fault`` plants one known fault (:data:`FAULTS`), for tests that the
comparison catches it. Float32 products need TF32 off: :func:`exact_matmuls`.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F

FP8_MAX = 448.0
FAULTS = ("softmax", "no_bias_select", "bias_in_weights", "no_shared", "scale_1", "silu",
          "norm_whole", "rope")


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
    """RMSNorm over the last axis, its weight stored as an offset from 1."""
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + w.float())


def relu2(x: torch.Tensor) -> torch.Tensor:
    return torch.square(torch.relu(x))


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over the sequence: x (S, C), w (K, C), b (C,).
    Output t sums taps k = 0..K-1 of input t - (K-1) + k."""
    K, S = w.shape[0], x.shape[0]
    xp = F.pad(x, (0, 0, K - 1, 0))
    return sum(xp[k:k + S] * w[k] for k in range(K)) + b


def ssd(x, dt, A, Bm, Cm, chunk: int, prec: str = "f32"):
    """x (S, H, P), dt (S, H), A (H,), Bm / Cm (S, G, N) shared by the H / G
    heads of each group. Returns y (S, H, P) float32."""
    S, H, P = x.shape
    G, N = Bm.shape[1], Bm.shape[2]
    R = H // G
    x = x.float().reshape(S, G, R, P)
    dt = dt.float().reshape(S, G, R)
    A = A.float().reshape(G, R)
    Bm, Cm = Bm.float(), Cm.float()
    state = x.new_zeros((G, R, P, N))
    ys = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, min(S, c0 + chunk))
        xq, dq, Bq, Cq = x[sl], dt[sl], Bm[sl], Cm[sl]
        Q = xq.shape[0]
        cum = torch.cumsum(dq * A, dim=0)                                # (Q, G, R)
        y = torch.einsum("qgn,grpn->qgrp", Cq, state) * torch.exp(cum)[..., None]
        cb = torch.einsum("qgn,sgn->gqs", Cq, Bq)
        ct = cum.permute(1, 2, 0)                                         # (G, R, Q)
        seg = ct[..., :, None] - ct[..., None, :]
        tri = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
        decay = torch.exp(seg.masked_fill(~tri, float("-inf")))
        W = cb[:, None] * decay * dq.permute(1, 2, 0)[..., None, :]
        y = y + mm("grqs,sgrp->qgrp", W, xq, prec)
        to_end = torch.exp(cum[-1:] - cum) * dq                           # (Q, G, R)
        state = (torch.exp(cum[-1])[..., None, None] * state
                 + torch.einsum("qgn,qgr,qgrp->grpn", Bq, to_end, xq))
        ys.append(y)
    return torch.cat(ys, dim=0).reshape(S, H, P)


def mamba(p: dict, x: torch.Tensor, cfg: dict, prec: str, fault: Optional[str]):
    S = x.shape[0]
    H, P = cfg["mamba_num_heads"], cfg["mamba_head_dim"]
    G, N = cfg["n_groups"], cfg["ssm_state_size"]
    di = H * P
    z = mm("sd,di->si", x, p["wz"], prec)
    xc = mm("sd,di->si", x, p["wx"], prec)
    Bv = mm("sd,dgn->sgn", x, p["wB"], prec).reshape(S, G * N)
    Cv = mm("sd,dgn->sgn", x, p["wC"], prec).reshape(S, G * N)
    dt_raw = mm("sd,dh->sh", x, p["wdt"], prec)
    xc = F.silu(causal_conv(xc, p["conv_wx"], p["conv_bx"]))
    Bv = F.silu(causal_conv(Bv, p["conv_wB"], p["conv_bB"]))
    Cv = F.silu(causal_conv(Cv, p["conv_wC"], p["conv_bC"]))
    dt = F.softplus(dt_raw + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xc.reshape(S, H, P)
    y = ssd(xh, dt, A, Bv.reshape(S, G, N), Cv.reshape(S, G, N), cfg["chunk_size"], prec)
    y = (y + xh * p["D_skip"][:, None]).reshape(S, di)
    g = y * F.silu(z)
    eps = cfg["layer_norm_epsilon"]
    if fault == "norm_whole":
        g = rmsnorm(g, p["norm"], eps)
    else:
        g = rmsnorm(g.reshape(S, G, di // G), p["norm"].reshape(G, di // G), eps).reshape(S, di)
    return mm("si,id->sd", g, p["out"], prec)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding over the whole head dim (the ``rope`` fault)."""
    S, _, hd = x.shape
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, device=x.device).float() / hd)
    ang = torch.arange(S, device=x.device).float()[:, None] * inv
    sin, cos = torch.sin(ang)[:, None], torch.cos(ang)[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(p: dict, x: torch.Tensor, cfg: dict, prec: str, fault: Optional[str]):
    S = x.shape[0]
    Hq, KV, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    q = mm("sd,dhk->shk", x, p["wq"], prec)
    k = mm("sd,dhk->shk", x, p["wk"], prec)
    v = mm("sd,dhk->shk", x, p["wv"], prec)
    if fault == "rope":
        q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    k = k.repeat_interleave(Hq // KV, dim=1)
    v = v.repeat_interleave(Hq // KV, dim=1)
    s = mm("qhk,shk->hqs", q, k, prec) * hd ** -0.5
    mask = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    w = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    o = mm("hqs,shk->qhk", w, v, prec)
    return mm("qhk,hkd->qd", o, p["wo"], prec)


def mlp(p: dict, x: torch.Tensor, prec: str, act=relu2) -> torch.Tensor:
    return mm("sf,fd->sd", act(mm("sd,df->sf", x, p["wi"], prec)), p["wo"], prec)


def moe(p: dict, x: torch.Tensor, cfg: dict, prec: str, fault: Optional[str]):
    E, K = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    logits = x.float() @ p["router"].float()                  # float32, never fp8
    if fault == "softmax":
        scores = torch.softmax(logits, dim=-1)
    else:
        scores = torch.sigmoid(logits)
    choice = scores if fault == "no_bias_select" else scores + p["router_bias"]
    top_e = torch.topk(choice, K, dim=-1).indices
    top_w = (choice if fault == "bias_in_weights" else scores).gather(1, top_e)
    top_w = top_w / (top_w.sum(-1, keepdim=True) + 1e-20)
    top_w = top_w * (1.0 if fault == "scale_1" else cfg["routed_scaling_factor"])
    act = F.silu if fault == "silu" else relu2
    out = torch.zeros_like(x, dtype=torch.float32)
    for e in range(E):
        tok, slot = torch.nonzero(top_e == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        ex = {"wi": p["wi"][e], "wo": p["wo"][e]}
        out.index_add_(0, tok, mlp(ex, x[tok], prec, act) * top_w[tok, slot, None])
    if fault != "no_shared":
        out = out + mlp(p["shared"], x, prec, act)
    return out


def _layer(params: dict, cfg: dict, i: int) -> dict:
    """Layer ``i``'s weights, upcast to float32."""
    pat = cfg["hybrid_override_pattern"]
    unit = params["units"][f"L{i % len(pat)}"]
    u = i // len(pat)

    def up(t):
        return {k: up(v) for k, v in t.items()} if isinstance(t, dict) else t[u].float()

    return up(unit)


def hidden(params: dict, tokens: torch.Tensor, cfg: dict, prec: str = "f32",
           fault: Optional[str] = None) -> torch.Tensor:
    """Final-normed hidden states (S, D) float32 of ``tokens`` (S,)."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    pat = cfg["hybrid_override_pattern"]
    eps = cfg["layer_norm_epsilon"]
    h = params["embed"]["tok"][tokens].float()
    for i in range(cfg["num_hidden_layers"]):
        p = _layer(params, cfg, i)
        kind = pat[i % len(pat)]
        x = rmsnorm(h, p["ln"], eps)
        if kind == "M":
            h = h + mamba(p["mamba"], x, cfg, prec, fault)
        elif kind == "*":
            h = h + attention(p["attn"], x, cfg, prec, fault)
        elif kind == "E":
            h = h + moe(p["ffn"], x, cfg, prec, fault)
        elif kind == "-":
            h = h + mlp(p["ffn"], x, prec)
        else:
            raise ValueError(f"layer kind {kind!r}")
        del p
    return rmsnorm(h, params["final_ln"], cfg["norm_eps"])


def logits(params: dict, h: torch.Tensor, prec: str = "f32") -> torch.Tensor:
    """Untied head: float32 logits (S, V)."""
    return mm("sd,dv->sv", h, params["embed"]["head"], prec)


def param_count(cfg: dict) -> int:
    """The published model's parameters from its config (router bias
    included): the number its weights' tree holds."""
    D, V = cfg["hidden_size"], cfg["vocab_size"]
    H, P, G, N = (cfg["mamba_num_heads"], cfg["mamba_head_dim"], cfg["n_groups"],
                  cfg["ssm_state_size"])
    di, K = H * P, cfg["conv_kernel"]
    conv = di + 2 * G * N
    mam = D * (2 * di + 2 * G * N + H) + K * conv + conv + 3 * H + di + di * D
    Hq, KV, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    att = D * Hq * hd + 2 * D * KV * hd + Hq * hd * D
    E, Fe, Fs = (cfg["n_routed_experts"], cfg["moe_intermediate_size"],
                 cfg["moe_shared_expert_intermediate_size"])
    moe_n = D * E + E + E * 2 * D * Fe + 2 * D * Fs
    body = {"M": mam, "*": att, "E": moe_n, "-": 2 * D * cfg["intermediate_size"]}
    pat = cfg["hybrid_override_pattern"]
    layers = sum(body[pat[i % len(pat)]] + D for i in range(cfg["num_hidden_layers"]))
    return 2 * V * D + layers + D

