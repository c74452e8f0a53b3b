"""Attention's spec and the training attention: the counterpart of the JAX
package's ``models/attention.py``.

The model's prefill and decode run attention through
:mod:`repro_torch.kernels.flash_attention.ops` (the CUDA kernels on the
card, :mod:`repro_torch.kernels.flash_attention.ref` on the CPU), which keeps
p in float32 for the PV product as the reference's Pallas kernel does. The
reference's XLA attention (``naive_attention``, the blocked forward and the
decode of its ``models/attention.py``) rounds p to v's dtype first;
``ref.attention_ref(..., p_dtype=torch.bfloat16)`` computes that function.

Training runs :func:`flash_attention_train`, which dispatches by device:

- a CPU tensor does what the reference does: when the shapes tile into
  ``block_q`` x ``block_k`` blocks (:func:`_divisible`), the blocked
  online-softmax forward (:func:`_flash_forward`, p rounded to v's dtype
  before PV), which saves (out, lse), and the manual backward
  (:func:`_flash_backward`, everything in float32), in the reference's
  block structure and summation order, inside a ``torch.autograd.Function``;
  when they do not, :func:`naive_attention` with autograd through it;
- a CUDA tensor takes any S through the kernels, inside the same
  ``torch.autograd.Function``: ``flash_attention_fwd(..., lse=True)``
  forward, ``flash_attention_bwd`` backward (p in float32 in both, so the
  backward recomputes exactly the forward's p);
- ``impl="ref"`` runs the kernels' plain versions (``ops`` with
  ``impl="ref"``) on any device: the yardstick of the card's training step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.kernels import use_ref
from repro_torch.kernels.flash_attention import ops as fa_ops


@dataclass(frozen=True)
class AttnSpec:
    causal: bool = True
    window: Optional[int] = None      # sliding-window size (None = unbounded)
    softcap: Optional[float] = None   # attention-logit softcap (gemma2: 50.0)
    block_q: int = 512
    block_k: int = 1024

    def scale(self, head_dim: int) -> float:
        return head_dim ** -0.5


NEG_INF = -1e30
F32 = torch.float32


def _softcap(scores: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return scores
    return cap * torch.tanh(scores / cap)


def _einsum_f32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``preferred_element_type=float32``: exact products of the (possibly
    bf16) inputs, summed in float32."""
    return torch.einsum(eq, a.to(F32), b.to(F32))


# ---------------------------------------------------------------------------
# naive oracle
# ---------------------------------------------------------------------------

def naive_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, spec: AttnSpec,
                    q_offset: int = 0) -> torch.Tensor:
    """Materialized-scores reference. q: (B, Sq, H, hd); k, v: (B, Skv, KV,
    hd). p is rounded to v's dtype before the PV product, as the reference
    does."""
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    G = H // KV
    dev = q.device
    q5 = q.reshape(B, Sq, KV, G, hd)
    scores = _einsum_f32("bqkgh,bskh->bkgqs", q5, k) * spec.scale(hd)
    scores = _softcap(scores, spec.softcap)
    qpos = q_offset + torch.arange(Sq, device=dev)[:, None]
    kpos = torch.arange(Skv, device=dev)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=dev)
    if spec.causal:
        mask &= kpos <= qpos
    if spec.window is not None:
        mask &= kpos > qpos - spec.window
    scores = torch.where(mask, scores, torch.full((), NEG_INF, dtype=F32, device=dev))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype), v)
    return out.reshape(B, Sq, H, hd)


# ---------------------------------------------------------------------------
# static block-range logic
# ---------------------------------------------------------------------------

def _kv_block_range(qi: int, spec: AttnSpec, Sq: int, Skv: int, nk_total: int
                    ) -> Tuple[int, int]:
    """[lo_blk, hi_blk) of the kv blocks q block ``qi`` touches (q_offset 0,
    Sq == Skv when causal)."""
    bq, bk = spec.block_q, spec.block_k
    q_lo, q_hi = qi * bq, min((qi + 1) * bq, Sq) - 1
    lo, hi = 0, Skv
    if spec.causal:
        hi = min(hi, q_hi + 1)
    if spec.window is not None:
        lo = max(lo, q_lo - spec.window + 1)
    return lo // bk, min(-(-hi // bk), nk_total)


def _block_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, spec: AttnSpec) -> torch.Tensor:
    """(bq, bk) bool mask for one (q block, kv block) pair."""
    qp, kp = q_pos[:, None], k_pos[None, :]
    mask = torch.ones((qp.shape[0], kp.shape[1]), dtype=torch.bool, device=qp.device)
    if spec.causal:
        mask &= kp <= qp
    if spec.window is not None:
        mask &= kp > qp - spec.window
    return mask


# ---------------------------------------------------------------------------
# blocked forward (CPU path)
# ---------------------------------------------------------------------------

def _fwd_one_q_block(q_blk, k_sub, v_sub, q_pos, k_pos0: int, spec: AttnSpec
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Online softmax of one q block (B, KV, G, bq, hd) over its kv span,
    block by block. Returns (out_blk in q's dtype, lse (B, KV, G, bq))."""
    B, KV, G, bq, hd = q_blk.shape
    bk = spec.block_k
    scale = spec.scale(hd)
    dev = q_blk.device
    m = torch.full((B, KV, G, bq), NEG_INF, dtype=F32, device=dev)
    l = torch.zeros((B, KV, G, bq), dtype=F32, device=dev)
    acc = torch.zeros((B, KV, G, bq, hd), dtype=F32, device=dev)
    neg = torch.full((), NEG_INF, dtype=F32, device=dev)
    for i in range(k_sub.shape[1] // bk):
        k_blk = k_sub[:, i * bk:(i + 1) * bk]
        v_blk = v_sub[:, i * bk:(i + 1) * bk]
        s = _einsum_f32("bkgqh,btkh->bkgqt", q_blk, k_blk) * scale
        s = _softcap(s, spec.softcap)
        k_pos = k_pos0 + i * bk + torch.arange(bk, device=dev)
        s = torch.where(_block_mask(q_pos, k_pos, spec), s, neg)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = _einsum_f32("bkgqt,btkh->bkgqh", p.to(v_blk.dtype), v_blk)
        acc = acc * alpha[..., None] + pv
        m = m_new
    l_safe = torch.clamp_min(l, 1e-30)
    return (acc / l_safe[..., None]).to(q_blk.dtype), m + torch.log(l_safe)


def _flash_forward(q, k, v, spec: AttnSpec) -> Tuple[torch.Tensor, torch.Tensor]:
    """Loop over q blocks; each scans only the kv blocks its (causal, window)
    range needs. Returns (out (B, Sq, H, hd), lse (B, H, Sq) float32)."""
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    G = H // KV
    bq, bk = spec.block_q, spec.block_k
    nq, nk = Sq // bq, Skv // bk
    q5 = q.reshape(B, Sq, KV, G, hd).permute(0, 2, 3, 1, 4)       # (B, KV, G, Sq, hd)
    outs, lses = [], []
    for qi in range(nq):
        lo_blk, hi_blk = _kv_block_range(qi, spec, Sq, Skv, nk)
        q_pos = qi * bq + torch.arange(bq, device=q.device)
        out_blk, lse_blk = _fwd_one_q_block(
            q5[:, :, :, qi * bq:(qi + 1) * bq], k[:, lo_blk * bk:hi_blk * bk],
            v[:, lo_blk * bk:hi_blk * bk], q_pos, lo_blk * bk, spec)
        outs.append(out_blk)
        lses.append(lse_blk)
    out = torch.cat(outs, dim=3).permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)
    return out, torch.cat(lses, dim=3).reshape(B, H, Sq)


# ---------------------------------------------------------------------------
# manual flash backward (CPU path)
# ---------------------------------------------------------------------------

def _flash_backward(q, k, v, out, lse, g, spec: AttnSpec):
    """Recompute-probabilities backward in the forward's block structure.
    q, out, g: (B, Sq, H, hd); lse: (B, H, Sq). Returns (dq, dk, dv) in the
    inputs' dtypes; everything in float32."""
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    G = H // KV
    bq, bk = spec.block_q, spec.block_k
    nq, nk = Sq // bq, Skv // bk
    scale = spec.scale(hd)
    dev = q.device
    neg = torch.full((), NEG_INF, dtype=F32, device=dev)

    def to5(t):
        return t.reshape(B, Sq, KV, G, hd).permute(0, 2, 3, 1, 4)

    q5, g5 = to5(q), to5(g).to(F32)
    lse5 = lse.reshape(B, KV, G, Sq)
    delta = torch.sum(g5 * to5(out).to(F32), dim=-1)           # (B, KV, G, Sq)
    dq5 = torch.zeros(q5.shape, dtype=F32, device=dev)
    dk = torch.zeros(k.shape, dtype=F32, device=dev)
    dv = torch.zeros(v.shape, dtype=F32, device=dev)

    for qi in range(nq):
        lo_blk, hi_blk = _kv_block_range(qi, spec, Sq, Skv, nk)
        rows = slice(qi * bq, (qi + 1) * bq)
        q_blk, g_blk = q5[:, :, :, rows], g5[:, :, :, rows]
        lse_blk, dlt_blk = lse5[..., rows], delta[..., rows]
        q_pos = qi * bq + torch.arange(bq, device=dev)
        span = (hi_blk - lo_blk) * bk
        dq_acc = torch.zeros(q_blk.shape, dtype=F32, device=dev)
        dk_sub = torch.zeros((B, span, KV, hd), dtype=F32, device=dev)
        dv_sub = torch.zeros((B, span, KV, hd), dtype=F32, device=dev)
        for i in range(span // bk):
            t0 = lo_blk * bk + i * bk
            k_blk, v_blk = k[:, t0:t0 + bk], v[:, t0:t0 + bk]
            s_raw = _einsum_f32("bkgqh,btkh->bkgqt", q_blk, k_blk) * scale
            if spec.softcap is not None:
                t = torch.tanh(s_raw / spec.softcap)
                s = spec.softcap * t
                dcap = 1.0 - t * t
            else:
                s, dcap = s_raw, None
            k_pos = t0 + torch.arange(bk, device=dev)
            s = torch.where(_block_mask(q_pos, k_pos, spec), s, neg)
            p = torch.exp(s - lse_blk[..., None])
            dp = torch.einsum("bkgqh,btkh->bkgqt", g_blk, v_blk.to(F32))
            ds = p * (dp - dlt_blk[..., None])
            if dcap is not None:
                ds = ds * dcap
            ds = ds * scale
            dq_acc = dq_acc + torch.einsum("bkgqt,btkh->bkgqh", ds, k_blk.to(F32))
            dk_sub[:, i * bk:(i + 1) * bk] += torch.einsum("bkgqt,bkgqh->btkh", ds,
                                                           q_blk.to(F32))
            dv_sub[:, i * bk:(i + 1) * bk] += torch.einsum("bkgqt,bkgqh->btkh", p, g_blk)
        dq5[:, :, :, rows] = dq_acc
        dk[:, lo_blk * bk:hi_blk * bk] += dk_sub
        dv[:, lo_blk * bk:hi_blk * bk] += dv_sub

    dq = dq5.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)
    return dq, dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def _divisible(q, k, spec: AttnSpec) -> bool:
    return (
        q.shape[1] % spec.block_q == 0
        and k.shape[1] % spec.block_k == 0
        and q.shape[1] >= spec.block_q
        and k.shape[1] >= spec.block_k
    )


class _FlashTrain(torch.autograd.Function):
    """Training attention with a manual backward: the forward saves (q, k,
    v, out, lse) and the backward recomputes p from lse. ``route`` is
    "blocked" (the CPU path's blocked forward and backward), "cuda" (the
    kernels) or "ref" (the kernels' plain versions)."""

    @staticmethod
    def forward(ctx, q, k, v, spec: AttnSpec, route: str):
        if route == "blocked":
            out, lse = _flash_forward(q, k, v, spec)
        else:
            out, lse = fa_ops.flash_attention(q, k, v, causal=spec.causal, window=spec.window,
                                              softcap=spec.softcap, impl=route, lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.spec, ctx.route = spec, route
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        spec = ctx.spec
        if ctx.route == "blocked":
            dq, dk, dv = _flash_backward(q, k, v, out, lse, g, spec)
        else:
            dq, dk, dv = fa_ops.flash_attention_bwd(
                q, k, v, out, lse, g.contiguous(), causal=spec.causal, window=spec.window,
                softcap=spec.softcap, impl=ctx.route)
        return dq, dk, dv, None, None


def flash_attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          spec: AttnSpec, impl: str = "auto") -> torch.Tensor:
    """Training attention (q_offset 0) -> (B, S, H, hd) in q's dtype, with a
    gradient for q, k and v (module docstring: which path runs where)."""
    if not use_ref(q, impl):
        return _FlashTrain.apply(q, k, v, spec, "cuda")
    if impl == "ref":
        return _FlashTrain.apply(q, k, v, spec, "ref")
    if not _divisible(q, k, spec):
        return naive_attention(q, k, v, spec)
    return _FlashTrain.apply(q, k, v, spec, "blocked")
