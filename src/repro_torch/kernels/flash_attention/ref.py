"""Plain PyTorch version of the flash-attention kernel.

The CPU path of :mod:`repro_torch.kernels.flash_attention.ops` and the
yardstick the CUDA kernels are held against on the card. Counterpart of the
JAX package's ``kernels/flash_attention/ref.py`` ``attention_ref``, which is
what its Pallas kernel ``_fa_kernel`` computes (with ``q_offset = 0``):
materialized scores, explicit causal/window masks with ``-1e30``, a float32
softmax and a float32 PV product (p is never rounded to the inputs' type).
Added here: the optional per-row ``kv_len`` mask ``(B,)`` that the
reference's decode applies (``models/attention.py`` ``naive_attention`` and
``flash_attention_decode``): positions ``>= kv_len[b]`` are masked; and
``p_dtype``, a type p is rounded to before the PV product, as the
reference's XLA attention (``naive_attention``, its blocked forward and its
decode) rounds p to v's dtype. With ``p_dtype=torch.bfloat16`` this is the
reference's model attention, the yardstick for how far that rounding alone
moves a bf16 model's output.

- :func:`attention_lse_ref`: the row log-sum-exp of the masked scores,
  ``(B, H, Sq)`` float32, which the prefill kernel writes beside its output
  when the training forward asks for it.
- :func:`attention_bwd_ref`: the plain version of the backward kernel, the
  reference's manual flash backward (``models/attention.py``
  ``_flash_backward``) with one block: p recomputed from the saved lse,
  ``ds = p (dp - delta)``, then the softcap's derivative, then the scale,
  in float32; dq, dk and dv in the inputs' dtype.
- :func:`fa_tolerance` / :func:`fa_close`: the bound the kernels are held to
  against this version on the same inputs; :func:`bwd_tolerance` /
  :func:`bwd_close` the same for the backward's gradients.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30
F32_RTOL = 1e-5
BWD_RTOL = 1e-4


def attention_ref(
    q: torch.Tensor,          # (B, Sq, H, hd)
    k: torch.Tensor,          # (B, Skv, KV, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    q_offset: int = 0,
    kv_len: Optional[torch.Tensor] = None,   # (B,) integer
    p_dtype: Optional[torch.dtype] = None,   # round p to this before PV
) -> torch.Tensor:
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    G = H // KV
    f32 = torch.float32
    dev = q.device
    scale = hd ** -0.5
    q5 = q.reshape(B, Sq, KV, G, hd).to(f32)
    s = torch.einsum("bqkgh,bskh->bkgqs", q5, k.to(f32)) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qpos = q_offset + torch.arange(Sq, device=dev)[:, None]
    kpos = torch.arange(Skv, device=dev)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=dev)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    mask = mask[None, None, None]                               # (1,1,1,Sq,Skv)
    if kv_len is not None:
        rows = kpos[None] < kv_len.to(dev).reshape(B, 1, 1)     # (B,1,Skv)
        mask = mask & rows[:, None, None]                       # (B,1,1,Sq,Skv)
    s = torch.where(mask, s, torch.full((), NEG_INF, dtype=f32, device=dev))
    p = torch.softmax(s, dim=-1)
    if p_dtype is not None:
        p = p.to(p_dtype).to(f32)
    out = torch.einsum("bkgqs,bskh->bqkgh", p, v.to(f32))
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def _masked_scores(q5: torch.Tensor, k: torch.Tensor, *, causal: bool,
                   window: Optional[int], softcap: Optional[float]):
    """(s (B, KV, G, Sq, Skv) float32 after scale, softcap and the causal /
    window masks (q_offset 0), tanh of the capped argument or None)."""
    Sq, Skv, hd = q5.shape[1], k.shape[1], q5.shape[-1]
    dev = q5.device
    s = torch.einsum("bqkgh,bskh->bkgqs", q5.to(torch.float32),
                     k.to(torch.float32)) * hd ** -0.5
    t = None
    if softcap is not None:
        t = torch.tanh(s / softcap)
        s = softcap * t
    qpos = torch.arange(Sq, device=dev)[:, None]
    kpos = torch.arange(Skv, device=dev)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=dev)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, torch.full((), NEG_INF, dtype=torch.float32, device=dev))
    return s, t


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
                      window: Optional[int] = None,
                      softcap: Optional[float] = None) -> torch.Tensor:
    """Row log-sum-exp of the masked scores (q_offset 0): (B, H, Sq) float32,
    head h = kv head * G + its index in the group."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    s, _ = _masked_scores(q.reshape(B, Sq, KV, H // KV, hd), k, causal=causal,
                          window=window, softcap=softcap)
    return torch.logsumexp(s, dim=-1).reshape(B, H, Sq)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      out: torch.Tensor, lse: torch.Tensor, g: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      softcap: Optional[float] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of the prefill attention (q_offset 0) from the forward's
    output ``out`` (B, S, H, hd) and its row lse (B, H, S) float32, for the
    output gradient ``g``: (dq, dk, dv) in q's, k's and v's dtypes. The
    reference's ``_flash_backward`` with a single block, in float32:
    ``delta = rowsum(g * out)``, ``p = exp(s - lse)`` from the capped and
    masked s, ``dp = g v^T``, ``ds = p (dp - delta)``, times ``1 - tanh^2``
    under a softcap, times the scale; ``dq = ds k``, ``dk = ds^T q`` and
    ``dv = p^T g``, each summed over the G query heads of a kv head."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    f32 = torch.float32
    q5 = q.reshape(B, Sq, KV, G, hd)
    g5 = g.reshape(B, Sq, KV, G, hd).to(f32)
    s, t = _masked_scores(q5, k, causal=causal, window=window, softcap=softcap)
    delta = torch.einsum("bqkgh,bqkgh->bkgq", g5, out.reshape(B, Sq, KV, G, hd).to(f32))
    p = torch.exp(s - lse.reshape(B, KV, G, Sq)[..., None])
    dp = torch.einsum("bqkgh,bskh->bkgqs", g5, v.to(f32))
    ds = p * (dp - delta[..., None])
    if t is not None:
        ds = ds * (1.0 - t * t)
    ds = ds * hd ** -0.5
    dq = torch.einsum("bkgqs,bskh->bqkgh", ds, k.to(f32)).reshape(B, Sq, H, hd)
    dk = torch.einsum("bkgqs,bqkgh->bskh", ds, q5.to(f32))
    dv = torch.einsum("bkgqs,bqkgh->bskh", p, g5)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def fa_tolerance(want: torch.Tensor) -> torch.Tensor:
    """Elementwise bound on |got - want| for two float32 computations of the
    same attention, sums taken in other orders (online softmax over key
    tiles against materialized scores): ``F32_RTOL * max|want|``. A score's
    rounding error enters its weight through ``exp`` as a relative error of
    the same size, and a head-dim-256 dot of N(0, 1) inputs at the scale
    1/16 is off by ~1e-6, so 1e-5 of the output's scale leaves room for a
    few of them. A bf16 ``want`` also gets one bf16 ulp of itself: the two
    float32 values may lie on either side of a bf16 rounding boundary."""
    w = want.to(torch.float32)
    bound = F32_RTOL * w.abs().max() * torch.ones_like(w)
    if want.dtype == torch.bfloat16:
        _, e = torch.frexp(w)
        bound = bound + torch.ldexp(torch.ones_like(w), (e - 8).to(torch.float32))
    return bound


def fa_close(got: torch.Tensor, want: torch.Tensor) -> Tuple[bool, float]:
    """(every entry within :func:`fa_tolerance`, max |got - want|); NaN or
    inf anywhere fails."""
    g, w = got.to(torch.float32), want.to(torch.float32)
    if g.shape != w.shape or not bool(torch.isfinite(g).all() and torch.isfinite(w).all()):
        return False, float("nan")
    diff = (g - w).abs()
    return bool((diff <= fa_tolerance(want)).all()), float(diff.max()) if diff.numel() else 0.0


def bwd_tolerance(want: torch.Tensor) -> torch.Tensor:
    """Elementwise bound on |got - want| for two float32 computations of the
    same gradient, sums taken in other orders: ``BWD_RTOL * max|want|``,
    plus one bf16 ulp of each entry for a bf16 ``want`` (as
    :func:`fa_tolerance`). 1e-4, ten times the forward's: dk and dv sum
    over every query row of G heads (8 192 terms at S 4096, G 2), where the
    forward sums over one row's keys, and ``dp - delta`` cancels, so a
    gradient entry can be far smaller than the terms whose rounding it
    carries."""
    w = want.to(torch.float32)
    bound = BWD_RTOL * w.abs().max() * torch.ones_like(w)
    if want.dtype == torch.bfloat16:
        _, e = torch.frexp(w)
        bound = bound + torch.ldexp(torch.ones_like(w), (e - 8).to(torch.float32))
    return bound


def bwd_close(got: torch.Tensor, want: torch.Tensor) -> Tuple[bool, float]:
    """(every entry within :func:`bwd_tolerance`, max |got - want|); NaN or
    inf anywhere fails."""
    g, w = got.to(torch.float32), want.to(torch.float32)
    if g.shape != w.shape or not bool(torch.isfinite(g).all() and torch.isfinite(w).all()):
        return False, float("nan")
    diff = (g - w).abs()
    return bool((diff <= bwd_tolerance(want)).all()), float(diff.max()) if diff.numel() else 0.0


def lse_close(got: torch.Tensor, want: torch.Tensor) -> Tuple[bool, float]:
    """(every row's lse within ``F32_RTOL * max(max|want|, 1)``, max |got -
    want|): the kernels' float32 sums of exp over the keys, in another order
    (and, on the tensor cores, in log2 units) than ``logsumexp``."""
    if got.shape != want.shape or got.dtype != torch.float32:
        return False, float("nan")
    if not bool(torch.isfinite(got).all() and torch.isfinite(want).all()):
        return False, float("nan")
    diff = (got - want).abs()
    bound = F32_RTOL * max(float(want.abs().max()), 1.0)
    return bool((diff <= bound).all()), float(diff.max()) if diff.numel() else 0.0
