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

- :func:`fa_tolerance` / :func:`fa_close`: the bound the kernels are held to
  against this version on the same inputs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30
F32_RTOL = 1e-5


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
