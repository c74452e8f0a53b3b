"""Dispatch for attention, in the model's layout (q (B, Sq, H, hd), k and v
(B, Skv, KV, hd), any Sq and Skv, any head dim up to 256).

``impl="auto"``: a CPU tensor goes to the plain version (:mod:`.ref`), a
CUDA tensor to the CUDA kernels (:mod:`.flash_attention`), which raise on
anything they do not take; there is no fallback. ``impl="ref"`` forces the
plain version on any device (the yardstick on the card); ``impl="cuda"``
forces the kernels.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import use_ref
from repro_torch.kernels.flash_attention import flash_attention as kernel
from repro_torch.kernels.flash_attention import ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None, impl: str = "auto", lse: bool = False):
    """Prefill attention (q_offset 0) -> (B, Sq, H, hd) in q's dtype; with
    ``lse=True`` also the rows' log-sum-exp, (B, H, Sq) float32 (the
    training forward's residual)."""
    if not use_ref(q, impl):
        return kernel.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                          softcap=softcap, lse=lse)
    out = ref.attention_ref(q, k, v, causal=causal, window=window, softcap=softcap)
    if not lse:
        return out
    return out, ref.attention_lse_ref(q, k, causal=causal, window=window, softcap=softcap)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor, g: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None, impl: str = "auto"):
    """The prefill attention's gradients (dq, dk, dv) in the inputs' dtype,
    from its output, its lse (B, H, Sq) float32 and the output gradient."""
    if not use_ref(q, impl):
        return kernel.flash_attention_bwd(q, k, v, out, lse, g, causal=causal,
                                          window=window, softcap=softcap)
    return ref.attention_bwd_ref(q, k, v, out, lse, g, causal=causal, window=window,
                                 softcap=softcap)


def flash_attention_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           kv_len: torch.Tensor, *, softcap: Optional[float] = None,
                           impl: str = "auto") -> torch.Tensor:
    """Decode attention against a cache: keys at or past ``kv_len[b]``
    ((B,) int32) masked, no causal or window mask (a local layer's window
    is its ring cache) -> (B, Sq, H, hd) in q's dtype."""
    if not use_ref(q, impl):
        return kernel.flash_attention_decode(q, k, v, kv_len, softcap=softcap)
    return ref.attention_ref(q, k, v, causal=False, softcap=softcap, kv_len=kv_len)
