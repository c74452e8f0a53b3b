"""Attention's spec: the counterpart of the JAX package's ``AttnSpec``.

The model's prefill and decode run attention through
:mod:`repro_torch.kernels.flash_attention.ops` (the CUDA kernels on the
card, :mod:`repro_torch.kernels.flash_attention.ref` on the CPU), which keeps
p in float32 for the PV product as the reference's Pallas kernel does. The
reference's XLA attention (``naive_attention``, the blocked forward and the
decode of its ``models/attention.py``) rounds p to v's dtype first;
``ref.attention_ref(..., p_dtype=torch.bfloat16)`` computes that function.
The reference's blocked forward and its manual backward come with the dense
training slice, as a ``torch.autograd.Function``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class AttnSpec:
    causal: bool = True
    window: Optional[int] = None      # sliding-window size (None = unbounded)
    softcap: Optional[float] = None   # attention-logit softcap (gemma2: 50.0)
