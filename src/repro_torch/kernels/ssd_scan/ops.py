"""Dispatch for the SSD scan, in the model's layout.

``impl="auto"``: a CPU tensor goes to the plain version (:mod:`.ref`), a CUDA
tensor to the CUDA kernel (:mod:`.ssd_scan`), which raises on anything it
does not take; there is no fallback. ``impl="ref"`` forces the plain version
on any device (the yardstick on the card); ``impl="cuda"`` forces the kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import use_ref
from repro_torch.kernels.ssd_scan import ref
from repro_torch.kernels.ssd_scan import ssd_scan as kernel


def to_kernel_layout(xh, dt, A, Bv, Cv):
    """Model layout -> the Pallas kernel's (B*H, S, ...) layout, each group's
    B and C broadcast over its heads (the reference wrapper's fold)."""
    B_, S, H, P = xh.shape
    G, N = Bv.shape[2], Bv.shape[3]
    r = H // G
    xf = xh.transpose(1, 2).reshape(B_ * H, S, P)
    dtf = dt.transpose(1, 2).reshape(B_ * H, S, 1).to(torch.float32)
    Af = A[None, :].expand(B_, H).reshape(B_ * H, 1).to(torch.float32)

    def heads(t):
        return t[:, :, :, None, :].expand(B_, S, G, r, N).permute(
            0, 2, 3, 1, 4).reshape(B_ * H, S, N)

    return xf, dtf, Af, heads(Bv), heads(Cv)


def ssd_scan(
    xh: torch.Tensor,     # (B, S, H, P)
    dt: torch.Tensor,     # (B, S, H) f32, post softplus
    A: torch.Tensor,      # (H,) f32, negative
    Bv: torch.Tensor,     # (B, S, G, N)
    Cv: torch.Tensor,     # (B, S, G, N)
    *,
    chunk: int,
    impl: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan from a zero state -> (y (B,S,H,P) in xh's dtype,
    final state (B,H,P,N) f32)."""
    if not use_ref(xh, impl):
        return kernel.ssd_scan_fwd(xh, dt, A, Bv, Cv, chunk=chunk)
    B_, S, H, P = xh.shape
    y, state = ref.ssd_scan_ref(*to_kernel_layout(xh, dt, A, Bv, Cv), chunk=chunk)
    return y.reshape(B_, H, S, P).transpose(1, 2), state.reshape(B_, H, P, Bv.shape[3])
