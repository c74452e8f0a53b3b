"""Plain PyTorch versions of the Mamba-2 SSD scan.

The CPU path of :mod:`repro_torch.kernels.ssd_scan.ops` and the yardstick the
CUDA kernel is held against on the card. Counterpart of the JAX package's
``kernels/ssd_scan/ref.py`` and of its Pallas kernel's own function.

- :func:`ssd_scan_ref`: what the Pallas kernel ``_ssd_kernel`` computes, in
  its layout: chunked, everything in float32 (the kernel upcasts its tiles),
  ``y`` in x's dtype and the final state in float32. The exponent above the
  diagonal is masked *before* ``exp``: there ``cum_t - cum_s`` is a growing
  positive sum that overflows at chunk 256, and ``CB * inf`` is NaN wherever
  CB is 0. The values where s <= t are the same either way.
- :func:`ssd_ref`: the sequential oracle, one time step at a time.
- :func:`ssd_tolerance`: the bound two chunked scans of the same inputs are
  held to (the kernel against :func:`ssd_scan_ref` on the card, the plain
  version against the reference's kernel on the CPU).
- :func:`init_inputs`: one scan's inputs drawn as the model's init draws
  dt and A, which the card's checks of the kernel feed it.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


F32_RTOL = 1e-4


def ssd_tolerance(want: torch.Tensor) -> torch.Tensor:
    """Elementwise bound on |got - want| for two chunked SSD scans of the
    same inputs, both computed in float32 with sums taken in different
    orders: ``F32_RTOL * max|want|``. The cumsum ``cum`` of ``dt * A`` enters
    through ``exp``, which turns an absolute error of one ulp of ``cum`` into
    that relative error of the result; at |cum| < 512 (chunk 256 with strong
    decay) one ulp is 3.1e-5, so 1e-4 leaves room for a few of them. A bf16
    ``want`` also gets one bf16 ulp of itself: the two float32 values may lie
    on either side of a bf16 rounding boundary."""
    w = want.to(torch.float32)
    bound = F32_RTOL * w.abs().max() * torch.ones_like(w)
    if want.dtype == torch.bfloat16:
        _, e = torch.frexp(w)
        bound = bound + torch.ldexp(torch.ones_like(w), (e - 8).to(torch.float32))
    return bound


def ssd_close(got: torch.Tensor, want: torch.Tensor) -> Tuple[bool, float]:
    """(every entry within :func:`ssd_tolerance`, max |got - want|); NaN or
    inf anywhere fails."""
    g, w = got.to(torch.float32), want.to(torch.float32)
    if g.shape != w.shape or not bool(torch.isfinite(g).all() and torch.isfinite(w).all()):
        return False, float("nan")
    diff = (g - w).abs()
    return bool((diff <= ssd_tolerance(want)).all()), float(diff.max()) if diff.numel() else 0.0


def init_inputs(gen: torch.Generator, shape: Tuple[int, ...], dtype: torch.dtype):
    """(x, dt, A, B, C) of one scan in the model's layout, drawn from ``gen``
    on its device; ``shape`` is (batch, S, H, P, G, N). x, B and C are
    N(0, 1) in ``dtype``; dt is log-uniform in [1e-3, 0.1] and A is
    -U(1, 16), as ``models.mamba2.init_mamba`` draws them."""
    b, s, h, p, g, n = shape
    dev = gen.device
    x = torch.randn(b, s, h, p, generator=gen, device=dev).to(dtype)
    bv = torch.randn(b, s, g, n, generator=gen, device=dev).to(dtype)
    cv = torch.randn(b, s, g, n, generator=gen, device=dev).to(dtype)
    u = torch.rand(b, s, h, generator=gen, device=dev)
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    a = -(1.0 + 15.0 * torch.rand(h, generator=gen, device=dev))
    return x, dt, a, bv, cv


def ssd_scan_ref(
    x: torch.Tensor,      # (BH, S, P)
    dt: torch.Tensor,     # (BH, S, 1) f32
    A: torch.Tensor,      # (BH, 1) f32, negative
    B: torch.Tensor,      # (BH, S, N)
    C: torch.Tensor,      # (BH, S, N)
    *,
    chunk: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan in kernel layout -> (y (BH,S,P) x.dtype, state
    (BH,P,N) f32), the state carried over the chunks from zero."""
    BH, S, P = x.shape
    N = B.shape[-1]
    if S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of the chunk {chunk}")
    f32 = torch.float32
    dev = x.device
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=dev))
    neg_inf = torch.full((), -float("inf"), dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    a = A.to(f32)[:, None, :]                                  # (BH,1,1)
    state = torch.zeros((BH, P, N), dtype=f32, device=dev)
    ys = []
    for c in range(S // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        xq = x[:, sl].to(f32)                                  # (BH,Q,P)
        dtq = dt[:, sl].to(f32)                                # (BH,Q,1)
        Bq = B[:, sl].to(f32)                                  # (BH,Q,N)
        Cq = C[:, sl].to(f32)
        cum = torch.cumsum(dtq * a, dim=1)                     # (BH,Q,1)
        cum_last = cum[:, -1:]                                 # (BH,1,1)
        # inter-chunk: exp(cum_t) * C_t . S_prev
        y_inter = torch.exp(cum) * torch.matmul(Cq, state.transpose(1, 2))
        # intra-chunk: W[t,s] = (C_t . B_s) exp(cum_t - cum_s) dt_s, s <= t
        CB = torch.matmul(Cq, Bq.transpose(1, 2))              # (BH,Q,Q)
        seg = torch.where(tri, cum - cum.transpose(1, 2), neg_inf)
        W = torch.where(tri, CB * torch.exp(seg), zero) * dtq.transpose(1, 2)
        y_intra = torch.matmul(W, xq)                          # (BH,Q,P)
        ys.append((y_inter + y_intra).to(x.dtype))
        # S = exp(cum_Q) S + sum_s exp(cum_Q - cum_s) dt_s x_s B_s^T
        xw = xq * (torch.exp(cum_last - cum) * dtq)            # (BH,Q,P)
        state = torch.exp(cum_last) * state + torch.matmul(xw.transpose(1, 2), Bq)
    return torch.cat(ys, dim=1), state


def ssd_ref(
    x: torch.Tensor,      # (BH, S, P)
    dt: torch.Tensor,     # (BH, S) f32
    A: torch.Tensor,      # (BH,) f32, negative
    B: torch.Tensor,      # (BH, S, N)
    C: torch.Tensor,      # (BH, S, N)
    init_state: Optional[torch.Tensor] = None,   # (BH, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact recurrence, one step at a time (slow, unambiguous):

        S_t = exp(dt_t * A) * S_{t-1} + dt_t * (x_t (x) B_t)
        y_t = C_t . S_t
    """
    BH, S, P = x.shape
    N = B.shape[-1]
    f32 = torch.float32
    xf, Bf, Cf = x.to(f32), B.to(f32), C.to(f32)
    state = (torch.zeros((BH, P, N), dtype=f32, device=x.device)
             if init_state is None else init_state.to(f32))
    ys = []
    for t in range(S):
        decay = torch.exp(dt[:, t] * A)                        # (BH,)
        outer = torch.einsum("bp,bn->bpn", xf[:, t], Bf[:, t])
        state = decay[:, None, None] * state + dt[:, t][:, None, None] * outer
        ys.append(torch.einsum("bn,bpn->bp", Cf[:, t], state))
    y = torch.stack(ys, dim=1).to(x.dtype)                     # (BH, S, P)
    return y, state
