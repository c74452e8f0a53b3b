"""Dispatch for the tdm_compress functions.

``impl="auto"``: a CPU tensor goes to the plain version (:mod:`.ref`), a CUDA
tensor to the CUDA kernel (:mod:`.tdm_compress`), which raises on anything it
does not take; there is no fallback. ``impl="ref"`` forces the plain version
on any device (the yardstick on the card); ``impl="cuda"`` forces the kernel.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import use_ref
from repro_torch.kernels.tdm_compress import ref
from repro_torch.kernels.tdm_compress import tdm_compress as kernel


def quantize(x, *, block: int = 1024, impl: str = "auto"):
    if use_ref(x, impl):
        return ref.quantize_ref(x, block=block)
    return kernel.quantize_fwd(x, block=block)


def quantize_scaled(x, scales, *, block: int = 1024, impl: str = "auto"):
    """int8 codes of x with caller-supplied blockwise scales: ``(nb,)``
    shared by every row, or ``(rows, nb)``."""
    if use_ref(x, impl):
        return ref.quantize_scaled_ref(x, scales, block=block)
    return kernel.quantize_scaled_fwd(x, scales, block=block)


def quantize_payload(x, *, block: int = 1024, impl: str = "auto"):
    """Any-shaped tensor -> (int8 payload, blockwise scales, its shape). The
    payload holds exactly ``x.numel()`` codes (``quantize`` pads to the
    block boundary inside)."""
    shape = tuple(x.shape)
    q, s = quantize(x.reshape(-1).to(torch.float32), block=block, impl=impl)
    return q, s, shape


def dequantize(q, scales, *, block: int = 1024, impl: str = "auto"):
    if use_ref(q, impl):
        return ref.dequantize_ref(q, scales, block=block)
    return kernel.dequantize_fwd(q, scales, block=block)


def dequantize_payload(q, scales, shape, *, block: int = 1024, impl: str = "auto"):
    """A flat int8 payload and its blockwise scales -> f32 tensor of
    ``shape`` (the payload holds at least ``prod(shape)`` codes)."""
    n = math.prod(shape)
    return dequantize(q, scales, block=block, impl=impl)[:n].reshape(shape)


def dequant_accumulate(q, scales, acc, w, *, block: int = 1024, impl: str = "auto"):
    if use_ref(acc, impl):
        return ref.dequant_acc_ref(q, scales, acc, w, block=block)
    return kernel.dequant_accumulate_fwd(q, scales, acc, w, block=block)


def gossip_fold(x, q, scales, src, w, diag, *, block: int = 1024, impl: str = "auto"):
    """The int8 gossip's receive side: every row's arrivals, read from the
    senders' codes by the row plan ``(src, w, diag)``, folded with the self
    term (:func:`.ref.gossip_fold_ref`)."""
    if use_ref(x, impl):
        return ref.gossip_fold_ref(x, q, scales, src, w, diag, block=block)
    return kernel.gossip_fold_fwd(x, q, scales, src, w, diag, block=block)


def topk_sparsify(x, *, k: int, block: int = 1024, impl: str = "auto"):
    if use_ref(x, impl):
        return ref.topk_sparsify_ref(x, k, block=block)
    return kernel.topk_sparsify_fwd(x, k, block=block)


def scatter_accumulate(vals, idxs, acc, w, *, block: int = 1024, impl: str = "auto"):
    if use_ref(acc, impl):
        return ref.scatter_acc_ref(vals, idxs, acc, w, block=block)
    return kernel.scatter_accumulate_fwd(vals, idxs, acc, w, block=block)
