"""ISL-link payload compression for the per-leaf TDM exchange, stacked.

Counterpart of the JAX package's ``core/compress.py``. There each function
sees one node's tensor under ``shard_map``; here it sees the stacked
``(n, ...)`` tensor and makes one payload per row, as every node would:

- ``topk``: magnitude top-k per row with error feedback (Stich et al.,
  NeurIPS 2018). The selection is ``jax.lax.top_k``'s: the k largest |x|,
  NaN above every number, ties to the lower index; the kept indices are
  then sorted. A stable descending sort reproduces that order exactly,
  which ``torch.topk`` does not promise on CUDA.
- ``int8``: symmetric int8 per row with one float32 scale. The scale is
  ``max(absmax, 1e-12) * fl(1/127)``, the multiply XLA compiles the
  reference's ``/ 127.0`` into under ``jit``; the codes divide by the scale
  (a true division) and round half to even.

The reference computes these in plain jnp with no Pallas kernel, so they are
plain PyTorch here too.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

INV127 = float(np.float32(1.0) / np.float32(127.0))


class TopKPayload(NamedTuple):
    """Sparse payloads, one per row: values (n, k) and int32 flat indices
    (n, k) into each row's flattened tensor, ascending."""

    values: torch.Tensor
    indices: torch.Tensor


def topk_compress(x: torch.Tensor, k: int) -> TopKPayload:
    """Keep each row's k largest-|x| entries (ties to the lower index)."""
    flat = x.reshape(x.shape[0], -1)
    if not 0 <= k <= flat.shape[1]:
        raise ValueError(f"top-k needs 0 <= k <= {flat.shape[1]}, got k={k}")
    order = torch.sort(flat.abs(), dim=1, descending=True, stable=True).indices
    idx = torch.sort(order[:, :k], dim=1).values
    return TopKPayload(values=flat.gather(1, idx), indices=idx.to(torch.int32))


def topk_decompress(payload: TopKPayload, shape: Tuple[int, ...], dtype=torch.float32) -> torch.Tensor:
    """Dense stacked tensor of ``shape`` (node axis first) holding each
    row's payload at its indices, zeros elsewhere."""
    n = shape[0]
    out = torch.zeros((n, math.prod(shape[1:])), dtype=dtype, device=payload.values.device)
    out.scatter_(1, payload.indices.to(torch.int64), payload.values.to(dtype))
    return out.reshape(shape)


def topk_with_error_feedback(
    x: torch.Tensor, residual: torch.Tensor, k: int
) -> Tuple[TopKPayload, torch.Tensor]:
    """Compress (x + residual); return the payload and the new residual."""
    corrected = x + residual
    payload = topk_compress(corrected, k)
    new_residual = corrected - topk_decompress(payload, tuple(x.shape), corrected.dtype)
    return payload, new_residual


class Int8Payload(NamedTuple):
    """int8 codes shaped like the stacked tensor, and one float32 scale per
    row, (n,)."""

    q: torch.Tensor
    scale: torch.Tensor


def _rows(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return v.reshape((-1,) + (1,) * (like.dim() - 1))


def int8_compress(x: torch.Tensor) -> Int8Payload:
    x32 = x.to(torch.float32)
    absmax = x32.abs().reshape(x.shape[0], -1).amax(dim=1)
    scale = torch.clamp(absmax, min=1e-12) * INV127
    q = torch.clamp(torch.round(x32 / _rows(scale, x32)), -127, 127).to(torch.int8)
    return Int8Payload(q=q, scale=scale)


def int8_decompress(p: Int8Payload, dtype=torch.float32) -> torch.Tensor:
    return (p.q.to(torch.float32) * _rows(p.scale, p.q)).to(dtype)


def compression_ratio(shape: Tuple[int, ...], k: int | None, mode: str) -> float:
    """Payload bytes / raw fp32 bytes of one node's tensor of ``shape``."""
    n = 1
    for s in shape:
        n *= s
    raw = 4 * n
    if mode == "topk":
        assert k is not None
        return (4 * k + 4 * k) / raw  # fp32 value + int32 index per entry
    if mode == "int8":
        return (n + 4) / raw
    if mode == "none":
        return 1.0
    raise ValueError(mode)
