"""Plain PyTorch versions of blockwise int8 / top-k TDM payload compression.

The CPU path of :mod:`repro_torch.kernels.tdm_compress.ops` and the yardstick
the CUDA kernels are held against on the card. Counterpart of the JAX
package's ``kernels/tdm_compress/ref.py``.

Shapes: every function takes a flat ``(n,)`` payload, as the reference does,
or a stacked ``(rows, n)`` one (one row per FL node; blocks never straddle
rows). Per-block outputs gain the same leading ``rows`` axis, and the weight
``w`` is a scalar or one value per row, ``(rows,)``.

Rounding: the reference runs under jit, where XLA computes the scale's
``/ 127.0`` as ``* fl(1/127)``; that is done here too, so codes and scales
match it bit for bit. XLA also contracts ``acc + w * v`` into a fused
multiply-add; these eager versions round twice, so the accumulates differ
from the reference (and from the kernels) by at most one rounding of
``w * v`` plus one of the sum.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

# fl(1/127): the constant XLA multiplies by where the reference divides
INV127 = torch.tensor(1.0 / 127.0, dtype=torch.float32)
SCALE_FLOOR = torch.tensor(1e-12, dtype=torch.float32)
TOPK_CHUNK_BLOCKS = 1 << 16       # blocks sorted at once by topk_sparsify_ref


def spacing(t: torch.Tensor) -> torch.Tensor:
    """ulp of |t| in float32 (distance to the next float away from zero)."""
    a = t.abs().to(torch.float32)
    return torch.nextafter(a, torch.full_like(a, float("inf"))) - a


def fma_gap_ok(got: torch.Tensor, want: torch.Tensor, prod: torch.Tensor) -> torch.Tensor:
    """Elementwise: may ``got`` and ``want`` be the fused and the unfused
    rounding of the same ``acc + prod``? One rounding of the product and one
    of each sum: ``|got - want| <= (ulp(prod) + ulp(got) + ulp(want)) / 2``.
    Equal values (NaN with NaN, inf with inf) pass."""
    got, want, prod = (t.to(torch.float32) for t in (got, want, prod))
    bound = 0.5 * (spacing(prod) + spacing(got) + spacing(want))
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    return same | ((got - want).abs() <= bound)


def _rows(x: torch.Tensor) -> torch.Tensor:
    if x.dim() not in (1, 2):
        raise ValueError(f"payload must be (n,) or (rows, n), got {tuple(x.shape)}")
    return x.reshape(1, -1) if x.dim() == 1 else x


def _blocks(x2: torch.Tensor, block: int) -> torch.Tensor:
    """(rows, n) -> (rows, nb, block), zero-padding each row's tail (a view
    when no padding is needed)."""
    rows, n = x2.shape
    nb = -(-n // block)
    if nb * block != n:
        x2 = F.pad(x2, (0, nb * block - n))
    return x2.reshape(rows, nb, block)


def _unblocks(xb: torch.Tensor, n: int, like: torch.Tensor) -> torch.Tensor:
    rows = xb.shape[0]
    out = xb.reshape(rows, -1)[:, :n]
    return out.reshape(like.shape)


def _per_block(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Drop the rows axis again for flat inputs."""
    return t[0] if like.dim() == 1 else t


def row_weights(w, rows: int, device) -> torch.Tensor:
    """Scalar or (rows,) weight -> (rows,) float32 on ``device``."""
    wt = torch.as_tensor(w, dtype=torch.float32, device=device).reshape(-1)
    if wt.numel() == 1:
        wt = wt.expand(rows)
    if wt.shape != (rows,):
        raise ValueError(f"weights must be scalar or ({rows},), got {tuple(wt.shape)}")
    return wt


def blockwise_scales_ref(x: torch.Tensor, block: int = 1024) -> torch.Tensor:
    """Per-block symmetric scales ``max(absmax, 1e-12) / 127`` (NaN kept)."""
    xb = _blocks(_rows(x.to(torch.float32)), block)
    absmax = xb.abs().amax(dim=2)
    scale = torch.maximum(absmax, SCALE_FLOOR.to(x.device)) * INV127.to(x.device)
    return _per_block(scale, x)


def _encode(xb: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    r = torch.clamp(torch.round(xb / scale[..., None]), -127, 127)
    return torch.where(torch.isnan(r), torch.zeros_like(r), r).to(torch.int8)


def quantize_ref(x: torch.Tensor, block: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (n,) or (rows, n) -> (q int8 like x, scales (nb,) or (rows, nb))."""
    x2 = _rows(x.to(torch.float32))
    xb = _blocks(x2, block)
    scale = _rows(blockwise_scales_ref(x2, block))
    q = _unblocks(_encode(xb, scale), x2.shape[1], x)
    return q, _per_block(scale, x)


def quantize_scaled_ref(x: torch.Tensor, scales: torch.Tensor, block: int = 1024) -> torch.Tensor:
    """Quantize with caller-supplied blockwise scales -> int8 like x."""
    x2 = _rows(x.to(torch.float32))
    xb = _blocks(x2, block)
    return _unblocks(_encode(xb, scales.reshape(xb.shape[:2])), x2.shape[1], x)


def dequantize_ref(q: torch.Tensor, scale: torch.Tensor, block: int = 1024) -> torch.Tensor:
    q2 = _rows(q)
    qb = _blocks(q2, block).to(torch.float32)
    return _unblocks(qb * scale.reshape(qb.shape[:2])[..., None], q2.shape[1], q)


def dequant_acc_ref(q: torch.Tensor, scale: torch.Tensor, acc: torch.Tensor, w,
                    block: int = 1024) -> torch.Tensor:
    """acc + w * dequant(q, scale); q int8 (gossip) or int16 (relay sums)."""
    rows = _rows(q).shape[0]
    wr = row_weights(w, rows, acc.device).reshape((rows,) + (1,) * (q.dim() - 1))
    if q.dim() == 1:
        wr = wr[0]
    return acc.to(torch.float32) + wr * dequantize_ref(q, scale, block)


def topk_sparsify_ref(x: torch.Tensor, k: int, block: int = 1024):
    """Blockwise top-k of |x| (NaN above +inf, ties to the lowest index).

    Returns ``(dense like x, vals (.., nb, k) fp32, idxs (.., nb, k) int32)``
    with block-local indices in descending key order: the stable descending
    argsort of the reference, so results compare elementwise.
    """
    x2 = _rows(x.to(torch.float32))
    rows, n = x2.shape
    xb = _blocks(x2, block)
    nb = xb.shape[1]
    if k == 0:
        empty = x2.new_zeros((rows, nb, 0))
        return (
            torch.zeros_like(x, dtype=torch.float32),
            _per_block(empty, x),
            _per_block(empty.to(torch.int32), x),
        )
    flat = xb.reshape(rows * nb, block)
    dense = torch.zeros_like(flat)
    vals = flat.new_empty((rows * nb, k))
    idxs = torch.empty((rows * nb, k), dtype=torch.int32, device=x.device)
    # blocks are independent: sort TOPK_CHUNK_BLOCKS of them at a time, so the
    # argsort's temporaries stay small at any buffer size
    for lo in range(0, rows * nb, TOPK_CHUNK_BLOCKS):
        xc = flat[lo:lo + TOPK_CHUNK_BLOCKS]
        key = torch.where(torch.isnan(xc), torch.full_like(xc, float("inf")), xc.abs())
        order = torch.argsort(-key, dim=1, stable=True)[:, :k]
        v = torch.take_along_dim(xc, order, dim=1)
        dense[lo:lo + TOPK_CHUNK_BLOCKS].scatter_(1, order, v)
        vals[lo:lo + TOPK_CHUNK_BLOCKS] = v
        idxs[lo:lo + TOPK_CHUNK_BLOCKS] = order
    return (
        _unblocks(dense.reshape(rows, nb, block), n, x),
        _per_block(vals.reshape(rows, nb, k), x),
        _per_block(idxs.reshape(rows, nb, k), x),
    )


def scatter_acc_ref(vals: torch.Tensor, idxs: torch.Tensor, acc: torch.Tensor, w,
                    block: int = 1024) -> torch.Tensor:
    """acc + w * scatter(vals at block-local idxs); indices unique per block."""
    acc2 = _rows(acc.to(torch.float32))
    rows, n = acc2.shape
    accb = _blocks(acc2, block)
    nb = accb.shape[1]
    v = vals.reshape(rows, nb, -1).to(torch.float32)
    i = idxs.reshape(rows, nb, -1).to(torch.int64)
    # 0 + v, as the reference's scatter-add into zeros (-0.0 lands as +0.0)
    dense = torch.zeros_like(accb).scatter_add_(2, i, v)
    wr = row_weights(w, rows, acc.device)[:, None, None]
    return _unblocks(accb + wr * dense, n, acc)
