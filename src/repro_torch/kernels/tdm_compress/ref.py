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
``w * v`` plus one of the sum. The unit-weight accumulate (``w=None``) is
the exception: it is computed exactly as the fused form, see
:func:`dequant_acc_ref`.
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


def _block_scales(scales: torch.Tensor, rows: int, nb: int) -> torch.Tensor:
    """(nb,) scales shared by every row, or (rows, nb) -> (rows, nb)."""
    if scales.dim() == 1 and scales.shape[0] == nb:
        return scales.reshape(1, nb).expand(rows, nb)
    return scales.reshape(rows, nb)


def quantize_scaled_ref(x: torch.Tensor, scales: torch.Tensor, block: int = 1024) -> torch.Tensor:
    """Quantize with caller-supplied blockwise scales -> int8 like x. For a
    stacked (rows, n) payload the scales are (rows, nb), or (nb,) shared by
    every row (the ground-segment relay's all-node max)."""
    x2 = _rows(x.to(torch.float32))
    xb = _blocks(x2, block)
    return _unblocks(_encode(xb, _block_scales(scales, *xb.shape[:2])), x2.shape[1], x)


def dequantize_ref(q: torch.Tensor, scale: torch.Tensor, block: int = 1024) -> torch.Tensor:
    """q * scale per block -> f32 like q; scales as in :func:`quantize_scaled_ref`."""
    q2 = _rows(q)
    qb = _blocks(q2, block).to(torch.float32)
    return _unblocks(qb * _block_scales(scale, *qb.shape[:2])[..., None], q2.shape[1], q)


def _fma_rows(q2: torch.Tensor, scale: torch.Tensor, acc2: torch.Tensor,
              block: int) -> torch.Tensor:
    """Correctly rounded float32 ``acc + q * scale`` (one rounding, as a
    fused multiply-add), one row at a time. In float64 ``q * scale`` is
    exact (at most 16 + 24 significant bits); the sum is rounded to odd
    (TwoSum gives its exact error, and an inexact even result moves one
    step toward the true value), and rounding that to float32 is the
    correctly rounded sum, the double rounding notwithstanding."""
    rows, n = acc2.shape
    nb = -(-n // block)
    sc = _block_scales(scale, rows, nb)
    out = torch.empty_like(acc2)
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=acc2.device)
    for r in range(rows):
        a = _blocks(q2[r:r + 1], block).to(torch.float64) * sc[r].to(torch.float64)[None, :, None]
        b = _blocks(acc2[r:r + 1], block).to(torch.float64)
        d = a + b
        a_v = d - b
        b_v = d - a_v
        err = (a - a_v) + (b - b_v)
        even = (d.view(torch.int64) & 1) == 0
        fix = torch.isfinite(d) & (err != 0) & even
        d = torch.where(fix, torch.nextafter(d, torch.where(err > 0, inf, -inf)), d)
        out[r] = d.to(torch.float32).reshape(-1)[:n]
    return out


def dequant_acc_ref(q: torch.Tensor, scale: torch.Tensor, acc: torch.Tensor, w,
                    block: int = 1024) -> torch.Tensor:
    """acc + w * dequant(q, scale); q int8 (gossip) or int16 (relay sums).

    ``w=None`` is the unit weight the ground segment passes as the constant
    1.0: under jit XLA drops the multiply by it and contracts the rest into
    ``fma(q, scale, acc)``, one rounding, which this reproduces exactly
    (and so does the kernel). Scales may be shared, ``(nb,)``, for a
    stacked q in that form."""
    if w is None:
        return _fma_rows(_rows(q), scale, _rows(acc.to(torch.float32)), block).reshape(acc.shape)
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
