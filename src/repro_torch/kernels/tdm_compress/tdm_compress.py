"""ctypes wrappers of the seven CUDA kernels in ``csrc/tdm_compress.cu``.

Each wrapper checks what the kernel takes (a CUDA tensor, dtype, contiguity,
shape, block size) and raises on anything else; it never falls back to the
plain version. It allocates the outputs with ``torch.empty``, launches on
PyTorch's current stream, raises if the launch is refused, and adds one to
its launch counter (:data:`LAUNCHES`). The library is built with ``nvcc`` on
first use (:mod:`repro_torch.kernels.build`), never at import.

Shapes follow :mod:`.ref`: a flat ``(n,)`` payload or a stacked
``(rows, n)`` one; per-block tensors carry the same leading ``rows`` axis and
``w`` is one float32 weight per row, ``(rows,)`` (a scalar for flat input).
``quantize_scaled_fwd`` and ``dequantize_fwd`` also take one ``(nb,)`` vector
of scales shared by every row of a stacked payload.

``topk_sparsify_fwd`` and ``scatter_accumulate_fwd`` have two kernel paths
each, chosen here from the per-block k: for ``k <= TOPK_SELECT_MAX_K`` the
select path (one warp per block, k rounds of a warp-wide argmax, the
contribution patched in registers), above it the bitonic sort and the
shared-memory scatter. Each path has its own launch counter.

``gossip_fold_fwd`` is the int8 gossip's whole receive side in one launch:
it reads each row's arrivals from the senders' codes where they lie, by a
row plan, and adds the self term.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build as build_lib
from repro_torch.kernels.tdm_compress.ref import row_weights

LIB_NAME = "tdm_compress"
MIN_BLOCK, MAX_BLOCK = 32, 4096
_MAX_GRID = 2**31 - 1
# largest per-block k that takes the select paths (at most 32, the C
# source's kSelectMaxK: one result per lane of the warp)
TOPK_SELECT_MAX_K = 32
_SELECT_BLOCKS_PER_CTA = 8     # kWarpsPerCta in the C source

LAUNCHES: Dict[str, int] = {
    "quantize": 0,
    "dequant_accumulate": 0,
    "topk_sparsify": 0,             # select path
    "topk_sparsify_sort": 0,
    "scatter_accumulate": 0,        # select path
    "scatter_accumulate_shared": 0,
    "quantize_scaled": 0,
    "dequantize": 0,
    "gossip_fold": 0,
}


_P = ctypes.c_void_p
_I = ctypes.c_int64
_SIGNATURES = {
    "tdm_quantize": [_P, _P, _P, _I, _I, _I, _P],
    "tdm_dequant_acc_i8": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "tdm_dequant_acc_i16": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "tdm_topk_select": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "tdm_topk_sort": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "tdm_scatter_acc_select": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "tdm_scatter_acc_shared": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "tdm_quantize_scaled": [_P, _P, _P, _I, _I, _I, _I, _P],
    "tdm_dequantize": [_P, _P, _P, _I, _I, _I, _I, _P],
    "tdm_gossip_fold": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
}
_lib = None


def library() -> ctypes.CDLL:
    """Build (first use) and bind the kernels' shared library."""
    global _lib
    if _lib is None:
        lib = build_lib.load(LIB_NAME)
        for fn, argtypes in _SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _lib = lib
    return _lib


def _call(fn: str, *args) -> None:
    rc = getattr(library(), fn)(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with error {rc}")


def _check(t: torch.Tensor, name: str, dtypes, shape=None) -> None:
    if not isinstance(t, torch.Tensor) or not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor for the CUDA kernel")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")


def _geometry(x: torch.Tensor, block: int, per_cta: int = 1) -> Tuple[int, int, int]:
    """(rows, row_len, blocks per row) of a (n,) or (rows, n) payload whose
    kernel takes ``per_cta`` blocks per thread block."""
    if not MIN_BLOCK <= block <= MAX_BLOCK:
        raise ValueError(f"block must be in [{MIN_BLOCK}, {MAX_BLOCK}], got {block}")
    if x.dim() not in (1, 2):
        raise ValueError(f"payload must be (n,) or (rows, n), got {tuple(x.shape)}")
    rows, n = (1, x.shape[0]) if x.dim() == 1 else tuple(x.shape)
    nb = -(-n // block)
    if -(-rows * nb // per_cta) > _MAX_GRID:
        raise ValueError(f"{rows * nb} blocks exceed the launch grid")
    return rows, n, nb


def _block_shape(x: torch.Tensor, rows: int, nb: int, *tail: int):
    return ((nb,) if x.dim() == 1 else (rows, nb)) + tail


def _weights(w, rows: int, like: torch.Tensor) -> torch.Tensor:
    wt = row_weights(w, rows, like.device).contiguous()
    _check(wt, "w", (torch.float32,), (rows,))
    return wt


def quantize_fwd(x: torch.Tensor, *, block: int = 1024):
    """x f32 -> (q int8 like x, scales f32 (.., nb)); one launch."""
    rows, n, nb = _geometry(x, block)
    _check(x, "x", (torch.float32,))
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    s = torch.empty(_block_shape(x, rows, nb), dtype=torch.float32, device=x.device)
    _call("tdm_quantize", x.data_ptr(), q.data_ptr(), s.data_ptr(), rows, n, block)
    LAUNCHES["quantize"] += 1
    return q, s


def dequant_accumulate_fwd(q: torch.Tensor, scales: torch.Tensor, acc: torch.Tensor,
                           w, *, block: int = 1024) -> torch.Tensor:
    """acc + w * (q * scale) with one FMA per lane; q int8 or int16.
    ``w=None`` is the unit weight as XLA compiles it: fma(q, scale, acc)."""
    rows, n, nb = _geometry(q, block)
    _check(q, "q", (torch.int8, torch.int16))
    _check(scales, "scales", (torch.float32,), _block_shape(q, rows, nb))
    _check(acc, "acc", (torch.float32,), q.shape)
    wt = None if w is None else _weights(w, rows, acc)
    out = torch.empty_like(acc)
    fn = "tdm_dequant_acc_i8" if q.dtype == torch.int8 else "tdm_dequant_acc_i16"
    _call(fn, q.data_ptr(), scales.data_ptr(), acc.data_ptr(),
          None if wt is None else wt.data_ptr(), out.data_ptr(), rows, n, block)
    LAUNCHES["dequant_accumulate"] += 1
    return out


def _path(k: int) -> Tuple[str, int]:
    """(path, payload blocks per thread block) of the two-path kernels."""
    if k <= TOPK_SELECT_MAX_K:
        return "select", _SELECT_BLOCKS_PER_CTA
    return "large", 1


def topk_sparsify_fwd(x: torch.Tensor, k: int, *, block: int = 1024):
    """Blockwise top-k -> (dense like x, vals (.., nb, k), idxs (.., nb, k));
    the select path for ``k <= TOPK_SELECT_MAX_K``, the sort above it."""
    path, per_cta = _path(k)
    rows, n, nb = _geometry(x, block, per_cta)
    if not 0 <= k <= block:
        raise ValueError(f"per-block k must be in [0, {block}], got {k}")
    _check(x, "x", (torch.float32,))
    if k == 0:  # static empty payload, no launch (as in the reference)
        vals = torch.zeros(_block_shape(x, rows, nb, 0), dtype=torch.float32, device=x.device)
        return torch.zeros_like(x), vals, vals.to(torch.int32)
    dense = torch.empty_like(x)
    vals = torch.empty(_block_shape(x, rows, nb, k), dtype=torch.float32, device=x.device)
    idxs = torch.empty(vals.shape, dtype=torch.int32, device=x.device)
    fn, counter = (("tdm_topk_select", "topk_sparsify") if path == "select"
                   else ("tdm_topk_sort", "topk_sparsify_sort"))
    _call(fn, x.data_ptr(), dense.data_ptr(), vals.data_ptr(), idxs.data_ptr(),
          rows, n, block, k)
    LAUNCHES[counter] += 1
    return dense, vals, idxs


def scatter_accumulate_fwd(vals: torch.Tensor, idxs: torch.Tensor, acc: torch.Tensor,
                           w, *, block: int = 1024) -> torch.Tensor:
    """acc + w * scatter(vals at block-local idxs), every lane one FMA; the
    select path for ``k <= TOPK_SELECT_MAX_K``, the shared-memory one above."""
    k = vals.shape[-1]
    path, per_cta = _path(k)
    rows, n, nb = _geometry(acc, block, per_cta)
    _check(acc, "acc", (torch.float32,))
    _check(vals, "vals", (torch.float32,), _block_shape(acc, rows, nb, k))
    _check(idxs, "idxs", (torch.int32,), vals.shape)
    wt = _weights(w, rows, acc)
    if k == 0:
        return acc.clone()
    out = torch.empty_like(acc)
    fn, counter = (("tdm_scatter_acc_select", "scatter_accumulate") if path == "select"
                   else ("tdm_scatter_acc_shared", "scatter_accumulate_shared"))
    _call(fn, vals.data_ptr(), idxs.data_ptr(), acc.data_ptr(), wt.data_ptr(),
          out.data_ptr(), rows, n, block, k)
    LAUNCHES[counter] += 1
    return out


def _scale_row_stride(scales: torch.Tensor, x: torch.Tensor, rows: int, nb: int) -> int:
    """Check per-block scales of payload ``x``: ``(nb,)`` shared by every row
    (stride 0) or, for a stacked payload, ``(rows, nb)`` (stride nb)."""
    _check(scales, "scales", (torch.float32,))
    if tuple(scales.shape) == (nb,):
        return 0
    _check(scales, "scales", (torch.float32,), _block_shape(x, rows, nb))
    return nb


def quantize_scaled_fwd(x: torch.Tensor, scales: torch.Tensor, *,
                        block: int = 1024) -> torch.Tensor:
    """x f32 -> q int8 like x, encoded with the caller's blockwise scales
    (``(nb,)`` shared, or ``(rows, nb)``); one launch."""
    rows, n, nb = _geometry(x, block)
    _check(x, "x", (torch.float32,))
    stride = _scale_row_stride(scales, x, rows, nb)
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    _call("tdm_quantize_scaled", x.data_ptr(), scales.data_ptr(), q.data_ptr(),
          rows, n, block, stride)
    LAUNCHES["quantize_scaled"] += 1
    return q


def dequantize_fwd(q: torch.Tensor, scales: torch.Tensor, *,
                   block: int = 1024) -> torch.Tensor:
    """q int8 -> q * scale as f32 like q (scales ``(nb,)`` shared, or
    ``(rows, nb)``); one launch."""
    rows, n, nb = _geometry(q, block)
    _check(q, "q", (torch.int8,))
    stride = _scale_row_stride(scales, q, rows, nb)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _call("tdm_dequantize", q.data_ptr(), scales.data_ptr(), out.data_ptr(),
          rows, n, block, stride)
    LAUNCHES["dequantize"] += 1
    return out


def gossip_fold_fwd(x: torch.Tensor, q: torch.Tensor, scales: torch.Tensor,
                    src: torch.Tensor, w: torch.Tensor, diag: torch.Tensor, *,
                    block: int = 1024) -> torch.Tensor:
    """The int8 gossip's receive side in one launch: row i of the result is
    ``diag[i] * x[i] + sum_m w[m, i] * dequant(q[src[m, i]])`` over the
    matchings m with ``src[m, i] >= 0``, rounded as the unfused chain (an
    accumulator of zeros, :func:`dequant_accumulate_fwd` per matching on the
    gathered rows, then ``+ diag * x``), bit for bit.

    x f32 and q int8 ``(rows, n)``, scales ``(rows, nb)``; the row plan: src
    int32 and w f32 ``(M, rows)``, diag f32 ``(rows,)``. ``n`` and ``block``
    multiples of 4 (the kernel takes float4 groups), x 16-byte and q 4-byte
    aligned."""
    if x.dim() != 2:
        raise ValueError(f"x must be (rows, n), got {tuple(x.shape)}")
    rows, n, nb = _geometry(x, block)
    if n % 4 or block % 4:
        raise ValueError(f"row length {n} and block {block} must be multiples of 4")
    _check(x, "x", (torch.float32,))
    _check(q, "q", (torch.int8,), x.shape)
    _check(scales, "scales", (torch.float32,), (rows, nb))
    n_match = src.shape[0] if src.dim() == 2 else -1
    _check(src, "src", (torch.int32,), (n_match, rows))
    _check(w, "w", (torch.float32,), (n_match, rows))
    _check(diag, "diag", (torch.float32,), (rows,))
    if x.data_ptr() % 16 or q.data_ptr() % 4:
        raise ValueError("x must be 16-byte and q 4-byte aligned")
    out = torch.empty_like(x)
    _call("tdm_gossip_fold", x.data_ptr(), q.data_ptr(), scales.data_ptr(), src.data_ptr(),
          w.data_ptr(), diag.data_ptr(), out.data_ptr(), rows, n, block, n_match)
    LAUNCHES["gossip_fold"] += 1
    return out
