"""ctypes wrappers of the six CUDA kernels in ``csrc/tdm_compress.cu``.

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

LAUNCHES: Dict[str, int] = {
    "quantize": 0,
    "dequant_accumulate": 0,
    "topk_sparsify": 0,
    "scatter_accumulate": 0,
    "quantize_scaled": 0,
    "dequantize": 0,
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


_P = ctypes.c_void_p
_I = ctypes.c_int64
_SIGNATURES = {
    "tdm_quantize": [_P, _P, _P, _I, _I, _I, _P],
    "tdm_dequant_acc_i8": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "tdm_dequant_acc_i16": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "tdm_topk_sparsify": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "tdm_scatter_acc": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "tdm_quantize_scaled": [_P, _P, _P, _I, _I, _I, _I, _P],
    "tdm_dequantize": [_P, _P, _P, _I, _I, _I, _I, _P],
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


def _geometry(x: torch.Tensor, block: int) -> Tuple[int, int, int]:
    """(rows, row_len, blocks per row) of a (n,) or (rows, n) payload."""
    if not MIN_BLOCK <= block <= MAX_BLOCK:
        raise ValueError(f"block must be in [{MIN_BLOCK}, {MAX_BLOCK}], got {block}")
    if x.dim() not in (1, 2):
        raise ValueError(f"payload must be (n,) or (rows, n), got {tuple(x.shape)}")
    rows, n = (1, x.shape[0]) if x.dim() == 1 else tuple(x.shape)
    nb = -(-n // block)
    if rows * nb > _MAX_GRID:
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


def topk_sparsify_fwd(x: torch.Tensor, k: int, *, block: int = 1024):
    """Blockwise top-k -> (dense like x, vals (.., nb, k), idxs (.., nb, k))."""
    rows, n, nb = _geometry(x, block)
    if not 0 <= k <= block:
        raise ValueError(f"per-block k must be in [0, {block}], got {k}")
    _check(x, "x", (torch.float32,))
    if k == 0:  # static empty payload, no launch (as in the reference)
        vals = torch.zeros(_block_shape(x, rows, nb, 0), dtype=torch.float32, device=x.device)
        return torch.zeros_like(x), vals, vals.to(torch.int32)
    dense = torch.empty_like(x)
    vals = torch.empty(_block_shape(x, rows, nb, k), dtype=torch.float32, device=x.device)
    idxs = torch.empty(vals.shape, dtype=torch.int32, device=x.device)
    _call("tdm_topk_sparsify", x.data_ptr(), dense.data_ptr(), vals.data_ptr(),
          idxs.data_ptr(), rows, n, block, k)
    LAUNCHES["topk_sparsify"] += 1
    return dense, vals, idxs


def scatter_accumulate_fwd(vals: torch.Tensor, idxs: torch.Tensor, acc: torch.Tensor,
                           w, *, block: int = 1024) -> torch.Tensor:
    """acc + w * scatter(vals at block-local idxs), every lane one FMA."""
    rows, n, nb = _geometry(acc, block)
    _check(acc, "acc", (torch.float32,))
    k = vals.shape[-1]
    _check(vals, "vals", (torch.float32,), _block_shape(acc, rows, nb, k))
    _check(idxs, "idxs", (torch.int32,), vals.shape)
    wt = _weights(w, rows, acc)
    if k == 0:
        return acc.clone()
    out = torch.empty_like(acc)
    _call("tdm_scatter_acc", vals.data_ptr(), idxs.data_ptr(), acc.data_ptr(),
          wt.data_ptr(), out.data_ptr(), rows, n, block, k)
    LAUNCHES["scatter_accumulate"] += 1
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
