"""ctypes wrappers of the CUDA attention kernels in ``csrc/flash_attention.cu``.

The wrappers check what the kernels take (CUDA tensors, dtypes, contiguity,
shapes, ``H % KV``, the head dim) and raise on anything else; they never
fall back to the plain version. Each allocates its output with
``torch.empty``, launches on PyTorch's current stream, raises if the launch
is refused, and adds one to its launch counter (:data:`LAUNCHES`). The
library is built with ``nvcc`` on first use (:mod:`repro_torch.kernels.build`),
never at import.

Layout is the model's: q and the output (B, S, H, hd), k and v (B, Skv, KV,
hd); query head h reads kv head h // (H // KV), and K and V are never
repeated in memory. The scale is ``hd ** -0.5`` of the true head dim (the
reference's wrapper pads hd to the TPU's 128 lanes and pre-scales q to
compensate; nothing here is padded).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.kernels import build as build_lib

LIB_NAME = "flash_attention"
HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_DECODE_ROWS = 16            # G * Sq rows per decode block
_MAX_GRID_Y = 65535

LAUNCHES: Dict[str, int] = {"flash_attention_fwd": 0, "flash_attention_decode": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


_P = ctypes.c_void_p
_I = ctypes.c_int64
_D = ctypes.c_double
_FWD_SIGNATURE = [_P] * 4 + [_I] * 7 + [_D, _D, _P]
_DEC_SIGNATURE = [_P] * 5 + [_I] * 6 + [_D, _D, _P]
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_lib = None


def library() -> ctypes.CDLL:
    """Build (first use) and bind the kernels' shared library."""
    global _lib
    if _lib is None:
        lib = build_lib.load(LIB_NAME)
        for sfx in _SUFFIX.values():
            for name, sig in (("flash_attention_fwd", _FWD_SIGNATURE),
                              ("flash_attention_decode", _DEC_SIGNATURE)):
                fn = getattr(lib, f"{name}_{sfx}")
                fn.argtypes = sig
                fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(t: torch.Tensor, name: str, dtypes, shape) -> None:
    if not isinstance(t, torch.Tensor) or not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor for the CUDA kernel")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")


def _heads(q: torch.Tensor, k: torch.Tensor):
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q and k must be 4-d, got {tuple(q.shape)}, {tuple(k.shape)}")
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    if KV < 1 or H % KV:
        raise ValueError(f"{H} query heads do not split over {KV} kv heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    return B, Sq, H, KV, hd


def _cap(softcap: Optional[float]) -> float:
    if softcap is None:
        return 0.0
    if not softcap > 0:
        raise ValueError(f"softcap must be positive or None, got {softcap}")
    return float(softcap)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None) -> torch.Tensor:
    """Prefill attention (q_offset 0, Sq == Skv) -> (B, S, H, hd) in q's
    dtype; one launch."""
    B, S, H, KV, hd = _heads(q, k)
    cap = _cap(softcap)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if B * H > _MAX_GRID_Y:
        raise ValueError(f"{B * H} (lane, head) rows exceed the launch grid")
    dtypes = (q.dtype,) if q.dtype in _SUFFIX else tuple(_SUFFIX)
    _check(q, "q", dtypes, (B, S, H, hd))
    _check(k, "k", dtypes, (B, S, KV, hd))
    _check(v, "v", dtypes, (B, S, KV, hd))
    out = torch.empty_like(q)
    rc = getattr(library(), f"flash_attention_fwd_{_SUFFIX[q.dtype]}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, S, H, KV, hd, int(causal), 0 if window is None else int(window),
        hd ** -0.5, cap, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd: CUDA launch failed with error {rc}")
    LAUNCHES["flash_attention_fwd"] += 1
    return out


def flash_attention_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           kv_len: torch.Tensor, *,
                           softcap: Optional[float] = None) -> torch.Tensor:
    """Decode attention against a cache of length L: no causal or window
    mask, keys at or past ``kv_len[b]`` (int32 (B,), on the card, each in
    [1, L]) masked -> (B, Sq, H, hd) in q's dtype; one launch."""
    B, Sq, H, KV, hd = _heads(q, k)
    cap = _cap(softcap)
    L = k.shape[1]
    if (H // KV) * Sq > MAX_DECODE_ROWS:
        raise ValueError(f"{H // KV} heads per kv head x {Sq} queries exceed "
                         f"{MAX_DECODE_ROWS} rows per block")
    dtypes = (q.dtype,) if q.dtype in _SUFFIX else tuple(_SUFFIX)
    _check(q, "q", dtypes, (B, Sq, H, hd))
    _check(k, "k", dtypes, (B, L, KV, hd))
    _check(v, "v", dtypes, (B, L, KV, hd))
    _check(kv_len, "kv_len", (torch.int32,), (B,))
    out = torch.empty_like(q)
    rc = getattr(library(), f"flash_attention_decode_{_SUFFIX[q.dtype]}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
        B, Sq, L, H, KV, hd, hd ** -0.5, cap,
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_decode: CUDA launch failed with error {rc}")
    LAUNCHES["flash_attention_decode"] += 1
    return out
