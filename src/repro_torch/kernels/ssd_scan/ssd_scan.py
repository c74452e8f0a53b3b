"""ctypes wrapper of the CUDA SSD-scan kernel in ``csrc/ssd_scan.cu``.

The wrapper checks what the kernel takes (CUDA tensors, dtypes, contiguity,
shapes, the chunk) and raises on anything else; it never falls back to the
plain version. It allocates ``y`` and the state with ``torch.empty``,
launches on PyTorch's current stream, raises if the launch is refused, and
adds one to its launch counter (:data:`LAUNCHES`). The library is built with
``nvcc`` on first use (:mod:`repro_torch.kernels.build`), never at import.

Layout is the model's (the JAX package's ``kernels/ssd_scan/ops.py``):
xh (B,S,H,P), dt (B,S,H) f32, A (H,) f32, Bv and Cv (B,S,G,N) shared by the
H/G heads of a group. The kernel reads each group's B and C itself; nothing
is broadcast to heads in device memory.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build as build_lib

LIB_NAME = "ssd_scan"
MAX_P, MAX_N, MAX_CHUNK = 64, 128, 256
_MAX_GRID = 2**31 - 1

LAUNCHES: Dict[str, int] = {"ssd_scan": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


_P = ctypes.c_void_p
_I = ctypes.c_int64
_SIGNATURE = [_P] * 7 + [_I] * 7 + [_P]
_FN = {torch.float32: "ssd_scan_f32", torch.bfloat16: "ssd_scan_bf16"}
_lib = None


def library() -> ctypes.CDLL:
    """Build (first use) and bind the kernel's shared library."""
    global _lib
    if _lib is None:
        lib = build_lib.load(LIB_NAME)
        for fn in _FN.values():
            getattr(lib, fn).argtypes = _SIGNATURE
            getattr(lib, fn).restype = ctypes.c_int
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


def ssd_scan_fwd(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bv: torch.Tensor, Cv: torch.Tensor, *,
                 chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan from a zero state -> (y (B,S,H,P) in xh's dtype,
    final state (B,H,P,N) f32); one launch."""
    if xh.dim() != 4 or Bv.dim() != 4:
        raise ValueError(f"xh and Bv must be 4-d, got {tuple(xh.shape)}, {tuple(Bv.shape)}")
    B_, S, H, P = xh.shape
    G, N = Bv.shape[2], Bv.shape[3]
    if not 1 <= P <= MAX_P or not 1 <= N <= MAX_N:
        raise ValueError(f"head dim {P} and state {N} must be <= {MAX_P} and <= {MAX_N}")
    if not 1 <= chunk <= MAX_CHUNK or S % chunk:
        raise ValueError(f"chunk {chunk} must be in [1, {MAX_CHUNK}] and divide S={S}")
    if G < 1 or H % G:
        raise ValueError(f"{H} heads do not split into {G} groups")
    if B_ * H > _MAX_GRID:
        raise ValueError(f"{B_ * H} rows exceed the launch grid")
    dtypes = (xh.dtype,) if xh.dtype in _FN else tuple(_FN)
    _check(xh, "xh", dtypes, (B_, S, H, P))
    _check(dt, "dt", (torch.float32,), (B_, S, H))
    _check(A, "A", (torch.float32,), (H,))
    _check(Bv, "Bv", dtypes, (B_, S, G, N))
    _check(Cv, "Cv", dtypes, (B_, S, G, N))
    y = torch.empty_like(xh)
    state = torch.empty((B_, H, P, N), dtype=torch.float32, device=xh.device)
    rc = getattr(library(), _FN[xh.dtype])(
        xh.data_ptr(), dt.data_ptr(), A.data_ptr(), Bv.data_ptr(), Cv.data_ptr(),
        y.data_ptr(), state.data_ptr(), B_, S, H, P, G, N, chunk,
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan: CUDA launch failed with error {rc}")
    LAUNCHES["ssd_scan"] += 1
    return y, state
