"""ctypes wrapper of the CUDA SSD-scan kernel in ``csrc/ssd_scan.cu``.

The wrapper checks what the kernel takes (CUDA tensors, dtypes, contiguity,
shapes, the chunk) and raises on anything else; it never falls back to the
plain version. It allocates ``y`` and the state with ``torch.empty``,
launches on PyTorch's current stream, raises if the launch is refused, and
adds one to its launch counter (:data:`LAUNCHES`) per call. The library is
built with ``nvcc`` on first use (:mod:`repro_torch.kernels.build`), never
at import.

A bfloat16 call runs three passes on the tensor cores, three launches
(chunk state, state passing, chunk scan; :func:`scan_plan` gives their
grids and scratch shapes), still counted as one call. Its scratch (``cum``,
each chunk's state term, each chunk's S_prev as bf16 hi and lo) is kept per
(device, stream) and grown when a larger shape comes. A float32 call is one
launch of the CUDA-core kernel.

Layout is the model's (the JAX package's ``kernels/ssd_scan/ops.py``):
xh (B,S,H,P), dt (B,S,H) f32, A (H,) f32, Bv and Cv (B,S,G,N) shared by the
H/G heads of a group. The kernel reads each group's B and C itself; nothing
is broadcast to heads in device memory.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.kernels import build as build_lib

LIB_NAME = "ssd_scan"
MAX_P, MAX_N, MAX_CHUNK = 64, 128, 256
TILE = 64                    # rows of t, s or p per tile of the bf16 passes
_MAX_GRID = 2**31 - 1

LAUNCHES: Dict[str, int] = {"ssd_scan": 0}


_P = ctypes.c_void_p
_I = ctypes.c_int64
_FN = {torch.float32: "ssd_scan_f32", torch.bfloat16: "ssd_scan_bf16"}
_SIGNATURE = {
    "ssd_scan_f32": [_P] * 7 + [_I] * 7 + [_P],
    "ssd_scan_bf16": [_P] * 10 + [_I] * 7 + [_P],   # + cum, term, prev scratch
}
_lib = None
# (device, stream) -> {scratch name: tensor}
_scratch_bufs: Dict[tuple, Dict[str, torch.Tensor]] = {}


class ScanPlan(NamedTuple):
    """The bf16 passes' grids (blocks of 128 threads) and scratch shapes."""
    state_grid: Tuple[int]        # pass 1: one block per (row, chunk)
    pass_grid: Tuple[int, int]    # pass 2: (rows, blocks of 512 (p, n) entries)
    scan_grid: Tuple[int]         # pass 3: one block per (row, chunk, 64-row t-tile)
    cum: Tuple[int, int]          # float32 (rows, S)
    term: Tuple[int, int, int, int]       # float32 (rows, chunks, P, N)
    prev: Tuple[int, int, int, int, int]  # bfloat16 (rows, chunks, 2, P, N)


def scan_plan(B: int, S: int, H: int, P: int, N: int, chunk: int) -> ScanPlan:
    """Grids and scratch of a bf16 call: ``rows = B * H`` (lane, head)
    rows of ``S // chunk`` chunks each."""
    rows, nc = B * H, S // chunk
    return ScanPlan(
        state_grid=(rows * nc,),
        pass_grid=(rows, -(-P * N // 512)),
        scan_grid=(rows * nc * -(-chunk // TILE),),
        cum=(rows, S),
        term=(rows, nc, P, N),
        prev=(rows, nc, 2, P, N),
    )


def library() -> ctypes.CDLL:
    """Build (first use) and bind the kernel's shared library."""
    global _lib
    if _lib is None:
        lib = build_lib.load(LIB_NAME)
        for fn in _FN.values():
            getattr(lib, fn).argtypes = _SIGNATURE[fn]
            getattr(lib, fn).restype = ctypes.c_int
        _lib = lib
    return _lib


def _scratch(device: torch.device, stream: int, plan: ScanPlan) -> Dict[str, torch.Tensor]:
    """The scratch of ``plan`` for a call on ``stream``, kept per (device,
    stream) and grown as needed: calls on one stream run in order, so they
    may share it; two streams never do."""
    bufs = _scratch_bufs.setdefault((device, stream), {})
    for k, shape, dt in (("cum", plan.cum, torch.float32), ("term", plan.term, torch.float32),
                         ("prev", plan.prev, torch.bfloat16)):
        if k not in bufs or bufs[k].numel() < math.prod(shape):
            bufs[k] = torch.empty(math.prod(shape), dtype=dt, device=device)
    return bufs


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
    final state (B,H,P,N) f32); one call (three launches in bf16, one in
    float32), counted once."""
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
    bf16 = xh.dtype == torch.bfloat16
    if bf16 and (P % 8 or N % 8):
        raise ValueError(f"bf16: head dim {P} and state {N} must be multiples of 8")
    if bf16 and scan_plan(B_, S, H, P, N, chunk).scan_grid[0] > _MAX_GRID:
        raise ValueError(f"{B_ * H} rows of {S // chunk} chunks exceed the launch grid")
    dtypes = (xh.dtype,) if xh.dtype in _FN else tuple(_FN)
    _check(xh, "xh", dtypes, (B_, S, H, P))
    _check(dt, "dt", (torch.float32,), (B_, S, H))
    _check(A, "A", (torch.float32,), (H,))
    _check(Bv, "Bv", dtypes, (B_, S, G, N))
    _check(Cv, "Cv", dtypes, (B_, S, G, N))
    if bf16 and any(t.data_ptr() % 16 for t in (xh, Bv, Cv)):
        raise ValueError("bf16: xh, Bv and Cv must start on 16-byte boundaries")
    y = torch.empty_like(xh)
    state = torch.empty((B_, H, P, N), dtype=torch.float32, device=xh.device)
    stream = torch.cuda.current_stream(xh.device).cuda_stream
    scratch = _scratch(xh.device, stream, scan_plan(B_, S, H, P, N, chunk)) if bf16 else {}
    rc = getattr(library(), _FN[xh.dtype])(
        xh.data_ptr(), dt.data_ptr(), A.data_ptr(), Bv.data_ptr(), Cv.data_ptr(),
        y.data_ptr(), state.data_ptr(),
        *(scratch[k].data_ptr() for k in ("cum", "term", "prev") if k in scratch),
        B_, S, H, P, G, N, chunk, stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan: CUDA launch failed with error {rc}")
    LAUNCHES["ssd_scan"] += 1
    return y, state
