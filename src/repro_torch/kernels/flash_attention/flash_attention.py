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

The prefill has two kernels, chosen by dtype in the C entry points: bf16 on
tensor cores (``wgmma``), float32 on CUDA cores. The C side reports which
one it launched, and the bf16 tensor-core launches count also under
``flash_attention_fwd_wgmma``. Asked for it (``lse=True``, the training
forward), either also writes each row's log-sum-exp, (B, H, S) float32.

The backward (:func:`flash_attention_bwd`) recomputes p from that lse: a
pass for ``delta = rowsum(g * out)``, a dk/dv pass (one block per lane, kv
head and key tile, walking the query tiles of its G heads that see the
tile) and a dq pass (one block per lane, head and query tile); three
launches per call, counted once under ``flash_attention_bwd``, with no
atomics, so a call's gradients are the same bits every time. bf16 runs its
products on tensor cores (``mma.sync``; p and ds enter as bf16 hi + lo, as
the forward's p does), float32 on CUDA cores. The decode is a split-KV pass:
:func:`decode_plan` cuts the cache into ``n_split`` chunks (one block per
lane, kv head and chunk), and the last block of each (lane, kv head) merges
the partials, so a call stays one launch.

The decode is host-bound in serving (one call per layer per tick, a kernel
of tens of microseconds), so its wrapper does the full checks and the plan
once per (shapes, dtypes, devices, softcap) and keeps the result; a repeat
call checks contiguity and alignment, allocates its output and launches.
The partials and the arrival counters are scratch of one stream: kept per
(device, stream) and grown as needed, so calls on one stream run in stream
order and calls on two streams never share a counter (the kernel leaves
the counters at 0). A call made while its stream is being captured into a
CUDA graph allocates its own scratch, which the graph keeps, so two graphs
never share one either.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build as build_lib

LIB_NAME = "flash_attention"
HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_DECODE_ROWS = 16            # G * Sq rows per decode block
_MAX_GRID_Y = 65535
# the split-KV decode: at least DECODE_WAVES blocks per SM, chunks of at
# least DECODE_MIN_CHUNK slots, at most DECODE_MAX_SPLIT chunks
DECODE_WAVES = 2
DECODE_MIN_CHUNK = 16
DECODE_MAX_SPLIT = 128
H100_SMS = 132

# every prefill launch counts under flash_attention_fwd; those that the C
# side reports on the tensor-core kernel also under flash_attention_fwd_wgmma
LAUNCHES: Dict[str, int] = {"flash_attention_fwd": 0, "flash_attention_fwd_wgmma": 0,
                            "flash_attention_decode": 0, "flash_attention_bwd": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


_P = ctypes.c_void_p
_I = ctypes.c_int64
_D = ctypes.c_double
_FWD_SIGNATURE = [_P] * 5 + [_I] * 7 + [_D, _D, _P]
_BWD_SIGNATURE = [_P] * 10 + [_I] * 7 + [_D, _D, _P]
_DEC_SIGNATURE = [_P] * 8 + [_I] * 8 + [_D, _D, _P]
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
FWD_TENSOR_CORES = 1            # flash_attention_fwd_launched(): the wgmma kernel
_lib = None
_sms: Dict[int, int] = {}                   # device index -> SM count
# decode calls checked and planned: key -> (entry, int and float arguments,
# n_split, float32 partial sums, float32 partials in all, arrival counters)
_decode_launches: Dict[tuple, tuple] = {}
# (device, stream) -> [float32 partials, int32 arrival counters]
_decode_scratch: Dict[tuple, list] = {}


def decode_plan(B: int, KV: int, L: int, rows: int, hd: int,
                sms: int = H100_SMS) -> Tuple[int, int, tuple, tuple]:
    """How the decode splits a cache of ``L`` slots for ``B * KV`` (lane, kv
    head) pairs of ``rows`` query rows each on a card of ``sms`` SMs:
    ``(n_split, chunk, part_acc shape, part_ml shape)``. Chunk p covers
    slots ``[p * chunk, min((p + 1) * chunk, L))``, the same for every lane;
    none is empty, and none is shorter than ``DECODE_MIN_CHUNK`` slots
    unless it is the whole cache. ``n_split`` aims at ``DECODE_WAVES``
    blocks per SM, within those limits and ``DECODE_MAX_SPLIT``.
    The partials are float32 ``(B * KV, n_split, rows, hd)`` sums and
    ``(B * KV, n_split, rows, 2)`` (max, sum) pairs."""
    pairs = B * KV
    want = -(-DECODE_WAVES * sms // pairs)
    n, chunk = split_cache(L, max(1, min(want, DECODE_MAX_SPLIT, L // DECODE_MIN_CHUNK)))
    return n, chunk, (pairs, n, rows, hd), (pairs, n, rows, 2)


def split_cache(L: int, n: int) -> Tuple[int, int]:
    """``(n_split, chunk)`` for cutting ``L`` slots into about ``n`` chunks
    (1 <= n <= L): chunks of ``L // n`` slots, rounded down so that there
    are at least ``n``, and no more than ``DECODE_MAX_SPLIT``; the last
    chunk takes what is left."""
    chunk = L // n
    if -(-L // chunk) > DECODE_MAX_SPLIT:
        chunk = -(-L // DECODE_MAX_SPLIT)
    return -(-L // chunk), chunk


def _stream(device: torch.device) -> int:
    """The handle of the current CUDA stream of ``device``, read without
    building a ``torch.cuda.Stream`` (which costs the host a few
    microseconds per call, on a decode that is host-bound)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _device_index(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None else torch.cuda.current_device()


def _sm_count(t: torch.Tensor) -> int:
    idx = _device_index(t)
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sms[idx]


def _scratch(device: torch.device, stream: int, floats: int, pairs: int) -> Tuple[int, int]:
    """Pointers to at least ``floats`` float32 and ``pairs`` int32 zeros
    (the arrival counters) for a decode on ``stream``: kept per (device,
    stream) outside a graph capture, the call's own inside one."""
    if torch.cuda.is_current_stream_capturing():
        part = torch.empty(floats, dtype=torch.float32, device=device)
        counters = torch.zeros(pairs, dtype=torch.int32, device=device)
        return part.data_ptr(), counters.data_ptr()
    bufs = _decode_scratch.get((device, stream))
    if bufs is None:
        bufs = _decode_scratch[(device, stream)] = [None, None]
    if bufs[0] is None or bufs[0].numel() < floats:
        bufs[0] = torch.empty(floats, dtype=torch.float32, device=device)
    if bufs[1] is None or bufs[1].numel() < pairs:
        bufs[1] = torch.zeros(max(pairs, 64), dtype=torch.int32, device=device)
    return bufs[0].data_ptr(), bufs[1].data_ptr()


def library() -> ctypes.CDLL:
    """Build (first use) and bind the kernels' shared library."""
    global _lib
    if _lib is None:
        lib = build_lib.load(LIB_NAME)
        for sfx in _SUFFIX.values():
            for name, sig in (("flash_attention_fwd", _FWD_SIGNATURE),
                              ("flash_attention_decode", _DEC_SIGNATURE),
                              ("flash_attention_bwd", _BWD_SIGNATURE)):
                fn = getattr(lib, f"{name}_{sfx}")
                fn.argtypes = sig
                fn.restype = ctypes.c_int
        lib.flash_attention_fwd_launched.argtypes = []
        lib.flash_attention_fwd_launched.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(t: torch.Tensor, name: str, dtypes, shape, aligned: bool = True) -> None:
    if not isinstance(t, torch.Tensor) or not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor for the CUDA kernel")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if aligned and t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary (16-byte loads)")


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


def _prefill_checks(q, k, v, causal, window, softcap):
    B, S, H, KV, hd = _heads(q, k)
    cap = _cap(softcap)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if B * H > _MAX_GRID_Y or -(-S // 32) > _MAX_GRID_Y:
        raise ValueError(f"{B * H} (lane, head) rows or S {S} exceed the launch grid")
    dtypes = (q.dtype,) if q.dtype in _SUFFIX else tuple(_SUFFIX)
    _check(q, "q", dtypes, (B, S, H, hd))
    _check(k, "k", dtypes, (B, S, KV, hd))
    _check(v, "v", dtypes, (B, S, KV, hd))
    return (B, S, H, KV, hd, int(causal), 0 if window is None else int(window),
            hd ** -0.5, cap)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None, lse: bool = False):
    """Prefill attention (q_offset 0, Sq == Skv) -> (B, S, H, hd) in q's
    dtype; with ``lse=True`` the pair (output, rows' log-sum-exp (B, H, S)
    float32). One launch (bf16: the tensor-core kernel)."""
    args = _prefill_checks(q, k, v, causal, window, softcap)
    B, S, H = args[:3]
    out = torch.empty_like(q)
    lse_t = torch.empty((B, H, S), dtype=torch.float32, device=q.device) if lse else None
    lib = library()
    rc = getattr(lib, f"flash_attention_fwd_{_SUFFIX[q.dtype]}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        0 if lse_t is None else lse_t.data_ptr(), *args, _stream(q.device))
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd: CUDA launch failed with error {rc}")
    LAUNCHES["flash_attention_fwd"] += 1
    if lib.flash_attention_fwd_launched() == FWD_TENSOR_CORES:
        LAUNCHES["flash_attention_fwd_wgmma"] += 1
    return out if lse_t is None else (out, lse_t)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor, g: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None):
    """Gradients of the prefill attention -> (dq, dk, dv) in the inputs'
    dtype, from its output ``out`` (B, S, H, hd), its lse (B, H, S) float32
    and the output gradient ``g`` (B, S, H, hd). Three launches (delta, dk
    and dv, dq), counted as one call."""
    args = _prefill_checks(q, k, v, causal, window, softcap)
    B, S, H, KV, hd = args[:5]
    _check(out, "out", (q.dtype,), (B, S, H, hd))
    _check(g, "g", (q.dtype,), (B, S, H, hd))
    _check(lse, "lse", (torch.float32,), (B, H, S))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    rc = getattr(library(), f"flash_attention_bwd_{_SUFFIX[q.dtype]}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
        *args, _stream(q.device))
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd: CUDA launch failed with error {rc}")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


def _plan_decode(q, k, v, kv_len, softcap) -> tuple:
    """The full checks of a decode call, its plan and its entry point."""
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
    _check(kv_len, "kv_len", (torch.int32,), (B,), aligned=False)
    n_split, chunk, acc_shape, ml_shape = decode_plan(B, KV, L, (H // KV) * Sq, hd,
                                                      _sm_count(q))
    if n_split > _MAX_GRID_Y:
        raise ValueError(f"{n_split} cache chunks exceed the launch grid")
    fn = getattr(library(), f"flash_attention_decode_{_SUFFIX[q.dtype]}")
    acc = acc_shape[0] * acc_shape[1] * acc_shape[2] * acc_shape[3]
    ml = ml_shape[0] * ml_shape[1] * ml_shape[2] * ml_shape[3]
    return (fn, (B, Sq, L, H, KV, hd, chunk, n_split, hd ** -0.5, cap), n_split, acc,
            acc + ml, B * KV)


def flash_attention_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           kv_len: torch.Tensor, *,
                           softcap: Optional[float] = None) -> torch.Tensor:
    """Decode attention against a cache of length L: no causal or window
    mask, keys at or past ``kv_len[b]`` (int32 (B,), on the card, each in
    [1, L]) masked -> (B, Sq, H, hd) in q's dtype; one launch, split over
    the cache as :func:`decode_plan` says."""
    key = (q.shape, k.shape, v.shape, kv_len.shape, q.dtype, k.dtype, v.dtype,
           kv_len.dtype, q.device, k.device, v.device, kv_len.device, softcap)
    launch = _decode_launches.get(key)
    if launch is None:
        launch = _decode_launches[key] = _plan_decode(q, k, v, kv_len, softcap)
    elif not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()
              and kv_len.is_contiguous()):
        raise ValueError("q, k, v and kv_len must be contiguous")
    fn, args, n_split, acc, floats, pairs = launch
    qp, kp, vp = q.data_ptr(), k.data_ptr(), v.data_ptr()
    if (qp | kp | vp) % 16:
        raise ValueError("q, k and v must start on a 16-byte boundary (16-byte loads)")
    device = q.device
    stream = _stream(device)
    out = torch.empty_like(q)
    part, counters = _scratch(device, stream, floats, pairs) if n_split > 1 else (0, 0)
    # the partial sums, then the (max, sum) pairs, in one float32 buffer
    rc = fn(qp, kp, vp, kv_len.data_ptr(), out.data_ptr(), part, part and part + 4 * acc,
            counters, *args, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_decode: CUDA launch failed with error {rc}")
    LAUNCHES["flash_attention_decode"] += 1
    return out
