#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions;
2. build: compiles ``src/repro_torch/csrc/tdm_compress.cu`` and
   ``src/repro_torch/csrc/ssd_scan.cu`` with nvcc (``sm_90a``), one process
   per source started together, and prints the build times and ptxas'
   per-kernel report;
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   on small ragged / NaN / inf cases and at the slice's shape (one stacked
   ``(8, P)`` float32 buffer of the full-width model): int8 codes, scales,
   codes with given scales (shared ``(nb,)`` and per-row), dequantized
   values, top-k ``dense``/``vals``/``idxs`` and the unit-weight accumulate
   bit for bit, the weighted accumulates within one rounding of the product
   and of the sum (fused vs unfused multiply-add). Each kernel is timed with
   CUDA events at the slice's shape (the buffers are ~100x the 50 MB L2, so
   every launch finds them cold) beside its byte bound at 3.35 TB/s, its
   plain version and, where one PyTorch call computes the same function,
   that call;
   The SSD-scan kernel is held to its plain version on small and ragged
   cases (chunks 8, 64, 96 and 256, one to four chunks, groups 1, 2 and 4,
   head dims 16 to 64, states 32 to 128, bf16 and float32 inputs) and on
   strong decay at chunk 256 (A = -16, dt 0.05-0.1: the exponent above the
   diagonal passes 88, so exp before the mask would be inf): y and the state
   finite and within ``ssd_scan.ref.ssd_tolerance`` (1e-4 of the output's
   scale, plus one bf16 ulp for bf16 outputs);
4. slice 3, serving (run first among the paths, so its peak memory is its
   own): ``repro_torch.launch.serve_constellation`` with the torch
   ``ModelDecoder`` on mamba2-780m at its published config, all 48 layers,
   random weights from seed 0: the smoke scenario (6 MEO satellites, 2
   ground stations), replicas 0 and 3, batch 4, 16 requests at one per
   slot, prompts of 200-300 tokens over the full vocabulary (prefill
   buckets 256 and 512, i.e. one and two SSD chunks), 16 new tokens each,
   replica 0 lost mid-epoch and restored. The launch counters are zeroed
   just before and read just after. Checks: every request delivered with
   16 tokens, the route-provenance audit clean, ``ssd_scan`` launched
   48 times per prefill call; a second run on a fresh decoder (under
   ``torch.profiler``, which gives the device's busy time) gives the same
   token streams bit for bit; one wave's prefill through the kernel and
   through the plain versions: layer by layer on the same input, every SSM
   state within ``ssd_tolerance`` and every mixer output within 2 bf16 ulps
   of its largest magnitude; the whole prefill's
   last-token logits and SSM states within 4x the plain path's own spread
   (its difference from the same prefill chunked at 128), since later
   layers carry and amplify a layer's rounding differences. Prints prefill
   ms per call with its bucket, decode ms per fleet tick, generated tokens
   per second of device time, peak GiB and the ``serve.*`` counters;
5. slice 1: the port's TDM path through its user entry points
   (``repro_torch.launch.train_fl_constellation``): constellation-driven
   TDM-FLA rounds of mamba2-780m at its published widths, depth cut to 8
   layers, 8 satellites with satellite 3 lost after round 1, 3 rounds each
   of compression none / int8 / topk. Launch counters are zeroed just
   before each mode and read just after. One exchange is also run with the
   plain versions (``quant_impl="ref"``) on the same input as the kernels;
6. slice 2: the ground-segment path through ``main_groundseg`` at the same
   widths and depth: 6 satellites and 2 ground sinks, hierarchical FedAvg,
   satellite 2 lost after round 1, 3 rounds each of (none, depth 1),
   (int8, depth 1) and (int8, depth 2 with a staleness horizon of 1), the
   counters zeroed before each config. Every round's loss and consensus are
   finite, the live satellites, pooling, deliveries and coverage are the
   routing programs', and the gathers and reductions equal the oracle's
   (the FL loop checks every round). Then one int8 exchange on the trained
   params, through the kernels and through the plain versions: bit for bit;
7. timing: the six exchange kernels at slice 1's shape (see 3) and
   ``ssd_scan`` at the serving prefill's shape with both replicas admitted
   (8 lanes x 48 heads, S 512, chunk 256, bf16), each beside its bound: the
   larger of the bytes it must move over 3.35 TB/s and its float32
   operations (the triangle s <= t only) over 67 TFLOP/s.

Prints a ``{"kernels": [...]}`` line, then ``{"ok": true, "device": ...}``
as the last line. Exits non-zero when no CUDA device is present or the
repository's ``src/`` is missing.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet, at the 700 W limit
F32_FLOPS_PER_S = 67e12        # float32 outside the tensor cores, same sheet
SOURCES = {
    "tdm_compress": "src/repro_torch/csrc/tdm_compress.cu",
    "ssd_scan": "src/repro_torch/csrc/ssd_scan.cu",
}
SOURCE = list(SOURCES.values())
REPLACES = {
    "quantize": "src/repro/kernels/tdm_compress/tdm_compress.py:121",
    "dequant_accumulate": "src/repro/kernels/tdm_compress/tdm_compress.py:172",
    "topk_sparsify": "src/repro/kernels/tdm_compress/tdm_compress.py:245",
    "scatter_accumulate": "src/repro/kernels/tdm_compress/tdm_compress.py:292",
    "quantize_scaled": "src/repro/kernels/tdm_compress/tdm_compress.py:211",
    "dequantize": "src/repro/kernels/tdm_compress/tdm_compress.py:150",
    "ssd_scan": "src/repro/kernels/ssd_scan/ssd_scan.py:80",
}
SLICE_NODES = 8
SLICE_LAYERS = 8            # mamba2-780m has 48; cut for memory (8 stacked nodes)
SLICE_ROUNDS = 3
SLICE_SEQ = 256             # tokens per row; 4 rows per node and local step
# ground segment: (compression, pipeline depth, staleness horizon)
GS_CONFIGS = (("none", 1, 0), ("int8", 1, 0), ("int8", 2, 1))
GS_ROUNDS = 3
GS_KERNELS = {"none": (), "int8": ("quantize_scaled", "quantize", "dequant_accumulate")}
# serving (slice 3): mamba2-780m at its published config, all 48 layers
SERVE_ARCH = "mamba2-780m"
SERVE_LAYERS = 48
SERVE_BATCH = 4
SERVE_REQUESTS = 16
SERVE_MAX_NEW = 16
SERVE_PROMPT = (200, 300)
SERVE_SPREAD = 4            # wave prefill: kernel vs plain <= 4x plain's own spread (see 4.)
OUT_ULPS = 2                # a layer's mixer output, kernel vs plain, same input (see 4.)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device() -> dict:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    log(f"[device] {card}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} devices {torch.cuda.device_count()}")
    return {"card": card, "kind": torch.cuda.get_device_name(0)}


def phase_build() -> None:
    from repro_torch.kernels import build as build_lib
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd_kern
    from repro_torch.kernels.tdm_compress import tdm_compress as kern

    t0 = time.perf_counter()
    build_lib.load_many(list(SOURCES))       # one nvcc per source, in parallel
    kern.library()
    ssd_kern.library()
    log(f"[build] both sources built and loaded in {time.perf_counter() - t0:.1f} s")
    for name in SOURCES:
        rec = build_lib.build_record(name)
        log(f"[build] {name}.cu: nvcc {rec['seconds']:.1f} s (built={rec['built']})")
        for line in rec["ptxas"].splitlines():
            if "Used" in line or "spill" in line or "Compiling entry" in line:
                log(f"[build]   {line.strip()}")


def _assert_bits(got, want, what: str) -> None:
    import torch

    same = (got == want)
    if got.dtype.is_floating_point:
        same |= torch.isnan(got) & torch.isnan(want)
    bad = int((~same).sum())
    check(got.shape == want.shape and bad == 0,
          f"{what}: {bad} of {want.numel()} entries differ (shapes "
          f"{tuple(got.shape)} vs {tuple(want.shape)})")


def _assert_fma(got, want, prod, what: str) -> float:
    import torch

    from repro_torch.kernels.tdm_compress.ref import fma_gap_ok

    ok = fma_gap_ok(got, want, prod)
    bad = int((~ok).sum())
    check(bad == 0, f"{what}: {bad} entries outside the fused/unfused bound")
    fin = torch.isfinite(got) & torch.isfinite(want)
    return float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) else 0.0


def _edge_payload(gen, rows: int, n: int, device):
    """normal payload with ~5% NaN, ~5% +inf, ~5% -inf, and exact ties"""
    import torch

    x = torch.randn(rows, n, generator=gen, device=device) * 3.0
    u = torch.rand(rows, n, generator=gen, device=device)
    x[u < 0.05] = float("nan")
    x[(u >= 0.05) & (u < 0.10)] = float("inf")
    x[(u >= 0.10) & (u < 0.15)] = float("-inf")
    x[(u >= 0.15) & (u < 0.25)] = 1.0
    x[(u >= 0.25) & (u < 0.30)] = -0.0
    return x


def phase_kernels_small(device) -> None:
    """Ragged, edge and tie cases at small shapes, every k regime."""
    import torch

    from repro_torch.kernels.tdm_compress import ref
    from repro_torch.kernels.tdm_compress import tdm_compress as kern

    gen = torch.Generator(device=device).manual_seed(7)
    cases = 0
    for rows, n, block in [(1, 1, 64), (3, 5000, 1024), (2, 777, 64),
                           (4, 4096, 256), (1, 3000, 128), (2, 1025, 4096)]:
        for kind in ("normal", "edge"):
            if kind == "edge":
                x = _edge_payload(gen, rows, n, device)
            else:
                x = torch.randn(rows, n, generator=gen, device=device) * 2.5
            q, s = kern.quantize_fwd(x, block=block)
            q_r, s_r = ref.quantize_ref(x, block=block)
            _assert_bits(q, q_r, f"quantize q {rows}x{n}/{block} {kind}")
            _assert_bits(s, s_r, f"quantize s {rows}x{n}/{block} {kind}")
            acc = torch.randn(rows, n, generator=gen, device=device)
            w = torch.rand(rows, generator=gen, device=device) * 2 - 1
            prod = w[:, None] * ref.dequantize_ref(q_r, s_r, block)
            _assert_fma(kern.dequant_accumulate_fwd(q, s, acc, w, block=block),
                        ref.dequant_acc_ref(q_r, s_r, acc, w, block), prod,
                        f"dequant_accumulate {rows}x{n}/{block} {kind}")
            q16 = torch.randint(-127 * 6, 127 * 6 + 1, (rows, n), generator=gen,
                                device=device).to(torch.int16)
            prod16 = w[:, None] * ref.dequantize_ref(q16, s_r, block)
            _assert_fma(kern.dequant_accumulate_fwd(q16, s_r, acc, w, block=block),
                        ref.dequant_acc_ref(q16, s_r, acc, w, block), prod16,
                        f"dequant_accumulate int16 {rows}x{n}/{block}")
            _assert_bits(kern.dequant_accumulate_fwd(q16, s_r, acc, None, block=block),
                         ref.dequant_acc_ref(q16, s_r, acc, None, block),
                         f"dequant_accumulate unit weight {rows}x{n}/{block} {kind}")
            per_row = ref.blockwise_scales_ref(x, block)
            shared = per_row.amax(dim=0)
            per_row[0, 0] = float("nan")
            per_row[-1, -1] = float("inf")
            for scales, tag in ((shared, "shared"), (per_row, "per-row")):
                qs = kern.quantize_scaled_fwd(x, scales, block=block)
                _assert_bits(qs, ref.quantize_scaled_ref(x, scales, block),
                             f"quantize_scaled {tag} {rows}x{n}/{block} {kind}")
                _assert_bits(kern.dequantize_fwd(qs, scales, block=block),
                             ref.dequantize_ref(qs, scales, block),
                             f"dequantize {tag} {rows}x{n}/{block} {kind}")
            for k in sorted({0, 1, 7, min(64, block), block}):
                d, v, i = kern.topk_sparsify_fwd(x, k, block=block)
                d_r, v_r, i_r = ref.topk_sparsify_ref(x, k, block)
                _assert_bits(d, d_r, f"topk dense {rows}x{n}/{block} k={k} {kind}")
                _assert_bits(v, v_r, f"topk vals {rows}x{n}/{block} k={k} {kind}")
                _assert_bits(i, i_r, f"topk idxs {rows}x{n}/{block} k={k} {kind}")
                if kind == "edge":
                    continue  # inf * w sums make NaN, compared above as bits
                got = kern.scatter_accumulate_fwd(v, i, acc, w, block=block)
                want = ref.scatter_acc_ref(v_r, i_r, acc, w, block)
                dense_w = ref.scatter_acc_ref(v_r, i_r, torch.zeros_like(acc), 1.0, block)
                _assert_fma(got, want, w[:, None] * dense_w,
                            f"scatter_accumulate {rows}x{n}/{block} k={k}")
                cases += 1
    torch.cuda.synchronize()
    log(f"[kernels] small/ragged/edge cases: all equal to the plain versions "
        f"({cases} scatter cases, blocks 64..4096; quantize_scaled and "
        f"dequantize with shared and per-row scales, NaN/inf payloads and "
        f"scales, bit for bit)")


def topk_total(n_leaves: int, padded: int) -> int:
    """The fused CHOCO budget of the slice (core/fused.py fused_buffer_mix)."""
    from repro_torch.launch import fl_train

    return min(fl_train.FLConfig().topk_k * n_leaves, padded)


def topk_block_budget(n_leaves: int, padded: int, block: int) -> int:
    """Per-block k of the fused CHOCO round (core/fused.py choco_fused_round)."""
    return max(1, min(block, -(-topk_total(n_leaves, padded) // (padded // block))))


def phase_kernels_slice(device, x, k_b: int, power_note: str) -> list:
    """Each kernel vs its plain version on the slice's stacked (8, P) params
    buffer (the trained params of the last mode), timed."""
    import torch

    from repro_torch.kernels.tdm_compress import ref
    from repro_torch.kernels.tdm_compress import tdm_compress as kern

    block = 1024
    rows, n = x.shape
    nb = n // block
    gen = torch.Generator(device=device).manual_seed(11)
    acc = torch.randn(rows, n, generator=gen, device=device) * 0.02
    w = torch.rand(rows, generator=gen, device=device) * 0.5
    elems = rows * n
    log(f"[kernels] slice shape: ({rows}, {n}) float32 = "
        f"{elems * 4 / 1e9:.2f} GB per buffer, block {block}, top-k k_b={k_b}")
    results = []

    def record(name, err, ms, plain_ms, nbytes, library_ms):
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        results.append({
            "name": name, "route": "cuda", "source": SOURCES["tdm_compress"],
            "replaces": REPLACES[name], "launches": 0,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": library_ms,
        })
        lib = "null" if library_ms is None else f"{library_ms:.3f}"
        log(f"[kernels] {name:<19} {ms:8.3f} ms  bound {bound_ms:7.3f} ms "
            f"({bound_ms / ms:5.1%})  plain {plain_ms:8.3f} ms  library {lib} ms"
            f"  max_abs_err {err:.3g}  [{power_note}]")

    # 1. quantize
    q, s = kern.quantize_fwd(x, block=block)
    q_r, s_r = ref.quantize_ref(x, block=block)
    _assert_bits(q, q_r, "quantize q at slice shape")
    _assert_bits(s, s_r, "quantize scales at slice shape")
    del q_r, s_r
    ms = time_ms(lambda: kern.quantize_fwd(x, block=block), reps=10)
    plain = time_ms(lambda: ref.quantize_ref(x, block=block), reps=3)
    record("quantize", 0.0, ms, plain, elems * 5 + rows * nb * 4, None)

    # 2. dequant_accumulate
    got = kern.dequant_accumulate_fwd(q, s, acc, w, block=block)
    want = ref.dequant_acc_ref(q, s, acc, w, block)
    prod = w[:, None] * ref.dequantize_ref(q, s, block)
    err = _assert_fma(got, want, prod, "dequant_accumulate at slice shape")
    del got, want, prod
    ms = time_ms(lambda: kern.dequant_accumulate_fwd(q, s, acc, w, block=block), reps=10)
    plain = time_ms(lambda: ref.dequant_acc_ref(q, s, acc, w, block), reps=3)
    record("dequant_accumulate", err, ms, plain,
           elems * (1 + 4 + 4) + rows * nb * 4 + rows * 4, None)
    del q, s

    # 3. topk_sparsify
    d, v, i = kern.topk_sparsify_fwd(x, k_b, block=block)
    d_r, v_r, i_r = ref.topk_sparsify_ref(x, k_b, block)
    _assert_bits(d, d_r, "topk dense at slice shape")
    _assert_bits(v, v_r, "topk vals at slice shape")
    _assert_bits(i, i_r, "topk idxs at slice shape")
    del d, d_r, v_r, i_r
    ms = time_ms(lambda: kern.topk_sparsify_fwd(x, k_b, block=block), reps=5)
    plain = time_ms(lambda: ref.topk_sparsify_ref(x, k_b, block), reps=2)
    xv = x.view(rows * nb, block)
    lib = time_ms(lambda: torch.topk(xv.abs(), k_b, dim=1), reps=5)
    record("topk_sparsify", 0.0, ms, plain,
           elems * 8 + rows * nb * k_b * 8, lib)

    # 4. scatter_accumulate
    got = kern.scatter_accumulate_fwd(v, i, acc, w, block=block)
    want = ref.scatter_acc_ref(v, i, acc, w, block)
    prod = w[:, None] * ref.scatter_acc_ref(v, i, torch.zeros_like(acc), 1.0, block)
    err = _assert_fma(got, want, prod, "scatter_accumulate at slice shape")
    del got, want, prod
    ms = time_ms(lambda: kern.scatter_accumulate_fwd(v, i, acc, w, block=block), reps=10)
    plain = time_ms(lambda: ref.scatter_acc_ref(v, i, acc, w, block), reps=3)
    accv = acc.view(rows * nb, block)
    wv = (w[:, None, None] * v).reshape(rows * nb, k_b)
    iv = i.reshape(rows * nb, k_b).to(torch.int64)
    lib = time_ms(lambda: accv.scatter_add(1, iv, wv), reps=10)
    record("scatter_accumulate", err, ms, plain,
           elems * 8 + rows * nb * k_b * 8 + rows * 4, lib)
    del acc, v, i, accv, wv, iv
    torch.cuda.empty_cache()

    # 5. quantize_scaled, with the relay's shared (nb,) scales: the max over
    # all rows of each row's blockwise scales
    s = ref.blockwise_scales_ref(x, block).amax(dim=0)
    q = kern.quantize_scaled_fwd(x, s, block=block)
    _assert_bits(q, ref.quantize_scaled_ref(x, s, block), "quantize_scaled at slice shape")
    ms = time_ms(lambda: kern.quantize_scaled_fwd(x, s, block=block), reps=10)
    plain = time_ms(lambda: ref.quantize_scaled_ref(x, s, block), reps=3)
    log("[kernels] quantize_scaled library: null (no single PyTorch call computes "
        "it: torch.quantize_per_channel clips to [-128, 127], not +-127, and "
        "returns a quantized tensor, not int8 codes)")
    record("quantize_scaled", 0.0, ms, plain, elems * 5 + nb * 4, None)

    # 6. dequantize of those codes with the same shared scales
    got = kern.dequantize_fwd(q, s, block=block)
    _assert_bits(got, ref.dequantize_ref(q, s, block), "dequantize at slice shape")
    qv, sv = q.view(rows, nb, block), s.view(1, nb, 1)
    _assert_bits(torch.mul(qv, sv).view(rows, n), got, "dequantize against torch.mul")
    del got
    ms = time_ms(lambda: kern.dequantize_fwd(q, s, block=block), reps=10)
    plain = time_ms(lambda: ref.dequantize_ref(q, s, block), reps=3)
    lib = time_ms(lambda: torch.mul(qv, sv), reps=10)
    record("dequantize", 0.0, ms, plain, elems * 5 + nb * 4, lib)
    del q, s, qv, sv
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return results


MODE_KERNELS = {
    "none": (),
    "int8": ("quantize", "dequant_accumulate"),
    "topk": ("topk_sparsify", "scatter_accumulate"),
}


def _mix_bound_ok(got, want, x, n_matchings: int) -> bool:
    """|got - want| <= 2 (M + 2) ulp(|x|max) per node: one fused-vs-unfused
    rounding gap per accumulation (tests/test_torch_exchange.py)."""
    import torch

    rowmax = x.abs().amax(dim=1, keepdim=True)
    ulp = torch.nextafter(rowmax, torch.full_like(rowmax, float("inf"))) - rowmax
    return bool(((got - want).abs() <= 2 * (n_matchings + 2) * ulp).all())


def _compare_exchange(buf, n_leaves: int, rel, mode: str, n_nodes: int) -> None:
    """The mode's exchange on the trained params' flat buffer, through the
    kernels and through the plain versions (``impl="ref"``), same input."""
    from repro_torch.core import fused, tdm
    from repro_torch.kernels.tdm_compress import ops

    m = len(tdm.edge_coloring(rel))
    if mode == "int8":
        q, s = ops.quantize(buf, impl="cuda")
        q_r, s_r = ops.quantize(buf, impl="ref")
        _assert_bits(q, q_r, "slice int8 codes")
        _assert_bits(s, s_r, "slice int8 scales")
        del q, s, q_r, s_r
        got = fused.int8_gossip(buf, rel, n_nodes, impl="cuda")
        want = fused.int8_gossip(buf, rel, n_nodes, impl="ref")
        check(_mix_bound_ok(got, want, buf, m), "slice int8 mix outside the bound")
        err = float((got - want).abs().max())
    else:
        k_b = topk_block_budget(n_leaves, buf.shape[1], fused.DEFAULT_BLOCK)
        for a, b, what in zip(ops.topk_sparsify(buf, k=k_b, impl="cuda"),
                              ops.topk_sparsify(buf, k=k_b, impl="ref"),
                              ("dense", "vals", "idxs")):
            _assert_bits(a, b, f"slice top-k {what}")
        k_total = topk_total(n_leaves, buf.shape[1])
        zero = tdm.choco_init(buf)
        got, st = fused.choco_fused_round(buf, zero, rel, n_nodes, k_total, impl="cuda")
        got_s = st.s
        del st
        want, st = fused.choco_fused_round(buf, zero, rel, n_nodes, k_total, impl="ref")
        check(_mix_bound_ok(got_s, st.s, buf, m), "slice CHOCO accumulator outside the bound")
        check(_mix_bound_ok(got, want, buf, m), "slice CHOCO mix outside the bound")
        err = float((got - want).abs().max())
        del st, got_s, zero
    del got, want
    log(f"[slice]   {mode} exchange, kernels vs plain versions on the same "
        f"input ({m} matchings): codes/selections equal, mix max |diff| {err:.3g}")


def phase_slice(device) -> tuple:
    """The port's main path, each compression mode driven through the
    launcher's entry point with the launch counters zeroed just before and
    read just after. Returns (launches per kernel, last mode's params
    buffer, its top-k block budget)."""
    import math

    import torch

    from repro_torch import telemetry
    from repro_torch.core import fused
    from repro_torch.kernels.tdm_compress import tdm_compress as kern
    from repro_torch.launch import train_fl_constellation as tfc

    launches = {name: 0 for name in kern.LAUNCHES}
    buf = None
    for mode in ("none", "int8", "topk"):
        buf = None                  # the previous mode's buffer, 6.2 GB
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        per_round = []

        def on_round(log_):
            per_round.append((log_, torch.cuda.max_memory_allocated(device)))
            torch.cuda.reset_peak_memory_stats(device)

        with telemetry.record_scope(tracing=True) as rec:
            kern.reset_launch_counts()
            t0 = time.perf_counter()
            res, scn = tfc.main_tdm(
                SLICE_ROUNDS, device=device, compression=mode, layers=SLICE_LAYERS,
                seq=SLICE_SEQ, full_width=True, fail_round=1, on_round=on_round,
            )
            torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
            counts = kern.launch_counts()
        def span_s(name):
            return [sp.dur_us / 1e6 for sp in rec.spans if sp.name == name]

        round_s = span_s("fl.round")
        for (lg, mem), secs, local, mix in zip(
                per_round, round_s, span_s("fl.local_steps"), span_s("fl.exchange")):
            log(f"[slice] {mode:<4} round {lg.round}  loss {lg.loss:.4f}  consensus "
                f"{lg.consensus:.3e}  links {lg.n_links}  alive {lg.alive}  "
                f"round {secs:.3f} s (local steps {local:.3f} s, exchange "
                f"{mix:.3f} s)  max mem {mem / 2**30:.1f} GiB")
        log(f"[slice] {mode:<4} {len(res.logs)} rounds in {wall:.1f} s; launches "
            f"{counts}; gathers {rec.get_counter('fl.exchange.gathers'):g} "
            f"(oracle {rec.get_counter('fl.collectives.collective-permute'):g})")
        check(len(res.logs) == SLICE_ROUNDS and len(round_s) == SLICE_ROUNDS,
              f"{mode}: {len(res.logs)} rounds logged")
        check(all(math.isfinite(lg.loss) and math.isfinite(lg.consensus)
                  for lg in res.logs), f"{mode}: non-finite loss or consensus")
        check([lg.alive for lg in res.logs] == [8, 8, 7],
              f"{mode}: satellite 3 not dropped after round 1")
        for name in kern.LAUNCHES:
            if name in MODE_KERNELS[mode]:
                check(counts[name] > 0, f"{mode}: kernel {name} never launched")
            else:
                check(counts[name] == 0, f"{mode}: kernel {name} launched unexpectedly")
            launches[name] += counts[name]
        params = res.state["params"]
        del res
        spec = fused.cached_spec(params)
        (bucket,) = spec.buckets
        buf = fused.flatten_pytree(spec, params)[bucket]
        n_leaves = spec.n_leaves(bucket)
        del params
        torch.cuda.empty_cache()
        if mode != "none":
            plan_rels = scn.plan.relations()
            rel = plan_rels[(SLICE_ROUNDS - 1) % len(plan_rels)].restrict(
                set(range(SLICE_NODES)) - {tfc.LOST_SATELLITE})
            _compare_exchange(buf, n_leaves, rel, mode, SLICE_NODES)
            torch.cuda.empty_cache()
    k_b = topk_block_budget(n_leaves, buf.shape[1], fused.DEFAULT_BLOCK)
    return launches, buf, k_b


def _gs_programs(scn, depth: int, stale: int):
    """What the routing programs say the ground-segment run delivers and
    covers per round: satellite 2 lost after round 1, replayed with the
    launcher's schedule (2 antennas, 4 MiB payloads)."""
    from repro_torch.groundseg import routing
    from repro_torch.launch import train_fl_constellation as tfc

    rels = list(scn.plan.schedule(antennas=2, payload_bytes=tfc.PAYLOAD_BYTES).tdm)
    n, sinks = scn.n_nodes, scn.ground_ids
    router = routing.MultiWindowRouter(n, sinks, max_staleness_windows=stale,
                                       pipeline_depth=depth)
    out = []
    for rnd in range(GS_ROUNDS):
        live = set(range(n)) - ({tfc.GS_LOST_SATELLITE} if rnd > 1 else set())
        if depth == 1 and stale == 0:
            restricted = [r.restrict(live) for r in rels]
            sources = [v for v in range(n) if v in live and v not in sinks]
            up = routing.build_relay_program(restricted, n, sinks, sources=sources)
            down = routing.build_broadcast_program(restricted, n, sinks)
        else:
            wp = router.plan_window(rels, alive=live)
            up, down = wp.uplink, wp.downlink
        covered = len(down.covered - sinks) if down is not None else 0
        out.append((up.delivered_count(), covered, up, down))
    return out


def _compare_groundseg_exchange(params, scn) -> None:
    """One int8 ground-segment exchange on the trained params, through the
    kernels and through the plain versions (``quant_impl``): bit for bit.
    The round writes into the params it is given, so the kernels' pass runs
    on a copy and the plain pass on the params themselves."""
    import torch

    from repro_torch.core import fused
    from repro_torch.groundseg import aggregation
    from repro_torch.pytree import tree_map

    _, _, up, down = _gs_programs(scn, 1, 0)[-1]
    spec = fused.cached_spec(params)
    out = {}
    for impl in ("cuda", "ref"):
        start = tree_map(torch.clone, params) if impl == "cuda" else params
        mixed = aggregation.groundseg_round(start, up, down, pool=True,
                                            compression="int8", quant_impl=impl)
        del start
        out[impl] = fused.flatten_pytree(spec, mixed)["float32"]
        del mixed
    _assert_bits(out["cuda"], out["ref"], "groundseg int8 exchange, kernels vs plain")
    log(f"[groundseg] int8 exchange on the trained params ({out['cuda'].shape[0]} x "
        f"{out['cuda'].shape[1]}), kernels vs plain versions: bit for bit")


def phase_groundseg(device) -> dict:
    """The ground-segment path, each config driven through ``main_groundseg``
    with the launch counters zeroed just before and read just after.
    Returns the launches per kernel."""
    import math

    import torch

    from repro_torch import telemetry
    from repro_torch.kernels.tdm_compress import tdm_compress as kern
    from repro_torch.launch import train_fl_constellation as tfc

    launches = {name: 0 for name in kern.LAUNCHES}
    params = scn = None
    for comp, depth, stale in GS_CONFIGS:
        params = None               # the previous config's params, 6.2 GB
        tag = f"{comp} depth {depth} staleness {stale}"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        per_round = []

        def on_round(log_):
            per_round.append((log_, torch.cuda.max_memory_allocated(device)))
            torch.cuda.reset_peak_memory_stats(device)

        with telemetry.record_scope(tracing=True) as rec:
            kern.reset_launch_counts()
            t0 = time.perf_counter()
            res, scn = tfc.main_groundseg(
                GS_ROUNDS, device=device, compression=comp, pipeline_depth=depth,
                max_staleness=stale, layers=SLICE_LAYERS, seq=SLICE_SEQ,
                full_width=True, on_round=on_round,
            )
            torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
            counts = kern.launch_counts()

        def span_s(name):
            return [sp.dur_us / 1e6 for sp in rec.spans if sp.name == name]

        round_s = span_s("groundseg.round" if depth == 1 and stale == 0
                         else "groundseg.window")
        for (lg, mem), secs, local, mix in zip(
                per_round, round_s, span_s("groundseg.local_steps"),
                span_s("groundseg.exchange")):
            log(f"[groundseg] {tag} round {lg.round}  loss {lg.loss:.4f}  consensus "
                f"{lg.consensus:.3e}  delivered {lg.delivered}/{lg.alive}  covered "
                f"{lg.covered}  {'pooled' if lg.pooled else 'regional'}  round "
                f"{secs:.3f} s (local steps {local:.3f} s, exchange {mix:.3f} s)  "
                f"max mem {mem / 2**30:.1f} GiB")
        gathers = rec.get_counter("groundseg.exchange.gathers")
        reductions = rec.get_counter("groundseg.exchange.reductions")
        log(f"[groundseg] {tag}: {len(res.logs)} rounds in {wall:.1f} s; launches "
            f"{counts}; gathers {gathers:g} (oracle "
            f"{rec.get_counter('groundseg.collectives.collective-permute'):g}), "
            f"reductions {reductions:g} (oracle "
            f"{rec.get_counter('groundseg.collectives.all-reduce'):g})")
        logs = res.logs
        check(len(logs) == GS_ROUNDS and len(round_s) == GS_ROUNDS,
              f"{tag}: {len(logs)} rounds logged")
        check(all(math.isfinite(lg.loss) and math.isfinite(lg.consensus) for lg in logs),
              f"{tag}: non-finite loss or consensus")
        check([lg.alive for lg in logs] == [6, 6, 5],
              f"{tag}: satellite 2 not dropped after round 1")
        check([lg.pooled for lg in logs] == [True, False, True], f"{tag}: pooling")
        want = _gs_programs(scn, depth, stale)
        check([(lg.delivered, lg.covered) for lg in logs] == [w[:2] for w in want],
              f"{tag}: delivered/covered differ from the routing programs")
        check(gathers == rec.get_counter("groundseg.collectives.collective-permute")
              and reductions == rec.get_counter("groundseg.collectives.all-reduce"),
              f"{tag}: exchanges issued differ from the oracle")
        for name in kern.LAUNCHES:
            if name in GS_KERNELS[comp]:
                check(counts[name] > 1, f"{tag}: kernel {name} launched {counts[name]} times")
            else:
                check(counts[name] == 0, f"{tag}: kernel {name} launched unexpectedly")
            launches[name] += counts[name]
        params = res.state["params"]
        del res
    torch.cuda.empty_cache()
    _compare_groundseg_exchange(params, scn)
    del params
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# slice 3: the SSD scan and serving
# ---------------------------------------------------------------------------

def _ssd_inputs(gen, case, device, strong=False):
    """Model-layout inputs of the SSD scan: x, B, C ~ N(0, 1) in ``dtype``;
    dt and A as the model's init draws them (dt log-uniform in [1e-3, 0.1]
    through softplus of a dt bias, A = -U(1, 16)), or strong decay."""
    import math

    import torch

    B_, S, H, P, G, N, _chunk, dtype = case
    x = torch.randn(B_, S, H, P, generator=gen, device=device).to(dtype)
    Bv = torch.randn(B_, S, G, N, generator=gen, device=device).to(dtype)
    Cv = torch.randn(B_, S, G, N, generator=gen, device=device).to(dtype)
    if strong:
        dt = 0.05 + 0.05 * torch.rand(B_, S, H, generator=gen, device=device)
        A = torch.full((H,), -16.0, device=device)
    else:
        u = torch.rand(B_, S, H, generator=gen, device=device)
        dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
        A = -(1.0 + 15.0 * torch.rand(H, generator=gen, device=device))
    return x, dt.contiguous(), A, Bv, Cv


def _ssd_vs_plain(inputs, chunk: int, what: str) -> float:
    """The kernel against its plain version on the same inputs: y and the
    state finite and within ``ssd_tolerance``. Returns the max |diff|."""
    import torch

    from repro_torch.kernels.ssd_scan import ops, ref

    y, s = ops.ssd_scan(*inputs, chunk=chunk, impl="cuda")
    y_r, s_r = ops.ssd_scan(*inputs, chunk=chunk, impl="ref")
    torch.cuda.synchronize()
    check(y.dtype == inputs[0].dtype and s.dtype == torch.float32, f"{what}: dtypes")
    ok_y, err_y = ref.ssd_close(y, y_r)
    ok_s, err_s = ref.ssd_close(s, s_r)
    check(ok_y, f"{what}: y outside ssd_tolerance (max |diff| {err_y})")
    check(ok_s, f"{what}: state outside ssd_tolerance (max |diff| {err_s})")
    return max(err_y, err_s)


SSD_CASES = [
    # (B, S, H, P, G, N, chunk): chunks 8, 32, 64, 96 and 256, 1 to 4 chunks
    (2, 8, 4, 64, 1, 128, 8),
    (3, 32, 4, 64, 2, 128, 8),
    (1, 128, 2, 16, 1, 32, 32),
    (1, 128, 8, 64, 4, 128, 64),
    (2, 192, 4, 32, 2, 64, 64),
    (1, 192, 4, 64, 1, 128, 96),
    (1, 256, 4, 64, 1, 128, 256),
    (2, 1024, 2, 64, 2, 128, 256),
]


def phase_ssd_small(device) -> None:
    import torch

    gen = torch.Generator(device=device).manual_seed(13)
    worst = 0.0
    for case in SSD_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            full = case + (dtype,)
            worst = max(worst, _ssd_vs_plain(_ssd_inputs(gen, full, device), case[-1],
                                             f"ssd_scan {full}"))
    for dtype in (torch.bfloat16, torch.float32):
        full = (2, 512, 4, 64, 1, 128, 256, dtype)
        worst = max(worst, _ssd_vs_plain(_ssd_inputs(gen, full, device, strong=True), 256,
                                         f"ssd_scan strong decay {full}"))
    log(f"[ssd_scan] {2 * len(SSD_CASES) + 2} small/ragged/strong-decay cases within "
        f"ssd_tolerance of the plain version, y and state finite (max |diff| {worst:.3g})")


def _tokens_by_request(report) -> dict:
    return {r.rid: list(r.out) for r in report.requests}


def _device_busy(prof):
    """(total ms, {name: (ms, count)}) of the device-side activities
    (kernels, copies, sets) of a profile, read from the raw kineto events
    (building PyTorch's FunctionEvent tree for ~10^5 launches takes minutes)."""
    from torch.autograd import DeviceType

    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            ms, n = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
    return sum(ms for ms, _ in by_name.values()), by_name


def _wave_prefill_vs_plain(decoder, report, device) -> None:
    """One wave (the first four requests' prompts, left-padded to their
    bucket) through the SSD kernel and through its plain version, same
    params and tokens:

    - layer by layer, both fed the same input: each layer's SSM state
      within ``ssd_tolerance``, the conv tails equal, and the mixer's bf16
      output within ``OUT_ULPS`` bf16 ulps of the output's largest
      magnitude: a y entry may differ by one bf16 ulp, the gate, the norm
      and the output projection round again, and the projection mixes 3072
      such entries into each output, so the natural unit is the ulp at the
      tensor's scale, not the entry's own;
    - the whole prefill (``transformer.prefill``): the last-token logits and
      every layer's SSM state within ``SERVE_SPREAD`` times the plain path's
      own spread, i.e. its difference from the same prefill with the scan
      chunked at 128 instead of 256 (mathematically the same scan, rounded
      in another order). Later layers carry and amplify a layer's rounding
      differences, so a bound in ulps does not apply there.

    Also reports whether the wave's logits change when a second wave shares
    its prefill call (more rows)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.kernels.ssd_scan import ref
    from repro_torch.models import mamba2, transformer
    from repro_torch.models.layers import embed_tokens, rmsnorm
    from repro_torch.pytree import tree_map

    cfg, params = decoder.cfg, decoder.params
    prompts = [r.prompt for r in sorted(report.requests, key=lambda r: r.rid)[:SERVE_BATCH]]
    plen = decoder._bucket(max(len(p) for p in prompts))
    toks = np.zeros((SERVE_BATCH, plen), np.int64)
    for lane, p in enumerate(prompts):
        toks[lane, plen - len(p):] = p
    tokens = torch.from_numpy(toks).to(device)

    def scale_ulps(a, b):
        """max |a - b| in bf16 ulps of max |b| (the ulp of the top binade)."""
        a, b = a.float(), b.float()
        top = float(b.abs().max())
        ulp = 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 2.0 ** -133
        return float((a - b).abs().max()) / ulp

    worst_state = worst_out = 0.0
    with torch.no_grad():
        h = embed_tokens(params["embed"], tokens, cfg)
        for u in range(transformer.n_units(cfg)):
            p = tree_map(lambda t: t[u], params["units"])["L0"]
            hn = rmsnorm(h, p["ln"], cfg.norm_eps)
            out_k, c_k = mamba2.mamba_prefill(p["mamba"], hn, cfg, ssd_impl="cuda")
            out_r, c_r = mamba2.mamba_prefill(p["mamba"], hn, cfg, ssd_impl="ref")
            ok_s, err_s = ref.ssd_close(c_k.ssm, c_r.ssm)
            err_o = scale_ulps(out_k, out_r)
            check(ok_s and err_o <= OUT_ULPS and torch.equal(c_k.conv, c_r.conv),
                  f"wave prefill layer {u}, same input: state {err_s:.3g} (ssd_tolerance), "
                  f"output {err_o:.3g} bf16 ulps at scale (bound {OUT_ULPS}), or conv tails differ")
            worst_state, worst_out = max(worst_state, err_s), max(worst_out, err_o)
            h = h + out_r
        del h, hn, out_k, out_r, c_k, c_r

        def rel(a, b):
            a, b = a.float(), b.float()
            return float((a - b).abs().max() / b.abs().max())

        def whole(impl, chunk):
            c = cfg.replace(mamba=dataclasses.replace(cfg.mamba, chunk=chunk))
            logits, cache = transformer.prefill(params, tokens, c, decoder.max_len,
                                                ssd_impl=impl)
            return logits, cache["units"]["mamba0"].ssm

        lk, sk = whole("cuda", cfg.mamba.chunk)
        lr, sr = whole("ref", cfg.mamba.chunk)
        l2, s2 = whole("ref", cfg.mamba.chunk // 2)
    check(all(bool(torch.isfinite(t).all()) for t in (lk, lr, sk, sr)),
          "wave prefill: non-finite logits or states")
    kern_l, spread_l = rel(lk, lr), rel(l2, lr)
    kern_s = max(rel(sk[u], sr[u]) for u in range(sk.shape[0]))
    spread_s = max(rel(s2[u], sr[u]) for u in range(sk.shape[0]))
    same_top = bool((lk[:, -1].argmax(-1) == lr[:, -1].argmax(-1)).all())
    log(f"[serve] wave prefill (4 lanes, bucket {plen}), kernel vs plain versions: layer by "
        f"layer on the same input, states max |diff| {worst_state:.3g} (within "
        f"ssd_tolerance) and outputs up to {worst_out:.3g} bf16 ulps at their scale "
        f"(bound {OUT_ULPS}); whole prefill, last-token logits "
        f"{kern_l:.3g} and layer states up to {kern_s:.3g} of their scale, against the "
        f"plain path's own spread (chunk {cfg.mamba.chunk // 2} vs {cfg.mamba.chunk}) of "
        f"{spread_l:.3g} and {spread_s:.3g} (bound {SERVE_SPREAD}x); greedy tokens "
        f"{'equal' if same_top else 'differ'}")
    check(kern_l <= SERVE_SPREAD * spread_l and kern_s <= SERVE_SPREAD * spread_s,
          f"wave prefill, kernel vs plain: logits {kern_l:.3g}, states {kern_s:.3g} of "
          f"their scale, beyond {SERVE_SPREAD}x the plain path's spread "
          f"({spread_l:.3g}, {spread_s:.3g})")
    del sk, sr, s2, lr, l2
    # co-scheduling: the same wave folded with a second one into 8 lanes
    other = torch.flip(tokens, dims=[0])
    with torch.no_grad():
        lf, _ = transformer.prefill(params, torch.cat([tokens, other]), cfg, decoder.max_len)
    same = bool(torch.equal(lf[:SERVE_BATCH], lk))
    diff = float((lf[:SERVE_BATCH] - lk).abs().max())
    log(f"[serve] the wave's logits alone (4 lanes) vs folded with another wave (8 lanes): "
        f"{'bit-identical' if same else f'differ, max |diff| {diff:.3g}'}")


def phase_serving(device) -> dict:
    """The serving path through ``serve_constellation``'s entry points, the
    launch counters zeroed just before and read just after. Returns the
    ``ssd_scan`` launches of that run."""
    import torch

    from repro_torch import telemetry
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd_kern
    from repro_torch.kernels.tdm_compress import tdm_compress as tdm_kern
    from repro_torch.launch import serve_constellation as sc
    from repro_torch.pytree import tree_leaves

    def decoder():
        return sc.model_decoder(SERVE_ARCH, False, len(sc.REPLICAS), SERVE_BATCH,
                                SERVE_PROMPT, SERVE_MAX_NEW, 0, device)

    def serve(dec, cfg):
        return sc.run(decoder=dec, vocab=cfg.vocab_size, requests=SERVE_REQUESTS,
                      batch=SERVE_BATCH, max_new=SERVE_MAX_NEW, prompt_len=SERVE_PROMPT,
                      log=lambda m: log(f"[serve] {m.strip()}"))

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg, dec = decoder()
    torch.cuda.synchronize(device)
    log(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.mamba.n_heads(cfg.d_model)} SSM heads x {cfg.mamba.head_dim}, d_state "
        f"{cfg.mamba.d_state}, chunk {cfg.mamba.chunk}, vocab {cfg.vocab_size}, params "
        f"{sum(t.numel() for t in tree_leaves(dec.params)) / 1e6:.1f} M f32 (seed 0), "
        f"{cfg.compute_dtype} compute; decoder built in {time.perf_counter() - t0:.1f} s")
    check(cfg.n_layers == SERVE_LAYERS, f"{cfg.name} has {cfg.n_layers} layers")
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    with telemetry.record_scope(tracing=True) as rec:
        ssd_kern.reset_launch_counts()
        tdm_kern.reset_launch_counts()
        t0 = time.perf_counter()
        res = serve(dec, cfg)
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        launches = ssd_kern.launch_counts()["ssd_scan"]
        tdm_launches = tdm_kern.launch_counts()
    peak = torch.cuda.max_memory_allocated(device)
    summ = res.report.summary()
    prefill_calls = int(rec.get_counter("serve.prefill.calls"))
    prefills = [sp for sp in rec.spans if sp.name == "serve.prefill"]
    decodes = [sp for sp in rec.spans if sp.name == "serve.decode"]
    for sp in prefills:
        log(f"[serve] prefill call: bucket {sp.args['bucket']}, {sp.args['lanes']} lanes, "
            f"{sp.dur_us / 1e3:.1f} ms")
    dms = sorted(sp.dur_us / 1e3 for sp in decodes)
    model_s = sum(sp.dur_us for sp in prefills + decodes) / 1e6
    log(f"[serve] decode: {len(decodes)} fleet ticks, ms per tick mean "
        f"{sum(dms) / len(dms):.1f} (min {dms[0]:.1f}, median {dms[len(dms) // 2]:.1f}, "
        f"max {dms[-1]:.1f}); 4-lane ticks {sum(1 for sp in decodes if sp.args['lanes'] == 4)}, "
        f"8-lane {sum(1 for sp in decodes if sp.args['lanes'] == 8)}")
    log(f"[serve] run: {wall:.2f} s wall, {model_s:.2f} s in model calls (host clock, each "
        f"call ends in a copy of its tokens to the host), peak {peak / 2**30:.2f} GiB "
        f"({(peak - base) / 2**30:.2f} GiB above the params and caches)")
    for name in sorted(n for n in rec.counters if n.startswith("serve.")):
        log(f"[serve]   {name} = {rec.counters[name]:g}")
    check(summ["delivered"] == summ["n_requests"] == SERVE_REQUESTS and not summ["undelivered"],
          f"serving delivered {summ['delivered']}/{summ['n_requests']}")
    check(all(len(r.out) == SERVE_MAX_NEW for r in res.report.requests),
          "a request was delivered without its 16 tokens")
    check(res.verdict.ok, f"serving audit: {len(res.verdict.violations)} violations")
    check(summ["retries"] > 0, "the mid-epoch failure re-routed nothing")
    check(prefill_calls > 0 and launches == cfg.n_layers * prefill_calls,
          f"ssd_scan launched {launches} times for {prefill_calls} prefill calls")
    check(all(v == 0 for v in tdm_launches.values()), f"tdm kernels on the serving path: {tdm_launches}")
    check(any(sp.args["bucket"] == 512 for sp in prefills), "no two-chunk prefill (bucket 512)")
    log(f"[serve] {summ['delivered']}/{summ['n_requests']} delivered x {SERVE_MAX_NEW} tokens, "
        f"audit OK ({res.verdict.n_hops} hops), {summ['retries']} retries; ssd_scan "
        f"launches {launches} = {cfg.n_layers} x {prefill_calls} prefill calls")

    _wave_prefill_vs_plain(dec, res.report, device)
    tokens = _tokens_by_request(res.report)
    del dec, res
    torch.cuda.empty_cache()

    # the same workload again on a fresh decoder, under the profiler
    _, dec2 = decoder()
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with telemetry.record_scope(tracing=False):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            res2 = serve(dec2, cfg)
            torch.cuda.synchronize(device)
    log(f"[serve] profiled replay: {time.perf_counter() - t0:.1f} s")
    check(_tokens_by_request(res2.report) == tokens,
          "a second run of the same workload gave other token streams")
    busy_ms, by_name = _device_busy(prof)
    generated = SERVE_REQUESTS * SERVE_MAX_NEW
    if busy_ms > 0:
        log(f"[serve] replay on a fresh decoder: token streams bit-identical; device busy "
            f"{busy_ms:.1f} ms (torch.profiler) -> {generated / (busy_ms / 1e3):.0f} generated "
            f"tokens/s of device time; busy share of the first run's model-call time "
            f"{busy_ms / 1e3 / model_s:.1%}; {sum(n for _, n in by_name.values())} device "
            f"activities")
        for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
            log(f"[serve]   device {ms:8.1f} ms {n:6d}x  {name[:110]}")
    else:
        log("[serve] replay on a fresh decoder: token streams bit-identical; device time "
            "not measured (the profiler recorded no device events)")
    _split_one_call(dec2, res2.report, device)
    del dec2, res2, prof
    torch.cuda.empty_cache()
    return {"ssd_scan": launches}


def _split_one_call(dec, report, device) -> None:
    """Host wall against device busy time of one 4-lane prefill (the first
    wave's prompts) and one 4-lane decode tick, each timed once unprofiled
    (host clock, ending in the copy of its tokens) and once under the
    profiler."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    prompts = [r.prompt for r in sorted(report.requests, key=lambda r: r.rid)[:SERVE_BATCH]]
    one = np.array([True, False])
    calls = {
        f"prefill (4 lanes, bucket {dec._bucket(max(len(p) for p in prompts))})":
            lambda: dec.prefill_waves({0: prompts}),
        "decode tick (4 lanes)": lambda: dec.step(one),
    }
    for what, fn in calls.items():
        fn()
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize(device)
        busy, by_name = _device_busy(prof)
        ssd = sum(ms for name, (ms, _) in by_name.items() if "ssd_scan" in name)
        log(f"[serve] one {what}: host {host_ms:.1f} ms, device busy {busy:.1f} ms "
            f"({busy / host_ms:.0%}) in {sum(n for _, n in by_name.values())} activities"
            f"{f', ssd_scan {ssd:.1f} ms' if ssd else ''}")


SSD_SLICE = (2 * SERVE_BATCH, 512, 48, 64, 1, 128, 256)   # (B, S, H, P, G, N, chunk)


def phase_ssd_slice(device, power_note: str) -> dict:
    """``ssd_scan`` at the serving prefill's shape with both replicas
    admitted (mamba2-780m: 48 heads x 64, one group of state 128, S 512 in
    chunks of 256), against its plain version, timed, with its bound."""
    import torch

    from repro_torch.kernels.ssd_scan import ops

    B_, S, H, P, G, N, Q = SSD_SLICE
    case = (B_, S, H, P, G, N, Q, torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(17)
    inputs = _ssd_inputs(gen, case, device)
    err = _ssd_vs_plain(inputs, Q, f"ssd_scan at the serving shape {case}")
    ms = time_ms(lambda: ops.ssd_scan(*inputs, chunk=Q, impl="cuda"), reps=20)
    plain = time_ms(lambda: ops.ssd_scan(*inputs, chunk=Q, impl="ref"), reps=5)
    rows, chunks = B_ * H, S // Q
    # float32 operations the inputs need, triangle s <= t only: C.B^T and
    # W.x on the triangle, C.S_prev and the state update
    flops = rows * chunks * (N * Q * (Q + 1) + P * Q * (Q + 1) + 2 * Q * N * P + 2 * Q * P * N)
    nbytes = (2 * B_ * S * H * P * 2         # x in, y out (bf16)
              + 2 * B_ * S * G * N * 2       # B and C (bf16), the group's rows once
              + B_ * S * H * 4 + H * 4       # dt, A
              + B_ * H * P * N * 4)          # final state (f32)
    op_ms, byte_ms = flops / F32_FLOPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(op_ms, byte_ms)
    log(f"[kernels] ssd_scan at the serving prefill shape (B {B_}, S {S}, H {H}, P {P}, "
        f"G {G}, N {N}, chunk {Q}, bf16): {ms:.3f} ms, bound {bound_ms:.3f} ms "
        f"({bound_ms / ms:.1%}; {flops / 1e9:.2f} GFLOP -> {op_ms:.3f} ms at 67 TFLOP/s, "
        f"{nbytes / 1e6:.1f} MB -> {byte_ms:.3f} ms at 3.35 TB/s), plain {plain:.3f} ms, "
        f"library null (no single PyTorch call computes the chunked SSD scan), "
        f"max_abs_err {err:.3g}  [{power_note}]")
    return {
        "name": "ssd_scan", "route": "cuda", "source": SOURCES["ssd_scan"],
        "replaces": REPLACES["ssd_scan"], "launches": 0, "max_abs_err": err,
        "ms": ms, "plain_ms": plain, "bound_ms": bound_ms,
        "bound_by": "operations" if op_ms >= byte_ms else "bytes", "library_ms": None,
    }


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a checkout "
              "of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    def mark(what):
        log(f"[time] {what} done at {time.perf_counter() - t_start:.1f} s")

    dev = phase_device()
    device = torch.device("cuda", 0)
    phase_build()
    mark("build")
    phase_kernels_small(device)
    phase_ssd_small(device)
    mark("small kernel cases")
    serve_launches = phase_serving(device)
    mark("serving")
    launches, buf, k_b = phase_slice(device)
    mark("slice 1")
    gs_launches = phase_groundseg(device)
    mark("slice 2")
    kernels = phase_kernels_slice(device, buf, k_b, dev["card"])
    for row in kernels:
        row["launches"] = launches[row["name"]] + gs_launches[row["name"]]
    del buf
    torch.cuda.empty_cache()
    ssd_row = phase_ssd_slice(device, dev["card"])
    ssd_row["launches"] = serve_launches["ssd_scan"]
    kernels.append(ssd_row)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(dev["card"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["kind"],
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
