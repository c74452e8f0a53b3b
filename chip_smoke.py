#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions;
2. build: compiles ``src/repro_torch/csrc/tdm_compress.cu``,
   ``ssd_scan.cu`` and ``flash_attention.cu`` with nvcc (``sm_90a``), one
   process per source started together, and prints the build times and
   ptxas' per-kernel report;
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
   that call. Top-k and its scatter have two kernel paths each, split at
   ``TOPK_SELECT_MAX_K`` in the wrapper: the small cases run k in {0, 1, 7,
   TOPK_SELECT_MAX_K, TOPK_SELECT_MAX_K + 1, 64, block} on normal, edge and
   all-equal payloads and check from the launch counters that each k took
   its path;
   The SSD-scan kernel is held to its plain version on small and ragged
   cases (chunks 8, 64, 96 and 256, one to four chunks, groups 1, 2 and 4,
   head dims 16 to 64, states 32 to 128, bf16 and float32 inputs) and on
   strong decay at chunk 256 (A = -16, dt 0.05-0.1: the exponent above the
   diagonal passes 88, so exp before the mask would be inf): y and the state
   finite and within ``ssd_scan.ref.ssd_tolerance`` (1e-4 of the output's
   scale, plus one bf16 ulp for bf16 outputs). Both attention entry points
   are held to their plain version within
   ``flash_attention.ref.fa_tolerance`` (1e-5 of the output's scale, plus
   one bf16 ulp of each entry for bf16 outputs) on prefill cases of head
   dim 16 to 256, G 1, 2 and 4, causal and not, windows below and above S,
   softcap 50 and none, S 1 to 4608 (ragged tiles included; S 4608 puts
   gemma2-9b's local mask at its window of 4096 on the card) and decode
   cases with per-row kv_len of 1, a middle value and the full cache, and
   against caches of 4096 and 8192 slots (many chunks of the split-KV
   decode; kv_len 1, one past a chunk edge, full), bf16 and float32; every
   case launched twice, bit-identical; the launch counters (counted by the
   kernel the C side reports it launched) show every bf16 prefill on the
   tensor-core kernel and no float32 one; the serving-shape decode queued
   alternately on two streams, and replayed from a CUDA graph, equals one
   launch bit for bit; both at their 8-lane serving shapes by
   ``torch.profiler`` (the serving phases' instrument), CUDA events and
   CUDA-graph replay, logged side by side, and the bf16 ``ssd_scan``'s
   three launches at 8 and 4 lanes by the profiler, pass by pass;
3b. gemma2-9b smoke edges (``repro_torch.serving.edge_check``, which the
   card tests run too): the smoke config (window 16) through
   ``ModelDecoder``, one prefill call admitting both replicas with prompts
   of 129-256 tokens (a bucket-256 wave), 24 ticks past the window (the
   local rings engaged): in float32 the tokens equal a CPU decoder's, in
   bf16 the launches are one per layer per call and the first local and
   global layers' attention (prompt and caches) within ``fa_tolerance``;
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
4b. slice 4, serving gemma2-9b at its published config, **all 42 layers**
   (9.24 B f32 params, 36.97 GB, one copy for both replicas), random
   weights from seed 0, the same scenario and workload as 4. Checks: every
   request delivered with 16 tokens, the audit clean,
   ``flash_attention_fwd`` launched 42 times per prefill call and
   ``flash_attention_decode`` 42 times per decode tick, every prefill
   launch on the tensor-core kernel, no other kernel; a
   replay on a fresh decoder (the first one freed: two copies of the params
   do not fit) under ``torch.profiler`` gives the same token streams bit for
   bit; one wave's prefill through the kernel and through the plain version,
   layer by layer on the same input (attention within ``fa_tolerance``, the
   sub-layer output within 2 bf16 ulps of its largest magnitude, K/V cache
   entries bit-identical), and the whole prefill's last-token logits within
   4x the plain path's own spread (the same prefill with p rounded to bf16
   before the PV product, as the reference's prefill attention computes).
   Prints prefill ms per call with its bucket and lanes, decode ms per tick,
   generated tokens per second of device time, the busy share, the device
   time by kind of kernel, ``lm_logits``' time, peak GiB and the
   ``serve.*`` counters;
4c. slice 11, serving the MoE family (``[moe]`` lines): qwen3-moe-30b-a3b
   at its published widths (d_model 2048, 32 / 4 heads x 128, 128 experts
   top-8 of d_ff 768, capacity factor 1.25, vocab 151 936 tied), depth cut
   to 24 of 48 layers (15.27 B f32 params, 61.1 GB; 48 layers are 120.9
   GB), built with ``ModelDecoder`` directly, random weights from seed 0,
   the same scenario and workload as 4. First one MoE layer at the
   published widths (layer 0's params copied to the CPU, B 1 x S 512 of a
   bf16 x from a seed) on the card, with TF32 switched on around the call,
   and on the CPU: ``top_e``, the token table, the slots and the drop count
   equal, the output within 2e-2 of its scale (the tests' bf16 bound).
   Then the run, the counters zeroed just before and read just after and
   ``moe.count_drops`` tallying: every request delivered with 16 tokens,
   the audit clean, ``flash_attention_fwd`` launched 24 times per prefill
   call (all on the tensor-core kernel) and ``flash_attention_decode`` 24
   times per tick, no other kernel, the peak under 74 GiB; the dropped
   share of routed assignments at prefill and at decode; a replay on a
   fresh decoder under ``torch.profiler``, bit-identical, with device time
   by kind; one 4-lane prefill and tick split into host and device time;
   then the attention kernels at the cell's shapes (G 8, hd 128, no
   softcap: ``kernels/flash_attention/cases.py``'s serving cases against
   their plain versions, and the 8- and 4-lane prefill and 8-lane decode
   timed beside their bounds and ``flex_attention``);
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
6b. slice 8, the rest of the paper's exchange layer, at the same widths and
   depth: (a) two-level (pod x data) FL through
   ``fl_train.build_hierarchical_fl_round`` on 2 orbital planes x 4
   satellites (intra a clique of the plane's 4, inter the one link between
   the planes, the reference worker's relations), 3 rounds each of none and
   int8 from the same start, the counters zeroed around each: losses
   finite, every round's gathers equal to
   ``expected_hierarchical_collectives``, ``quantize`` and
   ``dequant_accumulate`` launched under int8 and not under none; one
   uncompressed mix of the none run's params buffer equal to per-leaf
   ``hierarchical_gossip`` bit for bit and to the global node mean within
   1e-5, the int8 mix through the kernels within 2% of it, and each int8
   level through the kernels within the fused/unfused bound of the plain
   versions on the same input; (b) one per-leaf compressed round
   (``tdm_fla_round(fused=False)``) of each of int8 and top-k over the int8
   run's params: finite, 2 gathers per matching per leaf, int8 within 2% of
   the same algebra unquantized; (c) ``run_constellation_fl(optimize="rate")``
   on slice 1's scenario, 3 rounds uncompressed: each round's relation a
   matching of its step's visibility relation, losses finite, gathers equal
   to the oracle. Prints round, local-step and exchange seconds, peak
   memory, each per-leaf mode's seconds and the ``fl.build_schedule``
   seconds;
6c. slice 9, dense training (after the exchange kernels' timings, so the
   FL buffer is freed): (a) ``flash_attention_bwd`` and the forward's lse
   against their plain versions (``kernels/flash_attention/cases.py``, f32
   and bf16, windows with edges inside tiles, one biting at S 1024, G 1-4
   and MQA, head dims 16-256, ragged S), each case twice and
   bit-identical; (b) gemma2-9b at its published widths with 8 of 42
   layers through ``launch/steps.build_train_step`` on ``SyntheticStream``
   at S 4096 (train_4k's sequence), batch 2, 4 steps with
   ``launch/train.py``'s ``OptConfig``, the launch counters zeroed just
   before and read just after: per step the loss, grad norm, host step
   time and tokens/s, the peak memory, the attention launches against
   their oracle (remat: 2 forward and 1 backward per attention layer and
   step), every loss finite and the loss of step 0's batch lower after the
   4 steps than before, then one more step under ``torch.profiler`` (device
   time by kind); (c) on the smoke config a micro-2 step on the card
   against the CPU and a checkpoint round trip on the card, bit for bit;
   then ``flash_attention_bwd`` at the cell's shape against its plain
   version, timed beside its bound and flex_attention's backward;
7. timing: the six exchange kernels at slice 1's shape (see 3; top-k and
   the scatter at the CHOCO round's k, on their select paths) and, logged
   beside them, the select path at k = TOPK_SELECT_MAX_K and the sort and
   shared-memory scatter paths at TOPK_SELECT_MAX_K + 1, each checked
   against its plain version and timed beside its bound and library call;
   ``ssd_scan`` at the serving prefill's shape with both replicas admitted
   (8 lanes x 48 heads, S 512, chunk 256, bf16; the ``kernels`` row) and at
   the served 4 lanes, each beside its bound: the larger of the bytes it
   must move over 3.35 TB/s and its operations (the triangle s <= t only)
   over 989 TFLOP/s, the bf16 tensor-core rate (bytes; the float32 rate's
   67 TFLOP/s, which bounded the first port's kernel, logged beside it),
   and four launches on one input bit-identical; both attention
   entry points at gemma2-9b's serving shapes (prefill 8 lanes x 16 heads,
   S 512, hd 256, causal, softcap 50, bf16; decode 8 lanes against a
   529-slot cache; each also at the served 4 lanes), by the CUDA-event time
   of eager calls like every other row (where a wrapper costs the host more
   than its kernel costs the card, the host's time per call)
   and by device time per call from CUDA-graph replays (``graph_ms``),
   each beside its bound (the larger of the bytes of q, k, v and out at
   3.35 TB/s and the operations at the bf16 tensor-core rate: bytes for
   both), the library call (``flex_attention`` under ``torch.compile`` with
   the softcap as a ``score_mod`` and the causal or kv_len mask as a
   ``mask_mod``: the same function; null with the error if it does not
   build) and ``F.scaled_dot_product_attention`` on the same tensors, which
   has no softcap and so is only logged.

Prints a ``{"kernels": [...]}`` line, then ``{"ok": true, "device": ...}``
as the last line. Exits non-zero when no CUDA device is present or the
repository's ``src/`` is missing.
"""

from __future__ import annotations

import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet, at the 700 W limit
BF16_FLOPS_PER_S = 989e12      # dense bf16 on the tensor cores, same sheet
F32_FLOPS_PER_S = 67e12        # float32 outside the tensor cores, same sheet
SOURCES = {
    "tdm_compress": "src/repro_torch/csrc/tdm_compress.cu",
    "ssd_scan": "src/repro_torch/csrc/ssd_scan.cu",
    "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
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
    "flash_attention_fwd": "src/repro/kernels/flash_attention/flash_attention.py:100",
    "flash_attention_decode": "src/repro/kernels/flash_attention/flash_attention.py:100",
    # no Pallas kernel: the reference's backward is pure JAX under a custom_vjp
    "flash_attention_bwd": "src/repro/models/attention.py:211",
}
SLICE_NODES = 8
SLICE_LAYERS = 8            # mamba2-780m has 48; cut for memory (8 stacked nodes)
SLICE_ROUNDS = 3
SLICE_SEQ = 256             # tokens per row; 4 rows per node and local step
# ground segment: (compression, pipeline depth, staleness horizon)
GS_CONFIGS = (("none", 1, 0), ("int8", 1, 0), ("int8", 2, 1))
GS_ROUNDS = 3
GS_KERNELS = {"none": (), "int8": ("quantize_scaled", "quantize", "dequant_accumulate")}
# slice 8: two-level FL, pod = orbital plane of ShellSpec(planes=2, per_plane=4)
HIER_PODS, HIER_DATA = 2, 4
HIER_ROUNDS = 3
HIER_KERNELS = {"none": (), "int8": ("quantize", "dequant_accumulate")}
OPT_ROUNDS = 3
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
    from repro_torch.kernels.flash_attention import flash_attention as fa_kern
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd_kern
    from repro_torch.kernels.tdm_compress import tdm_compress as kern

    t0 = time.perf_counter()
    build_lib.load_many(list(SOURCES))       # one nvcc per source, in parallel
    kern.library()
    ssd_kern.library()
    fa_kern.library()
    log(f"[build] {len(SOURCES)} sources built and loaded in {time.perf_counter() - t0:.1f} s")
    for name in SOURCES:
        rec = build_lib.build_record(name)
        log(f"[build] {name}.cu: nvcc {rec['seconds']:.1f} s (built={rec['built']})")
        for line in rec["ptxas"].splitlines():
            if any(t in line for t in ("Used", "spill", "Compiling entry", "arning")):
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
    sel = kern.TOPK_SELECT_MAX_K
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
            _topk_small(x, acc, w, rows, n, block, kind)
            cases += 1
        # every key equal: only the lowest-index rule picks
        _topk_small(torch.full((rows, n), -0.75, device=device), acc, w, rows, n, block,
                    "all-equal")
    torch.cuda.synchronize()
    log(f"[kernels] small/ragged/edge cases: all equal to the plain versions "
        f"({cases} payloads, blocks 64..4096; top-k and scatter at k in "
        f"{{0, 1, 7, {sel}, {sel + 1}, 64, block}} on both paths; "
        f"quantize_scaled and dequantize with shared and per-row scales, "
        f"NaN/inf payloads and scales, bit for bit)")


def _topk_small(x, acc, w, rows: int, n: int, block: int, kind: str) -> None:
    """Both kernels at every k regime on one payload, each k on the path it
    belongs to: top-k bit for bit, the scatter within one rounding."""
    import torch

    from repro_torch.kernels.tdm_compress import ref
    from repro_torch.kernels.tdm_compress import tdm_compress as kern

    sel = kern.TOPK_SELECT_MAX_K

    def on_path(k, select, large, tag):
        counts = kern.launch_counts()
        want = select if k <= sel else large
        check(k == 0 or counts[want] == 1, f"{tag}: {want} not launched ({counts})")
        kern.reset_launch_counts()

    for k in sorted({0, 1, 7, sel, sel + 1, min(64, block), block}):
        if k > block:
            continue
        tag = f"{rows}x{n}/{block} k={k} {kind}"
        kern.reset_launch_counts()
        d, v, i = kern.topk_sparsify_fwd(x, k, block=block)
        on_path(k, "topk_sparsify", "topk_sparsify_sort", f"topk {tag}")
        d_r, v_r, i_r = ref.topk_sparsify_ref(x, k, block)
        _assert_bits(d, d_r, f"topk dense {tag}")
        _assert_bits(v, v_r, f"topk vals {tag}")
        _assert_bits(i, i_r, f"topk idxs {tag}")
        if kind == "edge":
            continue  # inf * w sums make NaN, compared above as bits
        got = kern.scatter_accumulate_fwd(v, i, acc, w, block=block)
        on_path(k, "scatter_accumulate", "scatter_accumulate_shared", f"scatter {tag}")
        want = ref.scatter_acc_ref(v_r, i_r, acc, w, block)
        dense_w = ref.scatter_acc_ref(v_r, i_r, torch.zeros_like(acc), 1.0, block)
        _assert_fma(got, want, w[:, None] * dense_w, f"scatter_accumulate {tag}")


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
    del v, i, accv, wv, iv
    torch.cuda.empty_cache()
    _time_topk_paths(x, acc, w, block, power_note)
    del acc
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


def _time_topk_paths(x, acc, w, block: int, power_note: str) -> None:
    """Both top-k paths off the main path at the slice's shape: the select
    at its largest k and the sort (and the shared-memory scatter) at the
    smallest k above it, each checked against its plain version. Logged
    only: the kernels line lists the main path's kernels."""
    import torch

    from repro_torch.kernels.tdm_compress import ref
    from repro_torch.kernels.tdm_compress import tdm_compress as kern

    rows, n = x.shape
    nb = n // block
    sel = kern.TOPK_SELECT_MAX_K
    for k in (sel, sel + 1):
        path = "select" if k <= sel else "sort"
        d, v, i = kern.topk_sparsify_fwd(x, k, block=block)
        d_r, v_r, i_r = ref.topk_sparsify_ref(x, k, block)
        _assert_bits(d, d_r, f"topk dense at slice shape, k={k}")
        _assert_bits(v, v_r, f"topk vals at slice shape, k={k}")
        _assert_bits(i, i_r, f"topk idxs at slice shape, k={k}")
        del d, d_r, v_r, i_r
        ms = time_ms(lambda: kern.topk_sparsify_fwd(x, k, block=block), reps=3)
        plain = time_ms(lambda: ref.topk_sparsify_ref(x, k, block), reps=2)
        xv = x.view(rows * nb, block)
        lib = time_ms(lambda: torch.topk(xv.abs(), k, dim=1), reps=3)
        bound = (rows * n * 8 + rows * nb * k * 8) / HBM_BYTES_PER_S * 1e3
        log(f"[kernels] topk_sparsify {path} path, k={k}: {ms:.3f} ms  bound {bound:.3f} ms "
            f"({bound / ms:.1%})  plain {plain:.3f} ms  library {lib:.3f} ms (torch.topk)  "
            f"bit for bit [{power_note}]")
        if k > sel:
            got = kern.scatter_accumulate_fwd(v, i, acc, w, block=block)
            want = ref.scatter_acc_ref(v, i, acc, w, block)
            prod = w[:, None] * ref.scatter_acc_ref(v, i, torch.zeros_like(acc), 1.0, block)
            err = _assert_fma(got, want, prod, f"scatter_accumulate at slice shape, k={k}")
            del got, want, prod
            ms = time_ms(lambda: kern.scatter_accumulate_fwd(v, i, acc, w, block=block),
                         reps=5)
            plain = time_ms(lambda: ref.scatter_acc_ref(v, i, acc, w, block), reps=2)
            accv = acc.view(rows * nb, block)
            wv = (w[:, None, None] * v).reshape(rows * nb, k)
            iv = i.reshape(rows * nb, k).to(torch.int64)
            lib = time_ms(lambda: accv.scatter_add(1, iv, wv), reps=5)
            bound = (rows * n * 8 + rows * nb * k * 8 + rows * 4) / HBM_BYTES_PER_S * 1e3
            log(f"[kernels] scatter_accumulate shared path, k={k}: {ms:.3f} ms  bound "
                f"{bound:.3f} ms ({bound / ms:.1%})  plain {plain:.3f} ms  library "
                f"{lib:.3f} ms (scatter_add)  max_abs_err {err:.3g} [{power_note}]")
            del accv, wv, iv
        del v, i
        torch.cuda.empty_cache()


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
# slice 8: the rest of the paper's exchange layer
# ---------------------------------------------------------------------------

def _hier_rels():
    """The reference worker's relations: a clique of the 4 satellites of a
    plane, and the one link between the 2 planes."""
    from repro_torch.core.relation import Relation

    return (Relation.clique(list(range(HIER_DATA))),
            Relation.from_edges([(0, 1)], nodes=range(HIER_PODS)))


def _fl_setup(device):
    from repro_torch.launch import fl_train
    from repro_torch.launch import train_fl_constellation as tfc

    cfg, opt_cfg, shape, scn = tfc.setup(tfc.N_SATS, SLICE_ROUNDS, layers=SLICE_LAYERS,
                                         seq=SLICE_SEQ, full_width=True)
    state = fl_train._stack_init(0, cfg, opt_cfg, tfc.N_SATS, device=device)
    return cfg, opt_cfg, shape, scn, state


def _rel_err(got, want) -> float:
    return float((got - want).norm() / want.norm())


def _check_hier_mix(params) -> None:
    """One two-level mix of the trained params' buffer: uncompressed equal to
    per-leaf ``hierarchical_gossip`` bit for bit and to the global node mean
    within 1e-5 (the clique and the one inter-plane link average exactly);
    int8 through the kernels within 2% of it; and each int8 level through the
    kernels within the fused/unfused bound of the plain versions on the same
    input (a level's last-bit differences may flip a code of the next one,
    so the levels are compared apart)."""
    import torch

    from repro_torch.core import fused, tdm
    from repro_torch.core.relation import Relation
    from repro_torch.pytree import tree_map

    intra, inter = _hier_rels()
    none_intra = Relation.from_edges([], nodes=range(HIER_DATA))
    none_inter = Relation.from_edges([], nodes=range(HIER_PODS))
    spec = fused.cached_spec(params)
    (bucket,) = spec.buckets
    buf = fused.flatten_pytree(spec, params)[bucket]
    none = fused.hierarchical_buffer_mix(buf, intra, inter, HIER_DATA, HIER_PODS)
    per_leaf = tree_map(lambda x: tdm.hierarchical_gossip(x, intra, inter, HIER_DATA, HIER_PODS),
                        params)
    leaf_buf = fused.flatten_pytree(spec, per_leaf)[bucket]
    del per_leaf
    _assert_bits(none, leaf_buf, "two-level none mix vs per-leaf hierarchical_gossip")
    del leaf_buf
    mean = buf.mean(dim=0, keepdim=True)
    mean_err = float((none - mean).abs().max() / mean.abs().max())
    check(mean_err <= 1e-5, f"two-level none mix vs global mean: {mean_err:.3g} > 1e-5")
    del mean
    int8 = fused.hierarchical_buffer_mix(buf, intra, inter, HIER_DATA, HIER_PODS,
                                         compression="int8", quant_impl="cuda")
    err8 = _rel_err(int8, none)
    check(err8 < 0.02, f"two-level int8 mix vs none: {err8:.4f} >= 2%")
    whole = float((int8 - fused.hierarchical_buffer_mix(
        buf, intra, inter, HIER_DATA, HIER_PODS, compression="int8", quant_impl="ref")
    ).abs().max())
    del int8, none
    gaps = []
    x = buf
    for a, b, m in ((intra, none_inter, len(tdm.edge_coloring(intra))),
                    (none_intra, inter, len(tdm.edge_coloring(inter)))):
        got = fused.hierarchical_buffer_mix(x, a, b, HIER_DATA, HIER_PODS,
                                            compression="int8", quant_impl="cuda")
        want = fused.hierarchical_buffer_mix(x, a, b, HIER_DATA, HIER_PODS,
                                             compression="int8", quant_impl="ref")
        check(_mix_bound_ok(got, want, x, m), "two-level int8 level, kernels vs plain, "
              "outside the bound")
        gaps.append(float((got - want).abs().max()))
        del got
        x = want
    del x, want, buf
    torch.cuda.empty_cache()
    log(f"[slice8] two-level mix of the trained params: none == per-leaf "
        f"hierarchical_gossip bit for bit, vs the global mean {mean_err:.3g} (<= 1e-5); "
        f"int8 vs none {err8:.4f} (< 2%); int8 kernels vs plain per level max |diff| "
        f"{gaps[0]:.3g} / {gaps[1]:.3g} (within the bound), whole round {whole:.3g}")


def _hier_fl(device) -> tuple:
    """Two-level FL through ``build_hierarchical_fl_round``: 3 rounds each of
    none and int8 from the same start, the counters zeroed around each.
    Returns (launches per kernel, the int8 run's params)."""
    import math

    import torch

    from repro_torch import telemetry
    from repro_torch.core import tdm
    from repro_torch.kernels.tdm_compress import tdm_compress as kern
    from repro_torch.launch import fl_train
    from repro_torch.launch import train_fl_constellation as tfc

    intra, inter = _hier_rels()
    launches = {name: 0 for name in kern.LAUNCHES}
    params = None
    for mode in ("none", "int8"):
        params = None
        torch.cuda.empty_cache()
        cfg, opt_cfg, shape, _, state = _fl_setup(device)
        batch_fn = tfc.make_batch_fn(cfg, shape, tfc.N_SATS)
        fn = fl_train.build_hierarchical_fl_round(
            cfg, opt_cfg, HIER_PODS, HIER_DATA,
            fl_train.FLConfig(mode="tdm", local_steps=tfc.LOCAL_STEPS, compression=mode),
            intra, inter)
        oracle = telemetry.expected_hierarchical_collectives(
            intra, inter, 1, compression=mode)["collective-permute"]
        with telemetry.record_scope(tracing=True) as rec:
            kern.reset_launch_counts()
            for rnd in range(HIER_ROUNDS):
                batch = fl_train.batch_to_device(batch_fn(rnd), device)
                torch.cuda.reset_peak_memory_stats(device)
                before = tdm.gather_count()
                with rec.span("fl.round", cat="slot", round=rnd):
                    state, losses = fn(state, batch)
                    torch.cuda.synchronize(device)
                gathers = tdm.gather_count() - before
                loss = float(losses.mean())
                span = {sp.name: sp.dur_us / 1e6 for sp in rec.spans[-3:]}
                log(f"[slice8] two-level {mode:<4} round {rnd}  loss {loss:.4f}  round "
                    f"{span['fl.round']:.3f} s (local steps {span['fl.local_steps']:.3f} s, "
                    f"exchange {span['fl.exchange']:.3f} s)  gathers {gathers} (oracle "
                    f"{oracle})  max mem {torch.cuda.max_memory_allocated(device) / 2**30:.1f} GiB")
                check(math.isfinite(loss) and bool(torch.isfinite(losses).all()),
                      f"two-level {mode} round {rnd}: non-finite loss")
                check(gathers == oracle, f"two-level {mode} round {rnd}: {gathers} gathers, "
                      f"the oracle expects {oracle}")
            counts = kern.launch_counts()
        log(f"[slice8] two-level {mode}: launches {counts}")
        for name in kern.LAUNCHES:
            if name in HIER_KERNELS[mode]:
                check(counts[name] > 0, f"two-level {mode}: kernel {name} never launched")
            else:
                check(counts[name] == 0, f"two-level {mode}: kernel {name} launched unexpectedly")
            launches[name] += counts[name]
        params = state["params"]
        del state, fn
        torch.cuda.empty_cache()
        if mode == "none":
            _check_hier_mix(params)
    return launches, params


def _per_leaf_exchange(params, rel) -> None:
    """One per-leaf compressed round (``tdm_fla_round(fused=False)``) of each
    of int8 and top-k over the trained params: finite, 2 gathers per
    matching per leaf (int8: codes and scale; CHOCO: values and indices), and
    per-leaf int8 within 2% of the same algebra unquantized."""
    import numpy as np
    import torch

    from repro_torch.core import fl, tdm
    from repro_torch.pytree import tree_leaves

    leaves = tree_leaves(params)
    m = len(tdm.edge_coloring(rel))
    k = min(64, min(leaf[0].numel() for leaf in leaves))
    for comp in ("int8", "topk"):
        cfg = fl.TDMFLAConfig(compression=comp, topk_k=k, fused=False)
        torch.cuda.synchronize()
        before = tdm.gather_count()
        t0 = time.perf_counter()
        mixed, _ = fl.tdm_fla_round(params, rel, SLICE_NODES, cfg)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        gathers = tdm.gather_count() - before
        out = tree_leaves(mixed)
        finite = all(bool(torch.isfinite(t).all()) for t in out)
        check(finite, f"per-leaf {comp}: non-finite result")
        check(gathers == 2 * m * len(leaves), f"per-leaf {comp}: {gathers} gathers, the "
              f"reference's code issues {2 * m * len(leaves)} (2 per matching per leaf)")
        note = ""
        if comp == "int8":
            w = float(np.float32(1.0 / (1.0 + rel.max_degree())))
            num = den = 0.0
            for x, got in zip(leaves, out):
                deg = tdm.node_scalars([rel.degree(v) for v in range(SLICE_NODES)], x)
                want = x + w * (tdm.neighbor_sum(x, rel) - deg * x)
                num += float((got - want).double().norm()) ** 2
                den += float(want.double().norm()) ** 2
            err = (num / den) ** 0.5
            check(err < 0.02, f"per-leaf int8 vs the unquantized algebra: {err:.4f} >= 2%")
            note = f", vs the same algebra unquantized {err:.4f} (< 2%)"
        del mixed, out
        torch.cuda.empty_cache()
        log(f"[slice8] per-leaf {comp} round over {len(leaves)} leaves ({m} matchings"
            f"{', k ' + str(k) if comp == 'topk' else ''}): {secs:.3f} s, gathers {gathers} "
            f"(2 x {m} x {len(leaves)}), finite{note}")


def _optimized_fl(device) -> None:
    """``run_constellation_fl(optimize="rate")`` on slice 1's scenario, 3
    rounds uncompressed: one round per sub-slot of the optimizer's schedule
    (one antenna per satellite), each a matching of its step's visibility
    relation; the driver holds every round's gathers to the oracle."""
    import math

    import torch

    from repro_torch import telemetry
    from repro_torch.launch import fl_train
    from repro_torch.launch import train_fl_constellation as tfc

    cfg, opt_cfg, shape, scn, state = _fl_setup(device)
    sched = scn.plan.schedule(payload_bytes=tfc.PAYLOAD_BYTES, optimize="rate")
    with telemetry.record_scope(tracing=True) as rec:
        t0 = time.perf_counter()
        state, logs = fl_train.run_constellation_fl(
            cfg, opt_cfg, tfc.N_SATS, fl_train.FLConfig(mode="tdm", local_steps=tfc.LOCAL_STEPS),
            scn.plan, state, tfc.make_batch_fn(cfg, shape, tfc.N_SATS), rounds=OPT_ROUNDS,
            optimize="rate", payload_bytes=tfc.PAYLOAD_BYTES)
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    build = [sp.dur_us / 1e6 for sp in rec.spans if sp.name == "fl.build_schedule"]
    rounds = [sp.dur_us / 1e6 for sp in rec.spans if sp.name == "fl.round"]
    gathers = rec.get_counter("fl.exchange.gathers")
    oracle = rec.get_counter("fl.collectives.collective-permute")
    slots = list(sched.slots)[:OPT_ROUNDS]
    check(len(logs) == OPT_ROUNDS == len(slots) and len(build) == 1,
          f"optimized FL: {len(logs)} rounds, {len(build)} schedule builds")
    for lg, slot in zip(logs, slots):
        rel = slot.relation
        check(rel.is_matching() and rel.pairs <= scn.plan.relation(slot.t_index).pairs
              and lg.n_links == len(rel) // 2,
              f"optimized FL round {lg.round}: not a matching of step {slot.t_index}'s "
              "visibility relation")
        check(math.isfinite(lg.loss), f"optimized FL round {lg.round}: non-finite loss")
    check(gathers == oracle, f"optimized FL: {gathers:g} gathers, oracle {oracle:g}")
    log(f"[slice8] optimize=rate: schedule built in {build[0]:.3f} s (fl.build_schedule), "
        f"{len(sched)} sub-slots over {len(scn.plan.times)} steps; rounds "
        + ", ".join(f"{lg.round}: step {s.t_index}, {lg.n_links} links, loss {lg.loss:.4f}, "
                    f"{r:.3f} s" for lg, s, r in zip(logs, slots, rounds))
        + f"; gathers {gathers:g} (oracle {oracle:g}); {wall:.1f} s in all")
    del state
    torch.cuda.empty_cache()


def phase_paper_exchange(device) -> dict:
    """Slice 8: two-level FL, the per-leaf compressed exchange on its
    params, and FL on the optimizer's schedule. Returns the launches per
    kernel of the two-level runs."""
    import torch

    from repro_torch.launch import train_fl_constellation as tfc

    launches, params = _hier_fl(device)
    scn = tfc.setup(tfc.N_SATS, SLICE_ROUNDS)[3]
    _per_leaf_exchange(params, scn.plan.relations()[0])
    del params
    torch.cuda.empty_cache()
    _optimized_fl(device)
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
                                                impl=impl)
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


def _serve_workload(dec, cfg, tag: str):
    from repro_torch.launch import serve_constellation as sc

    return sc.run(decoder=dec, vocab=cfg.vocab_size, requests=SERVE_REQUESTS,
                  batch=SERVE_BATCH, max_new=SERVE_MAX_NEW, prompt_len=SERVE_PROMPT,
                  log=lambda m: log(f"[{tag}] {m.strip()}"))


def _make_decoder(arch: str, device):
    from repro_torch.launch import serve_constellation as sc

    return sc.model_decoder(arch, False, len(sc.REPLICAS), SERVE_BATCH, SERVE_PROMPT,
                            SERVE_MAX_NEW, 0, device)


def _launch_counts() -> dict:
    """Every kernel's launch count, by kernel name."""
    from repro_torch.kernels.flash_attention import flash_attention as fa_kern
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd_kern
    from repro_torch.kernels.tdm_compress import tdm_compress as tdm_kern

    return {**tdm_kern.launch_counts(), **ssd_kern.launch_counts(),
            **fa_kern.launch_counts()}


def _reset_launch_counts() -> None:
    from repro_torch.kernels.flash_attention import flash_attention as fa_kern
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd_kern
    from repro_torch.kernels.tdm_compress import tdm_compress as tdm_kern

    for mod in (tdm_kern, ssd_kern, fa_kern):
        mod.reset_launch_counts()


def _run_serving(dec, cfg, device, tag: str):
    """The serving workload through ``serve_constellation``'s entry points,
    every launch counter zeroed just before and read just after; checks the
    deliveries, tokens, audit and re-routing. Returns (run, recorder,
    launches by kernel, seconds in model calls)."""
    import torch

    from repro_torch import telemetry

    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    with telemetry.record_scope(tracing=True) as rec:
        _reset_launch_counts()
        t0 = time.perf_counter()
        res = _serve_workload(dec, cfg, tag)
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated(device)
    summ = res.report.summary()
    prefills = [sp for sp in rec.spans if sp.name == "serve.prefill"]
    decodes = [sp for sp in rec.spans if sp.name == "serve.decode"]
    for sp in prefills:
        log(f"[{tag}] prefill call: bucket {sp.args['bucket']}, {sp.args['lanes']} lanes, "
            f"{sp.dur_us / 1e3:.1f} ms")
    dms = sorted(sp.dur_us / 1e3 for sp in decodes)
    model_s = sum(sp.dur_us for sp in prefills + decodes) / 1e6
    log(f"[{tag}] decode: {len(decodes)} fleet ticks, ms per tick mean "
        f"{sum(dms) / len(dms):.1f} (min {dms[0]:.1f}, median {dms[len(dms) // 2]:.1f}, "
        f"max {dms[-1]:.1f}); 4-lane ticks {sum(1 for sp in decodes if sp.args['lanes'] == 4)}, "
        f"8-lane {sum(1 for sp in decodes if sp.args['lanes'] == 8)}")
    log(f"[{tag}] run: {wall:.2f} s wall, {model_s:.2f} s in model calls (host clock, each "
        f"call ends in a copy of its tokens to the host), peak {peak / 2**30:.2f} GiB "
        f"({(peak - base) / 2**30:.2f} GiB above the params and caches)")
    for name in sorted(n for n in rec.counters if n.startswith("serve.")):
        log(f"[{tag}]   {name} = {rec.counters[name]:g}")
    check(summ["delivered"] == summ["n_requests"] == SERVE_REQUESTS and not summ["undelivered"],
          f"{tag}: delivered {summ['delivered']}/{summ['n_requests']}")
    check(all(len(r.out) == SERVE_MAX_NEW for r in res.report.requests),
          f"{tag}: a request was delivered without its 16 tokens")
    check(res.verdict.ok, f"{tag}: audit, {len(res.verdict.violations)} violations")
    check(summ["retries"] > 0, f"{tag}: the mid-epoch failure re-routed nothing")
    return res, rec, launches, model_s


def _profiled_replay(make, cfg, device, tokens, model_s: float, tag: str):
    """The same workload again on a fresh decoder from ``make()`` (the caller
    has freed the first), under the profiler: the same token streams bit for
    bit, and the device's busy time. Returns (decoder, run, device time by
    kernel name)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import telemetry

    _, dec = make()
    t0 = time.perf_counter()
    with telemetry.record_scope(tracing=False):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            res = _serve_workload(dec, cfg, tag)
            torch.cuda.synchronize(device)
    log(f"[{tag}] profiled replay: {time.perf_counter() - t0:.1f} s")
    check(_tokens_by_request(res.report) == tokens,
          f"{tag}: a second run of the same workload gave other token streams")
    busy_ms, by_name = _device_busy(prof)
    generated = SERVE_REQUESTS * SERVE_MAX_NEW
    if busy_ms > 0:
        log(f"[{tag}] replay on a fresh decoder: token streams bit-identical; device busy "
            f"{busy_ms:.1f} ms (torch.profiler) -> {generated / (busy_ms / 1e3):.0f} generated "
            f"tokens/s of device time; busy share of the first run's model-call time "
            f"{busy_ms / 1e3 / model_s:.1%}; {sum(n for _, n in by_name.values())} device "
            f"activities")
        for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
            log(f"[{tag}]   device {ms:8.1f} ms {n:6d}x  {name[:110]}")
    else:
        log(f"[{tag}] replay on a fresh decoder: token streams bit-identical; device time "
            "not measured (the profiler recorded no device events)")
    del prof
    return dec, res, by_name


def phase_serving(device) -> dict:
    """Slice 3: mamba2-780m serving through ``serve_constellation``'s entry
    points, the launch counters zeroed just before and read just after.
    Returns the ``ssd_scan`` launches of that run."""
    import torch

    from repro_torch.pytree import tree_leaves

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg, dec = _make_decoder(SERVE_ARCH, device)
    torch.cuda.synchronize(device)
    log(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.mamba.n_heads(cfg.d_model)} SSM heads x {cfg.mamba.head_dim}, d_state "
        f"{cfg.mamba.d_state}, chunk {cfg.mamba.chunk}, vocab {cfg.vocab_size}, params "
        f"{sum(t.numel() for t in tree_leaves(dec.params)) / 1e6:.1f} M f32 (seed 0), "
        f"{cfg.compute_dtype} compute; decoder built in {time.perf_counter() - t0:.1f} s")
    check(cfg.n_layers == SERVE_LAYERS, f"{cfg.name} has {cfg.n_layers} layers")
    res, rec, counts, model_s = _run_serving(dec, cfg, device, "serve")
    launches = counts["ssd_scan"]
    prefill_calls = int(rec.get_counter("serve.prefill.calls"))
    prefills = [sp for sp in rec.spans if sp.name == "serve.prefill"]
    check(prefill_calls > 0 and launches == cfg.n_layers * prefill_calls,
          f"ssd_scan launched {launches} times for {prefill_calls} prefill calls")
    others = {k: v for k, v in counts.items() if k != "ssd_scan" and v}
    check(not others, f"other kernels on the mamba2 serving path: {others}")
    check(any(sp.args["bucket"] == 512 for sp in prefills), "no two-chunk prefill (bucket 512)")
    summ = res.report.summary()
    log(f"[serve] {summ['delivered']}/{summ['n_requests']} delivered x {SERVE_MAX_NEW} tokens, "
        f"audit OK ({res.verdict.n_hops} hops), {summ['retries']} retries; ssd_scan "
        f"launches {launches} = {cfg.n_layers} x {prefill_calls} prefill calls")

    _wave_prefill_vs_plain(dec, res.report, device)
    tokens = _tokens_by_request(res.report)
    del dec, res
    torch.cuda.empty_cache()
    dec2, res2, _ = _profiled_replay(lambda: _make_decoder(SERVE_ARCH, device), cfg, device,
                                     tokens, model_s, "serve")
    _split_one_call(dec2, res2.report, device, "serve", "ssd_scan")
    del dec2, res2
    torch.cuda.empty_cache()
    return {"ssd_scan": launches}


def _split_one_call(dec, report, device, tag: str, kernel_key: str) -> None:
    """Host wall against device busy time of one 4-lane prefill (the first
    wave's prompts) and one 4-lane decode tick, each timed once unprofiled
    (host clock, ending in the copy of its tokens) and once under the
    profiler; the device time of the kernels whose names hold
    ``kernel_key``."""
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
        mine = sum(ms for name, (ms, _) in by_name.items() if kernel_key in name)
        log(f"[{tag}] one {what}: host {host_ms:.1f} ms, device busy {busy:.1f} ms "
            f"({busy / host_ms:.0%}) in {sum(n for _, n in by_name.values())} activities"
            f"{f', {kernel_key} {mine:.1f} ms' if mine else ''}")


SSD_SLICE = (2 * SERVE_BATCH, 512, 48, 64, 1, 128, 256)   # (B, S, H, P, G, N, chunk)
# the three launches of a bf16 call, by kernel name (csrc/ssd_scan.cu)
SSD_PASSES = ("ssd_scan_chunk_state", "ssd_scan_state_pass", "ssd_scan_chunk_scan")


def _ssd_bound(B_, S, H, P, G, N, Q):
    """(bound ms at the bf16 tensor-core rate, its "bytes" or "operations",
    bound ms at the float32 rate, GFLOP, MB) of one bf16 scan: the bytes it
    must move (x, B, C, dt, A read once, y and the final state written once)
    at 3.35 TB/s against its operations (the triangle s <= t only: C.B^T and
    W.x on it, C.S_prev and the state update) at 989 TFLOP/s, the earlier
    rows' float32 rate (67 TFLOP/s) beside it."""
    rows, chunks = B_ * H, S // Q
    flops = rows * chunks * (N * Q * (Q + 1) + P * Q * (Q + 1) + 2 * Q * N * P + 2 * Q * P * N)
    nbytes = (2 * B_ * S * H * P * 2         # x in, y out (bf16)
              + 2 * B_ * S * G * N * 2       # B and C (bf16), the group's rows once
              + B_ * S * H * 4 + H * 4       # dt, A
              + B_ * H * P * N * 4)          # final state (f32)
    op_ms, byte_ms = flops / BF16_FLOPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    f32_ms = max(flops / F32_FLOPS_PER_S * 1e3, byte_ms)
    return (max(op_ms, byte_ms), "operations" if op_ms >= byte_ms else "bytes", f32_ms,
            flops / 1e9, nbytes / 1e6)


def phase_ssd_slice(device, power_note: str) -> dict:
    """``ssd_scan`` at the serving prefill's shape with both replicas
    admitted (mamba2-780m: 48 heads x 64, one group of state 128, S 512 in
    chunks of 256; the ``kernels`` line's row) and at the served 4 lanes
    (every prefill call of the serving cell), against its plain version,
    timed, with its bound; and four launches on one input, bit-identical."""
    import torch

    from repro_torch.kernels.ssd_scan import ops

    row = None
    for B_ in (SSD_SLICE[0], SERVE_BATCH):
        _, S, H, P, G, N, Q = SSD_SLICE
        case = (B_, S, H, P, G, N, Q, torch.bfloat16)
        gen = torch.Generator(device=device).manual_seed(17)
        inputs = _ssd_inputs(gen, case, device)
        err = _ssd_vs_plain(inputs, Q, f"ssd_scan at the serving shape {case}")
        first = ops.ssd_scan(*inputs, chunk=Q, impl="cuda")
        for _ in range(3):
            again = ops.ssd_scan(*inputs, chunk=Q, impl="cuda")
            check(all(torch.equal(a, b) for a, b in zip(first, again)),
                  f"ssd_scan {case}: a repeated launch differs")
        ms = time_ms(lambda: ops.ssd_scan(*inputs, chunk=Q, impl="cuda"), reps=20)
        plain = time_ms(lambda: ops.ssd_scan(*inputs, chunk=Q, impl="ref"), reps=5)
        bound_ms, bound_by, f32_ms, gflop, mb = _ssd_bound(B_, S, H, P, G, N, Q)
        log(f"[kernels] ssd_scan at the serving prefill shape, {B_} lanes (S {S}, H {H}, "
            f"P {P}, G {G}, N {N}, chunk {Q}, bf16): {ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}; {bound_ms / ms:.1%}; {gflop:.2f} GFLOP at 989 TFLOP/s bf16, "
            f"{mb:.1f} MB at 3.35 TB/s; at the float32 rate {f32_ms:.3f} ms), plain "
            f"{plain:.3f} ms, library null (no single PyTorch call computes the chunked SSD "
            f"scan), max_abs_err {err:.3g}, 4 launches bit-identical  [{power_note}]")
        stats = {"ms": ms, "plain_ms": plain, "bound_ms": bound_ms, "bound_by": bound_by,
                 "bound_ms_f32_rate": f32_ms, "max_abs_err": err}
        if row is None:
            row = {"name": "ssd_scan", "route": "cuda", "source": SOURCES["ssd_scan"],
                   "replaces": REPLACES["ssd_scan"], "launches": 0, "library_ms": None,
                   **stats}
        else:
            row[f"served_{B_}_lanes"] = stats
    return row


# ---------------------------------------------------------------------------
# slice 4: attention and gemma2-9b serving
# ---------------------------------------------------------------------------

# (B, S, H, KV, hd, causal, window, softcap): hd 16 to 256, G 1, 2 and 4,
# causal on and off, windows below and above S, softcap 50 and none, S 1 to
# 512 with ragged tiles
FA_PREFILL_CASES = [
    (2, 1, 4, 4, 16, True, None, 50.0),
    (2, 8, 8, 4, 64, True, None, None),
    (1, 23, 8, 2, 128, False, None, 50.0),
    (2, 64, 4, 1, 256, True, 16, 50.0),
    (1, 300, 4, 2, 64, True, 64, None),
    (1, 300, 2, 2, 16, False, 100, None),
    (2, 512, 16, 8, 256, True, None, 50.0),
    (1, 512, 16, 8, 256, True, 4096, 50.0),
    (1, 512, 8, 8, 128, True, 100, 50.0),
    (1, 4608, 16, 8, 256, True, 4096, 50.0),     # gemma2-9b's local layer, S > window
]
# (B, L, H, KV, hd, Sq), rows' kv_len 1, L // 2 + 1 and L
FA_DECODE_CASES = [
    (3, 23, 4, 2, 16, 1),
    (3, 64, 8, 2, 64, 1),
    (3, 300, 4, 4, 128, 2),
    (3, 529, 16, 8, 256, 1),
    (3, 512, 8, 2, 256, 4),
]
# (B, L, H, KV, hd, Sq) against long caches, gemma2-9b's window 4096 as a
# ring and twice that: many cache chunks; rows' kv_len 1, one past the
# first chunk's edge and L
FA_DECODE_LONG_CASES = [
    (3, 4096, 16, 8, 256, 1),
    (3, 8192, 16, 8, 256, 1),
]
DENSE_ARCH = "gemma2-9b"
DENSE_LAYERS = 42
DENSE_TAG = "serve-dense"
# the kernels at the serving shapes, both replicas admitted (8 lanes)
FA_SERVE_PREFILL = (2 * SERVE_BATCH, 512, 16, 8, 256)      # (B, S, H, KV, hd)
FA_SERVE_DECODE = (2 * SERVE_BATCH, 529, 16, 8, 256)       # (B, L, H, KV, hd)


def _fa_inputs(gen, q_shape, kv_shape, dtype, device):
    import torch

    q = torch.randn(*q_shape, generator=gen, device=device).to(dtype)
    k = torch.randn(*kv_shape, generator=gen, device=device).to(dtype)
    v = torch.randn(*kv_shape, generator=gen, device=device).to(dtype)
    return q, k, v


def _fa_vs_plain(got, want, what: str) -> float:
    import torch

    from repro_torch.kernels.flash_attention import ref

    torch.cuda.synchronize()
    check(got.dtype == want.dtype, f"{what}: dtype {got.dtype} != {want.dtype}")
    ok, err = ref.fa_close(got, want)
    check(ok, f"{what}: outside fa_tolerance (max |diff| {err})")
    return err


def _twice(fn, what: str):
    """Two launches of ``fn`` on the same input: bit-identical outputs."""
    import torch

    a, b = fn(), fn()
    torch.cuda.synchronize()
    check(torch.equal(a, b), f"{what}: two launches on the same input differ")
    return a


def phase_fa_small(device) -> None:
    """Both attention entry points against their plain version on small,
    ragged and serving-sized cases, within ``fa_tolerance`` (1e-5 of the
    output's scale, plus one bf16 ulp of each entry for bf16 outputs); two
    launches of each case bit-identical; the launch counters show that bf16
    prefills took the tensor-core kernel and float32 ones did not."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention as fa_kern
    from repro_torch.kernels.flash_attention import ops

    gen = torch.Generator(device=device).manual_seed(19)
    worst, n = 0.0, 0
    for dtype in (torch.bfloat16, torch.float32):
        fwd0 = fa_kern.launch_counts()
        for B, S, H, KV, hd, causal, window, cap in FA_PREFILL_CASES:
            q, k, v = _fa_inputs(gen, (B, S, H, hd), (B, S, KV, hd), dtype, device)
            kw = dict(causal=causal, window=window, softcap=cap)
            what = f"flash_attention_fwd {(B, S, H, KV, hd)} {kw} {dtype}"
            worst = max(worst, _fa_vs_plain(
                _twice(lambda: ops.flash_attention(q, k, v, impl="cuda", **kw), what),
                ops.flash_attention(q, k, v, impl="ref", **kw), what))
            n += 1
        fwd1 = fa_kern.launch_counts()
        launched = fwd1["flash_attention_fwd"] - fwd0["flash_attention_fwd"]
        wgmma = fwd1["flash_attention_fwd_wgmma"] - fwd0["flash_attention_fwd_wgmma"]
        check(launched == 2 * len(FA_PREFILL_CASES) and
              wgmma == (launched if dtype == torch.bfloat16 else 0),
              f"{dtype} prefills: {launched} launches, {wgmma} on the tensor-core kernel")
        for B, L, H, KV, hd, Sq in FA_DECODE_CASES:
            q, k, v = _fa_inputs(gen, (B, Sq, H, hd), (B, L, KV, hd), dtype, device)
            kv_len = torch.tensor([1, L // 2 + 1, L], dtype=torch.int32, device=device)
            what = f"flash_attention_decode {(B, L, H, KV, hd, Sq)} {dtype}"
            worst = max(worst, _fa_vs_plain(
                _twice(lambda: ops.flash_attention_decode(q, k, v, kv_len, softcap=50.0,
                                                          impl="cuda"), what),
                ops.flash_attention_decode(q, k, v, kv_len, softcap=50.0, impl="ref"),
                what))
            n += 1
        for B, L, H, KV, hd, Sq in FA_DECODE_LONG_CASES:
            q, k, v = _fa_inputs(gen, (B, Sq, H, hd), (B, L, KV, hd), dtype, device)
            n_split, chunk, _, _ = fa_kern.decode_plan(
                B, KV, L, H // KV * Sq, hd,
                torch.cuda.get_device_properties(device).multi_processor_count)
            check(n_split > 1, f"decode against L {L}: one chunk")
            kv_len = torch.tensor([1, chunk + 1, L], dtype=torch.int32, device=device)
            what = f"flash_attention_decode {(B, L, H, KV, hd, Sq)} {n_split} chunks {dtype}"
            worst = max(worst, _fa_vs_plain(
                _twice(lambda: ops.flash_attention_decode(q, k, v, kv_len, softcap=50.0,
                                                          impl="cuda"), what),
                ops.flash_attention_decode(q, k, v, kv_len, softcap=50.0, impl="ref"),
                what))
            n += 1
    log(f"[attention] {n} prefill and decode cases (hd 16-256, G 1-4, causal and not, "
        f"windows, softcap 50 and none, S 1-4608 with gemma2-9b's window 4096 below S, "
        f"per-row kv_len, caches up to 8192 slots split into many chunks with kv_len 1, "
        f"one past a chunk edge and full, bf16 and f32) within fa_tolerance of the plain "
        f"version (max |diff| {worst:.3g}); two launches of each bit-identical; bf16 "
        f"prefills on the tensor-core kernel, f32 ones not")
    _decode_streams_and_graph(gen, device)


def _decode_streams_and_graph(gen, device) -> None:
    """The split-KV decode's scratch and arrival counters are the stream's:
    at the serving shape, decodes queued alternately on two side streams
    without waits between them, and decodes captured in a CUDA graph and
    replayed, equal one eager launch bit for bit."""
    import torch

    from repro_torch.kernels.flash_attention import ops

    B, L, H, KV, hd = FA_SERVE_DECODE
    q, k, v = _fa_inputs(gen, (B, 1, H, hd), (B, L, KV, hd), torch.bfloat16, device)
    kv_len = torch.tensor([1, 17, 100, 264, 265, 528, 529, 529][:B], dtype=torch.int32,
                          device=device)
    run = lambda: ops.flash_attention_decode(q, k, v, kv_len, softcap=50.0,  # noqa: E731
                                             impl="cuda")
    want = run()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    outs = []
    for i in range(16):
        with torch.cuda.stream(streams[i % 2]):
            outs.append(run())
    for st in streams:
        torch.cuda.current_stream().wait_stream(st)
    torch.cuda.synchronize()
    check(all(torch.equal(o, want) for o in outs),
          "flash_attention_decode on two streams differs from one launch")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = [run() for _ in range(3)]
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        check(all(torch.equal(o, want) for o in captured),
              "flash_attention_decode replayed from a CUDA graph differs from one launch")
    del graph
    log("[attention] split-KV decode at the serving shape: 16 launches alternating on "
        "two streams and 3 launches replayed twice from a CUDA graph equal one launch "
        "bit for bit")


def _wave_prefill_dense(decoder, report, device) -> None:
    """One wave (the first four requests' prompts, left-padded to their
    bucket) through the attention kernel and through its plain version, same
    params and tokens:

    - layer by layer, both fed the same input: the raw attention within
      ``fa_tolerance``, the sub-layer's output (after the output projection)
      within ``OUT_ULPS`` bf16 ulps of its largest magnitude, and the layer's
      K/V cache entries bit-identical (they do not pass through the kernel);
    - the whole prefill (``transformer.prefill``): the last-token logits
      within ``SERVE_SPREAD`` times the plain path's own spread, i.e. its
      difference from the same prefill with the reference's prefill
      attention (its ``naive_attention``, computed by ``attention_ref`` with
      ``p_dtype=bfloat16``: p rounded to bf16 before the PV product, as the
      reference computes at S below its 1024 block). Later
      layers carry and amplify a layer's rounding differences, so a bound in
      ulps does not apply there."""
    import numpy as np
    import torch

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.models import transformer
    from repro_torch.models.layers import embed_tokens, lm_logits, mlp_apply, rmsnorm
    from repro_torch.pytree import tree_map

    cfg, params, max_len = decoder.cfg, decoder.params, decoder.max_len
    prompts = [r.prompt for r in sorted(report.requests, key=lambda r: r.rid)[:SERVE_BATCH]]
    plen = decoder._bucket(max(len(p) for p in prompts))
    toks = np.zeros((SERVE_BATCH, plen), np.int64)
    for lane, p in enumerate(prompts):
        toks[lane, plen - len(p):] = p
    tokens = torch.from_numpy(toks).to(device)
    positions = torch.arange(plen, device=device)[None].expand(SERVE_BATCH, plen)

    def scale_ulps(a, b):
        a, b = a.float(), b.float()
        top = float(b.abs().max())
        ulp = 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 2.0 ** -133
        return float((a - b).abs().max()) / ulp

    def rel(a, b):
        a, b = a.float(), b.float()
        return float((a - b).abs().max() / b.abs().max())

    def attn_naive(p, hn, d):
        q, k, v = transformer._qkv(p, hn, cfg)
        q, k = transformer._rope_qk(q, k, positions, cfg)
        spec = transformer._attn_spec(cfg, d)
        return transformer._attn_out(p, fa_ref.attention_ref(
            q, k, v, causal=spec.causal, window=spec.window, softcap=spec.softcap,
            p_dtype=v.dtype))

    worst_raw = worst_out = 0.0
    with torch.no_grad():
        h = h_naive = embed_tokens(params["embed"], tokens, cfg)
        for u in range(transformer.n_units(cfg)):
            unit_p = tree_map(lambda t: t[u], params["units"])
            for j, d in enumerate(transformer.scan_unit(cfg)):
                p = unit_p[f"L{j}"]
                hn = rmsnorm(h, p["ln"], cfg.norm_eps)
                q, k, v = transformer._qkv(p["attn"], hn, cfg)
                q, k = transformer._rope_qk(q, k, positions, cfg)
                spec = transformer._attn_spec(cfg, d)
                kw = dict(causal=spec.causal, window=spec.window, softcap=spec.softcap)
                ok_raw, err_raw = fa_ref.fa_close(
                    fa_ops.flash_attention(q, k, v, impl="cuda", **kw),
                    fa_ops.flash_attention(q, k, v, impl="ref", **kw))
                out_k, kv_k = transformer.attn_prefill(p["attn"], hn, positions, cfg, d,
                                                       max_len, impl="cuda")
                out_r, kv_r = transformer.attn_prefill(p["attn"], hn, positions, cfg, d,
                                                       max_len, impl="ref")
                err_o = scale_ulps(out_k, out_r)
                same_kv = torch.equal(kv_k.k, kv_r.k) and torch.equal(kv_k.v, kv_r.v)
                check(ok_raw and err_o <= OUT_ULPS and same_kv,
                      f"wave prefill layer {2 * u + j}, same input: attention {err_raw:.3g} "
                      f"(fa_tolerance), sub-layer output {err_o:.3g} bf16 ulps at scale "
                      f"(bound {OUT_ULPS}), or K/V cache entries differ")
                worst_raw, worst_out = max(worst_raw, err_raw), max(worst_out, err_o)
                h = h + out_r
                h = h + mlp_apply(p["ffn"], rmsnorm(h, p["ln2"], cfg.norm_eps), cfg)
                hn = rmsnorm(h_naive, p["ln"], cfg.norm_eps)
                h_naive = h_naive + attn_naive(p["attn"], hn, d)
                h_naive = h_naive + mlp_apply(p["ffn"], rmsnorm(h_naive, p["ln2"], cfg.norm_eps),
                                              cfg)
        del q, k, v, out_k, out_r, kv_k, kv_r, hn
        final = params["final_ln"]
        l_loop = lm_logits(params["embed"], rmsnorm(h, final, cfg.norm_eps)[:, -1:], cfg)
        l_naive = lm_logits(params["embed"], rmsnorm(h_naive, final, cfg.norm_eps)[:, -1:], cfg)
        del h, h_naive
        lk, _ = transformer.prefill(params, tokens, cfg, max_len, impl="cuda")
        lr, _ = transformer.prefill(params, tokens, cfg, max_len, impl="ref")
    check(all(bool(torch.isfinite(t).all()) for t in (lk, lr, l_naive)),
          "wave prefill: non-finite logits")
    check(torch.equal(l_loop, lr), "the layer-by-layer loop is not the plain prefill")
    kern_l, spread_l = rel(lk, lr), rel(l_naive, lr)
    same_top = bool((lk[:, -1].argmax(-1) == lr[:, -1].argmax(-1)).all())
    log(f"[{DENSE_TAG}] wave prefill (4 lanes, bucket {plen}), kernel vs plain version: "
        f"layer by layer on the same input, attention max |diff| {worst_raw:.3g} (within "
        f"fa_tolerance), sub-layer outputs up to {worst_out:.3g} bf16 ulps at their scale "
        f"(bound {OUT_ULPS}), K/V caches bit-identical; whole prefill, last-token logits "
        f"{kern_l:.3g} of their scale against the plain path's own spread (p rounded to "
        f"bf16, the reference's prefill attention) of {spread_l:.3g} (bound "
        f"{SERVE_SPREAD}x); greedy tokens {'equal' if same_top else 'differ'}")
    check(kern_l <= SERVE_SPREAD * spread_l,
          f"wave prefill, kernel vs plain: logits {kern_l:.3g} of their scale, beyond "
          f"{SERVE_SPREAD}x the plain path's spread ({spread_l:.3g})")


def _device_time_by_kind(by_name: dict, tag: str) -> None:
    """The replay's device time by kind of kernel."""
    index = "index ops (K/V slot writes, embedding rows)"
    routing = "sort, gather, scatter and search ops (MoE routing, dispatch, combine)"
    kinds = {"attention (fa_prefill/fa_decode)": 0.0, "GEMMs": 0.0, index: 0.0, routing: 0.0,
             "casts and copies": 0.0, "other": 0.0}
    for name, (ms, _) in by_name.items():
        low = name.lower()
        if "fa_prefill" in name or "fa_decode" in name:
            kinds["attention (fa_prefill/fa_decode)"] += ms
        elif any(t in low for t in ("gemm", "xmma", "nvjet", "cutlass", "cublas")):
            kinds["GEMMs"] += ms
        elif any(t in low for t in ("sort", "scatter", "gather", "search", "radix")):
            kinds[routing] += ms
        elif "index" in low:
            kinds[index] += ms
        elif "copy" in low or "memcpy" in low:
            kinds["casts and copies"] += ms
        else:
            kinds["other"] += ms
    log(f"[{tag}] replay device time by kind: " + ", ".join(
        f"{k} {ms:.1f} ms" for k, ms in kinds.items()))
    for name, (ms, n) in sorted(by_name.items()):
        if "fa_prefill" in name or "fa_decode" in name:
            short = name.replace("(anonymous namespace)::", "").split("(")[0]
            log(f"[{tag}]   {short[-60:]}: {ms:.1f} ms in {n} launches "
                f"({ms / n * 1e3:.1f} us each)")


def _time_logits(dec, device, power_note: str) -> None:
    """``lm_logits`` alone at a fleet tick's 8 lanes: the tied embedding
    upcast to f32 on every call, then an f32 product."""
    import torch

    from repro_torch.models.layers import lm_logits

    cfg = dec.cfg
    gen = torch.Generator(device=device).manual_seed(23)
    h = torch.randn(2 * SERVE_BATCH, 1, cfg.d_model, generator=gen, device=device).to(
        torch.bfloat16)
    with torch.no_grad():
        ms = time_ms(lambda: lm_logits(dec.params["embed"], h, cfg), reps=5)
    log(f"[{DENSE_TAG}] lm_logits at 8 lanes (tied {cfg.vocab_size} x {cfg.d_model} "
        f"embedding upcast to f32 per call): {ms:.2f} ms  [{power_note}]")


def _time_cache_fold(dec, device, power_note: str) -> None:
    """A decode tick's cache traffic with both replicas active: the copy of
    their caches into one folded batch (``ModelDecoder._lanes``) and the
    copy back (``_write``), each against its byte bound (every cache byte
    read once and written once). With one replica active the fold is a view
    and nothing moves."""
    import torch

    from repro_torch.pytree import tree_leaves

    both = list(range(dec.n_replicas))
    nbytes = 2 * sum(t.numel() * t.element_size() for t in tree_leaves(dec._cache["units"]))
    folded = dec._lanes(both)
    one = dec._lanes([0])
    check(all(a.data_ptr() == b[0].data_ptr() for a, b in
              zip(tree_leaves(one["units"]), tree_leaves(dec._cache["units"]))),
          "one replica's fold is not a view of its cache")
    fold_ms = time_ms(lambda: dec._lanes(both), reps=10)
    write_ms = time_ms(lambda: dec._write(both, folded), reps=10)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"[{DENSE_TAG}] decode cache traffic at {dec.n_replicas * dec.batch} lanes: fold "
        f"{fold_ms:.3f} ms, write-back {write_ms:.3f} ms, each against a bound of "
        f"{bound:.3f} ms ({nbytes / 1e9:.3f} GB at 3.35 TB/s); at {dec.batch} lanes (one "
        f"replica) the fold is a view, nothing is copied  [{power_note}]")


def phase_serving_dense(device, power_note: str) -> dict:
    """Slice 4: gemma2-9b at its published config, all 42 layers, through
    ``serve_constellation``'s entry points, the launch counters zeroed just
    before and read just after. Returns the attention launches of that run."""
    import gc

    import torch

    from repro_torch.models import transformer
    from repro_torch.pytree import tree_leaves

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    cfg, dec = _make_decoder(DENSE_ARCH, device)
    torch.cuda.synchronize(device)
    init_peak = torch.cuda.max_memory_allocated(device)
    n_params = sum(t.numel() for t in tree_leaves(dec.params))
    cache_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(dec._cache))
    log(f"[{DENSE_TAG}] {cfg.name}: {cfg.n_layers} layers ({transformer.n_units(cfg)} "
        f"local/global units), d_model {cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} "
        f"kv heads x {cfg.head_dim}, d_ff {cfg.d_ff}, window {cfg.sliding_window}, softcaps "
        f"{cfg.attn_softcap}/{cfg.final_softcap}, vocab {cfg.vocab_size}; params "
        f"{n_params:,} f32 ({n_params * 4 / 1e9:.2f} GB, seed 0), caches "
        f"{cache_bytes / 1e9:.3f} GB for 2 replicas (max_len {dec.max_len}); "
        f"{cfg.compute_dtype} compute; decoder built in {time.perf_counter() - t0:.1f} s, "
        f"peak {init_peak / 2**30:.2f} GiB while building")
    check(cfg.n_layers == DENSE_LAYERS, f"{cfg.name} has {cfg.n_layers} layers")
    res, rec, counts, model_s = _run_serving(dec, cfg, device, DENSE_TAG)
    prefill_calls = int(rec.get_counter("serve.prefill.calls"))
    ticks = sum(1 for sp in rec.spans if sp.name == "serve.decode")
    fwd, dcd = counts["flash_attention_fwd"], counts["flash_attention_decode"]
    check(prefill_calls > 0 and fwd == cfg.n_layers * prefill_calls,
          f"flash_attention_fwd launched {fwd} times for {prefill_calls} prefill calls")
    check(ticks > 0 and dcd == cfg.n_layers * ticks,
          f"flash_attention_decode launched {dcd} times for {ticks} decode ticks")
    check(counts["flash_attention_fwd_wgmma"] == fwd,
          f"{counts['flash_attention_fwd_wgmma']} of {fwd} prefill launches on tensor cores")
    others = {k: v for k, v in counts.items() if not k.startswith("flash_attention") and v}
    check(not others, f"other kernels on the gemma2 serving path: {others}")
    check(counts["flash_attention_bwd"] == 0, "serving launched the attention backward")
    summ = res.report.summary()
    log(f"[{DENSE_TAG}] {summ['delivered']}/{summ['n_requests']} delivered x {SERVE_MAX_NEW} "
        f"tokens, audit OK ({res.verdict.n_hops} hops), {summ['retries']} retries; "
        f"flash_attention_fwd launches {fwd} = {cfg.n_layers} x {prefill_calls} prefill "
        f"calls (all on the tensor-core kernel), flash_attention_decode {dcd} = "
        f"{cfg.n_layers} x {ticks} ticks")

    _wave_prefill_dense(dec, res.report, device)
    tokens = _tokens_by_request(res.report)
    del dec, res
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated(device)
    check(left < 2**30, f"{left / 2**30:.2f} GiB still allocated after the first decoder")
    torch.cuda.reset_peak_memory_stats(device)
    dec2, res2, by_name = _profiled_replay(lambda: _make_decoder(DENSE_ARCH, device), cfg,
                                           device, tokens, model_s, DENSE_TAG)
    log(f"[{DENSE_TAG}] replay peak {torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB "
        f"(a fresh decoder: one copy of the params)")
    _device_time_by_kind(by_name, DENSE_TAG)
    _split_one_call(dec2, res2.report, device, DENSE_TAG, "fa_")
    _time_logits(dec2, device, power_note)
    _time_cache_fold(dec2, device, power_note)
    del dec2, res2
    gc.collect()
    torch.cuda.empty_cache()
    return {"flash_attention_fwd": fwd, "flash_attention_decode": dcd}


def phase_dense_edges(device) -> None:
    """Serving paths the full-size cell does not reach, on gemma2-9b's smoke
    config through ``ModelDecoder`` (``repro_torch.serving.edge_check``,
    which the card tests run too): one ``prefill_waves`` call that admits
    both replicas with prompts of 129-256 tokens (a bucket-256 wave), then
    24 ticks of both, each local layer's ring of 16 slots engaged. In
    float32 compute the first tokens and every tick equal a CPU decoder's
    with the same params; in bf16 compute the prefill launches the
    tensor-core kernel once per layer and every tick the decode kernel once
    per layer, and the first local and global layers' attention lies within
    ``fa_tolerance`` of the plain version."""
    from repro_torch.serving.edge_check import dense_edge_check

    try:
        seen = dense_edge_check(device, DENSE_ARCH)
    except AssertionError as exc:
        raise SmokeFailure(f"edge cell: {exc}") from exc
    cfg = seen["config"]
    log(f"[dense-edges] gemma2-9b smoke config ({cfg.n_layers} layers, window "
        f"{cfg.sliding_window}): one prefill call admitting both replicas, prompts "
        f"{seen['prompts']} (bucket 256), {seen['ticks']} ticks of both; f32: first tokens "
        f"and every tick equal a CPU decoder's; bf16: launches {seen['launches']}, prefill "
        f"on tensor cores; {'; '.join(seen['rings'])}; layers 0-1 prefill and decode "
        f"attention within fa_tolerance of the plain version (max |diff| "
        f"{seen['worst']:.3g})")


def _sdpa_ms(q, k, v, causal: bool) -> str:
    """``F.scaled_dot_product_attention`` on the same tensors (heads moved
    to dim 1, GQA by ``enable_gqa``): no logit softcap, so not the same
    function; a yardstick only, never called by the port."""
    import torch.nn.functional as F

    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    run = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,  # noqa: E731
                                                 enable_gqa=True)
    return f"{time_ms(run, reps=20):.4f} ms by CUDA events, {_graph_ms(run, 20):.4f} ms device"


def _graph_ms(fn, reps: int) -> float:
    """Device time per call of ``fn``: ``reps`` calls captured in one CUDA
    graph, the graph replayed and timed with CUDA events, over ``reps``. A
    replay launches the calls back to back, so a wrapper whose host time
    exceeds its kernel's (the decode's) is timed by its kernel alone."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    ms = time_ms(graph.replay, reps=3) / reps
    del graph
    return ms


def _profiled_ms(fn, key: str, reps: int) -> str:
    """Device time per launch of the kernels whose names hold ``key``, over
    ``reps`` eager calls of ``fn`` under ``torch.profiler``: the instrument
    of the serving phases' device times, read here beside CUDA events and
    graph replay on the same calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    _, by_name = _device_busy(prof)
    hits = [(ms, n) for name, (ms, n) in by_name.items() if key in name]
    launches = sum(n for _, n in hits)
    if launches != reps:
        return f"not measured (the profiler saw {launches} of {reps} launches)"
    return f"{sum(ms for ms, _ in hits) / launches:.4f} ms per launch"


def _flex(q, k, v, cap, causal: bool, kv_len=None):
    """The library yardstick: one ``flex_attention`` call under
    ``torch.compile`` that computes the kernel's function (softcap, where
    ``cap`` is not None, as a ``score_mod``, causal or per-row kv_len as a ``mask_mod``, GQA by
    ``enable_gqa``). Returns (a function that runs it and returns the output
    in the kernels' layout, None) or (None, the error). Never called by the
    port."""
    import torch
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    try:
        B, Sq, H, hd = q.shape
        L = k.shape[1]
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

        def softcap(score, b, h, q_idx, kv_idx):
            return cap * torch.tanh(score / cap)

        if causal:
            def mask(b, h, q_idx, kv_idx):
                return kv_idx <= q_idx
            block_mask = create_block_mask(mask, None, None, Sq, L, device=q.device)
        else:
            def mask(b, h, q_idx, kv_idx):
                return kv_idx < kv_len[b]
            block_mask = create_block_mask(mask, B, None, Sq, L, device=q.device)
        flex = torch.compile(flex_attention, dynamic=False)

        def run():
            return flex(qt, kt, vt, score_mod=softcap if cap is not None else None,
                        block_mask=block_mask, enable_gqa=True).transpose(1, 2)

        run()
        torch.cuda.synchronize()
        return run, None
    except Exception as exc:  # noqa: BLE001 - the yardstick may not build; say why
        return None, f"{type(exc).__name__}: {str(exc).splitlines()[0][:300]}"


def _profiler_check(device, power_note: str) -> None:
    """Both attention kernels at their 8-lane serving shapes (softcap 50) by
    ``torch.profiler``, the instrument of the serving phases' device times,
    beside CUDA events and graph replay on the same calls; and the three
    launches of one bf16 ``ssd_scan`` call at 8 and 4 lanes by the profiler,
    pass by pass, beside CUDA events of the whole call. It runs early:
    late in this script's process the profiler missed a fixed number of
    kernel records per session (10 of 20 prefill launches, 10 of 50 decode
    launches), which halves a per-launch time taken as the sum over the
    calls made; the serving replays' profiles count every launch the
    launch counters count."""
    import torch

    from repro_torch.kernels.flash_attention import ops

    cap = 50.0
    gen = torch.Generator(device=device).manual_seed(37)
    B, S, H, KV, hd = FA_SERVE_PREFILL
    q, k, v = _fa_inputs(gen, (B, S, H, hd), (B, S, KV, hd), torch.bfloat16, device)
    run = lambda: ops.flash_attention(q, k, v, softcap=cap, impl="cuda")  # noqa: E731
    log(f"[kernels] flash_attention_fwd at (B {B}, S {S}, causal, bf16): "
        f"{_profiled_ms(run, 'fa_prefill', 20)} by torch.profiler, {time_ms(run, reps=20):.4f} "
        f"ms by CUDA events, {_graph_ms(run, 20):.4f} ms by graph replay  [{power_note}]")
    B, L, H, KV, hd = FA_SERVE_DECODE
    q, k, v = _fa_inputs(gen, (B, 1, H, hd), (B, L, KV, hd), torch.bfloat16, device)
    kv_len = torch.full((B,), L, dtype=torch.int32, device=device)
    run = lambda: ops.flash_attention_decode(q, k, v, kv_len, softcap=cap,  # noqa: E731
                                             impl="cuda")
    log(f"[kernels] flash_attention_decode at (B {B}, L {L}, bf16): "
        f"{_profiled_ms(run, 'fa_decode', 50)} by torch.profiler, {time_ms(run, reps=50):.4f} "
        f"ms by CUDA events, {_graph_ms(run, 50):.4f} ms by graph replay  [{power_note}]")

    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    for B_ in (SSD_SLICE[0], SERVE_BATCH):
        _, S, H, P, G, N, Q = SSD_SLICE
        inputs = _ssd_inputs(gen, (B_, S, H, P, G, N, Q, torch.bfloat16), device)
        run = lambda: ssd_ops.ssd_scan(*inputs, chunk=Q, impl="cuda")  # noqa: E731
        passes = ", ".join(f"{key} {_profiled_ms(run, key, 20)}" for key in SSD_PASSES)
        log(f"[kernels] ssd_scan at {B_} lanes (S {S}, chunk {Q}, bf16) by torch.profiler: "
            f"{passes}; the call {time_ms(run, reps=20):.4f} ms by CUDA events  [{power_note}]")


def _library(run, note, want):
    """(ms, note) of the library yardstick from :func:`_flex`, held to the
    plain version ``want``; (None, why) when it did not build."""
    from repro_torch.kernels.flash_attention import ref

    if run is None:
        return None, f"null ({note})"
    ok, err = ref.fa_close(run(), want)
    ms = time_ms(run, reps=20)
    try:
        how = f"{_graph_ms(run, 20):.4f} ms device by graph replay"
    except Exception as exc:  # noqa: BLE001 - a compiled call may refuse capture
        how = f"CUDA-graph capture failed: {type(exc).__name__}"
    return ms, (f"{ms:.4f} ms by CUDA events ({how}; {'within' if ok else 'outside'} "
                f"fa_tolerance of the plain version, max |diff| {err:.3g})")


def phase_fa_slice(device, power_note: str) -> list:
    """Both attention entry points at the serving shapes (gemma2-9b, both
    replicas admitted: 8 lanes x 16 heads / 8 kv heads x 256, bf16, softcap
    50), against their plain version, timed, with their bounds. ``ms``,
    ``plain_ms`` and ``library_ms`` are the CUDA-event time per call of
    back-to-back eager calls (:func:`time_ms`), as for every other row of the
    ``kernels`` line; where a wrapper's host cost exceeds its kernel's (the
    decode's), that is the host's time per call. ``graph_ms`` is the device
    time per call from CUDA-graph replays (:func:`_graph_ms`), the kernel
    alone, reported beside."""
    import torch

    from repro_torch.kernels.flash_attention import ops

    gen = torch.Generator(device=device).manual_seed(29)
    rows = []

    def record(name, err, ms, graph, plain, flops, nbytes, lib, lib_note, sdpa, shape):
        op_ms, byte_ms = flops / BF16_FLOPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        bound_ms = max(op_ms, byte_ms)
        log(f"[kernels] {name} at {shape}: {ms:.4f} ms by CUDA events ({graph:.4f} ms device "
            f"by graph replay), bound {bound_ms:.4f} ms ({bound_ms / ms:.1%}; {flops / 1e9:.3f} "
            f"GFLOP -> {op_ms:.4f} ms at 989 TFLOP/s bf16, {nbytes / 1e6:.2f} MB -> "
            f"{byte_ms:.4f} ms at 3.35 TB/s), plain {plain:.3f} ms, library "
            f"(flex_attention, torch.compile) {lib_note}, sdpa without softcap (not the same "
            f"function) {sdpa}, max_abs_err {err:.3g}  [{power_note}]")
        rows.append({
            "name": name, "route": "cuda", "source": SOURCES["flash_attention"],
            "replaces": REPLACES[name], "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain, "bound_ms": bound_ms,
            "bound_by": "operations" if op_ms >= byte_ms else "bytes", "library_ms": lib,
            "graph_ms": graph,
        })

    cap = 50.0
    for B in (FA_SERVE_PREFILL[0], SERVE_BATCH):
        _, S, H, KV, hd = FA_SERVE_PREFILL
        q, k, v = _fa_inputs(gen, (B, S, H, hd), (B, S, KV, hd), torch.bfloat16, device)
        want = ops.flash_attention(q, k, v, softcap=cap, impl="ref")
        err = _fa_vs_plain(ops.flash_attention(q, k, v, softcap=cap, impl="cuda"), want,
                           f"flash_attention_fwd at the serving shape, {B} lanes")
        kernel = lambda: ops.flash_attention(q, k, v, softcap=cap, impl="cuda")  # noqa: E731
        ms, graph = time_ms(kernel, reps=20), _graph_ms(kernel, 20)
        plain = time_ms(lambda: ops.flash_attention(q, k, v, softcap=cap, impl="ref"), reps=3)
        flops = B * H * (S * (S + 1) // 2) * 4 * hd       # the causal triangle, QK and PV
        nbytes = 2 * B * S * H * hd * 2 + 2 * B * S * KV * hd * 2
        shape = f"(B {B}, S {S}, H {H}, KV {KV}, hd {hd}, causal, bf16)"
        lib, note = _library(*_flex(q, k, v, cap, True), want)
        if B == FA_SERVE_PREFILL[0]:
            record("flash_attention_fwd", err, ms, graph, plain, flops, nbytes, lib, note,
                   _sdpa_ms(q, k, v, True), shape)
        else:
            bound = max(flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
            log(f"[kernels] flash_attention_fwd at the served 4-lane shape {shape}: "
                f"{ms:.4f} ms by CUDA events ({graph:.4f} ms device by graph replay), bound "
                f"{bound:.4f} ms, "
                f"plain {plain:.3f} ms, library {note}, sdpa without softcap "
                f"{_sdpa_ms(q, k, v, True)}  [{power_note}]")
        del q, k, v, want
    for B in (FA_SERVE_DECODE[0], SERVE_BATCH):
        _, L, H, KV, hd = FA_SERVE_DECODE
        q, k, v = _fa_inputs(gen, (B, 1, H, hd), (B, L, KV, hd), torch.bfloat16, device)
        kv_len = torch.full((B,), L, dtype=torch.int32, device=device)
        want = ops.flash_attention_decode(q, k, v, kv_len, softcap=cap, impl="ref")
        err = _fa_vs_plain(ops.flash_attention_decode(q, k, v, kv_len, softcap=cap,
                                                      impl="cuda"), want,
                           f"flash_attention_decode at the serving shape, {B} lanes")
        kernel = lambda: ops.flash_attention_decode(q, k, v, kv_len,  # noqa: E731
                                                    softcap=cap, impl="cuda")
        ms, graph = time_ms(kernel, reps=50), _graph_ms(kernel, 50)
        plain = time_ms(lambda: ops.flash_attention_decode(q, k, v, kv_len, softcap=cap,
                                                           impl="ref"), reps=10)
        flops = B * H * L * 4 * hd
        nbytes = 2 * B * L * KV * hd * 2 + 2 * B * H * hd * 2 + B * 4
        shape = f"(B {B}, Sq 1, L {L}, kv_len {L}, H {H}, KV {KV}, hd {hd}, bf16)"
        lib, note = _library(*_flex(q, k, v, cap, False, kv_len), want)
        if B == FA_SERVE_DECODE[0]:
            record("flash_attention_decode", err, ms, graph, plain, flops, nbytes, lib, note,
                   _sdpa_ms(q, k, v, False), shape)
        else:
            bound = max(flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
            log(f"[kernels] flash_attention_decode at the served 4-lane shape {shape}: "
                f"{ms:.4f} ms by CUDA events ({graph:.4f} ms device by graph replay), bound "
                f"{bound:.4f} ms, "
                f"plain {plain:.3f} ms, library {note}, sdpa without softcap "
                f"{_sdpa_ms(q, k, v, False)}  [{power_note}]")
        del q, k, v, want
    return rows


# ---------------------------------------------------------------------------
# MoE serving (slice 11): qwen3-moe-30b-a3b through the ModelDecoder
# ---------------------------------------------------------------------------

MOE_ARCH = "qwen3-moe-30b-a3b"
MOE_LAYERS = 24             # qwen3-moe-30b-a3b has 48: 120.9 GB of f32 params, over 80 GB
MOE_TAG = "moe"
MOE_PEAK_GIB = 74.0         # the phase fails above this (then cut to 16 layers)
MOE_BF16_FRAC = 2e-2        # a MoE layer's bf16 output, card vs CPU (tests/test_torch_moe.py)
MOE_LAYER_S = 512           # the card-vs-CPU layer's tokens: one prefill bucket, B 1


def _make_moe_decoder(device):
    """The torch ``ModelDecoder`` of qwen3-moe-30b-a3b at its published
    widths, depth cut to ``MOE_LAYERS``, random weights from seed 0, its
    cache sized as the other serving cells'."""
    from repro_torch.configs import archs
    from repro_torch.launch import serve_constellation as sc
    from repro_torch.serving import ModelDecoder

    cfg = archs.get(MOE_ARCH).replace(n_layers=MOE_LAYERS)
    max_len = ModelDecoder._bucket(SERVE_PROMPT[1]) + SERVE_MAX_NEW + 1
    return cfg, ModelDecoder(cfg, len(sc.REPLICAS), SERVE_BATCH, max_len, seed=0,
                             device=device)


def _moe_layer_card_vs_cpu(dec, device) -> None:
    """One MoE layer at the published widths (layer 0's params, copied to the
    CPU), B 1 x S 512 of a bf16 x drawn from a seed, on the card and on the
    CPU: ``top_e``, the token table, each token's slots and the drop count
    equal; the routing weights within rtol 1e-5; the output within
    ``MOE_BF16_FRAC`` of its largest magnitude; the aux losses within rtol
    1e-4. TF32 is switched on around the card's call, so the router's
    product has to keep itself in float32."""
    import torch

    from repro_torch.models import moe
    from repro_torch.pytree import tree_map

    cfg = dec.cfg
    E, K, C = cfg.moe.n_experts, cfg.moe.top_k, moe.capacity(MOE_LAYER_S, cfg)
    p_card = tree_map(lambda t: t[0], dec.params["units"])["L0"]["ffn"]
    p_cpu = tree_map(lambda t: t.cpu(), p_card)
    gen = torch.Generator().manual_seed(41)
    x_cpu = torch.randn(1, MOE_LAYER_S, cfg.d_model, generator=gen).to(torch.bfloat16)

    def run(p, x):
        r = moe.route(p["router"], x, K)
        d = moe.dispatch(r.top_e, r.top_w, E, C)
        out, aux = moe.moe_apply(p, x, cfg)
        return r, d, out, aux

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with torch.no_grad():
            card = run(p_card, x_cpu.to(device))
        torch.cuda.synchronize(device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    t0 = time.perf_counter()
    with torch.no_grad():
        cpu = run(p_cpu, x_cpu)
    cpu_s = time.perf_counter() - t0
    (rg, dg, og, ag), (rc, dc, oc, ac) = tree_map(lambda t: t.cpu(), card), cpu
    for what, a, b in (("top_e", rg.top_e, rc.top_e), ("token table", dg.table, dc.table),
                       ("slots", dg.slots, dc.slots), ("counts", dg.counts, dc.counts),
                       ("drops", dg.dropped, dc.dropped)):
        check(torch.equal(a, b), f"MoE layer, card vs CPU: {what} differ "
              f"({int((a != b).sum())} of {a.numel()})")
    w_rel = float(((rg.top_w - rc.top_w).abs() / rc.top_w.abs()).max())
    scale = float(oc.float().abs().max())
    out_frac = float((og.float() - oc.float()).abs().max()) / scale
    ulps = out_frac * scale / 2.0 ** (math.floor(math.log2(scale)) - 7)
    aux_rel = max(abs(float(ag[k]) / float(ac[k]) - 1.0) for k in ac)
    log(f"[{MOE_TAG}] one MoE layer at the published widths (B 1, S {MOE_LAYER_S}, bf16, "
        f"C {C}, TF32 on around the card's call), card vs CPU ({cpu_s:.1f} s on the CPU): "
        f"top_e, token table, slots, counts and drops equal; {int(dc.dropped)} of "
        f"{MOE_LAYER_S * K} assignments dropped ({int(dc.dropped) / (MOE_LAYER_S * K):.2%}); "
        f"top_w max rel {w_rel:.3g}; output max |diff| {out_frac:.3g} of its scale (bound "
        f"{MOE_BF16_FRAC}), {ulps:.3g} bf16 ulps at that scale; aux losses rel {aux_rel:.3g}")
    check(torch.backends.cuda.matmul.allow_tf32 == prev, "moe left the TF32 switch changed")
    check(w_rel <= 1e-5 and out_frac <= MOE_BF16_FRAC and aux_rel <= 1e-4,
          f"MoE layer, card vs CPU: top_w {w_rel:.3g}, output {out_frac:.3g} of its scale, "
          f"aux {aux_rel:.3g}")


def _moe_drops_by_layer(dec, report) -> None:
    """The dropped share of routed assignments in one 4-lane prefill call
    (the first wave's prompts, left-padded to their bucket) and one 4-lane
    tick after it, layer by layer (``moe.count_drops`` keeps each call's
    layers in order)."""
    import numpy as np
    import torch

    from repro_torch.models import moe

    prompts = [r.prompt for r in sorted(report.requests, key=lambda r: r.rid)[:SERVE_BATCH]]
    plen = dec._bucket(max(len(p) for p in prompts))
    pads = sum(plen - len(p) for p in prompts)
    with moe.count_drops() as tally:
        dec.prefill_waves({0: prompts})
        dec.step(np.array([True, False]))
    for kind, what in (("prefill", f"one 4-lane prefill call (bucket {plen}, {pads} of "
                        f"{SERVE_BATCH * plen} tokens left padding)"),
                       ("decode", "the 4-lane tick after it")):
        per = torch.stack(tally[kind]).tolist()
        seen, dropped = (sum(c[i] for c in per) for i in (0, 1))
        shares = ", ".join(f"{d / n:.0%}" for n, d in per)
        log(f"[{MOE_TAG}] {what}: {dropped} of {seen} assignments dropped ({dropped / seen:.2%});"
            f" by layer {shares}")


def _moe_attention(device, power_note: str) -> None:
    """The attention kernels at qwen3-moe's shapes (32 / 4 heads x 128, G 8,
    no softcap): ``kernels/flash_attention/cases.py``'s serving cases
    against their plain versions (prefill at 4 and 8 lanes, S 512, causal;
    decode at 8 lanes against 529 slots with ragged kv_len; bf16 and f32,
    each launched twice bit-identical), then the bf16 prefill at 8 and 4
    lanes and the decode at 8 lanes timed beside their bounds and
    ``flex_attention`` (the same function: no softcap)."""
    import torch

    from repro_torch.kernels.flash_attention import cases, ops

    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for case in cases.SERVE_PREFILL_CASES:
            worst = max(worst, _case(cases.check_prefill_case, case, dtype, device))
        for case in cases.SERVE_DECODE_CASES:
            worst = max(worst, _case(cases.check_decode_case, case, dtype, device))
    log(f"[{MOE_TAG}] attention at qwen3-moe's shapes (G 8, hd 128, no softcap): "
        f"{2 * len(cases.SERVE_PREFILL_CASES)} prefill and {2 * len(cases.SERVE_DECODE_CASES)} "
        f"decode cases, bf16 and f32, within fa_tolerance of the plain version (max |diff| "
        f"{worst:.3g}), each launched twice bit-identical, bf16 prefills on tensor cores")
    gen = torch.Generator(device=device).manual_seed(43)
    for B, S, H, KV, hd, causal, _, _ in cases.SERVE_PREFILL_CASES[::-1]:
        q, k, v = _fa_inputs(gen, (B, S, H, hd), (B, S, KV, hd), torch.bfloat16, device)
        want = ops.flash_attention(q, k, v, impl="ref")
        kernel = lambda: ops.flash_attention(q, k, v, impl="cuda")  # noqa: E731
        ms, graph = time_ms(kernel, reps=20), _graph_ms(kernel, 20)
        plain = time_ms(lambda: ops.flash_attention(q, k, v, impl="ref"), reps=3)
        flops = B * H * (S * (S + 1) // 2) * 4 * hd
        nbytes = 2 * B * S * H * hd * 2 + 2 * B * S * KV * hd * 2
        _, note = _library(*_flex(q, k, v, None, True), want)
        _log_g8_row("flash_attention_fwd", f"(B {B}, S {S}, H {H}, KV {KV}, hd {hd}, causal, "
                    "bf16)", ms, graph, plain, flops, nbytes, note, power_note)
        del q, k, v, want
    for B, L, H, KV, hd, lens in cases.SERVE_DECODE_CASES:
        q, k, v = _fa_inputs(gen, (B, 1, H, hd), (B, L, KV, hd), torch.bfloat16, device)
        kv_len = torch.tensor(lens, dtype=torch.int32, device=device)
        want = ops.flash_attention_decode(q, k, v, kv_len, impl="ref")
        kernel = lambda: ops.flash_attention_decode(q, k, v, kv_len, impl="cuda")  # noqa: E731
        ms, graph = time_ms(kernel, reps=50), _graph_ms(kernel, 50)
        plain = time_ms(lambda: ops.flash_attention_decode(q, k, v, kv_len, impl="ref"),
                        reps=10)
        n = sum(lens)           # the keys this run's kv_len reads
        flops = n * H * 4 * hd
        nbytes = 2 * n * KV * hd * 2 + 2 * B * H * hd * 2 + B * 4
        _, note = _library(*_flex(q, k, v, None, False, kv_len), want)
        _log_g8_row("flash_attention_decode", f"(B {B}, Sq 1, L {L}, kv_len {list(lens)}, "
                    f"H {H}, KV {KV}, hd {hd}, bf16)", ms, graph, plain, flops, nbytes, note,
                    power_note)
        del q, k, v, want


def _case(fn, case, dtype, device) -> float:
    try:
        return fn(case, dtype, device)
    except AssertionError as exc:
        raise SmokeFailure(f"attention case: {exc}") from exc


def _log_g8_row(name, shape, ms, graph, plain, flops, nbytes, note, power_note) -> None:
    op_ms, byte_ms = flops / BF16_FLOPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    bound = max(op_ms, byte_ms)
    log(f"[{MOE_TAG}] {name} at {shape}: {ms:.4f} ms by CUDA events ({graph:.4f} ms device "
        f"by graph replay), bound {bound:.4f} ms by {'operations' if op_ms >= byte_ms else 'bytes'} "
        f"({bound / ms:.1%}; {flops / 1e9:.3f} GFLOP at 989 TFLOP/s "
        f"bf16, {nbytes / 1e6:.2f} MB at 3.35 TB/s), plain {plain:.3f} ms, library "
        f"(flex_attention, torch.compile) {note}  [{power_note}]")


def phase_serving_moe(device, power_note: str) -> dict:
    """Slice 11: qwen3-moe-30b-a3b at its published widths, 24 of 48 layers
    (15.27 B f32 params), through ``serve_constellation``'s entry points
    with the ``ModelDecoder`` built directly, the launch counters zeroed
    just before and read just after and the MoE drops tallied
    (``moe.count_drops``); a replay on a fresh decoder under the profiler,
    bit-identical; one MoE layer card vs CPU; the attention kernels at the
    cell's shapes. Returns the attention launches of the serving run."""
    import gc

    import torch

    from repro_torch.models import moe
    from repro_torch.pytree import tree_leaves

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    cfg, dec = _make_moe_decoder(device)
    torch.cuda.synchronize(device)
    init_peak = torch.cuda.max_memory_allocated(device)
    n_params = sum(t.numel() for t in tree_leaves(dec.params))
    n_attn, n_moe = (sum(t[0].numel() for t in tree_leaves(dec.params["units"]["L0"][part]))
                     for part in ("attn", "ffn"))
    cache_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(dec._cache))
    m = cfg.moe
    log(f"[{MOE_TAG}] {cfg.name}: {cfg.n_layers} of 48 layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv heads x {cfg.head_dim}, {m.n_experts} "
        f"experts top-{m.top_k}, expert d_ff {m.d_ff}, capacity factor {m.capacity_factor}, "
        f"vocab {cfg.vocab_size} (tied), rope theta {cfg.rope_theta:g}; params {n_params:,} "
        f"f32 ({n_params * 4 / 1e9:.2f} GB, seed 0; per layer {n_attn / 1e6:.1f} M attention, "
        f"{n_moe / 1e6:.1f} M MoE), caches {cache_bytes / 1e6:.1f} MB for 2 replicas (max_len "
        f"{dec.max_len}); {cfg.compute_dtype} compute; decoder built in "
        f"{time.perf_counter() - t0:.1f} s, peak {_gib(init_peak)} GiB while building")
    check(cfg.n_layers == MOE_LAYERS and m.n_experts == 128 and m.top_k == 8,
          f"{cfg.name}: {cfg.n_layers} layers, {m.n_experts} experts top-{m.top_k}")
    _moe_layer_card_vs_cpu(dec, device)
    torch.cuda.reset_peak_memory_stats(device)
    with moe.count_drops() as tally:
        res, rec, counts, model_s = _run_serving(dec, cfg, device, MOE_TAG)
    drops = {kind: torch.stack(calls).sum(0).tolist() for kind, calls in tally.items()}
    del tally
    peak = max(init_peak, torch.cuda.max_memory_allocated(device))
    prefill_calls = int(rec.get_counter("serve.prefill.calls"))
    ticks = sum(1 for sp in rec.spans if sp.name == "serve.decode")
    fwd, dcd = counts["flash_attention_fwd"], counts["flash_attention_decode"]
    check(prefill_calls > 0 and fwd == cfg.n_layers * prefill_calls,
          f"flash_attention_fwd launched {fwd} times for {prefill_calls} prefill calls")
    check(ticks > 0 and dcd == cfg.n_layers * ticks,
          f"flash_attention_decode launched {dcd} times for {ticks} decode ticks")
    check(counts["flash_attention_fwd_wgmma"] == fwd,
          f"{counts['flash_attention_fwd_wgmma']} of {fwd} prefill launches on tensor cores")
    others = {k: v for k, v in counts.items() if not k.startswith("flash_attention") and v}
    check(not others and counts["flash_attention_bwd"] == 0,
          f"other kernels on the MoE serving path: {others}, bwd {counts['flash_attention_bwd']}")
    check(peak <= MOE_PEAK_GIB * 2 ** 30,
          f"peak {_gib(peak)} GiB above {MOE_PEAK_GIB} GiB: cut the cell to 16 layers")
    summ = res.report.summary()
    log(f"[{MOE_TAG}] {summ['delivered']}/{summ['n_requests']} delivered x {SERVE_MAX_NEW} "
        f"tokens, audit OK ({res.verdict.n_hops} hops), {summ['retries']} retries; "
        f"flash_attention_fwd launches {fwd} = {cfg.n_layers} x {prefill_calls} prefill calls "
        f"(all on the tensor-core kernel), flash_attention_decode {dcd} = {cfg.n_layers} x "
        f"{ticks} ticks; peak {_gib(peak)} GiB (bound {MOE_PEAK_GIB})")
    for kind, (seen, dropped) in sorted(drops.items()):
        log(f"[{MOE_TAG}] {kind}: {dropped} of {seen} routed assignments dropped over "
            f"capacity ({dropped / seen:.2%}), all {cfg.n_layers} layers of "
            f"{prefill_calls if kind == 'prefill' else ticks} calls")
    check(set(drops) == {"prefill", "decode"}, f"drops tallied for {sorted(drops)}")

    tokens = _tokens_by_request(res.report)
    del dec, res
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated(device)
    check(left < 2**30, f"{_gib(left)} GiB still allocated after the first decoder")
    torch.cuda.reset_peak_memory_stats(device)
    dec2, res2, by_name = _profiled_replay(lambda: _make_moe_decoder(device), cfg, device,
                                           tokens, model_s, MOE_TAG)
    log(f"[{MOE_TAG}] replay peak {_gib(torch.cuda.max_memory_allocated(device))} GiB")
    _device_time_by_kind(by_name, MOE_TAG)
    _split_one_call(dec2, res2.report, device, MOE_TAG, "fa_")
    _moe_drops_by_layer(dec2, res2.report)
    del dec2, res2
    gc.collect()
    torch.cuda.empty_cache()
    _moe_attention(device, power_note)
    log(f"[{MOE_TAG}] phase {time.perf_counter() - t_phase:.1f} s")
    return {"flash_attention_fwd": fwd, "flash_attention_decode": dcd}


# ---------------------------------------------------------------------------
# dense training (slice 9): gemma2-9b through launch/steps.py
# ---------------------------------------------------------------------------

TRAIN_ARCH = "gemma2-9b"
TRAIN_LAYERS = 8            # gemma2-9b has 42; cut for memory (f32 params, grads, AdamW mu, nu)
TRAIN_SEQ = 4096            # the published train_4k shape's sequence
TRAIN_BATCH = 2             # train_4k's global batch of 256, cut to one card
TRAIN_STEPS = 4
TRAIN_TAG = "dense-train"
FA_TRAIN = (TRAIN_BATCH, TRAIN_SEQ, 16, 8, 256)            # (B, S, H, KV, hd)
TRAIN_WINDOW = 4096                                         # gemma2-9b's local layers


def _train_kernel_cases(device) -> None:
    """(a) ``flash_attention_bwd`` and the forward's lse against their plain
    versions (``kernels/flash_attention/cases.py``, which the card tests
    run too), f32 and bf16, each case launched twice and bit-identical."""
    import torch

    from repro_torch.kernels.flash_attention import cases

    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for case in cases.BWD_CASES:
            try:
                errs = cases.check_bwd_case(case, dtype, device)
            except AssertionError as exc:
                raise SmokeFailure(f"training attention: {exc}") from exc
            for k, v in errs.items():
                worst[k] = max(worst.get(k, 0.0), v)
    log(f"[{TRAIN_TAG}] {2 * len(cases.BWD_CASES)} training attention cases (hd 16-256, "
        f"G 1-4 (G 4 at hd 256) and MQA, causal, windows 5-256 with edges inside tiles and "
        f"one biting at S 1024, softcap 50 and none, ragged S 33-300 (65, 127, 191 across the "
        f"64-row tiles), the cell's local layers at S 4096 (window 4096), f32 and bf16): each "
        f"launched twice "
        f"bit-identical; lse within 1e-5 of max(|lse|, 1) of the plain lse, the output within "
        f"fa_tolerance, dq / dk / dv within bwd_tolerance (1e-4 of each tensor's scale, plus "
        f"one bf16 ulp in bf16) of ref.attention_bwd_ref; max |diff| " + ", ".join(
            f"{k} {v:.3g}" for k, v in worst.items()))


def _train_cell(device, power_note: str) -> dict:
    """(b) gemma2-9b at its published widths, 8 of 42 layers, through
    ``launch/steps.build_train_step`` on ``SyntheticStream`` at S 4096,
    batch 2, 4 steps with ``launch/train.py``'s OptConfig defaults. Returns
    the launch counts of the 4 steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import archs
    from repro_torch.data import pipeline
    from repro_torch.kernels.flash_attention import flash_attention as fa_kern
    from repro_torch.launch import steps
    from repro_torch.launch.fl_train import batch_to_device
    from repro_torch.models import registry, transformer
    from repro_torch.models.config import SHAPES, ShapeConfig
    from repro_torch.optim import adamw
    from repro_torch.pytree import tree_leaves

    cfg = archs.get(TRAIN_ARCH).replace(n_layers=TRAIN_LAYERS)
    base = SHAPES["train_4k"]
    check(base.seq_len == TRAIN_SEQ, f"train_4k's sequence is {base.seq_len}")
    shape = ShapeConfig(base.name, base.kind, TRAIN_SEQ, TRAIN_BATCH)
    opt_cfg = adamw.OptConfig(peak_lr=3e-3, warmup_steps=5, decay_steps=max(TRAIN_STEPS, 10))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    state = steps.init_state(0, cfg, opt_cfg, device)
    torch.cuda.synchronize(device)
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    log(f"[{TRAIN_TAG}] {TRAIN_ARCH} at its published widths (d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads x {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, window {cfg.sliding_window}, softcaps {cfg.attn_softcap} / "
        f"{cfg.final_softcap}), {cfg.n_layers} of 42 layers, remat {cfg.remat}: "
        f"{n_params / 1e9:.3f} B params, state {_gib(torch.cuda.memory_allocated(device))} "
        f"GiB, init {time.perf_counter() - t0:.1f} s")
    train_step = steps.build_train_step(cfg, opt_cfg)
    stream = pipeline.SyntheticStream(cfg, shape, seed=0)
    batches = [batch_to_device(stream.batch(i), device) for i in range(TRAIN_STEPS + 1)]
    attn_layers = sum(d.mixer == "attn" for d in transformer.scan_unit(cfg)) * \
        transformer.n_units(cfg)
    fa_kern.reset_launch_counts()
    losses = []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = train_step(state, batches[i])
        torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        losses.append(loss)
        log(f"[{TRAIN_TAG}] step {i}: loss {loss:.4f}, grad norm {gnorm:.4f}, lr "
            f"{float(metrics['lr']):.2e}, host step time {dt:.3f} s (ends in "
            f"torch.cuda.synchronize()), {TRAIN_BATCH * TRAIN_SEQ / dt:.0f} tokens/s  "
            f"[{power_note}]")
    counts = fa_kern.launch_counts()
    peak = torch.cuda.max_memory_allocated(device)
    per_step = 2 if cfg.remat == "full" else 1
    want = {"flash_attention_fwd": per_step * attn_layers * TRAIN_STEPS,
            "flash_attention_fwd_wgmma": per_step * attn_layers * TRAIN_STEPS,
            "flash_attention_bwd": attn_layers * TRAIN_STEPS, "flash_attention_decode": 0}
    log(f"[{TRAIN_TAG}] launches in {TRAIN_STEPS} steps: " + ", ".join(
        f"{k} {counts[k]} (oracle {want[k]})" for k in want) +
        f"; peak {_gib(peak)} GiB of device memory")
    check(counts == want, f"training launches {counts} != oracle {want}")
    # the loss of step 0's batch again, after the 4 steps: each step's loss
    # is on a fresh batch, and at random init the final softcap saturates the
    # logits (a loss of ~40), so batch-to-batch spread (~0.5) hides 4 steps
    # of progress; the same batch does not
    loss_fn = registry.bundle(cfg).loss_fn
    with torch.no_grad():
        again = float(loss_fn(state["params"], batches[0])[0])
        unseen = float(loss_fn(state["params"], batches[TRAIN_STEPS])[0])
    log(f"[{TRAIN_TAG}] step 0's batch after {TRAIN_STEPS} steps: loss {again:.4f} "
        f"(step 0: {losses[0]:.4f}); step {TRAIN_STEPS}'s batch, unseen: {unseen:.4f}")
    check(all(l == l and abs(l) != float("inf") for l in losses + [again]),
          f"non-finite training loss: {losses}, {again}")
    check(again < losses[0], f"training loss did not fall on step 0's batch: {losses[0]} "
          f"at init, {again} after {TRAIN_STEPS} steps")

    # one more step under torch.profiler: device busy time by kind
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = train_step(state, batches[TRAIN_STEPS])
        torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
    busy, by_name = _device_busy(prof)
    kinds = {"attention forward (fa_prefill)": 0.0, "attention backward (fa_bwd)": 0.0,
             "GEMMs": 0.0, "casts and copies": 0.0, "elementwise and reductions": 0.0}
    for name, (ms, _) in by_name.items():
        low = name.lower()
        if "fa_prefill" in name:
            kinds["attention forward (fa_prefill)"] += ms
        elif "fa_bwd" in name:
            kinds["attention backward (fa_bwd)"] += ms
        elif any(t in low for t in ("gemm", "xmma", "nvjet", "cutlass", "cublas")):
            kinds["GEMMs"] += ms
        elif "copy" in low or "memcpy" in low:
            kinds["casts and copies"] += ms
        else:
            kinds["elementwise and reductions"] += ms
    log(f"[{TRAIN_TAG}] profiled step {TRAIN_STEPS}: host {dt:.3f} s, device busy "
        f"{busy / 1e3:.3f} s ({busy / 1e3 / dt:.1%}), by kind: " + ", ".join(
            f"{k} {ms:.1f} ms" for k, ms in kinds.items()) + f"  [{power_note}]")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"[{TRAIN_TAG}]   {_short(name)}: {ms:.1f} ms in {n} launches")
    log(f"[{TRAIN_TAG}] the attention backward's passes in the profiled step: " + ", ".join(
        f"{_short(name)} {ms:.1f} ms in {n} launches ({ms / n:.3f} ms each)"
        for name, (ms, n) in sorted(by_name.items()) if "fa_bwd" in name))
    del state, metrics, batches, prof
    torch.cuda.empty_cache()
    return counts


def _short(kernel_name: str) -> str:
    return kernel_name.replace("(anonymous namespace)::", "").split("(")[0][-70:]


def _gib(nbytes: int) -> str:
    return f"{nbytes / 2 ** 30:.2f}"


def _train_smoke_paths(device) -> None:
    """(c) on the gemma2-9b smoke config, f32 compute: one microbatched step
    (micro 2) on the card against the same step on the CPU (the plain
    path; ``cases.check_first_step``), and a checkpoint round trip on the
    card (bf16 leaves and int8 AdamW moments included), restored equal bit
    for bit."""
    import tempfile

    import torch

    from repro_torch.checkpoint import checkpoint as ckpt_lib
    from repro_torch.configs import archs
    from repro_torch.data import pipeline
    from repro_torch.kernels.flash_attention import cases
    from repro_torch.launch import steps
    from repro_torch.launch.fl_train import batch_to_device
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import adamw
    from repro_torch.pytree import tree_leaves, tree_map

    cfg = archs.smoke_cfg(archs.get(TRAIN_ARCH)).replace(compute_dtype="float32",
                                                          micro_steps=2)
    opt_cfg = adamw.OptConfig(peak_lr=3e-3, warmup_steps=5, decay_steps=10)
    cpu = steps.init_state(0, cfg, opt_cfg, "cpu")
    card = tree_map(lambda t: t.to(device), cpu)
    batch = pipeline.SyntheticStream(cfg, ShapeConfig("c", "train", 40, 4), seed=3).batch(0)
    step = steps.build_train_step(cfg, opt_cfg)
    cpu, m_cpu = step(cpu, batch_to_device(batch, "cpu"))
    card, m_card = step(card, batch_to_device(batch, device))
    torch.cuda.synchronize(device)
    total = sum(t.numel() for t in tree_leaves(cpu["params"]))
    # f32 on both sides, sums in another order: the loss and the grad norm
    # within 1e-5, each leaf's mu (0.1 * the clipped gradient) within 1e-5
    # of its scale (as tests/test_torch_train.py holds the first step to
    # the reference; measured on an H100: 9.0e-8, 1.5e-7 and 6.0e-7), each
    # param entry within what that lets Adam's first step move it, and at
    # most 1e-4 of the entries more than 1e-6 apart (a gradient entry
    # within the tolerance of zero may flip its sign; measured 3)
    try:
        read = cases.check_first_step(card, m_card, cpu, m_cpu, opt_cfg, loss_rtol=1e-5,
                                      gnorm_rtol=1e-5, mu_rtol=1e-5)
    except AssertionError as exc:
        raise SmokeFailure(f"micro-2 step card vs CPU: {exc}") from exc
    log(f"[{TRAIN_TAG}] smoke config, micro 2 (S 40: the card's kernels on a ragged S, the "
        f"CPU's naive path): loss {float(m_card['loss']):.6f} on the card, "
        f"{float(m_cpu['loss']):.6f} on the CPU (rel {read['loss_rel']:.2e}); grad norm "
        f"{float(m_card['grad_norm']):.6f} (rel {read['gnorm_rel']:.2e}); mu max |diff| "
        f"{read['mu_frac']:.2e} of its leaf's scale; params max |diff| "
        f"{read['param_gap']:.2e}, smallest slack to the bound {read['param_slack']:.2e}, "
        f"{read['flips']} of {total} entries off by more than 1e-6")
    check(read["flips"] <= 1e-4 * total, f"micro-2 step card vs CPU: {read['flips']} param "
          f"entries of {total} off by more than 1e-6")

    q_opt = adamw.OptConfig(dtype="int8")
    tree = {"state": steps.init_state(1, cfg, q_opt, device),
            "bf16": tree_map(lambda t: t.to(torch.bfloat16), card["params"])}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        ckpt_lib.save(d, 7, tree)
        ckpt_lib.wait_all()
        step_no, back = ckpt_lib.restore(d, target=tree, device=device)
    same = all(a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
               for a, b in zip(tree_leaves(back), tree_leaves(tree)))
    log(f"[{TRAIN_TAG}] checkpoint round trip on the card (step {step_no}, "
        f"{len(tree_leaves(tree))} leaves: f32 params, int8 AdamW moments with f32 scales, "
        f"bf16 params, int32 counters): restored equal bit for bit: {same}")
    check(step_no == 7 and same, "checkpoint round trip on the card differs")


def _flex_bwd(q, k, v, g, cap: float):
    """The library yardstick of the backward: ``flex_attention`` under
    ``torch.compile`` (softcap ``score_mod``, causal ``block_mask``), its
    autograd backward timed alone. Not the same function to the bit: flex
    rounds p to bf16 before PV. Returns (a function running the backward,
    None) or (None, the error). Never called by the port."""
    import torch
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    try:
        B, S, H, hd = q.shape
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
        gt = g.transpose(1, 2).contiguous()

        def softcap(score, b, h, q_idx, kv_idx):
            return cap * torch.tanh(score / cap)

        def mask(b, h, q_idx, kv_idx):
            return kv_idx <= q_idx

        block_mask = create_block_mask(mask, None, None, S, S, device=q.device)
        flex = torch.compile(flex_attention, dynamic=False)
        out = flex(qt, kt, vt, score_mod=softcap, block_mask=block_mask, enable_gqa=True)

        def run():
            return torch.autograd.grad(out, (qt, kt, vt), gt, retain_graph=True)

        run()
        torch.cuda.synchronize()
        return run, None
    except Exception as exc:  # noqa: BLE001 - the yardstick may not build; say why
        return None, f"{type(exc).__name__}: {str(exc).splitlines()[0][:300]}"


def _train_bwd_row(device, power_note: str) -> dict:
    """The ``flash_attention_bwd`` row at the cell's shape (B 2, S 4096, 16
    heads / 8 kv heads x 256, causal, softcap 50, bf16): the kernel against
    its plain version on the kernels' own (out, lse), once those are held
    to ``ref.attention_ref`` and ``ref.attention_lse_ref``; CUDA-event
    times of both and of the library call, the bound. The row is the global
    layers' call (no window); the local layers' (window 4096) is timed
    beside it."""
    import torch

    from repro_torch.kernels.flash_attention import ops, ref

    B, S, H, KV, hd = FA_TRAIN
    cap = 50.0
    gen = torch.Generator(device=device).manual_seed(41)
    q, k, v = _fa_inputs(gen, (B, S, H, hd), (B, S, KV, hd), torch.bfloat16, device)
    g = torch.randn(B, S, H, hd, generator=gen, device=device).to(torch.bfloat16)
    out, lse = ops.flash_attention(q, k, v, softcap=cap, impl="cuda", lse=True)
    torch.cuda.synchronize()
    # the forward's out and lse at this shape first: the backward below is
    # compared on them, so a wrong lse would pass into both sides unseen
    ok, out_err = ref.fa_close(out, ref.attention_ref(q, k, v, softcap=cap))
    check(ok, f"flash_attention_fwd at the training shape: out outside fa_tolerance "
              f"({out_err})")
    ok, lse_err = ref.lse_close(lse, ref.attention_lse_ref(q, k, softcap=cap))
    check(ok, f"flash_attention_fwd at the training shape: lse outside F32_RTOL of its "
              f"scale ({lse_err})")
    torch.cuda.empty_cache()
    kernel = lambda: ops.flash_attention_bwd(q, k, v, out, lse, g, softcap=cap,  # noqa: E731
                                             impl="cuda")
    got = kernel()
    want = ops.flash_attention_bwd(q, k, v, out, lse, g, softcap=cap, impl="ref")
    torch.cuda.synchronize()
    err = 0.0
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        ok, e = ref.bwd_close(a, w)
        check(ok, f"flash_attention_bwd at the training shape: {name} outside "
                  f"bwd_tolerance ({e})")
        err = max(err, e)
    del got, want
    ms = time_ms(kernel, reps=5)
    plain = time_ms(lambda: ops.flash_attention_bwd(q, k, v, out, lse, g, softcap=cap,
                                                    impl="ref"), reps=2)
    torch.cuda.empty_cache()
    run, note = _flex_bwd(q, k, v, g, cap)
    lib = None
    if run is not None:
        lib = time_ms(run, reps=5)
        note = (f"{lib:.3f} ms by CUDA events (flex_attention's backward under torch.compile, "
                f"softcap score_mod; it rounds p to bf16, so not the same function to the bit)")
    # the local layers' call (window 4096) beside the global layers' (the
    # row); the passes' device times come from the profiled training step
    out_w, lse_w = ops.flash_attention(q, k, v, softcap=cap, window=TRAIN_WINDOW, impl="cuda",
                                       lse=True)
    local_ms = time_ms(lambda: ops.flash_attention_bwd(q, k, v, out_w, lse_w, g, softcap=cap,
                                                       window=TRAIN_WINDOW, impl="cuda"), reps=5)
    del out_w, lse_w
    log(f"[kernels] flash_attention_bwd at both layer kinds of the cell: global (no window) "
        f"{ms:.3f} ms, local (window {TRAIN_WINDOW}) {local_ms:.3f} ms by CUDA events  "
        f"[{power_note}]")
    flops = 5 * 2 * B * H * (S * (S + 1) // 2) * hd      # the causal triangle, five products
    nbytes = 4 * B * S * H * hd * 2 + 4 * B * S * KV * hd * 2 + B * H * S * 4
    op_ms, byte_ms = flops / BF16_FLOPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    bound = max(op_ms, byte_ms)
    log(f"[kernels] flash_attention_bwd at (B {B}, S {S}, H {H}, KV {KV}, hd {hd}, causal, "
        f"softcap {cap}, bf16): {ms:.3f} ms by CUDA events, bound {bound:.4f} ms "
        f"({bound / ms:.2%}; {flops / 1e9:.1f} GFLOP -> {op_ms:.4f} ms at 989 TFLOP/s bf16, "
        f"{nbytes / 1e6:.1f} MB -> {byte_ms:.4f} ms at 3.35 TB/s), plain {plain:.3f} ms, "
        f"library {note if lib is None else note}, max_abs_err {err:.3g}; the forward's out "
        f"within fa_tolerance (max |diff| {out_err:.3g}), its lse within 1e-5 of its scale "
        f"(max |diff| {lse_err:.3g})  [{power_note}]")
    return {"name": "flash_attention_bwd", "route": "cuda", "source": SOURCES["flash_attention"],
            "replaces": REPLACES["flash_attention_bwd"], "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain, "bound_ms": bound,
            "bound_by": "operations" if op_ms >= byte_ms else "bytes", "library_ms": lib}


def phase_dense_train(device, power_note: str) -> tuple:
    """Slice 9: (a) the training attention kernels' small cases, (b) the
    gemma2-9b training cell, (c) a microbatched step and a checkpoint round
    trip on the smoke config, then the backward's row. Returns (the cell's
    launch counts, the ``flash_attention_bwd`` row)."""
    t0 = time.perf_counter()
    _train_kernel_cases(device)
    counts = _train_cell(device, power_note)
    _train_smoke_paths(device)
    row = _train_bwd_row(device, power_note)
    log(f"[{TRAIN_TAG}] phase {time.perf_counter() - t0:.1f} s")
    return counts, row


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
    phase_fa_small(device)
    _profiler_check(device, dev["card"])
    mark("small kernel cases")
    phase_dense_edges(device)
    mark("gemma2-9b smoke edges")
    serve_launches = phase_serving(device)
    mark("serving, mamba2-780m")
    dense_launches = phase_serving_dense(device, dev["card"])
    mark("serving, gemma2-9b")
    moe_launches = phase_serving_moe(device, dev["card"])
    mark("serving, qwen3-moe-30b-a3b")
    launches, buf, k_b = phase_slice(device)
    mark("slice 1")
    gs_launches = phase_groundseg(device)
    mark("slice 2")
    hier_launches = phase_paper_exchange(device)
    mark("slice 8")
    kernels = phase_kernels_slice(device, buf, k_b, dev["card"])
    for row in kernels:
        row["launches"] = (launches[row["name"]] + gs_launches[row["name"]]
                           + hier_launches[row["name"]])
    del buf
    torch.cuda.empty_cache()
    train_launches, bwd_row = phase_dense_train(device, dev["card"])
    mark("slice 9, dense training")
    ssd_row = phase_ssd_slice(device, dev["card"])
    ssd_row["launches"] = serve_launches["ssd_scan"]
    kernels.append(ssd_row)
    for row in phase_fa_slice(device, dev["card"]):
        row["launches"] = (dense_launches[row["name"]] + moe_launches[row["name"]]
                           + train_launches[row["name"]])
        kernels.append(row)
    bwd_row["launches"] = train_launches["flash_attention_bwd"]
    kernels.append(bwd_row)
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
