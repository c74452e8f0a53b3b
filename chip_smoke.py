#!/usr/bin/env python3
"""The PyTorch port on one NVIDIA GPU (written for an H100): the kernel table,
the configurations that no benchmark cell runs, and the main path at the
cells' widths with its launches counted.

    python3 chip_smoke.py

Correctness on the card is ``python -m pytest -m cuda tests/test_torch_cuda.py``
(every kernel against its plain version, the FL, exchange and serving paths
through the kernels at smoke widths); the cells of ``BENCHMARK.json``
(``portbench/run.py``) time mamba2-780m and nemotron-3-nano serving and the
int8 TDM-FLA rounds and check what they produce, but count no launches and
run neither the none and top-k rounds nor the ground segment. This script
does the rest:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions;
2. build: compiles ``src/repro_torch/csrc/tdm_compress.cu``,
   ``ssd_scan.cu`` and ``flash_attention.cu`` with nvcc (``sm_90a``), one
   process per source started together, and prints the build times and
   ptxas' per-kernel report;
3. gemma2-9b serving at its published config, **all 42 layers** (9.24 B f32
   params, 36.97 GB, one copy for both replicas), random weights from seed
   0, through ``repro_torch.launch.serve_constellation``: the smoke scenario
   (6 MEO satellites, 2 ground stations), replicas 0 and 3, batch 4, 16
   requests at one per slot, prompts of 200-300 tokens over the full
   vocabulary, 16 new tokens each, replica 0 lost mid-epoch and restored;
   the launch counters zeroed just before and read just after. Checks: every
   request delivered with 16 tokens, the route-provenance audit clean, the
   mid-epoch failure re-routed, ``flash_attention_fwd`` launched 42 times
   per prefill call (all on the tensor-core kernel) and
   ``flash_attention_decode`` 42 times per decode tick, no other kernel; one
   wave's prefill (the first four prompts, left-padded to their bucket)
   through the kernel and through the plain version, layer by layer on the
   same input (attention within ``fa_tolerance``, the sub-layer output
   within ``OUT_ULPS`` bf16 ulps of its largest magnitude, K/V cache entries
   bit-identical), and the whole prefill's last-token logits within
   ``SERVE_SPREAD`` times the plain path's own spread (the same prefill with
   p rounded to bf16 before the PV product, as the reference's prefill
   attention computes); the same workload on a fresh decoder (the first one
   freed: two copies of the params do not fit) gives the same token streams
   bit for bit;
4. qwen3-moe-30b-a3b (``[moe]`` lines) at its published widths (d_model
   2048, 32 / 4 heads x 128, 128 experts top-8 of d_ff 768, capacity factor
   1.25, vocab 151 936 tied), depth cut to 24 of 48 layers (15.27 B f32
   params, 61.1 GB; 48 layers are 120.9 GB), built with ``ModelDecoder``
   directly, random weights from seed 0, the workload of 3. First one MoE
   layer at the published widths (layer 0's params copied to the CPU, B 1 x
   S 512 of a bf16 x from a seed) on the card, with TF32 switched on around
   the call, and on the CPU: ``top_e``, the token table, the slots and the
   drop count equal, the routing weights within rtol 1e-5, the output
   within 2e-2 of its scale (the tests' bf16 bound), the aux losses within
   rtol 1e-4. Then the serving checks of 3. with 24 attention layers, the
   MoE drops tallied at prefill and decode, the peak under 74 GiB, and the
   replay; then rows 8g and 8bg;
5. whisper-base (``[whisper]`` lines) at full size (6 + 6 layers, published
   widths), random weights from seed 0. Generation: ``registry.bundle(cfg)
   .prefill_fn`` on 8 lanes of a 4-token prompt with ``enc_embeds`` (8,
   1536, 512) from ``pipeline.host_batch``, max_len 448, then 192 greedy
   ``decode_fn`` ticks: 18 prefill launches (6 encoder, 6 self, 6 cross) and
   12 decodes a tick, a second generation's tokens equal, the same calls
   through the plain versions on the card, fed the same tokens: every
   logits tensor within 1.5e-2 of its scale. Training: one step on the
   kernels against one on the plain versions (``cases.check_first_step``)
   in float32 and in bf16, the bf16 kernels' step no farther from the f32
   plain step, or from the plain bf16 step, than 1.25 x the plain bf16
   step's distance from the f32 one, then 4 bf16 steps of
   ``build_train_step`` at S 4096 against 1536 frames, batch 16 (the
   launches 2 x 18 forward and 18 backward a step), the loss lower on step
   0's batch after them. Then rows 8e, 8c, 8c2, 8d, 8d2, 8h, 8bh, 9c and 9e:
   the kernels at its shapes against their bounds, plain versions and
   ``scaled_dot_product_attention`` on one named backend (the same
   function: no softcap), and at hd 112 with the padding's copy timed apart;
6. qwen2-vl-72b (``[vlm]`` lines, M-RoPE) at its published widths, 8 of 80
   layers (9.51 B f32 params), through the workload of 3. with
   ``ModelDecoder`` (text positions): the serving checks of 3. with 8
   attention layers and the replay, then one image-grid prefill (an 8 x 8
   grid, then 192 text tokens) through the kernels and the plain versions,
   last-token logits within 1.5e-2 of their scale, and moved by more than
   that from the same tokens at text positions;
7. jamba-1.5-large-398b (``[hybrid]`` lines) at its published widths
   (d_model 8192, 64 / 8 heads x 128, d_ff 24 576, Mamba-2 of 256 heads x
   64 in 8 groups, d_state 128, chunk 256, top-2 MoE with capacity 1.25 on
   every second layer, vocab 65 536 tied), cut by ``HYBRID_CUT`` to one unit
   (1 attention and 7 Mamba-2 layers, 4 MoE FFNs) of 4 of 16 experts (15.72
   B f32 params, 58.56 GiB), through the workload of 3.: the serving checks
   with 7 ``ssd_scan`` launches a prefill call and 1 attention layer, the
   drops tallied, the peak under 74 GiB; one wave's prefill layer by layer
   against the plain versions (attention within ``fa_tolerance``, SSM states
   within ``ssd_tolerance``, mixer outputs within ``OUT_ULPS`` bf16 ulps at
   scale, K/V and conv tails equal), then the whole prefill and 16 ticks
   and the SSM states after the prefill within ``SERVE_SPREAD`` times the
   plain path's own spread (chunk 128 and p in bf16); the replay;
8. mamba2-780m serving (``[serve]`` lines, the serving cells' model) at its
   published config, all 48 layers, through the workload of 3.: the serving
   checks with ``ssd_scan`` launched 48 times per prefill call and no other
   kernel, a two-chunk prefill (bucket 512) among the calls, the wave
   prefill of 7. (48 Mamba-2 layers, chunk 256 against 128) and the replay;
9. nemotron-3-nano-30b-a3b (``[nemotron]`` lines): the attention cases of
   ``kernels/flash_attention/cases.py`` at its shapes (G 16, hd 128) and
   ``ssd_scan`` at (2, 1024) x 64 heads in 8 groups, chunk 128, bf16 and
   f32, against their plain versions, each launched twice bit-identical;
   then its published widths cut to the pattern's first 7 layers
   (``NEMOTRON_CUT``: 3 Mamba-2, 3 dropless MoE of 128 experts, 1 GQA
   layer; bf16 params from seed 0) through the workload of 3.: the serving
   checks with 3 ``ssd_scan`` and 1 attention layer, a ``model.moe`` span
   per MoE layer and model call run or captured (none in a replay from a
   CUDA graph), the routes tallied (``moe.count_routes``, replayed ticks
   included) and none dropped;
10. the FL rounds (``[fl]`` lines) through ``train_fl_constellation.main_tdm``
   at the FL cells' widths (mamba2-780m, 8 of 48 layers, 8 satellites,
   satellite 3 lost after round 1, sequence 256), 3 rounds each of
   compression none, int8 and topk, the launch counters zeroed just before
   each mode: losses and consensus finite, the satellite dropped, each
   mode's exchange kernels launched and no other (none: none); then the
   mode's exchange on its trained params through the kernels and the plain
   versions: codes or selections bit for bit, the mix (and CHOCO's
   accumulator) within 2 (M + 2) ulps of each node's largest magnitude;
11. the ground segment (``[groundseg]`` lines) through ``main_groundseg`` at
   the same widths: 6 satellites and 2 ground sinks, satellite 2 lost after
   round 1, 3 rounds each of (none, depth 1), (int8, depth 1) and (int8,
   depth 2, staleness horizon 1), the counters zeroed before each: losses
   finite, the pooling, deliveries and coverage the routing programs', the
   gathers and reductions the oracle's, the int8 kernels each launched more
   than once (none: none); then one int8 exchange on the trained params
   through the kernels and the plain versions, bit for bit;
12. gemma2-9b training (``[dense-train]`` lines) at its published widths
   with 8 of 42 layers through ``launch/steps.build_train_step`` on
   ``SyntheticStream`` at S 4096 (train_4k's sequence), batch 2, 4 steps:
   the attention launches the oracle's (remat: 2 forward and 1 backward per
   attention layer and step), every loss finite and the loss of step 0's
   batch lower after the 4 steps than before; then row 9,
   ``flash_attention_bwd`` at the cell's shape (the forward's out and lse
   there held to the plain ones first) against its plain version, timed
   beside its bound and flex_attention's backward, the local layers' call
   (window 4096) timed beside it;
13. the kernel table (``PERF.md``, section 6): the six exchange kernels on
   the FL cells' stacked buffer (:func:`_fl_buffer`: 8 satellites of
   mamba2-780m at 8 of 48 layers from ``_stack_init``'s seed 0, (8, 194 384
   896) float32, block 1024; top-k and the scatter at the fused CHOCO
   round's k, on their select paths; rows 1-6), the int8 gossip's fold over
   relations of one and two matchings (bit for bit against the unfused
   chain of ``dequant_accumulate`` launches, which is timed and logged
   beside it; row 10) and, logged beside them, the select path at k =
   TOPK_SELECT_MAX_K and the sort and shared-memory scatter paths at
   TOPK_SELECT_MAX_K + 1; ``ssd_scan`` at the serving prefill's shape with
   both replicas admitted (8 lanes x 48 heads, S 512, chunk 256, bf16; row
   7), at the served 4 lanes and at jamba's served 4 lanes (256 heads in 8
   groups; row 7j), each beside its bound (the larger of the bytes it must
   move over 3.35 TB/s and its operations, the triangle s <= t only, over
   989 TFLOP/s, the bf16 tensor-core rate; the float32 rate's 67 TFLOP/s
   logged beside it) and four launches on one input bit-identical; both
   attention entry points at gemma2-9b's serving shapes (prefill 8 lanes x
   16 heads, S 512, hd 256, causal, softcap 50, bf16; decode 8 lanes
   against a 529-slot cache; each also at the served 4 lanes; rows 8 and
   8b), by the CUDA-event time of eager calls like every other row and by
   device time per call from CUDA-graph replays (``graph_ms``), each beside
   its bound, the library call (``flex_attention`` under ``torch.compile``
   with the softcap as a ``score_mod`` and the causal or kv_len mask as a
   ``mask_mod``: the same function; null with the error if it does not
   build) and ``F.scaled_dot_product_attention`` on the same tensors, which
   has no softcap and so is only logged. Every row's kernel is checked
   against its plain version at its shape before it is timed.

Any failed check exits non-zero, and no result line is printed. Prints a
``{"kernels": [...]}`` line, then ``{"ok": true, "device": ...}`` as the last
line. Exits non-zero when no CUDA device is present or the repository's
``src/`` is missing.
"""

from __future__ import annotations

import json
import math
import pathlib
import subprocess
import sys
import time

from portbench.counts import (
    PEAK_BF16_FLOPS,
    dequant_accumulate_bytes,
    quantize_bytes,
    seconds_at_hbm,
)

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

F32_FLOPS_PER_S = 67e12        # float32 outside the tensor cores, H100 SXM data sheet
SOURCES = {
    "tdm_compress": "src/repro_torch/csrc/tdm_compress.cu",
    "ssd_scan": "src/repro_torch/csrc/ssd_scan.cu",
    "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
}
REPLACES = {
    "quantize": "src/repro/kernels/tdm_compress/tdm_compress.py:121",
    "dequant_accumulate": "src/repro/kernels/tdm_compress/tdm_compress.py:172",
    "topk_sparsify": "src/repro/kernels/tdm_compress/tdm_compress.py:245",
    "scatter_accumulate": "src/repro/kernels/tdm_compress/tdm_compress.py:292",
    "quantize_scaled": "src/repro/kernels/tdm_compress/tdm_compress.py:211",
    "dequantize": "src/repro/kernels/tdm_compress/tdm_compress.py:150",
    # no Pallas kernel of its own: the int8 gossip's receive side, per matching
    # two ppermutes and one dequant_accumulate_fwd, then the self term
    "gossip_fold": "src/repro/core/fused.py:273",
    "ssd_scan": "src/repro/kernels/ssd_scan/ssd_scan.py:80",
    "flash_attention_fwd": "src/repro/kernels/flash_attention/flash_attention.py:100",
    "flash_attention_decode": "src/repro/kernels/flash_attention/flash_attention.py:100",
    # no Pallas kernel: the reference's backward is pure JAX under a custom_vjp
    "flash_attention_bwd": "src/repro/models/attention.py:211",
}
# the FL cells' widths (10., 11. and 13.'s buffer): 8 satellites of mamba2-780m
# cut to 8 of 48 layers
SLICE_NODES = 8
SLICE_LAYERS = 8
# the serving workload of 3., 4., 6., 7., 8. and 9.
SERVE_BATCH = 4
SERVE_REQUESTS = 16
SERVE_MAX_NEW = 16
SERVE_PROMPT = (200, 300)
SERVE_SPREAD = 4            # wave prefill: kernel vs plain <= 4x plain's own spread (see 3.)
OUT_ULPS = 2                # a layer's mixer output, kernel vs plain, same input (see 3.)


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


def _bound(flops: float, nbytes: float) -> tuple:
    """(the least time in ms, "operations" or "bytes"): the larger of the
    products at the bf16 tensor-core rate and the bytes at HBM's."""
    op_ms, byte_ms = flops / PEAK_BF16_FLOPS * 1e3, seconds_at_hbm(nbytes) * 1e3
    return max(op_ms, byte_ms), "operations" if op_ms >= byte_ms else "bytes"


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


def topk_total(n_leaves: int, padded: int) -> int:
    """The fused CHOCO budget of the slice (core/fused.py fused_buffer_mix)."""
    from repro_torch.launch import fl_train

    return min(fl_train.FLConfig().topk_k * n_leaves, padded)


def topk_block_budget(n_leaves: int, padded: int, block: int) -> int:
    """Per-block k of the fused CHOCO round (core/fused.py choco_fused_round)."""
    return max(1, min(block, -(-topk_total(n_leaves, padded) // (padded // block))))


def phase_kernels_slice(device, x, k_b: int, power_note: str) -> list:
    """Each exchange kernel vs its plain version on the FL cells' stacked
    (8, P) params buffer (:func:`_fl_buffer`), timed (rows 1-6 and 10)."""
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

    def record(name, err, ms, plain_ms, nbytes, library_ms, **extra):
        bound_ms = seconds_at_hbm(nbytes) * 1e3
        results.append({
            "name": name, "route": "cuda", "source": SOURCES["tdm_compress"],
            "replaces": REPLACES[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": library_ms,
            **extra,
        })
        lib = "null" if library_ms is None else f"{library_ms:.3f}"
        tag = "".join(f" {k} {v}" for k, v in extra.items())
        log(f"[kernels] {name + tag:<19} {ms:8.3f} ms  bound {bound_ms:7.3f} ms "
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
    record("quantize", 0.0, ms, plain, quantize_bytes(rows, n, block), None)

    # 2. dequant_accumulate
    got = kern.dequant_accumulate_fwd(q, s, acc, w, block=block)
    want = ref.dequant_acc_ref(q, s, acc, w, block)
    prod = w[:, None] * ref.dequantize_ref(q, s, block)
    err = _assert_fma(got, want, prod, "dequant_accumulate at slice shape")
    del got, want, prod
    ms = time_ms(lambda: kern.dequant_accumulate_fwd(q, s, acc, w, block=block), reps=10)
    plain = time_ms(lambda: ref.dequant_acc_ref(q, s, acc, w, block), reps=3)
    record("dequant_accumulate", err, ms, plain, dequant_accumulate_bytes(rows, n, block), None)
    _time_gossip_fold(x, q, s, block, record, power_note)
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


# 8-node relations of the FL launcher's plan (``portbench``'s mamba2-780m-fl8
# deployment): four links in one matching, and four in two matchings with
# nodes 0 and 2 of degree 2 and nodes 1 and 3 idle
FOLD_RELATIONS = {1: [(0, 5), (1, 4), (2, 7), (3, 6)], 2: [(0, 5), (0, 6), (2, 4), (2, 7)]}


def unfused_fold(x, q, s, plan, block: int):
    """The int8 gossip's receive side as the kernels ran it before the fold:
    per matching the rows that arrive (``index_select``, zeroed outside it)
    into one ``dequant_accumulate_fwd`` on an accumulator of zeros, then
    ``+ diag * x``."""
    import torch

    from repro_torch.kernels.tdm_compress import tdm_compress as kern

    acc = torch.zeros_like(x)
    for m in range(plan.src.shape[0]):
        idle = (plan.src[m] < 0)[:, None]
        rows = plan.src[m].clamp(min=0).to(torch.int64)
        q_r = q.index_select(0, rows).masked_fill_(idle, 0)
        s_r = s.index_select(0, rows).masked_fill_(idle, 0)
        acc = kern.dequant_accumulate_fwd(q_r, s_r, acc, plan.w[m], block=block)
        del q_r, s_r
    return acc.add_(plan.diag[:, None] * x)


def _time_gossip_fold(x, q, s, block: int, record, power_note: str) -> None:
    """The gossip fold on the slice's buffer over the plan's relations of one
    and two matchings: bit for bit against the unfused chain on the kernels,
    timed beside its bound, its plain version and (logged) the chain."""
    import numpy as np
    import torch

    from repro_torch.core import fused, tdm
    from repro_torch.core.relation import Relation
    from repro_torch.kernels.tdm_compress import ref
    from repro_torch.kernels.tdm_compress import tdm_compress as kern

    rows, n = x.shape
    nb = n // block
    for n_match, edges in FOLD_RELATIONS.items():
        rel = Relation.from_edges(edges, nodes=range(rows))
        diag, per_matching = tdm.matching_weight_vectors(rel, rows)
        matchings = tdm.edge_coloring(rel)
        check(len(matchings) == n_match, f"gossip fold: {len(matchings)} matchings, "
              f"expected {n_match}")
        src = [tdm.matching_sources(m, rows) for m in matchings]
        plan = fused.row_plan(src, per_matching, diag, x.device)

        def fold():
            return kern.gossip_fold_fwd(x, q, s, plan.src, plan.w, plan.diag, block=block)

        got = fold()
        _assert_bits(got, unfused_fold(x, q, s, plan, block),
                     f"gossip fold, {n_match} matchings, against the unfused chain")
        want = ref.gossip_fold_ref(x, q, s, plan.src, plan.w, plan.diag, block)
        err = float((got - want).abs().max())
        del got, want
        torch.cuda.empty_cache()
        ms = time_ms(fold, reps=10)
        chain = time_ms(lambda: unfused_fold(x, q, s, plan, block), reps=5)
        plain = time_ms(lambda: ref.gossip_fold_ref(x, q, s, plan.src, plan.w, plan.diag,
                                                    block), reps=3)
        arrivals = int(np.sum(np.array(src) >= 0))
        nbytes = rows * n * 8 + arrivals * (n + nb * 4) + n_match * rows * 8 + rows * 4
        log(f"[kernels] gossip_fold, {n_match} matchings ({arrivals} arrivals): the "
            f"unfused chain {chain:.3f} ms; library: null (no single call computes "
            f"it) [{power_note}]")
        record("gossip_fold", err, ms, plain, nbytes, None, matchings=n_match)
        torch.cuda.empty_cache()


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
        bound = seconds_at_hbm(rows * n * 8 + rows * nb * k * 8) * 1e3
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
            bound = seconds_at_hbm(rows * n * 8 + rows * nb * k * 8 + rows * 4) * 1e3
            log(f"[kernels] scatter_accumulate shared path, k={k}: {ms:.3f} ms  bound "
                f"{bound:.3f} ms ({bound / ms:.1%})  plain {plain:.3f} ms  library "
                f"{lib:.3f} ms (scatter_add)  max_abs_err {err:.3g} [{power_note}]")
            del accv, wv, iv
        del v, i
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the SSD scan and the serving workload
# ---------------------------------------------------------------------------

def _ssd_vs_plain(inputs, chunk: int, what: str) -> float:
    """The kernel against its plain version on the same inputs: y and the
    state finite and within ``ssd_tolerance``, a second launch bit-identical.
    Returns the max |diff|."""
    import torch

    from repro_torch.kernels.ssd_scan import ops, ref

    y, s = ops.ssd_scan(*inputs, chunk=chunk, impl="cuda")
    again = ops.ssd_scan(*inputs, chunk=chunk, impl="cuda")
    y_r, s_r = ops.ssd_scan(*inputs, chunk=chunk, impl="ref")
    torch.cuda.synchronize()
    check(y.dtype == inputs[0].dtype and s.dtype == torch.float32, f"{what}: dtypes")
    check(torch.equal(y, again[0]) and torch.equal(s, again[1]),
          f"{what}: a second launch differs")
    ok_y, err_y = ref.ssd_close(y, y_r)
    ok_s, err_s = ref.ssd_close(s, s_r)
    check(ok_y, f"{what}: y outside ssd_tolerance (max |diff| {err_y})")
    check(ok_s, f"{what}: state outside ssd_tolerance (max |diff| {err_s})")
    return max(err_y, err_s)


def _tokens_by_request(report) -> dict:
    return {r.rid: list(r.out) for r in report.requests}


def _scale_ulps(a, b) -> float:
    """max |a - b| in bf16 ulps of max |b| (the ulp of the top binade)."""
    a, b = a.float(), b.float()
    top = float(b.abs().max())
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 2.0 ** -133
    return float((a - b).abs().max()) / ulp


def _serve_workload(dec, cfg, tag: str):
    from repro_torch.launch import serve_constellation as sc

    return sc.run(decoder=dec, vocab=cfg.vocab_size, requests=SERVE_REQUESTS,
                  batch=SERVE_BATCH, max_new=SERVE_MAX_NEW, prompt_len=SERVE_PROMPT,
                  log=lambda m: log(f"[{tag}] {m.strip()}"))


def _make_decoder(arch: str, device):
    from repro_torch.launch import serve_constellation as sc

    return sc.model_decoder(arch, False, len(sc.REPLICAS), SERVE_BATCH, SERVE_PROMPT,
                            SERVE_MAX_NEW, 0, device)


def _run_serving(dec, cfg, device, tag: str):
    """The serving workload through ``serve_constellation``'s entry points,
    every launch counter zeroed just before and read just after; checks the
    deliveries, tokens, audit and re-routing. Returns (run, recorder,
    launches by kernel)."""
    import torch

    from repro_torch import kernels, telemetry

    with telemetry.record_scope(tracing=True) as rec:
        kernels.reset_launch_counts()
        res = _serve_workload(dec, cfg, tag)
        torch.cuda.synchronize(device)
        launches = kernels.launch_counts()
    summ = res.report.summary()
    check(summ["delivered"] == summ["n_requests"] == SERVE_REQUESTS and not summ["undelivered"],
          f"{tag}: delivered {summ['delivered']}/{summ['n_requests']}")
    check(all(len(r.out) == SERVE_MAX_NEW for r in res.report.requests),
          f"{tag}: a request was delivered without its 16 tokens")
    check(res.verdict.ok, f"{tag}: audit, {len(res.verdict.violations)} violations")
    check(summ["retries"] > 0, f"{tag}: the mid-epoch failure re-routed nothing")
    return res, rec, launches


def _replay(make, cfg, device, tokens, tag: str):
    """The same workload again on a fresh decoder from ``make()`` (the caller
    has freed the first): the same token streams bit for bit. Returns the
    decoder."""
    import torch

    from repro_torch import telemetry

    _, dec = make()
    with telemetry.record_scope(tracing=False):
        res = _serve_workload(dec, cfg, tag)
        torch.cuda.synchronize(device)
    check(_tokens_by_request(res.report) == tokens,
          f"{tag}: a second run of the same workload gave other token streams")
    log(f"[{tag}] replay on a fresh decoder: token streams bit-identical")
    return dec


SSD_SLICE = (2 * SERVE_BATCH, 512, 48, 64, 1, 128, 256)   # (B, S, H, P, G, N, chunk)
SSD_HYBRID = (SERVE_BATCH, 512, 256, 64, 8, 128, 256)     # jamba's served prefill (row 7j)


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
    op_ms, byte_ms = flops / PEAK_BF16_FLOPS * 1e3, seconds_at_hbm(nbytes) * 1e3
    f32_ms = max(flops / F32_FLOPS_PER_S * 1e3, byte_ms)
    return (max(op_ms, byte_ms), "operations" if op_ms >= byte_ms else "bytes", f32_ms,
            flops / 1e9, nbytes / 1e6)


def phase_ssd_slice(device, power_note: str) -> dict:
    """``ssd_scan`` at the serving prefill's shape with both replicas
    admitted (mamba2-780m: 48 heads x 64, one group of state 128, S 512 in
    chunks of 256; the ``kernels`` line's row), at the served 4 lanes
    (every prefill call of the serving cell) and at jamba-1.5-large's
    served 4 lanes (256 heads x 64 in 8 groups), against its plain version,
    timed, with its bound; and four launches on one input, bit-identical."""
    import torch

    from repro_torch.kernels.ssd_scan import ops, ref

    row = None
    shapes = (SSD_SLICE, (SERVE_BATCH,) + SSD_SLICE[1:], SSD_HYBRID)
    for (B_, S, H, P, G, N, Q), key in zip(shapes, (None, "served_4_lanes",
                                                    "jamba_served_4_lanes")):
        case = (B_, S, H, P, G, N, Q, torch.bfloat16)
        gen = torch.Generator(device=device).manual_seed(17)
        inputs = ref.init_inputs(gen, case[:6], torch.bfloat16)
        err = _ssd_vs_plain(inputs, Q, f"ssd_scan at the serving shape {case}")
        first = ops.ssd_scan(*inputs, chunk=Q, impl="cuda")
        for _ in range(3):
            again = ops.ssd_scan(*inputs, chunk=Q, impl="cuda")
            check(all(torch.equal(a, b) for a, b in zip(first, again)),
                  f"ssd_scan {case}: a repeated launch differs")
        ms = time_ms(lambda: ops.ssd_scan(*inputs, chunk=Q, impl="cuda"), reps=20)
        plain = time_ms(lambda: ops.ssd_scan(*inputs, chunk=Q, impl="ref"), reps=5)
        bound_ms, bound_by, f32_ms, gflop, mb = _ssd_bound(B_, S, H, P, G, N, Q)
        what = "jamba's served prefill shape" if key and key.startswith("jamba") else \
            "the serving prefill shape"
        log(f"[kernels] ssd_scan at {what}, {B_} lanes (S {S}, H {H}, "
            f"P {P}, G {G}, N {N}, chunk {Q}, bf16): {ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}; {bound_ms / ms:.1%}; {gflop:.2f} GFLOP at 989 TFLOP/s bf16, "
            f"{mb:.1f} MB at 3.35 TB/s; at the float32 rate {f32_ms:.3f} ms), plain "
            f"{plain:.3f} ms, library null (no single PyTorch call computes the chunked SSD "
            f"scan), max_abs_err {err:.3g}, 4 launches bit-identical  [{power_note}]")
        stats = {"ms": ms, "plain_ms": plain, "bound_ms": bound_ms, "bound_by": bound_by,
                 "bound_ms_f32_rate": f32_ms, "max_abs_err": err}
        if row is None:
            row = {"name": "ssd_scan", "route": "cuda", "source": SOURCES["ssd_scan"],
                   "replaces": REPLACES["ssd_scan"], "library_ms": None,
                   **stats}
        else:
            row[key] = stats
    return row


# ---------------------------------------------------------------------------
# attention and gemma2-9b serving
# ---------------------------------------------------------------------------

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
                err_o = _scale_ulps(out_k, out_r)
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


def _check_serving_launches(rec, counts, tag: str, attn: int, mamba: int = 0) -> str:
    """The serving run's launches against the oracle: per prefill call
    ``attn`` ``flash_attention_fwd``, all on the tensor-core kernel, and
    ``mamba`` ``ssd_scan``; per decode tick ``attn``
    ``flash_attention_decode``; no other kernel. Returns a line saying so."""
    calls = int(rec.get_counter("serve.prefill.calls"))
    ticks = sum(1 for sp in rec.spans if sp.name == "serve.decode")
    want = {"flash_attention_fwd": attn * calls, "flash_attention_fwd_wgmma": attn * calls,
            "flash_attention_decode": attn * ticks, "ssd_scan": mamba * calls}
    want = {k: n for k, n in want.items() if n}
    got = {k: n for k, n in counts.items() if n}
    check(calls > 0 and ticks > 0 and got == want,
          f"{tag}: launches {got} for {calls} prefill calls and {ticks} ticks, oracle {want}")
    return f"launches {got}, the oracle's for {calls} prefill calls and {ticks} ticks"


def _freed(device, tag: str) -> None:
    """Empties the cache once the caller has dropped its decoder, and checks
    that less than 1 GiB is left: two copies of the params do not fit."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated(device)
    check(left < 2**30, f"[{tag}] {_gib(left)} GiB still allocated after the decoder")


def phase_serving_dense(device) -> None:
    """gemma2-9b at its published config, all 42 layers, through
    ``serve_constellation``'s entry points (see 3.)."""
    from repro_torch.models import transformer

    cfg, dec = _make_decoder(DENSE_ARCH, device)
    log(f"[{DENSE_TAG}] {cfg.name}: {cfg.n_layers} layers ({transformer.n_units(cfg)} "
        f"local/global units), d_model {cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} "
        f"kv heads x {cfg.head_dim}, window {cfg.sliding_window}, {cfg.compute_dtype} compute")
    check(cfg.n_layers == DENSE_LAYERS, f"{cfg.name} has {cfg.n_layers} layers")
    res, rec, counts = _run_serving(dec, cfg, device, DENSE_TAG)
    log(f"[{DENSE_TAG}] delivered, audit OK; "
        + _check_serving_launches(rec, counts, DENSE_TAG, cfg.n_layers))
    _wave_prefill_dense(dec, res.report, device)
    tokens = _tokens_by_request(res.report)
    del dec, res
    _freed(device, DENSE_TAG)
    _replay(lambda: _make_decoder(DENSE_ARCH, device), cfg, device, tokens, DENSE_TAG)
    _freed(device, DENSE_TAG)


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
        bound_ms, by = _bound(flops, nbytes)
        log(f"[kernels] {name} at {shape}: {ms:.4f} ms by CUDA events ({graph:.4f} ms device "
            f"by graph replay), bound {bound_ms:.4f} ms by {by} ({bound_ms / ms:.1%}; "
            f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB), plain {plain:.3f} ms, library "
            f"(flex_attention, torch.compile) {lib_note}, sdpa without softcap (not the same "
            f"function) {sdpa}, max_abs_err {err:.3g}  [{power_note}]")
        rows.append({
            "name": name, "route": "cuda", "source": SOURCES["flash_attention"],
            "replaces": REPLACES[name], "max_abs_err": err, "ms": ms,
            "plain_ms": plain, "bound_ms": bound_ms, "bound_by": by, "library_ms": lib,
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
            bound = _bound(flops, nbytes)[0]
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
            bound = _bound(flops, nbytes)[0]
            log(f"[kernels] flash_attention_decode at the served 4-lane shape {shape}: "
                f"{ms:.4f} ms by CUDA events ({graph:.4f} ms device by graph replay), bound "
                f"{bound:.4f} ms, "
                f"plain {plain:.3f} ms, library {note}, sdpa without softcap "
                f"{_sdpa_ms(q, k, v, False)}  [{power_note}]")
        del q, k, v, want
    return rows


# ---------------------------------------------------------------------------
# MoE serving: qwen3-moe-30b-a3b through the ModelDecoder
# ---------------------------------------------------------------------------

MOE_ARCH = "qwen3-moe-30b-a3b"
MOE_LAYERS = 24             # qwen3-moe-30b-a3b has 48: 120.9 GB of f32 params, over 80 GB
MOE_TAG = "moe"
MOE_PEAK_GIB = 74.0         # the phase fails above this (then cut to 16 layers)
MOE_BF16_FRAC = 2e-2        # a MoE layer's bf16 output, card vs CPU (tests/test_torch_moe.py)
MOE_LAYER_S = 512           # the card-vs-CPU layer's tokens: one prefill bucket, B 1
HYBRID_ARCH = "jamba-1.5-large-398b"
# jamba-1.5-large cut to one card: n_layers 72 -> 8 (one scan unit: 1 attention
# and 7 Mamba-2 layers, 4 MoE FFNs) and n_experts 16 -> 4 (top-2 still routes):
# 15.72 B f32 params, 58.56 GiB; one unit of 16 experts is 44.71 B (166.6 GiB)
HYBRID_CUT = {"n_layers": 8, "n_experts": 4}
HYBRID_TAG = "hybrid"
WAVE_TICKS = 16             # decode ticks held against the plain versions (7. and 8.)


def _cut_decoder(cfg, device):
    """``(cfg, the torch ModelDecoder of cfg)`` for the serving workload:
    random weights from seed 0, its cache sized as the other serving
    cells'."""
    from repro_torch.launch import serve_constellation as sc
    from repro_torch.serving import ModelDecoder

    max_len = ModelDecoder._bucket(SERVE_PROMPT[1]) + SERVE_MAX_NEW + 1
    return cfg, ModelDecoder(cfg, len(sc.REPLICAS), SERVE_BATCH, max_len, seed=0,
                             device=device)


def _make_moe_decoder(device):
    """qwen3-moe-30b-a3b at its published widths, depth cut to
    ``MOE_LAYERS``, through ``_cut_decoder``."""
    from repro_torch.configs import archs

    return _cut_decoder(archs.get(MOE_ARCH).replace(n_layers=MOE_LAYERS), device)


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
    with torch.no_grad():
        cpu = run(p_cpu, x_cpu)
    (rg, dg, og, ag), (rc, dc, oc, ac) = tree_map(lambda t: t.cpu(), card), cpu
    for what, a, b in (("top_e", rg.top_e, rc.top_e), ("token table", dg.table, dc.table),
                       ("slots", dg.slots, dc.slots), ("counts", dg.counts, dc.counts),
                       ("drops", dg.dropped, dc.dropped)):
        check(torch.equal(a, b), f"MoE layer, card vs CPU: {what} differ "
              f"({int((a != b).sum())} of {a.numel()})")
    w_rel = float(((rg.top_w - rc.top_w).abs() / rc.top_w.abs()).max())
    out_frac = _rel(og, oc)
    aux_rel = max(abs(float(ag[k]) / float(ac[k]) - 1.0) for k in ac)
    log(f"[{MOE_TAG}] one MoE layer at the published widths (B 1, S {MOE_LAYER_S}, bf16, "
        f"C {C}, TF32 on around the card's call), card vs CPU: top_e, token table, slots, "
        f"counts and drops equal; top_w max rel {w_rel:.3g}; output max |diff| "
        f"{out_frac:.3g} of its scale (bound {MOE_BF16_FRAC}); aux losses rel {aux_rel:.3g}")
    check(torch.backends.cuda.matmul.allow_tf32 == prev, "moe left the TF32 switch changed")
    check(w_rel <= 1e-5 and out_frac <= MOE_BF16_FRAC and aux_rel <= 1e-4,
          f"MoE layer, card vs CPU: top_w {w_rel:.3g}, output {out_frac:.3g} of its scale, "
          f"aux {aux_rel:.3g}")


def _moe_attention(device, power_note: str) -> None:
    """Rows 8g and 8bg: the attention kernels at qwen3-moe's shapes (32 / 4
    heads x 128, G 8, no softcap; ``kernels/flash_attention/cases.py``'s
    serving cases), the bf16 prefill at 8 and 4 lanes and the decode at 8
    lanes, timed beside their bounds and ``flex_attention`` (the same
    function: no softcap)."""
    import torch

    from repro_torch.kernels.flash_attention import cases, ops

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


def _log_g8_row(name, shape, ms, graph, plain, flops, nbytes, note, power_note) -> None:
    bound, by = _bound(flops, nbytes)
    log(f"[{MOE_TAG}] {name} at {shape}: {ms:.4f} ms by CUDA events ({graph:.4f} ms device "
        f"by graph replay), bound {bound:.4f} ms by {by} ({bound / ms:.1%}; "
        f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB), plain {plain:.3f} ms, library "
        f"(flex_attention, torch.compile) {note}  [{power_note}]")


def phase_serving_moe(device, power_note: str) -> None:
    """qwen3-moe-30b-a3b at its published widths, 24 of 48 layers, through
    ``serve_constellation``'s entry points with the ``ModelDecoder`` built
    directly (see 4.)."""
    import torch

    from repro_torch.models import moe

    torch.cuda.reset_peak_memory_stats(device)
    cfg, dec = _make_moe_decoder(device)
    m = cfg.moe
    log(f"[{MOE_TAG}] {cfg.name}: {cfg.n_layers} of 48 layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv heads x {cfg.head_dim}, {m.n_experts} "
        f"experts top-{m.top_k}, expert d_ff {m.d_ff}, capacity factor {m.capacity_factor}, "
        f"{cfg.compute_dtype} compute")
    check(cfg.n_layers == MOE_LAYERS and m.n_experts == 128 and m.top_k == 8,
          f"{cfg.name}: {cfg.n_layers} layers, {m.n_experts} experts top-{m.top_k}")
    _moe_layer_card_vs_cpu(dec, device)
    with moe.count_drops() as tally:
        res, rec, counts = _run_serving(dec, cfg, device, MOE_TAG)
    check(set(tally) == {"prefill", "decode"}, f"drops tallied for {sorted(tally)}")
    del tally
    peak = torch.cuda.max_memory_allocated(device)
    check(peak <= MOE_PEAK_GIB * 2 ** 30,
          f"peak {_gib(peak)} GiB above {MOE_PEAK_GIB} GiB: cut the cell to 16 layers")
    log(f"[{MOE_TAG}] delivered, audit OK; "
        + _check_serving_launches(rec, counts, MOE_TAG, cfg.n_layers)
        + f"; peak {_gib(peak)} GiB (bound {MOE_PEAK_GIB})")
    tokens = _tokens_by_request(res.report)
    del dec, res
    _freed(device, MOE_TAG)
    _replay(lambda: _make_moe_decoder(device), cfg, device, tokens, MOE_TAG)
    _freed(device, MOE_TAG)
    _moe_attention(device, power_note)


# ---------------------------------------------------------------------------
# dense training: gemma2-9b through launch/steps.py
# ---------------------------------------------------------------------------

TRAIN_ARCH = "gemma2-9b"
TRAIN_LAYERS = 8            # gemma2-9b has 42; cut for memory (f32 params, grads, AdamW mu, nu)
TRAIN_SEQ = 4096            # the published train_4k shape's sequence
TRAIN_BATCH = 2             # train_4k's global batch of 256, cut to one card
TRAIN_STEPS = 4
TRAIN_TAG = "dense-train"
FA_TRAIN = (TRAIN_BATCH, TRAIN_SEQ, 16, 8, 256)            # (B, S, H, KV, hd)
TRAIN_WINDOW = 4096                                         # gemma2-9b's local layers


def _train_cell(device) -> None:
    """gemma2-9b at its published widths, 8 of 42 layers, through
    ``launch/steps.build_train_step`` on ``SyntheticStream`` at S 4096,
    batch 2, 4 steps (see 12.)."""
    import torch

    from repro_torch import kernels
    from repro_torch.configs import archs
    from repro_torch.data import pipeline
    from repro_torch.launch import steps
    from repro_torch.launch.fl_train import batch_to_device
    from repro_torch.models import registry, transformer
    from repro_torch.models.config import SHAPES, ShapeConfig
    from repro_torch.optim import adamw

    cfg = archs.get(TRAIN_ARCH).replace(n_layers=TRAIN_LAYERS)
    base = SHAPES["train_4k"]
    check(base.seq_len == TRAIN_SEQ, f"train_4k's sequence is {base.seq_len}")
    shape = ShapeConfig(base.name, base.kind, TRAIN_SEQ, TRAIN_BATCH)
    opt_cfg = adamw.OptConfig(peak_lr=3e-3, warmup_steps=5, decay_steps=max(TRAIN_STEPS, 10))
    torch.cuda.empty_cache()
    state = steps.init_state(0, cfg, opt_cfg, device)
    train_step = steps.build_train_step(cfg, opt_cfg)
    stream = pipeline.SyntheticStream(cfg, shape, seed=0)
    batches = [batch_to_device(stream.batch(i), device) for i in range(TRAIN_STEPS)]
    attn_layers = sum(d.mixer == "attn" for d in transformer.scan_unit(cfg)) * \
        transformer.n_units(cfg)
    kernels.reset_launch_counts()
    losses = []
    for batch in batches:
        state, metrics = train_step(state, batch)
        losses.append(float(metrics["loss"]))
    counts = {k: n for k, n in kernels.launch_counts().items() if n}
    per_step = 2 if cfg.remat == "full" else 1
    want = {"flash_attention_fwd": per_step * attn_layers * TRAIN_STEPS,
            "flash_attention_fwd_wgmma": per_step * attn_layers * TRAIN_STEPS,
            "flash_attention_bwd": attn_layers * TRAIN_STEPS}
    check(counts == want, f"training launches {counts} != oracle {want}")
    # the loss of step 0's batch again, after the 4 steps: each step's loss
    # is on a fresh batch, and at random init the final softcap saturates the
    # logits (a loss of ~40), so batch-to-batch spread (~0.5) hides 4 steps
    # of progress; the same batch does not
    with torch.no_grad():
        again = float(registry.bundle(cfg).loss_fn(state["params"], batches[0])[0])
    check(all(math.isfinite(x) for x in losses + [again]),
          f"non-finite training loss: {losses}, {again}")
    check(again < losses[0], f"training loss did not fall on step 0's batch: {losses[0]} "
          f"at init, {again} after {TRAIN_STEPS} steps")
    log(f"[{TRAIN_TAG}] {cfg.name}, {cfg.n_layers} of 42 layers, B {TRAIN_BATCH} x S "
        f"{TRAIN_SEQ}: launches {counts}, the oracle's; step 0's batch's loss {losses[0]:.4f} "
        f"-> {again:.4f} after {TRAIN_STEPS} steps")
    del state, metrics, batches
    torch.cuda.empty_cache()


def _gib(nbytes: int) -> str:
    return f"{nbytes / 2 ** 30:.2f}"


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
    # the local layers' call (window 4096) beside the global layers' (the row)
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
    bound, by = _bound(flops, nbytes)
    log(f"[kernels] flash_attention_bwd at (B {B}, S {S}, H {H}, KV {KV}, hd {hd}, causal, "
        f"softcap {cap}, bf16): {ms:.3f} ms by CUDA events, bound {bound:.4f} ms by {by} "
        f"({bound / ms:.2%}; {flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB), plain "
        f"{plain:.3f} ms, library {note}, max_abs_err {err:.3g}; the forward's out within "
        f"fa_tolerance (max |diff| {out_err:.3g}), its lse within 1e-5 of its scale (max "
        f"|diff| {lse_err:.3g})  [{power_note}]")
    return {"name": "flash_attention_bwd", "route": "cuda", "source": SOURCES["flash_attention"],
            "replaces": REPLACES["flash_attention_bwd"], "max_abs_err": err, "ms": ms,
            "plain_ms": plain, "bound_ms": bound, "bound_by": by, "library_ms": lib}


def phase_dense_train(device, power_note: str) -> dict:
    """The gemma2-9b training cell, then the backward's row (row 9).
    Returns the row."""
    _train_cell(device)
    return _train_bwd_row(device, power_note)


# ---------------------------------------------------------------------------
# rectangular attention, whisper-base (encoder-decoder) and qwen2-vl-72b
# (M-RoPE)
# ---------------------------------------------------------------------------

WHISPER_ARCH = "whisper-base"
WHISPER_TAG = "whisper"
WHISPER_LANES = 8
WHISPER_PROMPT = 4          # the length of Whisper's start-of-transcript sequence
WHISPER_MAX_LEN = 448       # Whisper's text context
WHISPER_TICKS = 192
WHISPER_TRAIN_SEQ = 4096    # the published train_4k shape's sequence
WHISPER_TRAIN_BATCH = 16    # train_4k's global batch of 256, cut to one card
WHISPER_STEPS = 4
VLM_ARCH = "qwen2-vl-72b"
VLM_LAYERS = 8              # qwen2-vl-72b has 80: 291 GB of f32 params, over 80 GB
VLM_TAG = "vlm"
VLM_GRID, VLM_TEXT = 8, 192  # the image-grid prefill: 8 x 8 patch tokens, then text
# bf16 logits of a whole model, kernels against plain versions on the card:
# the tests' bound for the port's bf16 model against the reference's
# (tests/test_torch_serving_dense.py, 1.5e-2 of the logits' scale)
BF16_MODEL_FRAC = 1.5e-2
# one train step on the kernels against one on the plain versions, float32
# compute (loss, grad norm, mu): sums in another order, the bounds of
# tests/test_torch_cuda.py
F32_FIRST_STEP = (1e-5, 1e-5, 1e-5)
# the same in bf16 compute at whisper's training shape (loss, grad norm,
# mu): read on an H100 on three batches up to 6.5e-6, 1.6e-4 and 1.22e-2,
# where each bf16 step lay 1.17-1.35e-2 of mu from the f32 plain step, the
# kernels' at most 1.04 x as far as the plain versions', and the kernels'
# gap from the plain bf16 step at most 0.90 x the plain bf16 step's own
# from f32: bf16 compute makes the gap, not the kernels. BF16_FAR_RATIO
# bounds both of those ratios.
BF16_WHISPER_FIRST_STEP = (5e-5, 5e-4, 2.5e-2)
BF16_FAR_RATIO = 1.25


def _whisper_batch(cfg, B: int, S: int, device) -> dict:
    """``pipeline.host_batch``'s tokens and ``enc_embeds`` (seed 0, step 0)
    on the card."""
    import torch

    from repro_torch.data import pipeline
    from repro_torch.models.config import ShapeConfig

    hb = pipeline.host_batch(cfg, ShapeConfig("whisper", "prefill", S, B), step=0, seed=0)
    return {"tokens": torch.from_numpy(hb["tokens"]).long().to(device),
            "enc_embeds": torch.from_numpy(hb["enc_embeds"]).to(device)}


def _generate(cfg, params, batch, impl: str, forced=None):
    """Greedy generation through the registry's ``prefill_fn`` and
    ``decode_fn`` (``impl="auto"``: the kernels), or the same calls on the
    plain versions (``impl="ref"``, fed ``forced``, the kernel run's
    tokens). Tokens stay on the card (argmax there). Returns (prefill
    logits, each tick's logits, the tokens fed)."""
    import torch

    from repro_torch.models import registry, transformer

    b = registry.bundle(cfg)
    with torch.no_grad():
        if impl == "auto":
            first, cache = b.prefill_fn(params, batch, WHISPER_MAX_LEN)
        else:
            first, cache = transformer.prefill(params, batch["tokens"], cfg, WHISPER_MAX_LEN,
                                               impl=impl, enc_embeds=batch["enc_embeds"])
        tok = forced[0] if forced else first[:, -1].argmax(-1)[:, None]
        toks, outs = [tok], []
        for i in range(WHISPER_TICKS):
            if impl == "auto":
                logits, cache = b.decode_fn(params, cache, {"token": tok})
            else:
                logits, cache = transformer.decode_step(params, cache, tok, cfg, impl=impl)
            outs.append(logits)
            tok = forced[i + 1] if forced else logits[:, -1].argmax(-1)[:, None]
            toks.append(tok)
        torch.cuda.synchronize()
    return first, outs, toks


def _rel(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max())


def _whisper_generation(device) -> None:
    """whisper-base at full size (6 + 6 layers, published widths), random
    weights from seed 0: ``prefill_fn`` on 8 lanes of a 4-token prompt with
    ``enc_embeds`` (8, 1536, 512) from ``pipeline.host_batch``, max_len 448,
    then 192 greedy ``decode_fn`` ticks, the launch counters zeroed just
    before and read just after; again, the same tokens bit for bit; the
    plain versions (``impl="ref"``) on the card fed the same tokens: prefill
    and every tick's logits within ``BF16_MODEL_FRAC`` of their scale."""
    import torch

    from repro_torch import kernels
    from repro_torch.configs import archs
    from repro_torch.models import registry

    cfg = archs.get(WHISPER_ARCH)
    check(cfg.n_layers == 6 and cfg.n_enc_layers == 6 and cfg.enc_frames == 1536 and
          cfg.d_model == 512, f"{cfg.name}: not the published whisper-base")
    torch.cuda.empty_cache()
    params = registry.bundle(cfg).init(torch.Generator(device=device).manual_seed(0))
    batch = _whisper_batch(cfg, WHISPER_LANES, WHISPER_PROMPT, device)
    kernels.reset_launch_counts()
    first, outs, toks = _generate(cfg, params, batch, "auto")
    got = {k: n for k, n in kernels.launch_counts().items() if n}
    L, E = cfg.n_layers, cfg.n_enc_layers
    want = {"flash_attention_fwd": E + 2 * L, "flash_attention_fwd_wgmma": E + 2 * L,
            "flash_attention_decode": 2 * L * WHISPER_TICKS}
    check(got == want, f"whisper generation launches {got}; oracle {want} (prefill: one per "
          "encoder layer, decoder self- and cross-attention; each tick: the self and the "
          "cross decode, per layer)")
    _, _, toks2 = _generate(cfg, params, batch, "auto")
    check(all(torch.equal(a, b) for a, b in zip(toks, toks2)),
          "whisper: a second generation gave other tokens")
    p_first, p_outs, _ = _generate(cfg, params, batch, "ref", forced=toks)
    pre_rel = _rel(first, p_first)
    tick_rel = max(_rel(a, b) for a, b in zip(outs, p_outs))
    log(f"[{WHISPER_TAG}] generation: launches {got}, the oracle's; two runs' tokens equal; "
        f"the plain versions fed the same tokens: prefill logits {pre_rel:.3g} of their "
        f"scale, the {WHISPER_TICKS} ticks' up to {tick_rel:.3g} (bound {BF16_MODEL_FRAC})")
    check(all(bool(torch.isfinite(t).all()) for t in [first] + outs),
          "whisper: non-finite logits")
    check(pre_rel <= BF16_MODEL_FRAC and tick_rel <= BF16_MODEL_FRAC,
          f"whisper generation, kernels vs plain: prefill {pre_rel:.3g}, ticks {tick_rel:.3g} "
          f"of the logits' scale, bound {BF16_MODEL_FRAC}")
    del params, outs, p_outs
    torch.cuda.empty_cache()


def _whisper_training(device) -> None:
    """whisper-base at full size through ``launch/steps.build_train_step`` on
    ``SyntheticStream`` at train_4k's sequence (S 4096) and enc_frames 1536,
    batch 16, ``launch/train.py``'s OptConfig: first one step on the kernels
    (``impl="cuda"``) held by ``cases.check_first_step`` to the same step
    on the plain versions (``impl="ref"``), in float32 compute (the
    CUDA-core kernels) at the f32 bounds and in bf16 compute (the
    tensor-core kernels the cell runs) at ``BF16_WHISPER_FIRST_STEP``; the
    kernels' bf16 mu no more than ``BF16_FAR_RATIO`` times as far from the
    f32 plain step, or from the plain bf16 step, as the plain bf16 step
    lies from the f32 one; then 4 bf16 steps on the kernels, the cell, the
    counters zeroed just before and read just after; the loss finite and
    lower on step 0's batch after them."""
    import torch

    from repro_torch import kernels
    from repro_torch.configs import archs
    from repro_torch.data import pipeline
    from repro_torch.kernels.flash_attention import cases
    from repro_torch.launch import steps
    from repro_torch.launch.fl_train import batch_to_device
    from repro_torch.models import registry
    from repro_torch.models.config import SHAPES, ShapeConfig
    from repro_torch.optim import adamw
    from repro_torch.pytree import tree_map

    cfg = archs.get(WHISPER_ARCH)
    base = SHAPES["train_4k"]
    check(base.seq_len == WHISPER_TRAIN_SEQ, f"train_4k's sequence is {base.seq_len}")
    shape = ShapeConfig(base.name, base.kind, WHISPER_TRAIN_SEQ, WHISPER_TRAIN_BATCH)
    opt_cfg = adamw.OptConfig(peak_lr=3e-3, warmup_steps=5,
                              decay_steps=max(WHISPER_STEPS, 10))
    torch.cuda.empty_cache()
    start = steps.init_state(0, cfg, opt_cfg, device)
    stream = pipeline.SyntheticStream(cfg, shape, seed=0)
    batches = [batch_to_device(stream.batch(i), device) for i in range(WHISPER_STEPS)]
    f32 = cfg.replace(compute_dtype="float32")
    runs = {}
    for key, c, impl in (("f32 cuda", f32, "cuda"), ("f32 ref", f32, "ref"),
                         ("bf16 cuda", cfg, "cuda"), ("bf16 ref", cfg, "ref")):
        runs[key] = steps.build_train_step(c, opt_cfg, impl)(
            tree_map(lambda t: t.clone(), start), batches[0])
        torch.cuda.synchronize()
    gap = {}
    for dt, bounds in (("f32", F32_FIRST_STEP), ("bf16", BF16_WHISPER_FIRST_STEP)):
        try:
            read = cases.check_first_step(*runs[f"{dt} cuda"], *runs[f"{dt} ref"], opt_cfg,
                                          loss_rtol=bounds[0], gnorm_rtol=bounds[1],
                                          mu_rtol=bounds[2])
        except AssertionError as exc:
            raise SmokeFailure(f"whisper {dt} first step, kernels vs plain: {exc}") from exc
        gap[dt] = read["mu_frac"]
    # the bf16 steps' distance from the f32 plain step: the kernels' no
    # larger than the plain versions' own, and the kernels' gap from the
    # plain bf16 step no larger than that step's own gap from f32
    far = {k: cases.step_gap(*runs[f"bf16 {k}"], *runs["f32 ref"])["mu_frac"]
           for k in ("cuda", "ref")}
    own = far["ref"]
    check(far["cuda"] <= BF16_FAR_RATIO * own and gap["bf16"] <= BF16_FAR_RATIO * own,
          f"whisper bf16 first step: the kernels' mu lies {far['cuda']:.3g} of its scale "
          f"from the f32 step and {gap['bf16']:.3g} from the plain bf16 step, which lies "
          f"{own:.3g} from the f32 step")
    del runs
    train_step = steps.build_train_step(cfg, opt_cfg)
    attn = cfg.n_enc_layers + 2 * cfg.n_layers
    kernels.reset_launch_counts()
    state, losses = start, []
    for batch in batches:
        state, metrics = train_step(state, batch)
        losses.append(float(metrics["loss"]))
    got = {k: n for k, n in kernels.launch_counts().items() if n}
    per = 2 if cfg.remat == "full" else 1
    want = {"flash_attention_fwd": per * attn * WHISPER_STEPS,
            "flash_attention_fwd_wgmma": per * attn * WHISPER_STEPS,
            "flash_attention_bwd": attn * WHISPER_STEPS}
    check(got == want, f"whisper training launches {got}, oracle {want} ({attn} attention "
          "calls a forward: encoder, decoder self and cross)")
    with torch.no_grad():
        again = float(registry.bundle(cfg).loss_fn(state["params"], batches[0])[0])
    check(all(math.isfinite(x) for x in losses + [again]), f"non-finite loss: {losses}")
    check(again < losses[0], f"whisper loss did not fall on step 0's batch: {losses[0]} -> "
          f"{again}")
    log(f"[{WHISPER_TAG}] training: first steps kernels vs plain within {F32_FIRST_STEP} (f32) "
        f"and {BF16_WHISPER_FIRST_STEP} (bf16), bf16 mu ratios {far['cuda'] / own:.3f} and "
        f"{gap['bf16'] / own:.3f} (bound {BF16_FAR_RATIO}); {WHISPER_STEPS} steps at B "
        f"{WHISPER_TRAIN_BATCH} x S {WHISPER_TRAIN_SEQ}: launches {got}, the oracle's; step 0's "
        f"batch's loss {losses[0]:.4f} -> {again:.4f}")
    del state, batches, start
    torch.cuda.empty_cache()


def _sdpa_run(q, k, v, grad=None, causal: bool = False):
    """``F.scaled_dot_product_attention`` on the same tensors (heads moved
    to dim 1, no softcap; causal with the mask aligned top-left, which
    ``is_causal`` gives at Sq == Skv), pinned to one
    backend (flash, then memory-efficient, then cuDNN, the first that
    runs): (a function running it, or with ``grad`` its backward alone,
    the backend's name), or (None, why). A yardstick only, never called by
    the port."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    errors = []
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION):
        try:
            qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(grad is not None)
                          for t in (q, k, v))
            with sdpa_kernel(backend):
                out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                     enable_gqa=True)
            if grad is None:
                def run(qt=qt, kt=kt, vt=vt, backend=backend):
                    with sdpa_kernel(backend):
                        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                              enable_gqa=True)
            else:
                gt = grad.transpose(1, 2).contiguous()

                def run(out=out, qt=qt, kt=kt, vt=vt, gt=gt):
                    return torch.autograd.grad(out, (qt, kt, vt), gt, retain_graph=True)
            run()
            torch.cuda.synchronize()
            return run, backend.name
        except Exception as exc:  # noqa: BLE001 - a backend may refuse the shape
            errors.append(f"{backend.name}: {type(exc).__name__}")
    return None, "; ".join(errors)


def _rect_rows(device, power_note: str) -> None:
    """The kernels at whisper-base's shapes and kimi-k2's head dim, bf16,
    each beside its bound (the larger of its bytes at 3.35 TB/s and its
    products at 989 TFLOP/s), its plain version and, at whisper's shapes
    (no softcap, no window, non-causal), ``scaled_dot_product_attention``
    on one backend, which computes the same function: the encoder's
    forward and backward (1536 x 1536, 8 and 16 lanes), the
    cross-attention's forward (Sq 4 against 1536 at 8 lanes, Sq 4096 at 16)
    and backward (Sq 4096), the decodes (G 1, hd 64: cross against 1536
    frames, self against 448 slots at the 197 tokens a generation ends
    with, ``sdpa`` on those 197); at hd 112 (64 / 8 heads, causal) the
    padded prefill and decode beside the kernel on inputs padded beforehand
    (the padding's copy) and ``sdpa`` (causal, GQA) on the unpadded ones."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention as fa_kern
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    gen = torch.Generator(device=device).manual_seed(47)
    bf = torch.bfloat16

    def row(what, ms, plain, flops, nbytes, lib, extra=""):
        b, by = _bound(flops, nbytes)
        log(f"[{WHISPER_TAG}] {what}: {ms:.4f} ms by CUDA events, bound {b:.4f} ms by {by} "
            f"({b / ms:.1%}; {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB), plain "
            f"{plain:.3f} ms, library {lib}{extra}  [{power_note}]")

    def lib_note(run, name, reps):
        return "null" if run is None else f"{time_ms(run, reps=reps):.4f} ms ({name})"

    H, KV, hd = 8, 8, 64
    for B, Sq, Skv in ((8, 1536, 1536), (16, 1536, 1536), (8, 4, 1536), (16, 4096, 1536)):
        q, k, v = _fa_inputs(gen, (B, Sq, H, hd), (B, Skv, KV, hd), bf, device)
        kernel = lambda: ops.flash_attention(q, k, v, causal=False, impl="cuda")  # noqa: E731
        _fa_vs_plain(kernel(), ops.flash_attention(q, k, v, causal=False, impl="ref"),
                     f"rect forward {B, Sq, Skv}")
        ms, graph = time_ms(kernel, reps=20), _graph_ms(kernel, 20)
        plain = time_ms(lambda: ops.flash_attention(q, k, v, causal=False, impl="ref"), reps=2)
        run, name = _sdpa_run(q, k, v)
        what = "encoder" if Sq == Skv else "cross-attention"
        row(f"flash_attention_fwd, {what} (B {B}, Sq {Sq}, Skv {Skv}, 8 / 8 x 64, non-causal)",
            ms, plain, 4 * B * H * Sq * Skv * hd, 2 * (2 * B * Sq * H * hd + 2 * B * Skv * KV * hd),
            lib_note(run, name, 20), f"; {graph:.4f} ms device by graph replay")
        if B == 16 and Sq >= 1536:
            out, lse = ops.flash_attention(q, k, v, causal=False, impl="cuda", lse=True)
            g = torch.randn(B, Sq, H, hd, generator=gen, device=device).to(bf)
            kb = lambda: ops.flash_attention_bwd(q, k, v, out, lse, g, causal=False,  # noqa: E731
                                                 impl="cuda")
            got = kb()
            want = ops.flash_attention_bwd(q, k, v, out, lse, g, causal=False, impl="ref")
            for nm, a, w in zip(("dq", "dk", "dv"), got, want):
                ok, e = fa_ref.bwd_close(a, w)
                check(ok, f"rect backward {B, Sq, Skv}: {nm} outside bwd_tolerance ({e})")
            del got, want
            ms = time_ms(kb, reps=5)
            plain = time_ms(lambda: ops.flash_attention_bwd(q, k, v, out, lse, g, causal=False,
                                                            impl="ref"), reps=1)
            run, name = _sdpa_run(q, k, v, grad=g)
            row(f"flash_attention_bwd, {what} (B {B}, Sq {Sq}, Skv {Skv}, non-causal)", ms, plain,
                5 * 2 * B * H * Sq * Skv * hd,
                2 * (4 * B * Sq * H * hd + 4 * B * Skv * KV * hd) + B * H * Sq * 4,
                lib_note(run, f"{name} backward alone", 5))
            del out, lse, g
        del q, k, v
        torch.cuda.empty_cache()
    for L, n in ((1536, 1536), (448, 197)):
        B = WHISPER_LANES
        q, k, v = _fa_inputs(gen, (B, 1, H, hd), (B, L, KV, hd), bf, device)
        kv_len = torch.full((B,), n, dtype=torch.int32, device=device)
        kernel = lambda: ops.flash_attention_decode(q, k, v, kv_len, impl="cuda")  # noqa: E731
        _fa_vs_plain(kernel(), ops.flash_attention_decode(q, k, v, kv_len, impl="ref"),
                     f"decode L {L}")
        ms, graph = time_ms(kernel, reps=50), _graph_ms(kernel, 50)
        plain = time_ms(lambda: ops.flash_attention_decode(q, k, v, kv_len, impl="ref"), reps=10)
        # the first n slots are every key kv_len lets the decode read
        run, name = _sdpa_run(q, k[:, :n], v[:, :n])
        lib = lib_note(run, name, 50)
        row(f"flash_attention_decode, {'cross' if L == 1536 else 'self'} (B {B}, Sq 1, L {L}, "
            f"kv_len {n}, G 1, hd 64)", ms, plain, 4 * B * H * n * hd,
            2 * (2 * B * n * KV * hd + 2 * B * H * hd) + 4 * B, lib,
            f"; {graph:.4f} ms device by graph replay")
        del q, k, v
    # kimi-k2's head dim: the padded call against the kernel on inputs padded
    # beforehand, the difference the padding's copy
    H, KV, hd, hp = 64, 8, 112, 128
    B, S = 2, 1024
    q, k, v = _fa_inputs(gen, (B, S, H, hd), (B, S, KV, hd), bf, device)
    qp, kp, vp = (fa_kern.pad_head_dim(x, hp) for x in (q, k, v))
    padded = lambda: ops.flash_attention(q, k, v, impl="cuda")  # noqa: E731
    _fa_vs_plain(padded(), ops.flash_attention(q, k, v, impl="ref"), "hd 112 prefill")
    ms = time_ms(padded, reps=20)
    pre = time_ms(lambda: fa_kern.flash_attention_fwd(qp, kp, vp), reps=20)
    plain = time_ms(lambda: ops.flash_attention(q, k, v, impl="ref"), reps=2)
    run, name = _sdpa_run(q, k, v, causal=True)
    row(f"flash_attention_fwd at hd 112 (B {B}, S {S}, 64 / 8 heads, causal; padded to 128)",
        ms, plain, B * H * (S * (S + 1) // 2) * 4 * hd,
        2 * (2 * B * S * H * hd + 2 * B * S * KV * hd), lib_note(run, name, 20),
        f"; the kernel on inputs padded beforehand {pre:.4f} ms, so the padding "
        f"{ms - pre:.4f} ms")
    B, L = 4, 529
    q, k, v = _fa_inputs(gen, (B, 1, H, hd), (B, L, KV, hd), bf, device)
    qp, kp, vp = (fa_kern.pad_head_dim(x, hp) for x in (q, k, v))
    kv_len = torch.full((B,), L, dtype=torch.int32, device=device)
    padded = lambda: ops.flash_attention_decode(q, k, v, kv_len, impl="cuda")  # noqa: E731
    _fa_vs_plain(padded(), ops.flash_attention_decode(q, k, v, kv_len, impl="ref"),
                 "hd 112 decode")
    ms = time_ms(padded, reps=50)
    pre = time_ms(lambda: fa_kern.flash_attention_decode(qp, kp, vp, kv_len), reps=50)
    plain = time_ms(lambda: ops.flash_attention_decode(q, k, v, kv_len, impl="ref"), reps=10)
    run, name = _sdpa_run(q, k, v)
    row(f"flash_attention_decode at hd 112 (B {B}, Sq 1, L {L}, 64 / 8 heads; padded to 128)",
        ms, plain, 4 * B * H * L * hd, 2 * (2 * B * L * KV * hd + 2 * B * H * hd) + 4 * B,
        lib_note(run, name, 50), f"; the kernel on inputs padded beforehand {pre:.4f} ms, so the padding (a "
        f"copy of the cache a call) {ms - pre:.4f} ms")
    del q, k, v, qp, kp, vp
    torch.cuda.empty_cache()


def phase_whisper(device, power_note: str) -> None:
    """The encoder-decoder family: whisper-base generation and training at
    full size, then the kernels' rows at its shapes (see 5.)."""
    _whisper_generation(device)
    _whisper_training(device)
    _rect_rows(device, power_note)


def _make_vlm_decoder(device):
    """qwen2-vl-72b at its published widths, depth cut to ``VLM_LAYERS``,
    through ``_cut_decoder``."""
    from repro_torch.configs import archs

    return _cut_decoder(archs.get(VLM_ARCH).replace(n_layers=VLM_LAYERS), device)


def grid_positions(B: int, grid: int, text: int, t0: int = 0):
    """Qwen2-VL's positions of one image of ``grid`` x ``grid`` patch tokens
    then ``text`` tokens: (B, grid^2 + text, 3) int32, the image at ``(t0,
    t0 + row, t0 + col)``, the text at ``max + 1 + i`` on all three."""
    import numpy as np

    rows, cols = np.divmod(np.arange(grid * grid), grid)
    image = np.stack([np.full_like(rows, t0), t0 + rows, t0 + cols], axis=-1)
    txt = np.repeat((int(image.max()) + 1 + np.arange(text))[:, None], 3, axis=1)
    return np.concatenate([image, txt])[None].repeat(B, axis=0).astype(np.int32)


def _vlm_grid_prefill(dec, device) -> None:
    """One bundle prefill with image-grid positions (an 8 x 8 grid of patch
    tokens at (t0, t0 + row, t0 + col), then 192 text tokens at max + 1 +
    i) on 4 lanes, through the kernels and through the plain versions:
    the last-token logits within ``BF16_MODEL_FRAC`` of their scale; and
    against the same tokens at text positions, which must differ (the
    positions reach the rope)."""
    import numpy as np
    import torch

    from repro_torch.models import transformer

    cfg = dec.cfg
    S = VLM_GRID * VLM_GRID + VLM_TEXT
    rng = np.random.default_rng(53)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (SERVE_BATCH, S))).to(device)
    pos = torch.from_numpy(grid_positions(SERVE_BATCH, VLM_GRID, VLM_TEXT, t0=7)).to(device)
    with torch.no_grad():
        lk, _ = dec.bundle.prefill_fn(dec.params, {"tokens": tokens, "positions": pos},
                                      dec.max_len)
        lr, _ = transformer.prefill(dec.params, tokens, cfg, dec.max_len, impl="ref",
                                    positions=pos)
        lt, _ = dec.bundle.prefill_fn(dec.params, {"tokens": tokens}, dec.max_len)
    rel, moved = _rel(lk, lr), _rel(lt, lk)
    log(f"[{VLM_TAG}] image-grid prefill ({SERVE_BATCH} lanes, a {VLM_GRID} x {VLM_GRID} grid "
        f"then {VLM_TEXT} text tokens, positions up to {int(pos.max())}): last-token logits, "
        f"kernels vs plain, {rel:.3g} of their scale (bound {BF16_MODEL_FRAC}); the same "
        f"tokens at text positions move them by {moved:.3g}")
    check(bool(torch.isfinite(lk).all()) and rel <= BF16_MODEL_FRAC,
          f"qwen2-vl image-grid prefill, kernels vs plain: {rel:.3g} of the logits' scale")
    check(moved > BF16_MODEL_FRAC, f"qwen2-vl: image-grid positions moved the logits by "
          f"{moved:.3g} only")


def phase_vlm(device) -> None:
    """M-RoPE: qwen2-vl-72b at its published widths, 8 of 80 layers, through
    ``serve_constellation``'s entry points with the ``ModelDecoder`` built
    directly (see 6.)."""
    cfg, dec = _make_vlm_decoder(device)
    log(f"[{VLM_TAG}] {cfg.name}: {cfg.n_layers} of 80 layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} / {cfg.n_kv_heads} heads x {cfg.head_dim}, M-RoPE sections "
        f"{cfg.mrope_sections}, {cfg.compute_dtype} compute")
    check(cfg.n_layers == VLM_LAYERS and cfg.mrope_sections == (16, 24, 24) and cfg.qkv_bias,
          f"{cfg.name}: {cfg.n_layers} layers, sections {cfg.mrope_sections}")
    res, rec, counts = _run_serving(dec, cfg, device, VLM_TAG)
    log(f"[{VLM_TAG}] delivered, audit OK; "
        + _check_serving_launches(rec, counts, VLM_TAG, cfg.n_layers))
    tokens = _tokens_by_request(res.report)
    del dec, res
    _freed(device, VLM_TAG)
    dec = _replay(lambda: _make_vlm_decoder(device), cfg, device, tokens, VLM_TAG)
    _vlm_grid_prefill(dec, device)
    del dec
    _freed(device, VLM_TAG)


def _make_hybrid_decoder(device):
    """jamba-1.5-large-398b at its published widths, cut by ``HYBRID_CUT``,
    through ``_cut_decoder``."""
    import dataclasses

    from repro_torch.configs import archs

    cfg = archs.get(HYBRID_ARCH)
    return _cut_decoder(cfg.replace(
        n_layers=HYBRID_CUT["n_layers"],
        moe=dataclasses.replace(cfg.moe, n_experts=HYBRID_CUT["n_experts"])), device)


def _wave_prefill_ssm(dec, report, device, tag: str) -> None:
    """One wave (the first four requests' prompts, left-padded to their
    bucket) of a stack with Mamba-2 layers through the kernels and through
    their plain versions:

    - layer by layer, both fed the same input: an attention layer's raw
      attention within ``fa_tolerance``, its K/V cache entries
      bit-identical; each Mamba-2 layer's SSM state within
      ``ssd_tolerance`` and its conv tail equal; every mixer output within
      ``OUT_ULPS`` bf16 ulps of its largest magnitude (the gemma2 phase's
      bound): a y entry may differ by one bf16 ulp, the gate, the norm and
      the output projection round again, and the projection mixes thousands
      of such entries into each output, so the natural unit is the ulp at
      the tensor's scale. The FFNs (MoE or dense) take no kernel and run
      once on the plain path's output;
    - the whole prefill and ``WAVE_TICKS`` decode ticks (fed the kernel
      path's greedy tokens): the logits, and every Mamba-2 layer's SSM state
      after the prefill, within ``SERVE_SPREAD`` times the plain path's own
      spread, i.e. its difference from the same plain path with the scan
      chunked at half the config's chunk and attention's p rounded to bf16
      before the PV product at prefill and decode (the reference's prefill
      attention; mathematically the same model, rounded in another order).
      Later layers carry and amplify a layer's rounding differences, and a
      token whose near-tied top-k routing or capacity drop flips moves its
      logits, so a bound in ulps does not apply."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    from repro_torch.models import mamba2, transformer
    from repro_torch.models.layers import embed_tokens, rmsnorm
    from repro_torch.pytree import tree_map

    cfg, params, max_len = dec.cfg, dec.params, dec.max_len
    prompts = [r.prompt for r in sorted(report.requests, key=lambda r: r.rid)[:SERVE_BATCH]]
    plen = dec._bucket(max(len(p) for p in prompts))
    toks = np.zeros((SERVE_BATCH, plen), np.int64)
    for lane, p in enumerate(prompts):
        toks[lane, plen - len(p):] = p
    tokens = torch.from_numpy(toks).to(device)
    positions = torch.arange(plen, device=device)[None].expand(SERVE_BATCH, plen)
    worst = {"attention": 0.0, "state": 0.0, "attn out": 0.0, "mamba out": 0.0}
    with torch.no_grad():
        h = embed_tokens(params["embed"], tokens, cfg)
        for u in range(transformer.n_units(cfg)):
            unit_p = tree_map(lambda t: t[u], params["units"])
            for j, d in enumerate(transformer.scan_unit(cfg)):
                p = unit_p[f"L{j}"]
                hn = rmsnorm(h, p["ln"], cfg.norm_eps)
                if d.mixer == "attn":
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
                    err_o = _scale_ulps(out_k, out_r)
                    check(ok_raw and err_o <= OUT_ULPS and torch.equal(kv_k.k, kv_r.k)
                          and torch.equal(kv_k.v, kv_r.v),
                          f"{tag}: wave prefill unit {u} layer {j}, same input: attention {err_raw:.3g}"
                          f" (fa_tolerance), output {err_o:.3g} bf16 ulps at scale (bound "
                          f"{OUT_ULPS}), or K/V cache entries differ")
                    worst["attention"] = max(worst["attention"], err_raw)
                    worst["attn out"] = max(worst["attn out"], err_o)
                elif d.mixer == "mamba":
                    out_k, c_k = mamba2.mamba_prefill(p["mamba"], hn, cfg, ssd_impl="cuda")
                    out_r, c_r = mamba2.mamba_prefill(p["mamba"], hn, cfg, ssd_impl="ref")
                    ok_s, err_s = ssd_ref.ssd_close(c_k.ssm, c_r.ssm)
                    err_o = _scale_ulps(out_k, out_r)
                    check(ok_s and err_o <= OUT_ULPS and torch.equal(c_k.conv, c_r.conv),
                          f"{tag}: wave prefill unit {u} layer {j}, same input: state {err_s:.3g} "
                          f"(ssd_tolerance), output {err_o:.3g} bf16 ulps at scale (bound "
                          f"{OUT_ULPS}), or conv tails differ")
                    worst["state"] = max(worst["state"], err_s)
                    worst["mamba out"] = max(worst["mamba out"], err_o)
                if d.mixer is not None:
                    h = h + out_r
                if d.ffn is not None:
                    h = h + transformer._ffn(p, h, cfg, d)[0]
        del h, hn, out_k, out_r

        def run(impl, chunk, forced=None):
            c = cfg.replace(mamba=dataclasses.replace(cfg.mamba, chunk=chunk))
            logits, cache = transformer.prefill(params, tokens, c, max_len, impl=impl)
            states = [e.ssm[u].clone() for name, e in cache["units"].items()
                      if name.startswith("mamba") for u in range(e.ssm.shape[0])]
            outs, fed = [logits], []
            for t in range(WAVE_TICKS):
                fed.append(forced[t] if forced else outs[-1][:, -1].argmax(-1)[:, None])
                logits, cache = transformer.decode_step(params, cache, fed[-1], c, impl=impl)
                outs.append(logits)
            return outs, fed, states

        kern, fed, kern_states = run("cuda", cfg.mamba.chunk)
        plain, _, states = run("ref", cfg.mamba.chunk, fed)
        attention_ref = fa_ref.attention_ref
        fa_ref.attention_ref = lambda *a, **kw: attention_ref(*a, **kw, p_dtype=torch.bfloat16)
        try:
            plain2, _, states2 = run("ref", cfg.mamba.chunk // 2, fed)
        finally:
            fa_ref.attention_ref = attention_ref
    check(all(bool(torch.isfinite(t).all())
              for t in kern + plain + plain2 + kern_states + states + states2),
          f"{tag}: wave, non-finite logits or states")
    k_pre, s_pre = _rel(kern[0], plain[0]), _rel(plain2[0], plain[0])
    k_tick = max(_rel(a, b) for a, b in zip(kern[1:], plain[1:]))
    s_tick = max(_rel(a, b) for a, b in zip(plain2[1:], plain[1:]))
    k_state = max(_rel(a, b) for a, b in zip(kern_states, states))
    s_state = max(_rel(a, b) for a, b in zip(states2, states))
    same = sum(bool((a[:, -1].argmax(-1) == b[:, -1].argmax(-1)).all())
               for a, b in zip(kern, plain))
    log(f"[{tag}] wave prefill (4 lanes, bucket {plen}), kernels vs plain versions: "
        f"layer by layer on the same input, attention max |diff| {worst['attention']:.3g} "
        f"(fa_tolerance) and its output {worst['attn out']:.3g} bf16 ulps at scale, SSM states "
        f"max |diff| {worst['state']:.3g} (ssd_tolerance) and Mamba outputs up to "
        f"{worst['mamba out']:.3g} bf16 ulps (bound {OUT_ULPS}), K/V and conv tails equal; "
        f"whole prefill last-token logits {k_pre:.3g} of their scale, {WAVE_TICKS} ticks "
        f"up to {k_tick:.3g} and the SSM states up to {k_state:.3g}, against the plain "
        f"path's own spread (chunk {cfg.mamba.chunk // 2} vs {cfg.mamba.chunk}, p in bf16) "
        f"of {s_pre:.3g}, {s_tick:.3g} and {s_state:.3g} (bound {SERVE_SPREAD}x); greedy "
        f"tokens equal in {same} of {len(kern)} calls")
    check(k_pre <= SERVE_SPREAD * s_pre and k_tick <= SERVE_SPREAD * s_tick
          and k_state <= SERVE_SPREAD * s_state,
          f"{tag}: wave, kernels vs plain: prefill {k_pre:.3g}, ticks {k_tick:.3g} of the "
          f"logits' scale, states {k_state:.3g}, beyond {SERVE_SPREAD}x the plain path's "
          f"spread ({s_pre:.3g}, {s_tick:.3g}, {s_state:.3g})")


def phase_hybrid(device) -> None:
    """The hybrid family: jamba-1.5-large-398b at its published widths cut by
    ``HYBRID_CUT`` (one unit, 4 experts), through ``serve_constellation``'s
    entry points with the ``ModelDecoder`` built directly (see 7.)."""
    import torch

    from repro_torch.models import moe, transformer
    from repro_torch.pytree import tree_leaves

    torch.cuda.reset_peak_memory_stats(device)
    cfg, dec = _make_hybrid_decoder(device)
    n_params = sum(t.numel() for t in tree_leaves(dec.params))
    m, mb = cfg.moe, cfg.mamba
    descs = transformer.scan_unit(cfg)
    n_mamba = sum(d.mixer == "mamba" for d in descs) * transformer.n_units(cfg)
    n_attn = cfg.n_layers - n_mamba
    log(f"[{HYBRID_TAG}] {cfg.name}: {cfg.n_layers} of 72 layers ({n_attn} attention, "
        f"{n_mamba} Mamba-2 of {mb.n_heads(cfg.d_model)} heads x {mb.head_dim} in "
        f"{mb.n_groups} groups), {m.n_experts} of 16 experts top-{m.top_k}, {n_params:,} "
        f"params, {cfg.compute_dtype} compute")
    check(n_params == cfg.param_count() and n_mamba == 7 and n_attn == 1
          and m.n_experts == HYBRID_CUT["n_experts"] and m.top_k == 2,
          f"{cfg.name}: {n_params} params, {n_mamba} Mamba layers, {m.n_experts} experts")
    with moe.count_drops() as tally:
        res, rec, counts = _run_serving(dec, cfg, device, HYBRID_TAG)
    check(set(tally) == {"prefill", "decode"}, f"drops tallied for {sorted(tally)}")
    del tally
    peak = torch.cuda.max_memory_allocated(device)
    check(peak <= MOE_PEAK_GIB * 2 ** 30,
          f"peak {_gib(peak)} GiB above {MOE_PEAK_GIB} GiB: find the transient, or cut to 3 "
          "experts")
    log(f"[{HYBRID_TAG}] delivered, audit OK; "
        + _check_serving_launches(rec, counts, HYBRID_TAG, n_attn, n_mamba)
        + f"; peak {_gib(peak)} GiB (bound {MOE_PEAK_GIB})")
    _wave_prefill_ssm(dec, res.report, device, HYBRID_TAG)
    tokens = _tokens_by_request(res.report)
    del dec, res
    _freed(device, HYBRID_TAG)
    _replay(lambda: _make_hybrid_decoder(device), cfg, device, tokens, HYBRID_TAG)
    _freed(device, HYBRID_TAG)


# ---------------------------------------------------------------------------
# the main path at the cells' widths: mamba2-780m and nemotron-3-nano
# serving, the FL rounds and the ground segment
# ---------------------------------------------------------------------------

SERVE_ARCH = "mamba2-780m"
SERVE_TAG = "serve"
NEMOTRON_ARCH = "nemotron-3-nano-30b-a3b"
NEMOTRON_CUT = "MEMEM*E"    # the published pattern's first 7 layers: each kind, at its widths
NEMOTRON_SSD = (2, 1024, 64, 64, 8, 128)   # (B, S, H, P, G, N) at chunk 128
NEMOTRON_TAG = "nemotron"
SLICE_ROUNDS = 3
SLICE_SEQ = 256             # tokens per row; 4 rows per node and local step
MODE_KERNELS = {"none": (), "int8": ("quantize", "gossip_fold"),
                "topk": ("topk_sparsify", "scatter_accumulate")}
# ground segment: (compression, pipeline depth, staleness horizon)
GS_CONFIGS = (("none", 1, 0), ("int8", 1, 0), ("int8", 2, 1))
GS_ROUNDS = 3
GS_KERNELS = {"none": (), "int8": ("quantize_scaled", "quantize", "dequant_accumulate")}


def phase_serving(device) -> None:
    """mamba2-780m at its published config, all 48 layers, through
    ``serve_constellation``'s entry points (see 8.)."""
    cfg, dec = _make_decoder(SERVE_ARCH, device)
    log(f"[{SERVE_TAG}] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.mamba.n_heads(cfg.d_model)} SSM heads x {cfg.mamba.head_dim}, d_state "
        f"{cfg.mamba.d_state}, chunk {cfg.mamba.chunk}, {cfg.compute_dtype} compute")
    check(cfg.n_layers == 48, f"{cfg.name} has {cfg.n_layers} layers")
    res, rec, counts = _run_serving(dec, cfg, device, SERVE_TAG)
    check(any(sp.args["bucket"] == 512 for sp in rec.spans if sp.name == "serve.prefill"),
          f"[{SERVE_TAG}] no two-chunk prefill (bucket 512)")
    log(f"[{SERVE_TAG}] delivered, audit OK; "
        + _check_serving_launches(rec, counts, SERVE_TAG, 0, cfg.n_layers))
    _wave_prefill_ssm(dec, res.report, device, SERVE_TAG)
    tokens = _tokens_by_request(res.report)
    del dec, res
    _freed(device, SERVE_TAG)
    _replay(lambda: _make_decoder(SERVE_ARCH, device), cfg, device, tokens, SERVE_TAG)
    _freed(device, SERVE_TAG)


def phase_nemotron(device) -> None:
    """nemotron-3-nano-30b-a3b: the kernels at its shapes against their
    plain versions, then its published widths cut to ``NEMOTRON_CUT``
    through ``serve_constellation``'s entry points (see 9.)."""
    import torch

    from repro_torch.configs import archs
    from repro_torch.kernels.flash_attention import cases
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    from repro_torch.models import moe, transformer
    from repro_torch.pytree import tree_leaves

    worst = 0.0
    gen = torch.Generator(device=device).manual_seed(13)
    for dtype in (torch.bfloat16, torch.float32):
        try:
            for case in cases.NEMOTRON_PREFILL_CASES:
                worst = max(worst, cases.check_prefill_case(case, dtype, device))
            for case in cases.NEMOTRON_DECODE_CASES:
                worst = max(worst, cases.check_decode_case(case, dtype, device))
        except AssertionError as exc:
            raise SmokeFailure(f"[{NEMOTRON_TAG}] attention case: {exc}") from exc
        worst = max(worst, _ssd_vs_plain(ssd_ref.init_inputs(gen, NEMOTRON_SSD, dtype), 128,
                                         f"[{NEMOTRON_TAG}] ssd_scan {NEMOTRON_SSD} {dtype}"))
    log(f"[{NEMOTRON_TAG}] attention (G 16, hd 128) and ssd_scan (64 heads in 8 groups, "
        f"chunk 128) at its shapes, bf16 and f32: within fa_tolerance and ssd_tolerance of "
        f"the plain versions (max |diff| {worst:.3g}), each launched twice bit-identical")
    cfg, dec = _cut_decoder(archs.get(NEMOTRON_ARCH).replace(
        pattern=NEMOTRON_CUT, n_layers=len(NEMOTRON_CUT)), device)
    descs = transformer.scan_unit(cfg)
    n_mamba, n_attn, n_moe = (sum(d.mixer == "mamba" for d in descs),
                              sum(d.mixer == "attn" for d in descs),
                              sum(d.ffn == "moe" for d in descs))
    n_params = sum(t.numel() for t in tree_leaves(dec.params))
    check(n_params == cfg.param_count() and (n_mamba, n_attn, n_moe) == (3, 1, 3),
          f"{cfg.name}: {n_params} params, layers {[(d.mixer, d.ffn) for d in descs]}")
    with moe.count_routes() as tally:
        res, rec, counts = _run_serving(dec, cfg, device, NEMOTRON_TAG)
    routes = {kind: torch.stack(calls).sum(0).tolist() for kind, calls in tally.items()}
    del tally
    calls = int(rec.get_counter("serve.prefill.calls"))
    ticks = sum(1 for sp in rec.spans if sp.name == "serve.decode")
    captures, replays = (int(rec.get_counter(f"serve.decode.graph.{k}"))
                         for k in ("captures", "replays"))
    moe_spans = sum(1 for sp in rec.spans if sp.name == "model.moe")
    line = _check_serving_launches(rec, counts, NEMOTRON_TAG, n_attn, n_mamba)
    # a replayed tick runs no span; a capturing one runs the call twice (the
    # capture's spans carry no device time)
    check(moe_spans == n_moe * (calls + ticks - replays + captures),
          f"[{NEMOTRON_TAG}] {moe_spans} model.moe spans for {calls} prefill calls and "
          f"{ticks} ticks, {captures} of them captured and {replays} replayed")
    check(set(routes) == {"prefill", "decode"} and all(r[2] == 0 for r in routes.values()),
          f"[{NEMOTRON_TAG}] routes tallied {routes}")
    log(f"[{NEMOTRON_TAG}] {cfg.name} cut to {NEMOTRON_CUT}: delivered, audit OK; {line}; "
        f"model.moe spans {moe_spans}; routed (assignments, experts hit, dropped) {routes}")
    del dec, res
    _freed(device, NEMOTRON_TAG)


def _mix_bound_ok(got, want, x, n_matchings: int) -> bool:
    """|got - want| <= 2 (M + 2) ulp(|x|max) per node: one fused-vs-unfused
    rounding gap per accumulation (tests/test_torch_exchange.py)."""
    import torch

    rowmax = x.abs().amax(dim=1, keepdim=True)
    ulp = torch.nextafter(rowmax, torch.full_like(rowmax, float("inf"))) - rowmax
    return bool(((got - want).abs() <= 2 * (n_matchings + 2) * ulp).all())


def _compare_exchange(buf, n_leaves: int, rel, mode: str) -> None:
    """The mode's exchange on the trained params' flat buffer, through the
    kernels and through the plain versions (``impl="ref"``), same input:
    codes or selections bit for bit, the mix within :func:`_mix_bound_ok`."""
    from repro_torch.core import fused, tdm
    from repro_torch.kernels.tdm_compress import ops

    m = len(tdm.edge_coloring(rel))
    if mode == "int8":
        for a, b, what in zip(ops.quantize(buf, impl="cuda"), ops.quantize(buf, impl="ref"),
                              ("codes", "scales")):
            _assert_bits(a, b, f"[fl] int8 {what}")
        got = fused.int8_gossip(buf, rel, SLICE_NODES, impl="cuda")
        want = fused.int8_gossip(buf, rel, SLICE_NODES, impl="ref")
    else:
        k_b = topk_block_budget(n_leaves, buf.shape[1], fused.DEFAULT_BLOCK)
        for a, b, what in zip(ops.topk_sparsify(buf, k=k_b, impl="cuda"),
                              ops.topk_sparsify(buf, k=k_b, impl="ref"),
                              ("dense", "vals", "idxs")):
            _assert_bits(a, b, f"[fl] top-k {what}")
        k_total, zero = topk_total(n_leaves, buf.shape[1]), tdm.choco_init(buf)
        got, st = fused.choco_fused_round(buf, zero, rel, SLICE_NODES, k_total, impl="cuda")
        want, st_r = fused.choco_fused_round(buf, zero, rel, SLICE_NODES, k_total, impl="ref")
        check(_mix_bound_ok(st.s, st_r.s, buf, m), "[fl] CHOCO accumulator outside the bound")
        del st, st_r, zero
    check(_mix_bound_ok(got, want, buf, m), f"[fl] {mode} mix outside the bound")
    log(f"[fl] {mode} exchange on the trained params ({m} matchings), kernels vs plain "
        f"versions: codes/selections equal, mix max |diff| {float((got - want).abs().max()):.3g}")


def _tdm_launches(counts) -> dict:
    """The exchange kernels' launches of ``counts``, by name."""
    from repro_torch.kernels.tdm_compress import tdm_compress

    return {name: counts[name] for name in tdm_compress.LAUNCHES}


def phase_fl(device) -> None:
    """TDM-FLA rounds of each compression mode through the launcher's entry
    point (see 10.)."""
    import torch

    from repro_torch import kernels, telemetry
    from repro_torch.core import fused
    from repro_torch.launch import train_fl_constellation as tfc

    for mode in ("none", "int8", "topk"):
        torch.cuda.empty_cache()
        with telemetry.record_scope(tracing=True) as rec:
            kernels.reset_launch_counts()
            res, scn = tfc.main_tdm(SLICE_ROUNDS, device=device, compression=mode,
                                    layers=SLICE_LAYERS, seq=SLICE_SEQ, full_width=True,
                                    fail_round=1)
            torch.cuda.synchronize(device)
            counts = _tdm_launches(kernels.launch_counts())
        launched = {name: n for name, n in counts.items() if n}
        logs = res.logs
        spans = sum(sp.name == "fl.round" for sp in rec.spans)
        check(len(logs) == spans == SLICE_ROUNDS and all(
            math.isfinite(lg.loss) and math.isfinite(lg.consensus) for lg in logs),
            f"[fl] {mode}: {len(logs)} rounds logged, {spans} traced, or a non-finite "
            "loss or consensus")
        check([lg.alive for lg in logs] == [8, 8, 7], f"[fl] {mode}: satellite 3 not dropped")
        check(all((n > 0) == (name in MODE_KERNELS[mode]) for name, n in counts.items()),
              f"[fl] {mode}: launches {launched}, want only {MODE_KERNELS[mode]}")
        log(f"[fl] {mode}: {len(logs)} rounds, losses "
            f"{[round(lg.loss, 4) for lg in logs]}, alive {[lg.alive for lg in logs]}, "
            f"launches {launched}, gathers {rec.get_counter('fl.exchange.gathers'):g} (oracle "
            f"{rec.get_counter('fl.collectives.collective-permute'):g})")
        if mode == "none":
            continue
        spec = fused.cached_spec(res.state["params"])
        (bucket,) = spec.buckets
        buf = fused.flatten_pytree(spec, res.state["params"])[bucket]
        del res
        torch.cuda.empty_cache()
        rels = scn.plan.relations()
        rel = rels[(SLICE_ROUNDS - 1) % len(rels)].restrict(
            set(range(SLICE_NODES)) - {tfc.LOST_SATELLITE})
        _compare_exchange(buf, spec.n_leaves(bucket), rel, mode)
        del buf


def _gs_programs(scn, depth: int, stale: int):
    """(delivered, covered, uplink, downlink) per round as the routing
    programs give them: satellite 2 lost after round 1, replayed with the
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


def phase_groundseg(device) -> None:
    """The ground-segment path through ``main_groundseg`` (see 11.)."""
    import torch

    from repro_torch import kernels, telemetry
    from repro_torch.core import fused
    from repro_torch.groundseg import aggregation
    from repro_torch.launch import train_fl_constellation as tfc
    from repro_torch.pytree import tree_map

    params = scn = None
    for comp, depth, stale in GS_CONFIGS:
        params = None               # the previous config's params, 6.2 GB
        tag = f"[groundseg] {comp} depth {depth} staleness {stale}"
        torch.cuda.empty_cache()
        with telemetry.record_scope(tracing=True) as rec:
            kernels.reset_launch_counts()
            res, scn = tfc.main_groundseg(
                GS_ROUNDS, device=device, compression=comp, pipeline_depth=depth,
                max_staleness=stale, layers=SLICE_LAYERS, seq=SLICE_SEQ, full_width=True)
            torch.cuda.synchronize(device)
            counts = _tdm_launches(kernels.launch_counts())
        launched = {name: n for name, n in counts.items() if n}
        logs = res.logs
        span = "groundseg.round" if depth == 1 and stale == 0 else "groundseg.window"
        spans = sum(sp.name == span for sp in rec.spans)
        check(len(logs) == spans == GS_ROUNDS and all(
            math.isfinite(lg.loss) and math.isfinite(lg.consensus) for lg in logs),
            f"{tag}: {len(logs)} rounds logged, {spans} traced, or a non-finite loss or "
            "consensus")
        check([lg.alive for lg in logs] == [6, 6, 5], f"{tag}: satellite 2 not dropped")
        check([lg.pooled for lg in logs] == [True, False, True], f"{tag}: pooling")
        check([(lg.delivered, lg.covered) for lg in logs]
              == [w[:2] for w in _gs_programs(scn, depth, stale)],
              f"{tag}: delivered/covered differ from the routing programs")
        counters = {k: rec.get_counter(f"groundseg.{k}") for k in (
            "exchange.gathers", "collectives.collective-permute", "exchange.reductions",
            "collectives.all-reduce")}
        check(counters["exchange.gathers"] == counters["collectives.collective-permute"]
              and counters["exchange.reductions"] == counters["collectives.all-reduce"],
              f"{tag}: exchanges issued {counters} differ from the oracle")
        check(all((n > 1) if name in GS_KERNELS[comp] else n == 0
                  for name, n in counts.items()),
              f"{tag}: launches {launched}, want more than one of each of {GS_KERNELS[comp]} "
              "and no other")
        log(f"{tag}: {len(logs)} rounds, delivered "
            f"{[(lg.delivered, lg.alive) for lg in logs]}, launches {launched}, {counters}")
        params = res.state["params"]
        del res
    torch.cuda.empty_cache()
    # one int8 exchange on the trained params, kernels vs plain versions; the
    # round writes into the params it is given, so the kernels' pass takes a copy
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
    del params
    _assert_bits(out["cuda"], out["ref"], "[groundseg] int8 exchange, kernels vs plain")
    log(f"[groundseg] int8 exchange on the trained params ({out['cuda'].shape[0]} x "
        f"{out['cuda'].shape[1]}), kernels vs plain versions: bit for bit")
    del out
    torch.cuda.empty_cache()


def _fl_buffer(device) -> tuple:
    """The FL cells' stacked params buffer, as the exchange engine flattens
    it: mamba2-780m at its published widths, 8 of 48 layers, 8 satellites
    from ``_stack_init``'s seed 0, (8, 194 384 896) float32; and the fused
    CHOCO round's per-block k on it."""
    from repro_torch.core import fused
    from repro_torch.launch import fl_train
    from repro_torch.launch import train_fl_constellation as tfc

    cfg, opt, _, _ = tfc.setup(SLICE_NODES, layers=SLICE_LAYERS, full_width=True)
    params = fl_train._stack_init(0, cfg, opt, SLICE_NODES, device=device)["params"]
    spec = fused.cached_spec(params)
    (bucket,) = spec.buckets
    buf = fused.flatten_pytree(spec, params)[bucket]
    return buf, topk_block_budget(spec.n_leaves(bucket), buf.shape[1], fused.DEFAULT_BLOCK)


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
    phase_serving_dense(device)
    mark("serving, gemma2-9b")
    phase_serving_moe(device, dev["card"])
    mark("serving, qwen3-moe-30b-a3b")
    phase_whisper(device, dev["card"])
    mark("whisper-base, generation and training")
    phase_vlm(device)
    mark("serving, qwen2-vl-72b")
    phase_hybrid(device)
    mark("serving, jamba-1.5-large-398b")
    phase_serving(device)
    mark("serving, mamba2-780m")
    phase_nemotron(device)
    mark("serving, nemotron-3-nano-30b-a3b")
    phase_fl(device)
    mark("FL rounds")
    phase_groundseg(device)
    mark("ground segment")
    buf, k_b = _fl_buffer(device)
    torch.cuda.empty_cache()        # the satellites' params and moments, 18.7 GB
    rows = phase_kernels_slice(device, buf, k_b, dev["card"])
    del buf
    torch.cuda.empty_cache()
    mark("the exchange kernels' rows")
    bwd_row = phase_dense_train(device, dev["card"])
    mark("training, gemma2-9b")
    rows.append(phase_ssd_slice(device, dev["card"]))
    rows += phase_fa_slice(device, dev["card"])
    rows.append(bwd_row)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
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
