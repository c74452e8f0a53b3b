"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips (from a fixture) when no CUDA device is
present. Run on a machine with an H100:

    python -m pytest -m cuda tests/test_torch_cuda.py

Standards as in ``chip_smoke.py``: int8 codes and scales, codes with given
(shared or per-row) scales, dequantized values and top-k dense/vals/idxs bit
for bit, on both top-k paths (select and sort, split at
``TOPK_SELECT_MAX_K``) with normal, tied, all-equal and NaN/inf payloads;
the weighted accumulates within one rounding of the product and of
the sum (the kernels fuse the multiply-add, the plain versions round twice),
the unit-weight accumulate bit for bit (both round once); one int8 and one
topk FL round on the small model through the kernels, held to the same round
through the plain versions, and the int8 ground-segment exchange through the
kernels equal to it through the plain versions bit for bit. The SSD-scan
kernel against its plain version within ``ssd_scan.ref.ssd_tolerance`` (1e-4
of the output's scale, plus one bf16 ulp for bf16 outputs), y and state
finite, on ragged cases and on strong decay at chunk 256, four calls at
the serving shape bit-identical; and a ``ModelDecoder`` prefill and decode
tick on the card. The attention kernels
(prefill and decode) against their plain version within
``flash_attention.ref.fa_tolerance`` (1e-5 of the output's scale, plus one
bf16 ulp for bf16 outputs) on head dims 16 to 256, G 1 to 4, causal,
window and softcap, ragged S (up to 4608, past gemma2-9b's window 4096)
and per-row kv_len (caches up to 8192 slots, split into many chunks), two
launches bit-identical, bf16 prefills counted on the tensor-core kernel;
and gemma2-9b smoke ``ModelDecoder`` runs on the card: a prefill and tick,
and one prefill call admitting both replicas in a bucket-256 wave followed
by ticks past the window (the local ring engaged). The MoE serving cell's
attention shapes (``kernels/flash_attention/cases.py``: qwen3-moe-30b-a3b's
GQA group of 8 at hd 128, no softcap; the prefill at 4 and 8 lanes and
bucket 512, the decode at 8 lanes with ragged kv_len), and a
qwen3-moe smoke ``ModelDecoder`` on the card against the CPU's. Training attention
(``kernels/flash_attention/cases.py``, as ``chip_smoke.py`` runs it): the
forward's lse and ``flash_attention_bwd`` against their plain versions,
f32 and bf16, each launched twice bit-identical; and one train step of the
gemma2-9b smoke config on the kernels against the same step on the plain
versions (``impl="ref"``) on the card.
"""

from __future__ import annotations

import pytest
import torch

from repro_torch.kernels.flash_attention.cases import (
    BWD_CASES,
    SERVE_DECODE_CASES,
    SERVE_PREFILL_CASES,
)
from repro_torch.kernels.tdm_compress.tdm_compress import TOPK_SELECT_MAX_K

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _bits(a, b):
    same = a == b
    if a.dtype.is_floating_point:
        same |= torch.isnan(a) & torch.isnan(b)
    return a.shape == b.shape and bool(same.all())


def _clone(tree):
    return {k: t.clone() for k, t in tree.items()}


SHAPES = [(1, 1, 64), (3, 5000, 1024), (2, 777, 64), (8, 3 * 1024, 256), (2, 1025, 4096)]
# the slice's stacked buffer: 8 nodes x the 8-layer mamba2-780m (194,384,896)
SLICE = (8, 194_384_896, 1024)


@pytest.mark.parametrize("rows,n,block", SHAPES + [SLICE])
def test_quantize_and_dequant_accumulate(device, rows, n, block):
    from repro_torch.kernels.tdm_compress import ref
    from repro_torch.kernels.tdm_compress import tdm_compress as kern

    g = torch.Generator(device=device).manual_seed(n)
    x = torch.randn(rows, n, generator=g, device=device) * 2
    q, s = kern.quantize_fwd(x, block=block)
    q_r, s_r = ref.quantize_ref(x, block)
    assert _bits(q, q_r) and _bits(s, s_r)
    acc = torch.randn(rows, n, generator=g, device=device)
    w = torch.rand(rows, generator=g, device=device)
    got = kern.dequant_accumulate_fwd(q, s, acc, w, block=block)
    want = ref.dequant_acc_ref(q, s, acc, w, block)
    prod = w[:, None] * ref.dequantize_ref(q, s, block)
    assert bool(ref.fma_gap_ok(got, want, prod).all())


def _topk_cases():
    """(rows, n, block, k): k on both sides of the select/sort split, 1 only
    at the slice's shape; (3, 4097, 1024) puts rows 1 and 2 off 16-byte
    alignment, so the select paths take their scalar loads there."""
    sel = TOPK_SELECT_MAX_K
    out = []
    for rows, n, block in SHAPES + [(3, 4097, 1024), SLICE]:
        ks = [1] if n > 10**6 else sorted({1, 7, sel, sel + 1, block})
        out += [(rows, n, block, k) for k in ks if k <= block]
    return out


@pytest.mark.parametrize("kind", ["normal", "ties", "equal", "edge"])
@pytest.mark.parametrize("rows,n,block,k", _topk_cases())
def test_topk_and_scatter_accumulate(device, rows, n, block, k, kind):
    """Top-k bit for bit and the scatter within one rounding, on the path
    that k selects (the launch counters say which)."""
    from repro_torch.kernels.tdm_compress import ref
    from repro_torch.kernels.tdm_compress import tdm_compress as kern

    g = torch.Generator(device=device).manual_seed(n + 1)
    x = torch.randn(rows, n, generator=g, device=device)
    if kind == "ties":
        x[:, ::5] = 1.0                                # exact ties
    elif kind == "equal":
        x.fill_(-0.75)                                 # only the index decides
    elif kind == "edge":
        x = _edge(x, g)
    acc = torch.randn(rows, n, generator=g, device=device)
    w = torch.rand(rows, generator=g, device=device)
    select = k <= TOPK_SELECT_MAX_K
    kern.reset_launch_counts()
    d, v, i = kern.topk_sparsify_fwd(x, k, block=block)
    d_r, v_r, i_r = ref.topk_sparsify_ref(x, k, block)
    assert _bits(d, d_r) and _bits(v, v_r) and _bits(i, i_r)
    got = kern.scatter_accumulate_fwd(v, i, acc, w, block=block)
    want = ref.scatter_acc_ref(v, i, acc, w, block)
    dense = ref.scatter_acc_ref(v, i, torch.zeros_like(acc), 1.0, block)
    assert bool(ref.fma_gap_ok(got, want, w[:, None] * dense).all())
    counts = kern.launch_counts()
    assert counts["topk_sparsify" if select else "topk_sparsify_sort"] == 1
    assert counts["scatter_accumulate" if select else "scatter_accumulate_shared"] == 1


def _edge(x, g):
    u = torch.rand(x.shape, generator=g, device=x.device)
    x[u < 0.03] = float("nan")
    x[(u >= 0.03) & (u < 0.06)] = float("inf")
    x[(u >= 0.06) & (u < 0.09)] = float("-inf")
    x[(u >= 0.09) & (u < 0.12)] = -0.0
    return x


@pytest.mark.parametrize("rows,n,block", SHAPES + [SLICE])
def test_quantize_scaled_and_dequantize(device, rows, n, block):
    from repro_torch.kernels.tdm_compress import ref
    from repro_torch.kernels.tdm_compress import tdm_compress as kern

    g = torch.Generator(device=device).manual_seed(n + 2)
    x = torch.randn(rows, n, generator=g, device=device) * 2
    if n < 10**6:
        x = _edge(x, g)
    per_row = ref.blockwise_scales_ref(x, block)
    shared = per_row.amax(dim=0)
    if n < 10**6:
        per_row[0, 0] = float("nan")
        per_row[-1, -1] = float("inf")
    for scales in (shared, per_row):
        q = kern.quantize_scaled_fwd(x, scales, block=block)
        assert _bits(q, ref.quantize_scaled_ref(x, scales, block))
        assert _bits(kern.dequantize_fwd(q, scales, block=block),
                     ref.dequantize_ref(q, scales, block))


@pytest.mark.parametrize("rows,n,block", SHAPES + [SLICE])
def test_unit_weight_dequant_accumulate(device, rows, n, block):
    """w=None: fma(q, s, acc), one rounding, in the kernel and (exactly, via
    float64 rounded to odd) in the plain version: bit for bit."""
    from repro_torch.kernels.tdm_compress import ref
    from repro_torch.kernels.tdm_compress import tdm_compress as kern

    g = torch.Generator(device=device).manual_seed(n + 3)
    nb = -(-n // block)
    s = torch.rand(rows, nb, generator=g, device=device) * 0.1
    acc = torch.randn(rows, n, generator=g, device=device) * 10 ** (
        torch.rand(rows, n, generator=g, device=device) * 12 - 6)
    for qtype, hi in ((torch.int16, 762), (torch.int8, 127)):
        q = torch.randint(-hi, hi + 1, (rows, n), generator=g, device=device).to(qtype)
        assert _bits(kern.dequant_accumulate_fwd(q, s, acc, None, block=block),
                     ref.dequant_acc_ref(q, s, acc, None, block))


def test_groundseg_exchange_through_kernels(device):
    """The int8 ground-segment round and pipelined window on a stacked
    smoke-size tree, in the example's sky: through the kernels and through
    the plain versions, bit for bit; the kernels launch."""
    from repro_torch.constellation import scenario
    from repro_torch.core import fused
    from repro_torch.groundseg import aggregation, routing
    from repro_torch.kernels.tdm_compress import tdm_compress as kern

    scn = scenario.build_scenario(scenario.ScenarioSpec(
        shells=(scenario.ShellSpec(planes=2, per_plane=3),), n_ground=2, steps=4,
        max_range_km=14_000.0))
    rels = list(scn.plan.schedule(antennas=2, payload_bytes=1 << 22).tdm)
    sinks = scn.ground_ids
    up = routing.build_relay_program(rels, 8, sinks)
    down = routing.build_broadcast_program(rels, 8, sinks)
    g = torch.Generator(device=device).manual_seed(9)
    tree = {"a": torch.randn(8, 70_000, generator=g, device=device),
            "b": torch.randn(8, 3, 5000, generator=g, device=device) * 0.01}
    for pool in (True, False):
        before = kern.launch_counts()
        got = aggregation.groundseg_round(_clone(tree), up, down, pool=pool,
                                          compression="int8", quant_impl="cuda")
        after = kern.launch_counts()
        assert all(after[k] > before[k] for k in
                   ("quantize_scaled", "quantize", "dequant_accumulate"))
        want = aggregation.groundseg_round(_clone(tree), up, down, pool=pool,
                                           compression="int8", quant_impl="ref")
        for k in ("a", "b"):
            assert _bits(got[k], want[k])
    router = routing.MultiWindowRouter(8, sinks, max_staleness_windows=1, pipeline_depth=2)
    spec = fused.cached_spec(tree)
    aux = {impl: (aggregation.stacked_zero_buffers(spec, 8, device),
                  aggregation.stacked_zero_buffers(spec, 8, device)) for impl in ("cuda", "ref")}
    params = {impl: _clone(tree) for impl in ("cuda", "ref")}
    for w in range(2):
        wp = router.plan_window(rels)
        for impl in ("cuda", "ref"):
            params[impl], c, p = aggregation.pipelined_window_round(
                params[impl], *aux[impl], wp, pool=(w == 0), compression="int8",
                quant_impl=impl)
            aux[impl] = (c, p)
        for k in ("a", "b"):
            assert _bits(params["cuda"][k], params["ref"][k])
        assert _bits(aux["cuda"][1]["float32"], aux["ref"][1]["float32"])


@pytest.mark.parametrize("compression", ["int8", "topk"])
def test_fl_round_through_kernels(device, compression):
    """One FL round of the smoke model: local AdamW steps, then the round's
    exchange once through the kernels and once through the plain versions
    on the same trained params. The kernels must launch, int8 codes and
    top-k selections must agree exactly, and the mixes within
    2 (M + 2) ulp(|x|max) per node (one fused-vs-unfused gap per
    accumulation, see tests/test_torch_exchange.py)."""
    from repro_torch.configs import archs
    from repro_torch.constellation.scenario import ScenarioSpec, ShellSpec, build_scenario
    from repro_torch.core import fl, fused, tdm
    from repro_torch.kernels.tdm_compress import ops
    from repro_torch.kernels.tdm_compress import tdm_compress as kern
    from repro_torch.launch import fl_train
    from repro_torch.launch.train_fl_constellation import make_batch_fn
    from repro_torch.models import registry
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import adamw

    cfg = archs.smoke_cfg(archs.get("mamba2-780m"))
    opt = adamw.OptConfig(peak_lr=5e-3, warmup_steps=2, decay_steps=100)
    scn = build_scenario(ScenarioSpec(shells=(ShellSpec(planes=2, per_plane=4),),
                                      n_ground=0, steps=4, max_range_km=14_000.0))
    batch = fl_train.batch_to_device(
        make_batch_fn(cfg, ShapeConfig("fl", "train", 32, 4), 8)(0), device)
    rel = scn.plan.relations()[0]
    state = fl_train._stack_init(0, cfg, opt, 8, device=device)
    losses = fl_train.local_train(registry.bundle(cfg), opt, state, batch, 2)
    assert torch.isfinite(losses).all()
    tdm_cfg = fl.TDMFLAConfig(compression=compression)
    spec = fused.cached_spec(state["params"])
    buf = fused.flatten_pytree(spec, state["params"])["float32"]
    if compression == "int8":
        q, s = ops.quantize(buf, impl="cuda")
        q_r, s_r = ops.quantize(buf, impl="ref")
        assert _bits(q, q_r) and _bits(s, s_r)
    else:
        nb = buf.shape[1] // fused.DEFAULT_BLOCK
        k_total = min(tdm_cfg.topk_k * spec.n_leaves("float32"), buf.shape[1])
        k_b = max(1, min(fused.DEFAULT_BLOCK, -(-k_total // nb)))  # as choco_fused_round
        for a, b in zip(ops.topk_sparsify(buf, k=k_b, impl="cuda"),
                        ops.topk_sparsify(buf, k=k_b, impl="ref")):
            assert _bits(a, b)
    mixed = {}
    for impl in ("cuda", "ref"):
        before = kern.launch_counts()
        mixed[impl], _ = fl.tdm_fla_round(state["params"], rel, 8, tdm_cfg, quant_impl=impl)
        after = kern.launch_counts()
        launched = {k: after[k] - before[k] for k in after}
        if impl == "ref":
            assert sum(launched.values()) == 0
        elif compression == "int8":
            assert launched["quantize"] == 1 and launched["dequant_accumulate"] > 0
        else:
            assert launched["topk_sparsify"] == 1 and launched["scatter_accumulate"] > 0
    m = len(tdm.edge_coloring(rel))
    got = fused.flatten_pytree(spec, mixed["cuda"])["float32"]
    want = fused.flatten_pytree(spec, mixed["ref"])["float32"]
    rowmax = buf.abs().amax(dim=1, keepdim=True)
    ulp = torch.nextafter(rowmax, torch.full_like(rowmax, float("inf"))) - rowmax
    assert bool(((got - want).abs() <= 2 * (m + 2) * ulp).all())


# (B, S, H, P, G, N, chunk): chunks 8 to 256 (96: a ragged last tile), 1 to 4
# chunks, groups 1, 2 and 4, head dims 16 to 64, states 32 to 128
SSD_CASES = [
    (2, 8, 4, 64, 1, 128, 8),
    (3, 32, 4, 64, 2, 128, 8),
    (1, 128, 2, 16, 1, 32, 32),
    (1, 128, 8, 64, 4, 128, 64),
    (2, 192, 4, 32, 2, 64, 64),
    (1, 192, 4, 64, 1, 128, 96),
    (2, 1024, 2, 64, 2, 128, 256),
]


def _ssd_inputs(device, case, dtype, strong=False):
    B, S, H, P, G, N, _ = case
    g = torch.Generator(device=device).manual_seed(S + H + G)
    x = torch.randn(B, S, H, P, generator=g, device=device).to(dtype)
    Bv = torch.randn(B, S, G, N, generator=g, device=device).to(dtype)
    Cv = torch.randn(B, S, G, N, generator=g, device=device).to(dtype)
    if strong:
        dt = 0.05 + 0.05 * torch.rand(B, S, H, generator=g, device=device)
        A = torch.full((H,), -16.0, device=device)
    else:
        dt = torch.nn.functional.softplus(torch.randn(B, S, H, generator=g, device=device))
        A = -torch.exp(torch.rand(H, generator=g, device=device) * 2 - 1)
    return x, dt, A, Bv, Cv


def _ssd_check(inputs, chunk):
    from repro_torch.kernels.ssd_scan import ops, ref
    from repro_torch.kernels.ssd_scan import ssd_scan as kern

    before = kern.launch_counts()["ssd_scan"]
    y, s = ops.ssd_scan(*inputs, chunk=chunk)
    assert kern.launch_counts()["ssd_scan"] == before + 1   # CUDA tensors: the kernel
    y_r, s_r = ops.ssd_scan(*inputs, chunk=chunk, impl="ref")
    torch.cuda.synchronize()
    assert y.dtype == inputs[0].dtype and s.dtype == torch.float32
    for got, want in ((y, y_r), (s, s_r)):
        ok, err = ref.ssd_close(got, want)
        assert ok, err


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", SSD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_ssd_scan_against_plain(device, case, dtype):
    _ssd_check(_ssd_inputs(device, case, dtype), case[-1])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_ssd_scan_strong_decay_at_published_chunk(device, dtype):
    """A = -16, dt 0.05-0.1, chunk 256: exp before the mask would be inf
    above the diagonal; the kernel's y and state are finite and equal."""
    _ssd_check(_ssd_inputs(device, (2, 512, 4, 64, 1, 128, 256), dtype, strong=True), 256)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_ssd_scan_launches_are_bit_identical(device, dtype):
    """Four calls on one input at the serving prefill's shape (4 lanes x 48
    heads, S 512, chunk 256) give the same y and state bit for bit: every
    pass sums in a fixed order, with no atomics."""
    from repro_torch.kernels.ssd_scan import ops

    inputs = _ssd_inputs(device, (4, 512, 48, 64, 1, 128, 256), dtype)
    first = ops.ssd_scan(*inputs, chunk=256)
    for _ in range(3):
        y, s = ops.ssd_scan(*inputs, chunk=256)
        assert _bits(y, first[0]) and _bits(s, first[1])


def test_model_decoder_prefill_and_tick(device):
    """A two-replica ModelDecoder on the mamba2-780m smoke config (chunk 8)
    on the card: the prefill launches ssd_scan once per layer, and its first
    tokens and one decode tick equal a CPU decoder's with the same params
    (float32 compute; both take the plain SSD version on the CPU side)."""
    import numpy as np

    from repro_torch.configs import archs
    from repro_torch.kernels.ssd_scan import ssd_scan as kern
    from repro_torch.pytree import tree_map
    from repro_torch.serving import ModelDecoder

    cfg = archs.smoke_cfg(archs.get("mamba2-780m")).replace(compute_dtype="float32")
    gpu = ModelDecoder(cfg, 2, 2, 40, seed=3, device=device)
    cpu = ModelDecoder(cfg, 2, 2, 40, seed=3, device="cpu")
    cpu.params = tree_map(lambda t: t.cpu(), gpu.params)
    rng = np.random.default_rng(0)
    waves = {0: [rng.integers(0, 128, 13).astype(np.int32),
                 rng.integers(0, 128, 9).astype(np.int32)],
             1: [rng.integers(0, 128, 16).astype(np.int32)]}
    before = kern.launch_counts()["ssd_scan"]
    first = gpu.prefill_waves(waves)
    assert kern.launch_counts()["ssd_scan"] == before + cfg.n_layers
    assert first == cpu.prefill_waves(waves)
    active = np.array([True, True])
    assert (gpu.step(active) == cpu.step(active)).all()


# (B, S, H, KV, hd, causal, window, softcap)
FA_CASES = [
    (2, 23, 4, 2, 16, True, None, 50.0),
    (1, 300, 4, 1, 64, True, 16, None),
    (1, 64, 8, 2, 128, False, None, None),
    (2, 512, 16, 8, 256, True, None, 50.0),
    (1, 8, 4, 4, 256, False, 3, 50.0),
    (1, 4608, 16, 8, 256, True, 4096, 50.0),     # gemma2-9b's local layer, S > window
]


def _fa_inputs(device, shape_q, shape_kv, dtype, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(*shape_q, generator=g, device=device).to(dtype)
    k = torch.randn(*shape_kv, generator=g, device=device).to(dtype)
    v = torch.randn(*shape_kv, generator=g, device=device).to(dtype)
    return q, k, v


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", FA_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_attention_against_plain(device, case, dtype):
    from repro_torch.kernels.flash_attention import flash_attention as kern
    from repro_torch.kernels.flash_attention import ops, ref

    B, S, H, KV, hd, causal, window, cap = case
    q, k, v = _fa_inputs(device, (B, S, H, hd), (B, S, KV, hd), dtype, S + hd)
    before = kern.launch_counts()["flash_attention_fwd"]
    got = ops.flash_attention(q, k, v, causal=causal, window=window, softcap=cap)
    assert kern.launch_counts()["flash_attention_fwd"] == before + 1
    want = ops.flash_attention(q, k, v, causal=causal, window=window, softcap=cap,
                               impl="ref")
    torch.cuda.synchronize()
    ok, err = ref.fa_close(got, want)
    assert ok, err


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("hd,G,Sq", [(16, 2, 1), (64, 4, 4), (256, 2, 1), (128, 1, 2)])
def test_flash_attention_decode_against_plain(device, hd, G, Sq, dtype):
    from repro_torch.kernels.flash_attention import flash_attention as kern
    from repro_torch.kernels.flash_attention import ops, ref

    B, L, KV = 3, 529, 2
    q, k, v = _fa_inputs(device, (B, Sq, G * KV, hd), (B, L, KV, hd), dtype, hd + G)
    kv_len = torch.tensor([1, 300, L], dtype=torch.int32, device=device)
    before = kern.launch_counts()["flash_attention_decode"]
    got = ops.flash_attention_decode(q, k, v, kv_len, softcap=50.0)
    assert kern.launch_counts()["flash_attention_decode"] == before + 1
    want = ops.flash_attention_decode(q, k, v, kv_len, softcap=50.0, impl="ref")
    torch.cuda.synchronize()
    ok, err = ref.fa_close(got, want)
    assert ok, err


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("L", [4096, 8192])
def test_flash_attention_decode_long_cache(device, L, dtype):
    """gemma2-9b's window as a ring length, and twice it: the cache split
    into many chunks; kv_len 1, one past the first chunk's edge, and L."""
    from repro_torch.kernels.flash_attention import flash_attention as kern
    from repro_torch.kernels.flash_attention import ops, ref

    B, H, KV, hd = 3, 16, 8, 256
    q, k, v = _fa_inputs(device, (B, 1, H, hd), (B, L, KV, hd), dtype, L)
    n_split, chunk, _, _ = kern.decode_plan(
        B, KV, L, H // KV, hd, torch.cuda.get_device_properties(device).multi_processor_count)
    assert n_split > 1
    kv_len = torch.tensor([1, chunk + 1, L], dtype=torch.int32, device=device)
    got = ops.flash_attention_decode(q, k, v, kv_len, softcap=50.0)
    want = ops.flash_attention_decode(q, k, v, kv_len, softcap=50.0, impl="ref")
    torch.cuda.synchronize()
    ok, err = ref.fa_close(got, want)
    assert ok, err


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("entry", ["prefill", "decode"])
def test_flash_attention_launches_are_bit_identical(device, entry, dtype):
    """Two launches on the same input give the same bits (the decode merges
    its cache chunks in chunk order, whichever block finishes last)."""
    from repro_torch.kernels.flash_attention import ops

    if entry == "prefill":
        q, k, v = _fa_inputs(device, (2, 512, 16, 256), (2, 512, 8, 256), dtype, 1)
        run = lambda: ops.flash_attention(q, k, v, softcap=50.0)  # noqa: E731
    else:
        q, k, v = _fa_inputs(device, (8, 1, 16, 256), (8, 529, 8, 256), dtype, 2)
        kv_len = torch.tensor([1, 17, 100, 264, 265, 528, 529, 529], dtype=torch.int32,
                              device=device)
        run = lambda: ops.flash_attention_decode(q, k, v, kv_len, softcap=50.0)  # noqa: E731
    first = run()
    for _ in range(3):
        assert torch.equal(run(), first)


def test_flash_attention_decode_on_two_streams_and_in_a_graph(device):
    """The decode's scratch and arrival counters belong to a stream: launches
    queued alternately on two streams, and launches captured in a CUDA graph
    and replayed, equal one eager launch bit for bit."""
    from repro_torch.kernels.flash_attention import ops

    q, k, v = _fa_inputs(device, (8, 1, 16, 256), (8, 529, 8, 256), torch.bfloat16, 4)
    kv_len = torch.tensor([1, 17, 100, 264, 265, 528, 529, 529], dtype=torch.int32,
                          device=device)
    run = lambda: ops.flash_attention_decode(q, k, v, kv_len, softcap=50.0)  # noqa: E731
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
    assert all(torch.equal(o, want) for o in outs)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = [run() for _ in range(3)]
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(o, want) for o in captured)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_bf16_prefill_takes_the_tensor_core_kernel(device, dtype):
    from repro_torch.kernels.flash_attention import flash_attention as kern

    q, k, v = _fa_inputs(device, (1, 64, 4, 64), (1, 64, 2, 64), dtype, 3)
    before = kern.launch_counts()
    kern.flash_attention_fwd(q, k, v)
    after = kern.launch_counts()
    assert after["flash_attention_fwd"] == before["flash_attention_fwd"] + 1
    assert (after["flash_attention_fwd_wgmma"] - before["flash_attention_fwd_wgmma"]
            == (1 if dtype == torch.bfloat16 else 0))


def test_dense_model_decoder_prefill_and_tick(device):
    """A two-replica ModelDecoder on the gemma2-9b smoke config on the card:
    the prefill launches the attention kernel once per layer and a tick the
    decode kernel once per layer; the first tokens and two ticks (the
    replicas at different pos) equal a CPU decoder's with the same params
    (float32 compute)."""
    import numpy as np

    from repro_torch.configs import archs
    from repro_torch.kernels.flash_attention import flash_attention as kern
    from repro_torch.pytree import tree_map
    from repro_torch.serving import ModelDecoder

    cfg = archs.smoke_cfg(archs.get("gemma2-9b")).replace(compute_dtype="float32")
    gpu = ModelDecoder(cfg, 2, 2, 40, seed=3, device=device)
    cpu = ModelDecoder(cfg, 2, 2, 40, seed=3, device="cpu")
    cpu.params = tree_map(lambda t: t.cpu(), gpu.params)
    rng = np.random.default_rng(0)
    first = {0: [rng.integers(0, 128, 13).astype(np.int32),
                 rng.integers(0, 128, 9).astype(np.int32)]}
    second = {1: [rng.integers(0, 128, 20).astype(np.int32)]}
    kern.reset_launch_counts()
    assert gpu.prefill_waves(first) == cpu.prefill_waves(first)
    assert kern.launch_counts()["flash_attention_fwd"] == cfg.n_layers
    one = np.array([True, False])
    assert (gpu.step(one) == cpu.step(one)).all()
    assert kern.launch_counts()["flash_attention_decode"] == cfg.n_layers
    assert gpu.prefill_waves(second) == cpu.prefill_waves(second)
    both = np.array([True, True])
    assert (gpu.step(both) == cpu.step(both)).all()


def test_dense_decoder_both_replicas_bucket_256_and_local_ring(device):
    """The serving paths the full-size gemma2-9b cell does not reach, on its
    smoke config (window 16), through ``serving.edge_check``: one
    ``prefill_waves`` call admitting both replicas with prompts of 129-256
    tokens (a bucket-256 wave), then 24 ticks of both, each local layer's
    ring engaged. float32 compute: the tokens equal a CPU decoder's with the
    same params. bf16 compute: one tensor-core prefill launch per layer and
    one decode launch per layer per tick, and the first local and global
    layers' attention, on the prompt and on the caches the ticks left,
    within ``fa_tolerance`` of the plain version."""
    from repro_torch.serving.edge_check import EDGE_TICKS, dense_edge_check

    seen = dense_edge_check(device)
    cfg = seen["config"]
    assert seen["prompts"] == [129, 200, 256, 160] and seen["ticks"] == EDGE_TICKS == 24
    assert seen["launches"] == {"flash_attention_fwd": cfg.n_layers,
                                "flash_attention_fwd_wgmma": cfg.n_layers,
                                "flash_attention_decode": cfg.n_layers * EDGE_TICKS,
                                "flash_attention_bwd": 0}
    assert len(seen["rings"]) == 2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", list(range(len(SERVE_PREFILL_CASES))))
def test_flash_attention_at_moe_serving_shapes(device, case, dtype):
    from repro_torch.kernels.flash_attention import cases

    cases.check_prefill_case(cases.SERVE_PREFILL_CASES[case], dtype, device)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", list(range(len(SERVE_DECODE_CASES))))
def test_flash_attention_decode_at_moe_serving_shapes(device, case, dtype):
    from repro_torch.kernels.flash_attention import cases

    cases.check_decode_case(cases.SERVE_DECODE_CASES[case], dtype, device)


def test_moe_model_decoder_prefill_and_ticks(device):
    """A two-replica ModelDecoder on the qwen3-moe smoke config at a binding
    capacity factor (0.5) on the card: the first tokens and ticks (both
    replicas, at different pos, each its own MoE decode group) equal a CPU
    decoder's with the same params (float32 compute); the prefill launches
    the attention kernel once per layer and a tick the decode kernel once
    per layer; capacity drops happen on both devices alike."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import archs
    from repro_torch.kernels.flash_attention import flash_attention as kern
    from repro_torch.models import moe
    from repro_torch.pytree import tree_map
    from repro_torch.serving import ModelDecoder

    cfg = archs.smoke_cfg(archs.get("qwen3-moe-30b-a3b"))
    cfg = cfg.replace(compute_dtype="float32",
                      moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))
    gpu = ModelDecoder(cfg, 2, 2, 40, seed=3, device=device)
    cpu = ModelDecoder(cfg, 2, 2, 40, seed=3, device="cpu")
    cpu.params = tree_map(lambda t: t.cpu(), gpu.params)
    rng = np.random.default_rng(0)
    first = {0: [rng.integers(0, 128, 13).astype(np.int32),
                 rng.integers(0, 128, 9).astype(np.int32)]}
    second = {1: [rng.integers(0, 128, 20).astype(np.int32)]}
    kern.reset_launch_counts()
    tallies = []
    for dec in (gpu, cpu):
        with moe.count_drops() as tally:
            toks = [dec.prefill_waves(first)]
            toks.append(dec.step(np.array([True, False])).tolist())
            toks.append(dec.prefill_waves(second))
            toks += [dec.step(np.array([True, True])).tolist() for _ in range(3)]
        tallies.append({k: [t.tolist() for t in v] for k, v in tally.items()})
        if dec is gpu:
            counts = kern.launch_counts()
            want = toks
    assert toks == want
    assert tallies[0] == tallies[1] and sum(t[1] for t in tallies[0]["decode"]) > 0
    assert counts["flash_attention_fwd"] == 2 * cfg.n_layers
    assert counts["flash_attention_decode"] == 4 * cfg.n_layers


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", list(range(len(BWD_CASES))))
def test_flash_attention_bwd_against_plain(device, case, dtype):
    from repro_torch.kernels.flash_attention import cases

    cases.check_bwd_case(cases.BWD_CASES[case], dtype, device)


# (loss rtol, grad norm rtol, mu's share of its leaf's scale) for one step
# on the kernels against one on the plain versions. f32: sums in another
# order, as tests/test_torch_train.py holds the step to the reference
# (measured on an H100: grad norm 0, mu 4.4e-7). bf16: a bf16 activation
# rounded the other way moves a gradient by bf16 ulps; mu within the bf16
# attention tolerance of test_torch_train.py, 1e-2 of scale (measured
# 7.3e-3), the grad norm within 1e-4 (measured 1.2e-5), the loss 1e-3
# (measured 1.1e-6)
FIRST_STEP_TOL = {"float32": (1e-5, 1e-5, 1e-5), "bfloat16": (1e-3, 1e-4, 1e-2)}


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_train_step_on_kernels_matches_plain(device, compute_dtype):
    """One train step of the gemma2-9b smoke config (S 40: ragged tiles,
    windows of 16) on the kernels and on their plain versions from the same
    state, held together by ``cases.check_first_step`` at
    ``FIRST_STEP_TOL``: the loss, the grad norm, every leaf's first moment
    (0.1 times the clipped gradient, so the gradients' sizes), and every
    param entry within what the mu tolerance lets Adam's first step move
    it; besides, every param entry within twice the step's lr, and all but
    1e-4 of them within 1e-6 in f32 (as ``tests/test_torch_train.py`` holds
    the step to the reference: Adam's ``mu / (sqrt(nu) + eps)`` amplifies
    the rounding of gradient entries near eps), all but 1% within 1e-4 in
    bf16 (a bf16 activation rounded the other way moves the gradients by
    bf16 ulps, which flips the sign of the entries whose gradient is that
    small; measured 104 of 131 648); the attention launches are the
    oracle's (remat: forward twice per layer)."""
    from repro_torch.configs import archs
    from repro_torch.data import pipeline
    from repro_torch.kernels.flash_attention import cases
    from repro_torch.kernels.flash_attention import flash_attention as fa_kern
    from repro_torch.launch import steps
    from repro_torch.launch.fl_train import batch_to_device
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import adamw
    from repro_torch.pytree import tree_leaves, tree_map

    cfg = archs.smoke_cfg(archs.get("gemma2-9b")).replace(compute_dtype=compute_dtype)
    opt = adamw.OptConfig(peak_lr=3e-3, warmup_steps=5, decay_steps=10)
    start = steps.init_state(0, cfg, opt, device)
    batch = batch_to_device(
        pipeline.SyntheticStream(cfg, ShapeConfig("c", "train", 40, 4), seed=1).batch(0),
        device)
    runs = {}
    for impl in ("cuda", "ref"):
        state = tree_map(lambda t: t.clone(), start)
        fa_kern.reset_launch_counts()
        state, metrics = steps.build_train_step(cfg, opt, impl)(state, batch)
        torch.cuda.synchronize()
        runs[impl] = (state, metrics, fa_kern.launch_counts())
    assert runs["cuda"][2]["flash_attention_fwd"] == 2 * cfg.n_layers
    assert runs["cuda"][2]["flash_attention_bwd"] == cfg.n_layers
    assert runs["ref"][2]["flash_attention_fwd"] == runs["ref"][2]["flash_attention_bwd"] == 0
    loss_rtol, gnorm_rtol, mu_rtol = FIRST_STEP_TOL[compute_dtype]
    read = cases.check_first_step(runs["cuda"][0], runs["cuda"][1], runs["ref"][0],
                                  runs["ref"][1], opt, loss_rtol=loss_rtol,
                                  gnorm_rtol=gnorm_rtol, mu_rtol=mu_rtol)
    print(f"first step, {compute_dtype}: {read}")
    off = total = 0
    for a, b in zip(tree_leaves(runs["cuda"][0]["params"]), tree_leaves(runs["ref"][0]["params"])):
        diff = (a - b).abs()
        assert float(diff.max()) <= 2 * 3e-3 / 5      # a sign flip at step 0's lr
        off += int((diff > (1e-6 if compute_dtype == "float32" else 1e-4)).sum())
        total += diff.numel()
    assert off <= (1e-4 if compute_dtype == "float32" else 1e-2) * total, \
        f"{off} of {total} param entries off"
