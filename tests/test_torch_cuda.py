"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips (from a fixture) when no CUDA device is
present. Run on a machine with an H100:

    python -m pytest -m cuda tests/test_torch_cuda.py

Standards as in ``chip_smoke.py``: int8 codes and scales, codes with given
(shared or per-row) scales, dequantized values and top-k dense/vals/idxs bit
for bit; the weighted accumulates within one rounding of the product and of
the sum (the kernels fuse the multiply-add, the plain versions round twice),
the unit-weight accumulate bit for bit (both round once); one int8 and one
topk FL round on the small model through the kernels, held to the same round
through the plain versions, and the int8 ground-segment exchange through the
kernels equal to it through the plain versions bit for bit. The SSD-scan
kernel against its plain version within ``ssd_scan.ref.ssd_tolerance`` (1e-4
of the output's scale, plus one bf16 ulp for bf16 outputs), y and state
finite, on ragged cases and on strong decay at chunk 256; and a
``ModelDecoder`` prefill and decode tick on the card.
"""

from __future__ import annotations

import pytest
import torch

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


@pytest.mark.parametrize("rows,n,block", SHAPES + [SLICE])
def test_topk_and_scatter_accumulate(device, rows, n, block):
    from repro_torch.kernels.tdm_compress import ref
    from repro_torch.kernels.tdm_compress import tdm_compress as kern

    g = torch.Generator(device=device).manual_seed(n + 1)
    x = torch.randn(rows, n, generator=g, device=device)
    x[:, ::5] = 1.0                                    # exact ties
    acc = torch.randn(rows, n, generator=g, device=device)
    w = torch.rand(rows, generator=g, device=device)
    for k in sorted({1, min(7, block), block} if n < 10**6 else {1}):
        d, v, i = kern.topk_sparsify_fwd(x, k, block=block)
        d_r, v_r, i_r = ref.topk_sparsify_ref(x, k, block)
        assert _bits(d, d_r) and _bits(v, v_r) and _bits(i, i_r)
        got = kern.scatter_accumulate_fwd(v, i, acc, w, block=block)
        want = ref.scatter_acc_ref(v, i, acc, w, block)
        dense = ref.scatter_acc_ref(v, i, torch.zeros_like(acc), 1.0, block)
        assert bool(ref.fma_gap_ok(got, want, w[:, None] * dense).all())


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
