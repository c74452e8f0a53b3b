"""The port's correctness on the card: the CUDA kernels against their plain
PyTorch versions, and the paths that run them at smoke widths.

Marked ``cuda``; each test skips (from a fixture) when no CUDA device is
present. Run on a machine with an H100:

    python -m pytest -m cuda tests/test_torch_cuda.py

The exchange kernels: int8 codes and scales, codes with given (shared or
per-row) scales, dequantized values and top-k dense/vals/idxs bit for bit,
on both top-k paths (select and sort, split at ``TOPK_SELECT_MAX_K``; k 0
launches nothing) with normal, tied, all-equal and NaN/inf payloads; the
weighted accumulates (int8 and int16 codes, weights of both signs) within
one rounding of the product and of the sum (the kernels fuse the
multiply-add, the plain versions round twice), the unit-weight accumulate
bit for bit; the int8 gossip's fold bit for bit against the chain of
dequant-accumulate launches it replaces. The paths through them: one int8
and one topk FL round on the small model held to the same round through
the plain versions, a fused int8 round launching one fold per dtype
bucket, two-level (plane x satellite) rounds with their gathers and
launches, the two-level int8 mix level by level against the plain
versions, per-leaf compressed rounds, FL on the optimizer's rate
schedule, and the int8 ground-segment exchange bit for bit against the
plain versions. The SSD scan within ``ssd_scan.ref.ssd_tolerance`` on
ragged, init-drawn and strong-decay cases and at the served prefill
shapes, each launched twice bit-identical. The attention kernels (prefill,
decode, backward) within ``flash_attention.ref.fa_tolerance`` /
``bwd_tolerance`` on head dims 16 to 256, G 1 to 16, causal, window,
softcap, ragged S up to 4608 and caches up to 8192 slots, rectangular and
padded cases (``kernels/flash_attention/cases.py``), each launched twice
bit-identical, bf16 prefills on the tensor-core kernel, the decode on two
streams and from a CUDA graph. Serving: ``ModelDecoder`` prefill and ticks
against a CPU decoder (mamba2, gemma2, qwen3-moe smoke configs), the
decode tick replayed from CUDA graphs bit for bit against the eager tick,
with the same MoE tallies, and without a synchronise (mamba2, nemotron-h,
qwen3-moe smoke configs), gemma2-9b's serving edges
(``serving/edge_check.py``), nemotron-3-nano's smoke config against its
plain reference. Training: train steps on the kernels against the plain
versions (gemma2-9b, whisper-base) and a microbatched step against the
CPU, and a checkpoint round trip on the card.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.flash_attention.cases import (
    BWD_CASES,
    NEMOTRON_DECODE_CASES,
    NEMOTRON_PREFILL_CASES,
    RECT_CASES,
    RECT_DECODE_CASES,
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


SHAPES = [(1, 1, 64), (3, 5000, 1024), (2, 777, 64), (8, 3 * 1024, 256), (2, 1025, 4096),
          (4, 4096, 256), (1, 3000, 128)]
# the slice's stacked buffer: 8 nodes x the 8-layer mamba2-780m (194,384,896)
SLICE = (8, 194_384_896, 1024)


@pytest.mark.parametrize("rows,n,block", SHAPES + [SLICE])
def test_quantize_and_dequant_accumulate(device, rows, n, block):
    """Codes and scales bit for bit, the weighted accumulate within one
    rounding of the product and of the sum; below the slice's size also on
    a NaN / inf / -0.0 payload with weights of both signs, and on int16
    codes (a sum of int8 ones) with a weight."""
    from repro_torch.kernels.tdm_compress import ref
    from repro_torch.kernels.tdm_compress import tdm_compress as kern

    g = torch.Generator(device=device).manual_seed(n)
    x = torch.randn(rows, n, generator=g, device=device) * 2
    acc = torch.randn(rows, n, generator=g, device=device)
    w = torch.rand(rows, generator=g, device=device)
    payloads = [(x, w)]
    if n < 10**6:
        payloads.append((_edge(x.clone(), g), torch.rand(rows, generator=g, device=device) * 2 - 1))
    for x, w in payloads:
        q, s = kern.quantize_fwd(x, block=block)
        q_r, s_r = ref.quantize_ref(x, block)
        assert _bits(q, q_r) and _bits(s, s_r)
        codes = [q]
        if n < 10**6:
            codes.append(torch.randint(-127 * 6, 127 * 6 + 1, (rows, n), generator=g,
                                       device=device).to(torch.int16))
        for c in codes:
            got = kern.dequant_accumulate_fwd(c, s, acc, w, block=block)
            want = ref.dequant_acc_ref(c, s, acc, w, block)
            prod = w[:, None] * ref.dequantize_ref(c, s, block)
            assert bool(ref.fma_gap_ok(got, want, prod).all())


def _topk_cases():
    """(rows, n, block, k): k on both sides of the select/sort split and 0
    (no launch), 1 only at the slice's shape; (3, 4097, 1024) puts rows 1
    and 2 off 16-byte alignment, so the select paths take their scalar loads
    there."""
    sel = TOPK_SELECT_MAX_K
    out = []
    for rows, n, block in SHAPES + [(3, 4097, 1024), SLICE]:
        ks = [1] if n > 10**6 else sorted({0, 1, 7, sel, sel + 1, 64, block})
        out += [(rows, n, block, k) for k in ks if k <= block]
    return out


@pytest.mark.parametrize("kind", ["normal", "ties", "equal", "edge"])
@pytest.mark.parametrize("rows,n,block,k", _topk_cases())
def test_topk_and_scatter_accumulate(device, rows, n, block, k, kind):
    """Top-k bit for bit and the scatter within one rounding, on the path
    that k selects (the launch counters say which; k 0 launches nothing)."""
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
    kernels.reset_launch_counts()
    d, v, i = kern.topk_sparsify_fwd(x, k, block=block)
    d_r, v_r, i_r = ref.topk_sparsify_ref(x, k, block)
    assert _bits(d, d_r) and _bits(v, v_r) and _bits(i, i_r)
    got = kern.scatter_accumulate_fwd(v, i, acc, w, block=block)
    want = ref.scatter_acc_ref(v, i, acc, w, block)
    dense = ref.scatter_acc_ref(v, i, torch.zeros_like(acc), 1.0, block)
    assert bool(ref.fma_gap_ok(got, want, w[:, None] * dense).all())
    counts = kernels.launch_counts()
    assert counts["topk_sparsify" if select else "topk_sparsify_sort"] == (k > 0)
    assert counts["scatter_accumulate" if select else "scatter_accumulate_shared"] == (k > 0)


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
        before = kernels.launch_counts()
        got = aggregation.groundseg_round(_clone(tree), up, down, pool=pool,
                                          compression="int8", quant_impl="cuda")
        after = kernels.launch_counts()
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


def _fold_plan(rows: int, n_match: int, seed: int):
    """Sources, weights and self weights of ``n_match`` random matchings on
    ``rows`` nodes: the last row idle in every one; the first matching pairs
    all but one of the others, each later one a random subset, so rows of
    degree 0 to ``n_match`` occur."""
    rng = np.random.default_rng(seed)
    src = -np.ones((n_match, rows), dtype=np.int32)
    most = (rows - 1) // 2
    for m in range(n_match):
        pairs = most if m == 0 else int(rng.integers(1, most + 1))
        live = rng.permutation(rows - 1)[:2 * pairs]
        for a, b in live.reshape(-1, 2):
            src[m, a], src[m, b] = b, a
    w = np.where(src >= 0, rng.uniform(0.05, 0.5, src.shape), 0.0)
    return src, w, rng.uniform(0.1, 1.0, rows)


def _unfused_fold(x, q, s, src, w, diag, block):
    """The receive side as the kernels ran it before the fold: per matching
    the arriving rows (gathered, zeroed outside it) into one
    ``dequant_accumulate_fwd`` on an accumulator of zeros, then + diag * x."""
    from repro_torch.kernels.tdm_compress import tdm_compress as kern

    acc = torch.zeros_like(x)
    for m in range(src.shape[0]):
        idle = (src[m] < 0)[:, None]
        rows = src[m].clamp(min=0).to(torch.int64)
        q_r = q.index_select(0, rows).masked_fill_(idle, 0)
        s_r = s.index_select(0, rows).masked_fill_(idle, 0)
        acc = kern.dequant_accumulate_fwd(q_r, s_r, acc, w[m], block=block)
    return acc.add_(diag[:, None] * x)


@pytest.mark.parametrize("n_match", [0, 1, 2, 3])
@pytest.mark.parametrize("rows,n,block", [(8, 5 * 4096 + 1024, 1024), (16, 5 * 4096 + 1024, 256),
                                          (8, 4096 + 44, 256), (16, 3 * 1024, 1024)])
def test_gossip_fold_bit_identical_to_unfused_chain(device, rows, n, block, n_match):
    """The fold launch against the chain it replaces, bit for bit: 0 to 3
    matchings, a row idle in every matching and rows of degree 2 and more,
    a ragged last chunk and (4096 + 44 at block 256) a ragged last block."""
    from repro_torch.kernels.tdm_compress import tdm_compress as kern

    src_np, w_np, diag_np = _fold_plan(rows, n_match, seed=rows * 10 + n_match)
    src = torch.as_tensor(src_np, device=device)
    w = torch.as_tensor(w_np, dtype=torch.float32, device=device)
    diag = torch.as_tensor(diag_np, dtype=torch.float32, device=device)
    g = torch.Generator(device=device).manual_seed(n + n_match)
    x = torch.randn(rows, n, generator=g, device=device) * torch.rand(
        rows, 1, generator=g, device=device) * 3
    q, s = kern.quantize_fwd(x, block=block)
    before = kernels.launch_counts()
    got = kern.gossip_fold_fwd(x, q, s, src, w, diag, block=block)
    assert kernels.launch_counts()["gossip_fold"] == before["gossip_fold"] + 1
    assert _bits(got, _unfused_fold(x, q, s, src, w, diag, block))
    assert _bits(got, kern.gossip_fold_fwd(x, q, s, src, w, diag, block=block))


def test_gossip_fold_refuses_what_it_does_not_take(device):
    from repro_torch.kernels.tdm_compress import tdm_compress as kern

    x = torch.zeros(4, 1024, device=device)
    q, s = kern.quantize_fwd(x, block=256)
    src = torch.full((1, 4), -1, dtype=torch.int32, device=device)
    w, diag = torch.zeros(1, 4, device=device), torch.ones(4, device=device)
    with pytest.raises(ValueError, match="multiples"):
        kern.gossip_fold_fwd(x[:, :1022], q[:, :1022], s, src, w, diag, block=250)
    with pytest.raises(ValueError, match="src"):
        kern.gossip_fold_fwd(x, q, s, src.to(torch.int64), w, diag, block=256)
    with pytest.raises(ValueError, match="aligned"):
        xs = torch.zeros(4 * 1024 + 1, device=device)[1:].view(4, 1024)
        kern.gossip_fold_fwd(xs, q, s, src, w, diag, block=256)


def test_fused_round_folds_once_per_bucket(device):
    """A fused int8 round over a two-bucket tree on the card: one quantize and
    one gossip fold per bucket, no standalone dequant-accumulate, and each
    bucket's mix bit-identical to the unfused chain on the kernels."""
    from repro_torch.core import fl, fused, tdm
    from repro_torch.core.relation import Relation
    from repro_torch.kernels.tdm_compress import tdm_compress as kern

    n = 8
    rel = Relation.from_edges([(0, 5), (0, 6), (2, 4), (2, 7)], nodes=range(n))
    g = torch.Generator(device=device).manual_seed(3)
    tree = {"a": torch.randn(n, 3000, generator=g, device=device),
            "b": torch.randn(n, 7, 300, generator=g, device=device).to(torch.bfloat16),
            "c": torch.randn(n, 50, generator=g, device=device)}
    spec = fused.cached_spec(tree)
    before = kernels.launch_counts()
    out, _ = fl.tdm_fla_round(tree, rel, n, fl.TDMFLAConfig(compression="int8"))
    after = kernels.launch_counts()
    launched = {k: after[k] - before[k] for k in after}
    assert launched["quantize"] == launched["gossip_fold"] == len(spec.buckets) == 2
    assert launched["dequant_accumulate"] == 0
    diag, per_matching = tdm.matching_weight_vectors(rel, n)
    matchings = tdm.edge_coloring(rel)
    src = torch.as_tensor(np.array([tdm.matching_sources(m, n) for m in matchings]),
                          device=device)
    w = torch.as_tensor(np.array(per_matching), dtype=torch.float32, device=device)
    d = torch.as_tensor(diag, dtype=torch.float32, device=device)
    got = fused.flatten_pytree(spec, out)
    for bucket, buf in fused.flatten_pytree(spec, tree).items():
        x32 = buf.to(torch.float32)
        q, s = kern.quantize_fwd(x32)
        want = _unfused_fold(x32, q, s, src, w, d, fused.DEFAULT_BLOCK).to(buf.dtype)
        assert _bits(got[bucket], want)


@pytest.mark.parametrize("compression", ["none", "int8", "topk"])
def test_fl_round_through_kernels(device, compression):
    """One FL round of the smoke model: local AdamW steps, then the round's
    exchange once through the kernels and once through the plain versions
    on the same trained params. The kernels must launch (none without
    compression), int8 codes and top-k selections must agree exactly, and
    the mixes within 2 (M + 2) ulp(|x|max) per node (one fused-vs-unfused
    gap per accumulation, see tests/test_torch_exchange.py)."""
    from repro_torch.configs import archs
    from repro_torch.constellation.scenario import ScenarioSpec, ShellSpec, build_scenario
    from repro_torch.core import fl, fused, tdm
    from repro_torch.kernels.tdm_compress import ops
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
    elif compression == "topk":
        nb = buf.shape[1] // fused.DEFAULT_BLOCK
        k_total = min(tdm_cfg.topk_k * spec.n_leaves("float32"), buf.shape[1])
        k_b = max(1, min(fused.DEFAULT_BLOCK, -(-k_total // nb)))  # as choco_fused_round
        for a, b in zip(ops.topk_sparsify(buf, k=k_b, impl="cuda"),
                        ops.topk_sparsify(buf, k=k_b, impl="ref")):
            assert _bits(a, b)
    mixed = {}
    for impl in ("cuda", "ref"):
        before = kernels.launch_counts()
        mixed[impl], _ = fl.tdm_fla_round(state["params"], rel, 8, tdm_cfg, quant_impl=impl)
        after = kernels.launch_counts()
        launched = {k: after[k] - before[k] for k in after}
        if impl == "ref" or compression == "none":
            assert sum(launched.values()) == 0
        elif compression == "int8":
            assert launched["quantize"] == launched["gossip_fold"] == len(spec.buckets)
            assert launched["dequant_accumulate"] == 0
        else:
            assert launched["topk_sparsify"] == 1 and launched["scatter_accumulate"] > 0
    got = fused.flatten_pytree(spec, mixed["cuda"])["float32"]
    want = fused.flatten_pytree(spec, mixed["ref"])["float32"]
    assert _within_mix_bound(got, want, buf, len(tdm.edge_coloring(rel)))


def _within_mix_bound(got, want, x, n_matchings: int) -> bool:
    """|got - want| <= 2 (M + 2) ulp(|x|max) per node: one fused-vs-unfused
    gap per accumulation (see tests/test_torch_exchange.py)."""
    rowmax = x.abs().amax(dim=1, keepdim=True)
    ulp = torch.nextafter(rowmax, torch.full_like(rowmax, float("inf"))) - rowmax
    return bool(((got - want).abs() <= 2 * (n_matchings + 2) * ulp).all())


def _two_level_rels():
    """2 orbital planes x 4 satellites: a clique within each plane, the one
    link between the planes."""
    from repro_torch.core.relation import Relation

    return Relation.clique(list(range(4))), Relation.from_edges([(0, 1)], nodes=range(2))


def _trained_fl_state(device):
    """The FL launcher's smoke model (mamba2-780m, 8 satellites in 2 planes
    of 4) stacked on ``device``, after 2 local AdamW steps of each satellite
    on its own data, so the satellites' params differ: (scenario, state)."""
    from repro_torch.launch import fl_train
    from repro_torch.launch import train_fl_constellation as tfc
    from repro_torch.models import registry

    cfg, opt, shape, scn = tfc.setup(8)
    state = fl_train._stack_init(0, cfg, opt, 8, device=device)
    batch = fl_train.batch_to_device(tfc.make_batch_fn(cfg, shape, 8)(0), device)
    fl_train.local_train(registry.bundle(cfg), opt, state, batch, tfc.LOCAL_STEPS)
    return scn, state


@pytest.mark.parametrize("compression", ["none", "int8"])
def test_two_level_fl_rounds_through_kernels(device, compression):
    """Two rounds of two-level (plane x satellite) FL on the smoke model
    through ``build_hierarchical_fl_round``: losses finite, each round's
    gathers the oracle's, and under int8 ``quantize`` and ``gossip_fold``
    the only kernels launched, under none no kernel."""
    from repro_torch import telemetry
    from repro_torch.core import fused, tdm
    from repro_torch.launch import fl_train
    from repro_torch.launch import train_fl_constellation as tfc

    cfg, opt, shape, _ = tfc.setup(8)
    state = fl_train._stack_init(0, cfg, opt, 8, device=device)
    intra, inter = _two_level_rels()
    fn = fl_train.build_hierarchical_fl_round(
        cfg, opt, 2, 4, fl_train.FLConfig(mode="tdm", local_steps=tfc.LOCAL_STEPS,
                                          compression=compression), intra, inter)
    oracle = telemetry.expected_hierarchical_collectives(
        intra, inter, len(fused.cached_spec(state["params"]).buckets),
        compression=compression)["collective-permute"]
    batch_fn = tfc.make_batch_fn(cfg, shape, 8)
    kernels.reset_launch_counts()
    for rnd in range(2):
        before = tdm.gather_count()
        state, losses = fn(state, fl_train.batch_to_device(batch_fn(rnd), device))
        assert tdm.gather_count() - before == oracle
        assert bool(torch.isfinite(losses).all())
    launched = {k for k, n in kernels.launch_counts().items() if n}
    assert launched == ({"quantize", "gossip_fold"} if compression == "int8" else set())


def test_two_level_int8_mix_through_kernels(device):
    """One two-level mix of the satellites' params after local training:
    uncompressed equal to per-leaf ``hierarchical_gossip`` bit for bit and
    to the global node mean within 1e-5 (the clique and the one link between
    the planes average exactly); int8 through the kernels within 2% of it;
    and each int8 level through the kernels within the fused/unfused bound
    of the plain versions on the same input (a level's last-bit differences
    may flip a code of the next, so the levels are compared apart)."""
    from repro_torch.core import fused, tdm
    from repro_torch.core.relation import Relation
    from repro_torch.pytree import tree_map

    params = _trained_fl_state(device)[1]["params"]
    intra, inter = _two_level_rels()
    spec = fused.cached_spec(params)
    (bucket,) = spec.buckets
    buf = fused.flatten_pytree(spec, params)[bucket]
    none = fused.hierarchical_buffer_mix(buf, intra, inter, 4, 2)
    per_leaf = tree_map(lambda x: tdm.hierarchical_gossip(x, intra, inter, 4, 2), params)
    assert _bits(none, fused.flatten_pytree(spec, per_leaf)[bucket])
    mean = buf.mean(dim=0, keepdim=True)
    assert float((none - mean).abs().max() / mean.abs().max()) <= 1e-5
    int8 = fused.hierarchical_buffer_mix(buf, intra, inter, 4, 2, compression="int8",
                                         quant_impl="cuda")
    assert float((int8 - none).norm() / none.norm()) < 0.02
    x = buf
    for a, b, level in ((intra, Relation.from_edges([], nodes=range(2)), intra),
                        (Relation.from_edges([], nodes=range(4)), inter, inter)):
        got, want = (fused.hierarchical_buffer_mix(x, a, b, 4, 2, compression="int8",
                                                   quant_impl=impl) for impl in ("cuda", "ref"))
        assert _within_mix_bound(got, want, x, len(tdm.edge_coloring(level)))
        x = want


@pytest.mark.parametrize("compression", ["int8", "topk"])
def test_per_leaf_compressed_round_on_card(device, compression):
    """One per-leaf compressed round (``tdm_fla_round(fused=False)``) over
    the satellites' params after local training: finite, 2 gathers per
    matching per leaf (int8: codes and scale; CHOCO: values and indices),
    and int8 within 2% of the same algebra unquantized."""
    from repro_torch.core import fl, tdm
    from repro_torch.pytree import tree_leaves

    scn, state = _trained_fl_state(device)
    rel = scn.plan.relations()[0]
    leaves = tree_leaves(state["params"])
    m = len(tdm.edge_coloring(rel))
    k = min(64, min(leaf[0].numel() for leaf in leaves))
    before = tdm.gather_count()
    mixed, _ = fl.tdm_fla_round(state["params"], rel, 8, fl.TDMFLAConfig(
        compression=compression, topk_k=k, fused=False))
    assert tdm.gather_count() - before == 2 * m * len(leaves)
    out = tree_leaves(mixed)
    assert all(bool(torch.isfinite(t).all()) for t in out)
    if compression == "int8":
        w = float(np.float32(1.0 / (1.0 + rel.max_degree())))
        num = den = 0.0
        for x, got in zip(leaves, out):
            deg = tdm.node_scalars([rel.degree(v) for v in range(8)], x)
            want = x + w * (tdm.neighbor_sum(x, rel) - deg * x)
            num += float((got - want).double().norm()) ** 2
            den += float(want.double().norm()) ** 2
        assert (num / den) ** 0.5 < 0.02


def test_rate_optimized_fl_on_card(device):
    """``run_constellation_fl(optimize="rate")`` on the smoke model, 3 rounds
    uncompressed: one schedule build, each round's relation a matching of
    its step's visibility relation, losses finite, the gathers the
    oracle's."""
    from repro_torch import telemetry
    from repro_torch.launch import fl_train
    from repro_torch.launch import train_fl_constellation as tfc

    cfg, opt, shape, scn = tfc.setup(8)
    state = fl_train._stack_init(0, cfg, opt, 8, device=device)
    with telemetry.record_scope(tracing=True) as rec:
        state, logs = fl_train.run_constellation_fl(
            cfg, opt, 8, fl_train.FLConfig(mode="tdm", local_steps=tfc.LOCAL_STEPS), scn.plan,
            state, tfc.make_batch_fn(cfg, shape, 8), rounds=3, optimize="rate",
            payload_bytes=tfc.PAYLOAD_BYTES)
    slots = list(scn.plan.schedule(payload_bytes=tfc.PAYLOAD_BYTES, optimize="rate").slots)[:3]
    assert len(logs) == len(slots) == 3
    assert sum(sp.name == "fl.build_schedule" for sp in rec.spans) == 1
    for lg, slot in zip(logs, slots):
        rel = slot.relation
        assert rel.is_matching() and rel.pairs <= scn.plan.relation(slot.t_index).pairs
        assert lg.n_links == len(rel) // 2 and np.isfinite(lg.loss)
    assert rec.get_counter("fl.exchange.gathers") == rec.get_counter(
        "fl.collectives.collective-permute")


# (B, S, H, P, G, N, chunk): chunks 8 to 256 (96: a ragged last tile), 1 to 4
# chunks, groups 1, 2, 4 and 8, head dims 16 to 64, states 32 to 128; each
# case launched twice, bit-identical
SSD_CASES = [
    (2, 8, 4, 64, 1, 128, 8),
    (3, 32, 4, 64, 2, 128, 8),
    (1, 128, 2, 16, 1, 32, 32),
    (1, 128, 8, 64, 4, 128, 64),
    (2, 192, 4, 32, 2, 64, 64),
    (1, 192, 4, 64, 1, 128, 96),
    (1, 256, 4, 64, 1, 128, 256),
    (2, 1024, 2, 64, 2, 128, 256),
    (8, 512, 48, 64, 1, 128, 256),      # mamba2-780m's served prefill, both replicas admitted
    (1, 512, 256, 64, 8, 128, 256),     # jamba-1.5-large: 256 heads in 8 groups of 32
    (2, 1024, 64, 64, 8, 128, 128),     # nemotron-3-nano: 64 heads in 8 groups, chunk 128
]


def _ssd_inputs(device, case, dtype, strong=False):
    """x, B, C ~ N(0, 1) in ``dtype``; dt and A softplus-normal and
    -exp(U(-1, 1)), or (a case ending in ``"init"``) as the model's init
    draws them (``ssd_scan.ref.init_inputs``), or strong decay."""
    from repro_torch.kernels.ssd_scan import ref

    B, S, H, P, G, N = case[:6]
    g = torch.Generator(device=device).manual_seed(S + H + G)
    if case[7:] == ("init",):
        return ref.init_inputs(g, case[:6], dtype)
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

    before = kernels.launch_counts()["ssd_scan"]
    y, s = ops.ssd_scan(*inputs, chunk=chunk)
    assert kernels.launch_counts()["ssd_scan"] == before + 1   # CUDA tensors: the kernel
    again = ops.ssd_scan(*inputs, chunk=chunk)
    assert _bits(y, again[0]) and _bits(s, again[1])        # a second launch, bit for bit
    y_r, s_r = ops.ssd_scan(*inputs, chunk=chunk, impl="ref")
    torch.cuda.synchronize()
    assert y.dtype == inputs[0].dtype and s.dtype == torch.float32
    for got, want in ((y, y_r), (s, s_r)):
        ok, err = ref.ssd_close(got, want)
        assert ok, err


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", SSD_CASES + [c + ("init",) for c in SSD_CASES],
                         ids=lambda c: "-".join(map(str, c)))
def test_ssd_scan_against_plain(device, case, dtype):
    _ssd_check(_ssd_inputs(device, case, dtype), case[6])


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
    from repro_torch.configs import archs
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
    before = kernels.launch_counts()["ssd_scan"]
    first = gpu.prefill_waves(waves)
    assert kernels.launch_counts()["ssd_scan"] == before + cfg.n_layers
    assert first == cpu.prefill_waves(waves)
    active = np.array([True, True])
    assert (gpu.step(active) == cpu.step(active)).all()


# the decode-graph check's script: (call, argument) in order; ticks of
# replicas {0, 1} 20, {0} 8 and {1} 8, so 3 captures and 33 replays
GRAPH_SCRIPT = ([("prefill", (0, 1))] + [("step", (1, 1))] * 12 + [("step", (1, 0))] * 8
                + [("prefill", (1,))] + [("step", (0, 1))] * 8 + [("step", (1, 1))] * 8)


@pytest.mark.parametrize("arch", ["mamba2-780m", "nemotron-3-nano-30b-a3b", "qwen3-moe-30b-a3b"])
def test_decode_replayed_from_graphs_equals_eager(device, arch):
    """The smoke config of ``arch`` (no MoE; the dropless MoE of nemotron-h;
    qwen3-moe's capacity MoE): two decoders over one set of params, one
    with its capture seam removed, run ``GRAPH_SCRIPT`` call by call; after
    every call their logits (the prefill's last position, the tick's),
    tokens, caches and ``pos`` are equal, and so are the route and drop
    tallies each call made (``moe.count_routes``, ``moe.count_drops``): a
    replayed tick's are the copies its replay appends. The replaying decoder
    captures each active set once and replays every later tick of it (its
    counters). Then the captured call, once eagerly and once replayed, runs
    under ``torch.cuda.set_sync_debug_mode("error")``: neither
    synchronises."""
    from repro_torch import telemetry
    from repro_torch.configs import archs
    from repro_torch.models import moe, transformer
    from repro_torch.pytree import tree_leaves
    from repro_torch.serving import ModelDecoder

    class Logged(ModelDecoder):
        """Keeps the logits of every call."""

        def _tokens(self, logits, k):
            self.seen.append(logits.clone())
            return super()._tokens(logits, k)

    def tallied(call):
        with moe.count_routes() as routes, moe.count_drops() as drops:
            out = call()
        return out, {"routes": routes, "drops": drops}

    cfg = archs.smoke_cfg(archs.get(arch))
    n_moe = sum(d.ffn == "moe" for d in transformer.scan_unit(cfg)) * transformer.n_units(cfg)
    batch, prompt = 4, 100
    max_len = ModelDecoder._bucket(prompt) + len(GRAPH_SCRIPT) + 1
    rng = np.random.default_rng(0)
    waves = [[rng.integers(0, cfg.vocab_size, prompt).astype(np.int32) for _ in range(batch)]
             for _ in range(3)]
    params = ModelDecoder(cfg, 2, batch, max_len, seed=3, device=device).params
    eager, graph = (Logged(cfg, 2, batch, max_len, device=device, params=params)
                    for _ in range(2))
    eager._graphs = None
    eager.seen, graph.seen = [], []
    assert graph._graphs is not None
    with telemetry.record_scope() as rec:
        for i, (call, arg) in enumerate(GRAPH_SCRIPT):
            if call == "prefill":
                w = {r: waves[r if i == 0 else 2] for r in arg}
                outs = [tallied(lambda: d.prefill_waves(w)) for d in (eager, graph)]
            else:
                outs = [tallied(lambda: d.step(np.array(arg, bool)).tolist())
                        for d in (eager, graph)]
            what = f"call {i} ({call} {arg})"
            assert outs[0][0] == outs[1][0], what
            assert torch.equal(eager.seen[-1], graph.seen[-1]), what
            assert torch.equal(eager._cache["pos"], graph._cache["pos"]), what
            assert all(torch.equal(a, b) for a, b in zip(
                tree_leaves(eager._cache["units"]), tree_leaves(graph._cache["units"]))), what
            (_, want), (_, got) = outs
            kind = "prefill" if call == "prefill" else "decode"
            assert sum(len(t.get(kind, [])) for t in want.values()) == n_moe, what
            for name in want:
                assert sorted(got[name]) == sorted(want[name]), f"{what}: {name}"
                for k, calls in want[name].items():
                    assert len(got[name][k]) == len(calls), f"{what}: {name} {k}"
                    assert all(torch.equal(a, b) for a, b in zip(got[name][k], calls)), \
                        f"{what}: {name} {k}"
        counts = {k.rsplit(".", 1)[-1]: rec.get_counter(k) for k in (
            "serve.decode.graph.captures", "serve.decode.graph.replays", "serve.decode.eager")}
    ticks = sum(call == "step" for call, _ in GRAPH_SCRIPT)
    assert counts == {"captures": 3, "replays": ticks - 3, "eager": ticks}
    rs = (0, 1)
    lanes = eager._lanes(rs)
    tok = torch.zeros((len(rs) * batch, 1), dtype=torch.int64, device=device)
    replay, _ = graph._replays[rs]
    torch.cuda.synchronize(device)
    torch.cuda.set_sync_debug_mode("error")
    try:
        with moe.count_routes(), moe.count_drops():
            eager.bundle.decode_fn(eager.params, lanes, {"token": tok})
            replay()
    finally:
        torch.cuda.set_sync_debug_mode(0)


# (B, S, H, KV, hd, causal, window, softcap): S 1 to 4608 with ragged tiles,
# windows below and above S
FA_CASES = [
    (2, 23, 4, 2, 16, True, None, 50.0),
    (1, 300, 4, 1, 64, True, 16, None),
    (1, 64, 8, 2, 128, False, None, None),
    (2, 512, 16, 8, 256, True, None, 50.0),
    (1, 8, 4, 4, 256, False, 3, 50.0),
    (1, 4608, 16, 8, 256, True, 4096, 50.0),     # gemma2-9b's local layer, S > window
    (2, 1, 4, 4, 16, True, None, 50.0),
    (2, 8, 8, 4, 64, True, None, None),
    (1, 23, 8, 2, 128, False, None, 50.0),
    (2, 64, 4, 1, 256, True, 16, 50.0),
    (1, 300, 4, 2, 64, True, 64, None),
    (1, 300, 2, 2, 16, False, 100, None),
    (1, 512, 16, 8, 256, True, 4096, 50.0),
    (1, 512, 8, 8, 128, True, 100, 50.0),
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
    """Within ``fa_tolerance``; a second launch bit-identical; bf16 on the
    tensor-core kernel, float32 not."""
    from repro_torch.kernels.flash_attention import ops, ref

    B, S, H, KV, hd, causal, window, cap = case
    q, k, v = _fa_inputs(device, (B, S, H, hd), (B, S, KV, hd), dtype, S + hd)
    before = kernels.launch_counts()
    got = ops.flash_attention(q, k, v, causal=causal, window=window, softcap=cap)
    again = ops.flash_attention(q, k, v, causal=causal, window=window, softcap=cap)
    after = kernels.launch_counts()
    assert after["flash_attention_fwd"] == before["flash_attention_fwd"] + 2
    assert (after["flash_attention_fwd_wgmma"] - before["flash_attention_fwd_wgmma"]
            == (2 if dtype == torch.bfloat16 else 0))
    want = ops.flash_attention(q, k, v, causal=causal, window=window, softcap=cap,
                               impl="ref")
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    ok, err = ref.fa_close(got, want)
    assert ok, err


# (B, L, H, KV, hd, Sq, kv_len of the middle row); the other rows' kv_len 1
# and L
FA_DECODE_CASES = [
    (3, 529, 4, 2, 16, 1, 300),
    (3, 529, 8, 2, 64, 4, 300),
    (3, 529, 4, 2, 256, 1, 300),
    (3, 529, 2, 2, 128, 2, 300),
    (3, 23, 4, 2, 16, 1, 12),
    (3, 64, 8, 2, 64, 1, 33),
    (3, 300, 4, 4, 128, 2, 151),
    (3, 529, 16, 8, 256, 1, 265),
    (3, 512, 8, 2, 256, 4, 257),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", FA_DECODE_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_attention_decode_against_plain(device, case, dtype):
    """Within ``fa_tolerance``; a second launch bit-identical."""
    from repro_torch.kernels.flash_attention import ops, ref

    B, L, H, KV, hd, Sq, mid = case
    q, k, v = _fa_inputs(device, (B, Sq, H, hd), (B, L, KV, hd), dtype, hd + H // KV)
    kv_len = torch.tensor([1, mid, L], dtype=torch.int32, device=device)
    before = kernels.launch_counts()["flash_attention_decode"]
    got = ops.flash_attention_decode(q, k, v, kv_len, softcap=50.0)
    again = ops.flash_attention_decode(q, k, v, kv_len, softcap=50.0)
    assert kernels.launch_counts()["flash_attention_decode"] == before + 2
    want = ops.flash_attention_decode(q, k, v, kv_len, softcap=50.0, impl="ref")
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    ok, err = ref.fa_close(got, want)
    assert ok, err


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("L", [4096, 8192])
def test_flash_attention_decode_long_cache(device, L, dtype):
    """gemma2-9b's window as a ring length, and twice it: the cache split
    into many chunks; kv_len 1, one past the first chunk's edge, and L; a
    second launch bit-identical."""
    from repro_torch.kernels.flash_attention import flash_attention as kern
    from repro_torch.kernels.flash_attention import ops, ref

    B, H, KV, hd = 3, 16, 8, 256
    q, k, v = _fa_inputs(device, (B, 1, H, hd), (B, L, KV, hd), dtype, L)
    n_split, chunk, _, _ = kern.decode_plan(
        B, KV, L, H // KV, hd, torch.cuda.get_device_properties(device).multi_processor_count)
    assert n_split > 1
    kv_len = torch.tensor([1, chunk + 1, L], dtype=torch.int32, device=device)
    got = ops.flash_attention_decode(q, k, v, kv_len, softcap=50.0)
    again = ops.flash_attention_decode(q, k, v, kv_len, softcap=50.0)
    want = ops.flash_attention_decode(q, k, v, kv_len, softcap=50.0, impl="ref")
    torch.cuda.synchronize()
    assert torch.equal(got, again)
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
    before = kernels.launch_counts()
    kern.flash_attention_fwd(q, k, v)
    after = kernels.launch_counts()
    assert after["flash_attention_fwd"] == before["flash_attention_fwd"] + 1
    assert (after["flash_attention_fwd_wgmma"] - before["flash_attention_fwd_wgmma"]
            == (1 if dtype == torch.bfloat16 else 0))


def test_dense_model_decoder_prefill_and_tick(device):
    """A two-replica ModelDecoder on the gemma2-9b smoke config on the card:
    the prefill launches the attention kernel once per layer and a tick the
    decode kernel once per layer; the first tokens and two ticks (the
    replicas at different pos) equal a CPU decoder's with the same params
    (float32 compute)."""
    from repro_torch.configs import archs
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
    kernels.reset_launch_counts()
    assert gpu.prefill_waves(first) == cpu.prefill_waves(first)
    assert kernels.launch_counts()["flash_attention_fwd"] == cfg.n_layers
    one = np.array([True, False])
    assert (gpu.step(one) == cpu.step(one)).all()
    assert kernels.launch_counts()["flash_attention_decode"] == cfg.n_layers
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
    one decode launch per layer per tick, no other kernel, and the first local and global
    layers' attention, on the prompt and on the caches the ticks left,
    within ``fa_tolerance`` of the plain version."""
    from repro_torch.serving.edge_check import EDGE_TICKS, dense_edge_check

    seen = dense_edge_check(device)
    cfg = seen["config"]
    assert seen["prompts"] == [129, 200, 256, 160] and seen["ticks"] == EDGE_TICKS == 24
    assert seen["launches"] == {"flash_attention_fwd": cfg.n_layers,
                                "flash_attention_fwd_wgmma": cfg.n_layers,
                                "flash_attention_decode": cfg.n_layers * EDGE_TICKS}
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

    from repro_torch.configs import archs
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
    kernels.reset_launch_counts()
    tallies = []
    for dec in (gpu, cpu):
        with moe.count_drops() as tally:
            toks = [dec.prefill_waves(first)]
            toks.append(dec.step(np.array([True, False])).tolist())
            toks.append(dec.prefill_waves(second))
            toks += [dec.step(np.array([True, True])).tolist() for _ in range(3)]
        tallies.append({k: [t.tolist() for t in v] for k, v in tally.items()})
        if dec is gpu:
            counts = kernels.launch_counts()
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
        kernels.reset_launch_counts()
        state, metrics = steps.build_train_step(cfg, opt, impl)(state, batch)
        torch.cuda.synchronize()
        runs[impl] = (state, metrics, kernels.launch_counts())
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


def test_microbatched_step_on_card_matches_cpu(device):
    """One train step of the gemma2-9b smoke config at micro 2, float32
    compute, on the card (S 40: the kernels on a ragged S) against the same
    step on the CPU (the naive path), held by ``cases.check_first_step`` at
    the f32 bounds of ``FIRST_STEP_TOL``; at most 1e-4 of the param entries
    more than 1e-6 apart (a gradient entry within the tolerance of zero may
    flip its sign)."""
    from repro_torch.configs import archs
    from repro_torch.data import pipeline
    from repro_torch.kernels.flash_attention import cases
    from repro_torch.launch import steps
    from repro_torch.launch.fl_train import batch_to_device
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import adamw
    from repro_torch.pytree import tree_leaves, tree_map

    cfg = archs.smoke_cfg(archs.get("gemma2-9b")).replace(compute_dtype="float32",
                                                          micro_steps=2)
    opt = adamw.OptConfig(peak_lr=3e-3, warmup_steps=5, decay_steps=10)
    cpu = steps.init_state(0, cfg, opt, "cpu")
    card = tree_map(lambda t: t.to(device), cpu)
    batch = pipeline.SyntheticStream(cfg, ShapeConfig("c", "train", 40, 4), seed=3).batch(0)
    step = steps.build_train_step(cfg, opt)
    cpu, m_cpu = step(cpu, batch_to_device(batch, "cpu"))
    card, m_card = step(card, batch_to_device(batch, device))
    torch.cuda.synchronize(device)
    loss_rtol, gnorm_rtol, mu_rtol = FIRST_STEP_TOL["float32"]
    read = cases.check_first_step(card, m_card, cpu, m_cpu, opt, loss_rtol=loss_rtol,
                                  gnorm_rtol=gnorm_rtol, mu_rtol=mu_rtol)
    total = sum(t.numel() for t in tree_leaves(cpu["params"]))
    assert read["flips"] <= 1e-4 * total, f"{read['flips']} of {total} param entries off"


def test_checkpoint_round_trip_on_card(device, tmp_path):
    """A checkpoint of card tensors (f32 params, int8 AdamW moments with f32
    scales, bf16 params, int32 counters) restored onto the card: every leaf
    equal bit for bit, with its dtype and device."""
    from repro_torch.checkpoint import checkpoint as ckpt_lib
    from repro_torch.configs import archs
    from repro_torch.launch import steps
    from repro_torch.optim import adamw
    from repro_torch.pytree import tree_leaves, tree_map

    cfg = archs.smoke_cfg(archs.get("gemma2-9b"))
    state = steps.init_state(1, cfg, adamw.OptConfig(dtype="int8"), device)
    tree = {"state": state, "bf16": tree_map(lambda t: t.to(torch.bfloat16), state["params"])}
    ckpt_lib.save(str(tmp_path), 7, tree)
    ckpt_lib.wait_all()
    step_no, back = ckpt_lib.restore(str(tmp_path), target=tree, device=device)
    assert step_no == 7
    assert all(a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
               for a, b in zip(tree_leaves(back), tree_leaves(tree)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", list(range(len(RECT_CASES))))
def test_flash_attention_rect_against_plain(device, case, dtype):
    """Sq != Skv (whisper-base's encoder and cross-attention shapes, Skv 1500,
    causal rectangles both ways; its training self-attention, causal 4096^2
    at B 16) and padded head dims (112, 40): forward
    with and without lse and backward against their plain versions."""
    from repro_torch.kernels.flash_attention import cases

    cases.check_rect_case(cases.RECT_CASES[case], dtype, device)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_flash_attention_query_tile_without_keys_writes_zeros(device, dtype):
    """A non-causal window past the last key: queries 128.. see none of the
    100 keys (their window starts at key 127, inside the last key tile of
    both kernels' tilings), so their tile walks no key tile, its output rows
    are zeros and so are their dq."""
    from repro_torch.kernels.flash_attention import ops

    kw = dict(causal=False, window=2, softcap=None)
    q, k, v = _fa_inputs(device, (1, 192, 4, 64), (1, 100, 2, 64), dtype, 7)
    g = torch.randn_like(q)
    out, lse = ops.flash_attention(q, k, v, impl="cuda", lse=True, **kw)
    dq, dk, dv = ops.flash_attention_bwd(q, k, v, out, lse, g, impl="cuda", **kw)
    torch.cuda.synchronize()
    assert not out[:, 128:].any() and not dq[:, 128:].any()
    assert all(bool(t.float().isfinite().all()) for t in (out, lse, dq, dk, dv))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", list(range(len(RECT_DECODE_CASES))))
def test_flash_attention_decode_rect_against_plain(device, case, dtype):
    """whisper-base's cross decode (G 1, hd 64, every one of 1536 or 1500
    frames valid) and self decode (448 slots), kimi-k2's heads (hd 112) and
    qwen2-vl-72b's (64 / 8 x 128, 529 slots)."""
    from repro_torch.kernels.flash_attention import cases

    cases.check_decode_case(cases.RECT_DECODE_CASES[case], dtype, device)


def test_whisper_smoke_on_kernels_matches_plain(device):
    """whisper-base's smoke config, float32 compute, on the card: the prefill
    (encoder, self- and cross-attention on the kernels) and 4 decode ticks
    (self and cross decode) against the same calls on the CPU, logits and
    caches within 2e-5 of their scale; the launches one forward per encoder
    layer and two per decoder layer, two decodes per layer and tick; then
    one train step on the kernels against one on their plain versions
    (``cases.check_first_step`` at the f32 bounds of the gemma2-9b step)."""
    from repro_torch.configs import archs
    from repro_torch.data import pipeline
    from repro_torch.kernels.flash_attention import cases
    from repro_torch.launch import steps
    from repro_torch.launch.fl_train import batch_to_device
    from repro_torch.models import registry
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import adamw
    from repro_torch.pytree import tree_leaves, tree_map

    cfg = archs.smoke_cfg(archs.get("whisper-base")).replace(compute_dtype="float32")
    b = registry.bundle(cfg)
    params = b.init(torch.Generator(device=device).manual_seed(5))
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 12)))
    enc = torch.from_numpy(rng.standard_normal((2, cfg.enc_frames, cfg.d_model)).astype(
        np.float32))
    seen = {}
    for dev in (device, torch.device("cpu")):
        p = tree_map(lambda t: t.to(dev), params)
        kernels.reset_launch_counts()
        with torch.no_grad():
            logits, cache = b.prefill_fn(p, {"tokens": toks[:, :8].to(dev),
                                             "enc_embeds": enc.to(dev)}, 16)
            outs = [logits]
            for t in range(8, 12):
                logits, cache = b.decode_fn(p, cache, {"token": toks[:, t:t + 1].to(dev)})
                outs.append(logits)
        seen[dev.type] = (outs, cache, kernels.launch_counts())
    for a, w in zip(seen["cuda"][0] + tree_leaves(seen["cuda"][1]["units"]),
                    seen["cpu"][0] + tree_leaves(seen["cpu"][1]["units"])):
        w = w.float()
        assert float((a.cpu().float() - w).abs().max()) <= 2e-5 * float(w.abs().max())
    counts = seen["cuda"][2]
    assert counts["flash_attention_fwd"] == cfg.n_enc_layers + 2 * cfg.n_layers
    assert counts["flash_attention_decode"] == 4 * 2 * cfg.n_layers

    opt = adamw.OptConfig(peak_lr=3e-3, warmup_steps=5, decay_steps=10)
    start = steps.init_state(0, cfg, opt, device)
    batch = batch_to_device(
        pipeline.SyntheticStream(cfg, ShapeConfig("c", "train", 40, 4), seed=1).batch(0),
        device)
    runs = {}
    for impl in ("cuda", "ref"):
        state = tree_map(lambda t: t.clone(), start)
        state, metrics = steps.build_train_step(cfg, opt, impl)(state, batch)
        runs[impl] = (state, metrics)
    torch.cuda.synchronize()
    cases.check_first_step(*runs["cuda"], *runs["ref"], opt, loss_rtol=1e-5, gnorm_rtol=1e-5,
                           mu_rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", list(range(len(NEMOTRON_PREFILL_CASES))))
def test_flash_attention_at_nemotron_serving_shapes(device, case, dtype):
    from repro_torch.kernels.flash_attention import cases

    cases.check_prefill_case(cases.NEMOTRON_PREFILL_CASES[case], dtype, device)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", list(range(len(NEMOTRON_DECODE_CASES))))
def test_flash_attention_decode_at_nemotron_serving_shapes(device, case, dtype):
    from repro_torch.kernels.flash_attention import cases

    cases.check_decode_case(cases.NEMOTRON_DECODE_CASES[case], dtype, device)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_grouped_mm_against_a_loop(device, dtype):
    """``moe.grouped_mm`` on the card at nemotron's expert shapes (2688 ->
    1856) with empty, one-row and long runs: each run's rows equal its own
    product (bf16: within one bf16 rounding of the float32 product)."""
    from repro_torch.models import moe

    g = torch.Generator(device=device).manual_seed(7)
    sizes = [0, 1, 3, 0, 0, 40, 1, 2, 0, 17]
    E, K, N = len(sizes), 2688, 1856
    a = torch.randn(sum(sizes), K, generator=g, device=device).to(dtype)
    b = (torch.randn(E, K, N, generator=g, device=device) * K ** -0.5).to(dtype)
    offs = torch.tensor(sizes, device=device).cumsum(0).to(torch.int32)
    got = moe.grouped_mm(a, b, offs)
    assert got.dtype == dtype and got.shape == (a.shape[0], N)
    start = 0
    for e, n in enumerate(sizes):
        want = a[start:start + n].float() @ b[e].float()
        tol = 1e-5 if dtype == torch.float32 else 8e-3
        torch.testing.assert_close(got[start:start + n].float(), want, rtol=tol, atol=tol)
        start += n


def test_nemotron_smoke_on_card(device):
    """nemotron-3-nano's smoke config on the card: float32 prefill of 16
    tokens and 8 decode steps within 2e-5 of the logits' largest magnitude
    of the plain reference (TF32 off), as on the CPU; then a bf16 decode
    step of 32 lanes under ``set_sync_debug_mode("error")``: the tick waits
    for the host nowhere (the dropless MoE sizes its groups on the device)."""

    import nemotron_h_ref as ref
    from test_torch_nemotron import port_logits, ref_cfg, smoke

    from repro_torch.models import registry

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = smoke()
        params = registry.bundle(cfg).init(torch.Generator(device=device).manual_seed(0))
        tokens = torch.as_tensor(np.random.default_rng(1).integers(0, 128, 24),
                                 device=device).long()
        with torch.no_grad():
            got = port_logits(params, tokens, cfg, 16)
        with ref.exact_matmuls():
            want = ref.logits(params, ref.hidden(params, tokens, ref_cfg(cfg)))[15:]
        err = float((got - want).abs().max())
        assert err <= 2e-5 * float(want.abs().max()), err
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    cfg = smoke("bfloat16")
    b = registry.bundle(cfg)
    params = b.init(torch.Generator(device=device).manual_seed(0))
    tok = torch.randint(0, 128, (32, 16), device=device)
    with torch.no_grad():
        _, cache = b.prefill_fn(params, {"tokens": tok}, 32)
        b.decode_fn(params, cache, {"token": tok[:, :1]})        # warm
        torch.cuda.synchronize(device)
        torch.cuda.set_sync_debug_mode("error")
        try:
            b.decode_fn(params, cache, {"token": tok[:, 1:2]})
        finally:
            torch.cuda.set_sync_debug_mode(0)
