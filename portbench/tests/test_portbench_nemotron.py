"""The nemotron3-nano-30b-a3b-serve configuration and the two serving cells
it came with, on the CPU at a small size: ``serve_nemotron_chat`` at the
port's smoke config of the arch (the pattern ``ME*``, float32) and
``serve_long_prompt`` at ``conftest``'s tiny serving size; the counts at the
published sizes; the seeded weights in the port's tree; a program without
the arch refused before anything is made.

``conftest.TINY_MODEL`` has no entry for the ``serve_nemotron_h`` kind, so
the cell-generic tests of ``test_portbench_run.py`` and
``test_portbench_imports.py`` cannot shrink ``serve_nemotron_chat``; the
tests here run it at a small size of their own.
"""

import copy
import json
import math
import subprocess
import sys

import pytest
import torch

from portbench import counts, harness, weights_nemotron_h
from portbench.counts_nemotron_h import NemotronH
from portbench.drivers import serve_nemotron_h

CELL = "serve_nemotron_chat"
TINY = {
    "arch_variant": "smoke", "hidden_size": 64, "num_hidden_layers": 3, "vocab_size": 128,
    "hybrid_override_pattern": "ME*", "mamba_num_heads": 6, "mamba_head_dim": 8,
    "n_groups": 2, "ssm_state_size": 16, "conv_kernel": 4, "chunk_size": 8,
    "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
    "n_routed_experts": 16, "num_experts_per_tok": 4, "moe_intermediate_size": 32,
    "moe_shared_expert_intermediate_size": 48, "intermediate_size": 96,
    "norm_eps": 1e-6, "layer_norm_epsilon": 1e-6,
    "precision": {"params": "float32", "compute": "float32"},
}
TINY_TRAFFIC = {"lanes": 2, "prompt_len": [8, 40], "max_new": [2, 6], "requests": 300,
                "checked_requests": 3, "profile": {"first": 1, "units": 2}}


def tiny_nemotron():
    c = copy.deepcopy(harness.cell(CELL))
    c.config.update(copy.deepcopy(TINY))
    c.traffic.update(copy.deepcopy(TINY_TRAFFIC))
    return c


def _run(c, trace, seed=2**31 + 11, seconds=None):
    seconds = seconds or (6.0 if trace else 2.0)
    return harness.run_cell(c, seed, seconds, trace, "cpu", log=lambda m: None)


@pytest.mark.parametrize("trace", [False, True])
def test_nemotron_cell_runs_small(trace):
    c = tiny_nemotron()
    r = _run(c, trace)
    json.dumps(r)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["checks"]) == {"logit_gap", "logit_gap_q90", "undelivered", "dropped"}
    assert r["checks"]["dropped"]["value"] == 0.0 and r["checks"]["undelivered"]["value"] == 0
    want = [m["name"] for m in (c.per_layer if trace else c.end_to_end)]
    for name, m in r["metrics"].items():
        assert name in want and math.isfinite(m["value"])
    if not trace:
        assert sorted(r["metrics"]) == sorted(want) == ["serve_tokens_per_s", "setup_s"]
    else:
        # no device spans on the CPU: the stream-time readers find nothing
        # (the host-time span readers find something only where a span falls
        # outside the profiled stretch, which a slow CPU may not give)
        assert "serve_moe_ms" not in r["metrics"] and "serve_moe_roofline" not in r["metrics"]
        assert "serve_mfu_pct" in r["metrics"]


def test_traced_window_tallies_routes():
    c = tiny_nemotron()
    run = harness.Run(c, 9, 3.0, True, "cpu")
    job = serve_nemotron_h.setup(run)
    serve_nemotron_h.window(run, job)
    s = run.stats
    sizes = run.sizes
    assert s["moe_decode_calls"] == s["moe_decode_ticks"] * sizes.count("E") > 0
    assert s["moe_decode_assignments"] % sizes.num_experts_per_tok == 0
    assert 0 < s["moe_decode_hit"] <= s["moe_decode_calls"] * sizes.n_routed_experts
    assert s["moe_decode_least_bytes_per_tick"] > 0 and s["dropped_spans"] == 0
    assert len(job.routes) == 2 and serve_nemotron_h.dropped(job) == 0.0
    # the profiled stretch's calls: within the window's, each call's least
    # time at least its experts' bytes at 3.35 TB/s
    calls = sum(len(v) for v in job.routes[1].values())
    assert 0 < s["moe_stretch_calls"] <= calls
    per_expert = counts.seconds_at_hbm(sizes.expert_params(sizes.moe_intermediate_size) * 2)
    assert s["moe_stretch_least_s"] >= s["moe_stretch_calls"] * per_expert


def test_long_prompt_cell_runs_small(tiny_cell):
    r = _run(tiny_cell("serve_long_prompt"), False)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert sorted(r["metrics"]) == ["serve_tokens_per_s", "setup_s"]


def test_same_seed_same_checks():
    a = _run(tiny_nemotron(), False, seed=5, seconds=1.0)
    b = _run(tiny_nemotron(), False, seed=5, seconds=1.0)
    assert a["checks"].keys() == b["checks"].keys()


def test_program_without_the_arch_is_refused_before_anything_is_made(monkeypatch):
    from repro_torch.configs import archs

    monkeypatch.delitem(archs.ARCHS, "nemotron-3-nano-30b-a3b")

    def refuse(*a, **k):
        raise AssertionError("weights made")

    monkeypatch.setattr(serve_nemotron_h, "make_weights", refuse)
    run = harness.Run(harness.cell(CELL), 1, 1.0, False, "cpu")
    with pytest.raises(ValueError, match="no arch"):
        serve_nemotron_h.setup(run)


def test_program_config_matches_the_published_file():
    c = harness.cell(CELL)
    cfg = serve_nemotron_h.program_config(c.config)
    assert cfg.param_count() == harness.counts(c.config).params() == 31_577_940_288
    assert (cfg.param_dtype, cfg.compute_dtype) == ("bfloat16", "bfloat16")
    assert c.config["reduced"] == {} and c.config["num_hidden_layers"] == 52


def test_counts_at_published_sizes():
    m = harness.counts(harness.cell(CELL).config)
    assert isinstance(m, NemotronH)
    assert (m.count("M"), m.count("E"), m.count("*")) == (23, 23, 6)
    D = 2688
    assert m.mamba_params() + D == 38_744_896
    assert m.attn_params() + D == 23_399_040
    assert m.n_routed_experts * m.expert_params(1856) == 1_277_165_568
    assert m.expert_params(3712) == 19_955_712
    assert m.params() * 2 / 1e9 == pytest.approx(63.16, abs=0.005)
    # a decode token: 23 Mamba steps, 6 attention projections, 23 x (router,
    # 6 experts, shared), the head
    mamba = 2 * (D * (2 * 4096 + 2 * 8 * 128 + 64) + 4096 * D) + 2 * 4 * 6144 + 64 * 4 * 128 * 64
    attn = 2 * (2 * D * 4096 + 2 * D * 256)
    moe = 2 * (D * 128 + 6 * 2 * D * 1856 + 2 * D * 3712)
    assert m.generated_flops(True) == pytest.approx(23 * mamba + 6 * attn + 23 * moe
                                                    + 2 * D * 131072)
    # ~100 of 128 experts hit by 32 tokens; ~47 GB of MoE reads a tick
    assert m.expected_hit(32) == pytest.approx(100.46, abs=0.01)
    tick = 23 * m.moe_call_least_bytes(m.expected_hit(32), 32)
    assert tick / 1e9 == pytest.approx(47.07, abs=0.01)
    assert counts.seconds_at_hbm(tick) * 1e3 == pytest.approx(14.05, abs=0.01)


def test_weights_take_the_ports_tree():
    from repro_torch.models import registry
    from repro_torch.pytree import tree_flatten

    c = tiny_nemotron()
    cfg = serve_nemotron_h.program_config(c.config)
    sizes = harness.counts(c.config)
    got = weights_nemotron_h.make(sizes, 3, "cpu", torch.float32)
    want = registry.bundle(cfg).init(torch.Generator().manual_seed(0))
    (gl, gt), (wl, wt) = tree_flatten(got), tree_flatten(want)
    assert gt == wt
    assert [(t.shape, t.dtype) for t in gl] == [(t.shape, t.dtype) for t in wl]
    again = weights_nemotron_h.make(sizes, 3, "cpu", torch.float32)
    assert all(torch.equal(a, b) for a, b in zip(gl, tree_flatten(again)[0]))


def test_weights_drawn_in_pieces(monkeypatch):
    """A leaf larger than a piece is drawn in several, each of at most
    ``PIECE_BYTES`` of float32, and fills the whole leaf."""
    sizes = harness.counts(tiny_nemotron().config)
    drawn = []
    real = torch.randn

    def randn(shape, **kw):
        drawn.append(math.prod(shape) * 4)
        return real(shape, **kw)

    monkeypatch.setattr(weights_nemotron_h, "PIECE_BYTES", 4 * 64 * 5)
    monkeypatch.setattr(torch, "randn", randn)
    w = weights_nemotron_h.make(sizes, 3, "cpu", torch.float32)
    assert max(drawn) <= 4 * 64 * 5
    wi = w["units"]["L1"]["ffn"]["wi"]           # (1, 16, 64, 32): 1024 rows of 32
    assert wi.shape == (1, 16, 64, 32) and bool((wi != 0).all())


DRY = """
import sys, copy
sys.path[:0] = [{src!r}, {root!r}, {tests!r}]
from test_portbench_nemotron import tiny_nemotron
from portbench import harness
harness.run_cell(tiny_nemotron(), 3, 0.5, False, "cpu", log=lambda m: None)
print(sorted({{m.split('.')[0] for m in sys.modules}} & {forbidden!r}))
"""


def test_a_run_loads_no_jax():
    code = DRY.format(src=str(harness.ROOT / "src"), root=str(harness.ROOT),
                      tests=str(harness.HERE / "tests"), forbidden=set(harness.FORBIDDEN))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _span(name, t, dur, dev_us=None):
    from types import SimpleNamespace

    return SimpleNamespace(name=name, t_start_us=float(t), dur_us=float(dur), dev_us=dev_us)


def _moe_run(spans_, stats=None):
    run = harness.Run(tiny_nemotron(), seed=3, seconds=1.0, trace=True, device="cpu")
    run.spans = spans_
    run._stretch_us = (1000.0, 2000.0)
    run.stats.update(stats or {})
    return run


def _moe_spans():
    """A prefill with two MoE layers, a tick with two, a tick inside the
    profiled stretch, a tick with two more."""
    return [_span("serve.prefill", 0, 100), _span("model.moe", 10, 5, 4000.0),
            _span("model.moe", 20, 5, 6000.0),
            _span("serve.decode", 200, 100), _span("model.moe", 210, 5, 1000.0),
            _span("model.moe", 220, 5, 2000.0),
            _span("serve.decode", 1200, 100), _span("model.moe", 1210, 5, 1e6),
            _span("serve.decode", 3000, 100), _span("model.moe", 3010, 5, 3000.0),
            _span("model.moe", 3020, 5, 4000.0)]


GROUPED = ("void cutlass::device_kernel<at::cuda::detail::enable_3x_kernel_for_sm9x<"
           "cutlass::gemm::kernel::GemmUniversal<cutlass::gemm::GroupProblemShape<")


def _devtrace(grouped_s=None):
    from portbench.devtrace import DeviceTrace

    ops = {"nvjet_tst_64x32_64x16_4x1_v_bz_splitK_NNT": (0.5, 9)}
    if grouped_s is not None:
        ops[GROUPED + "cute::tuple<int, int, int> > > >"] = (grouped_s, 4)
    return DeviceTrace(window_s=1.0, busy_s=0.6, ops=ops, gaps={})


def test_moe_readers_per_tick_and_per_prefill():
    run = _moe_run(_moe_spans(), {"moe_stretch_least_s": 2.5e-3})
    run.devtrace = _devtrace(5e-3)
    assert harness.metric("serve_moe_ms").read(run) == pytest.approx((3.0 + 7.0) / 2)
    assert harness.metric("serve_moe_prefill_ms").read(run) == pytest.approx(10.0)
    # 2.5 ms of least time over 5 ms of the grouped GEMMs' device time; the
    # other kernels and the spans' stream time do not enter
    assert harness.metric("serve_moe_roofline").read(run) == pytest.approx(50.0)


def test_routed_least_time_takes_the_longer_of_bytes_and_operations():
    m = harness.counts(harness.cell(CELL).config)
    expert = 2 * 2688 * 1856 * 2
    # a decode call: 192 assignments over 100 experts, bytes bound
    assert m.routed_least_s(100, 192) == pytest.approx(
        (100 * expert + 2 * 192 * 2688 * 2) / 3.35e12)
    # a prefill call of 16 x 1024 tokens: all 128 experts, operations bound
    A = 16 * 1024 * 6
    assert m.routed_least_s(128, A) == pytest.approx(2 * A * 2 * 2688 * 1856 / 989e12)


def test_gap_checks_see_one_faulty_request_and_a_tail():
    sound = [torch.full((40,), 0.5) for _ in range(6)]
    base = serve_nemotron_h.gap_checks(sound)
    assert base == {"logit_gap": 0.5, "logit_gap_q90": 0.5}
    assert serve_nemotron_h.first_gap(sound) == 0.5
    # one lane of six wrong: the overall median does not move, the largest
    # per-request median does
    lane = sound[:5] + [torch.full((40,), 4.0)]
    assert float(torch.cat(lane).median()) == 0.5
    assert serve_nemotron_h.gap_checks(lane)["logit_gap"] == 4.0
    # a tenth of every request's positions wrong: the medians do not move,
    # the 90th percentile does
    tail = [torch.cat([torch.full((5,), 4.0), g[5:]]) for g in sound]
    assert serve_nemotron_h.gap_checks(tail) == {"logit_gap": 0.5, "logit_gap_q90": 4.0}
    # every request's first token (the prefill's output) wrong: a reading
    # for the stats, no check (the control's overlaps the program's)
    first = [torch.cat([torch.full((1,), 4.0), g[1:]]) for g in sound]
    assert serve_nemotron_h.first_gap(first) == 4.0
    assert serve_nemotron_h.gap_checks([torch.zeros(0)])["logit_gap"] == float("inf")


@pytest.mark.parametrize("program", ["cpu", "no_spans", "no_tally"])
def test_moe_readers_find_nothing(program):
    """A CPU run (no device time, no device trace), a program without
    ``model.moe`` spans or grouped GEMMs, or without the routing tally (the
    parent): the readers return None."""
    s = _moe_spans()
    stats = {"moe_stretch_least_s": 1e-3}
    trace = _devtrace(5e-3)
    if program == "cpu":
        s = [_span(x.name, x.t_start_us, x.dur_us) for x in s]
        trace = None
    elif program == "no_spans":
        s = [x for x in s if x.name != "model.moe"]
        trace = _devtrace()
    else:
        stats = {}
    run = _moe_run(s, stats)
    run.devtrace = trace
    assert harness.metric("serve_moe_roofline").read(run) is None
    if program != "no_tally":
        assert harness.metric("serve_moe_ms").read(run) is None
        assert harness.metric("serve_moe_prefill_ms").read(run) is None
