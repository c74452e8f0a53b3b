"""The port's serving slice against the reference's.

- Model: ``transformer.prefill`` / ``decode_step`` on the mamba2-780m smoke
  config (2 layers, chunk 8), reference params carried across with
  ``weights.params_from_jax``; a 16-token prompt (two chunks, so the state
  is carried) and 6 greedy decode steps. In float32 compute both sides run
  the same float32 algorithm and are held to rtol 2e-5 with an absolute
  floor of 2e-5 x the tensor's largest magnitude (summation order), and the
  greedy tokens are equal. In bf16 compute the reference's model scan
  (``ssd_chunked``) rounds the intra-chunk weights W to bf16 before the
  W x product while the Pallas kernel, and so the port, keeps W in float32;
  together with eager per-op bf16 rounding that is held to an absolute
  3e-2 x the tensor's largest magnitude (about 8 bf16 ulps of it).
- Transport (``requests``, ``engine``, ``audit``, ``elastic``), copies of
  the reference: the same workload and churn through both packages'
  ``ServingEngine`` + ``ReplicaFleet`` + ``NullDecoder`` give equal
  ``SlotRecord``s, summaries, token streams and audit verdicts, bit for bit.
- ``ModelDecoder``: one replica against the reference's one-replica decoder
  (float32 compute, same params): the same tokens. Two replicas folded into
  one batch, admitted at different times: each replica's stream equals a
  one-replica run of its own waves, and an idle replica's cache and ``pos``
  stay as they were, bit for bit. Against the reference's engine with two
  replicas (two forced JAX host devices, run as a child script, ``slow``):
  the same token streams.
- The launchers end to end on the CPU.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import archs as j_archs
from repro.constellation.scenario import smoke_scenario as j_smoke_scenario
from repro.launch import elastic as j_elastic
from repro.models import registry as j_registry
from repro_torch.configs import archs
from repro_torch.constellation.scenario import smoke_scenario
from repro_torch.launch import elastic
from repro_torch.models import registry
from repro_torch.weights import params_from_jax

ROOT = pathlib.Path(__file__).resolve().parents[1]
PROMPT, DECODE_STEPS = 16, 6


def _cfgs(compute_dtype="float32"):
    j = j_archs.smoke_cfg(j_archs.get("mamba2-780m")).replace(compute_dtype=compute_dtype)
    t = archs.smoke_cfg(archs.get("mamba2-780m")).replace(compute_dtype=compute_dtype)
    return j, t


@pytest.fixture(scope="module")
def ref_params():
    jcfg, _ = _cfgs()
    params, _ = j_registry.bundle(jcfg).init(jax.random.PRNGKey(0))
    return params


def _close(got, want, rtol, floor, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    atol = floor * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


# ---------------------------------------------------------------------------
# model: prefill and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(ref_params, compute_dtype):
    jcfg, tcfg = _cfgs(compute_dtype)
    jb, tb = j_registry.bundle(jcfg), registry.bundle(tcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, ref_params), "cpu")
    rtol, floor = (2e-5, 2e-5) if compute_dtype == "float32" else (0.0, 3e-2)
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size, (3, PROMPT)).astype(np.int32)
    jl, jc = jb.prefill_fn(ref_params, {"tokens": jnp.asarray(toks)}, 32)
    tl, tc = tb.prefill_fn(tp, {"tokens": torch.from_numpy(toks)}, 32)

    def check(step):
        _close(tl.numpy(), jl, rtol, floor, f"logits at step {step}")
        jm, tm = jc["units"]["mamba0"], tc["units"]["mamba0"]
        _close(tm.ssm.numpy(), jm.ssm, rtol, floor, f"ssm cache at step {step}")
        _close(tm.conv.to(torch.float32).numpy(), jm.conv.astype(jnp.float32), rtol, floor,
               f"conv cache at step {step}")
        assert tm.ssm.dtype == torch.float32 and tm.conv.dtype == getattr(torch, compute_dtype)
        assert int(tc["pos"]) == int(jc["pos"]) == PROMPT + step

    check(0)
    for step in range(1, DECODE_STEPS + 1):
        jt = np.argmax(np.asarray(jl)[:, -1], axis=-1)
        tt = torch.argmax(tl[:, -1], dim=-1).numpy()
        if compute_dtype == "float32":
            np.testing.assert_array_equal(tt, jt)
        jl, jc = jb.decode_fn(ref_params, jc, {"token": jnp.asarray(jt[:, None].astype(np.int32))})
        tl, tc = tb.decode_fn(tp, tc, {"token": torch.from_numpy(jt[:, None].astype(np.int64))})
        check(step)


def test_decode_steps_continue_the_prefill_scan(ref_params):
    """Prefill of a prompt then decode of its continuation == prefill of the
    whole sequence (the decode recurrence continues the chunked scan)."""
    _, tcfg = _cfgs()
    tb = registry.bundle(tcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, ref_params), "cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, 128, (2, 24)).astype(np.int64))
    whole_logits, whole = tb.prefill_fn(tp, {"tokens": toks}, 32)
    logits, cache = tb.prefill_fn(tp, {"tokens": toks[:, :16]}, 32)
    for t in range(16, 24):
        logits, cache = tb.decode_fn(tp, cache, {"token": toks[:, t:t + 1]})
    _close(logits.numpy(), whole_logits.numpy(), 1e-4, 1e-4, "last-token logits")
    _close(cache["units"]["mamba0"].ssm.numpy(), whole["units"]["mamba0"].ssm.numpy(),
           1e-4, 1e-4, "ssm state")
    assert int(cache["pos"]) == int(whole["pos"]) == 24


def test_conv_step_matches_reference():
    """``conv_step`` (one decode step of the causal depthwise conv) equals the
    reference's, and continues ``causal_conv`` over a sequence."""
    from repro.models import mamba2 as j_mamba
    from repro_torch.models import mamba2

    rng = np.random.default_rng(6)
    B, K, C, S = 3, 4, 10, 7
    x = rng.standard_normal((B, S, C)).astype(np.float32)
    w = rng.standard_normal((K, C)).astype(np.float32)
    b = rng.standard_normal((C,)).astype(np.float32)
    state = np.zeros((B, K - 1, C), np.float32)
    j_state, outs = jnp.asarray(state), []
    t_state = torch.from_numpy(state)
    for t in range(S):
        j_out, j_state = j_mamba.conv_step(jnp.asarray(x[:, t]), j_state, jnp.asarray(w),
                                           jnp.asarray(b))
        t_out, t_state = mamba2.conv_step(torch.from_numpy(x[:, t]), t_state,
                                          torch.from_numpy(w), torch.from_numpy(b))
        np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(t_state.numpy(), np.asarray(j_state), rtol=0, atol=0)
        outs.append(t_out)
    full = mamba2.causal_conv(*map(torch.from_numpy, (x, w, b)))
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(), rtol=1e-5, atol=1e-5)


def test_init_cache_and_other_families():
    _, tcfg = _cfgs()
    jcfg, _ = _cfgs()
    cache = registry.bundle(tcfg).init_cache(3, 32, "cpu")
    ref = j_registry.bundle(jcfg).init_cache(3, 32)
    for name in ("ssm", "conv"):
        got = getattr(cache["units"]["mamba0"], name)
        want = getattr(ref["units"]["mamba0"], name)
        assert tuple(got.shape) == want.shape and not got.any()
    assert int(cache["pos"]) == 0
    # the hybrid family (jamba), which raised here before it was ported:
    # its attention ring and 7 Mamba states, shaped as the reference's
    jamba = (j_archs.smoke_cfg(j_archs.get("jamba-1.5-large-398b")),
             archs.smoke_cfg(archs.get("jamba-1.5-large-398b")))
    got = registry.bundle(jamba[1]).init_cache(3, 32, "cpu")["units"]
    want = j_registry.bundle(jamba[0]).init_cache(3, 32)["units"]
    assert sorted(got) == sorted(want) == ["kv0"] + [f"mamba{j}" for j in range(1, 8)]
    for name, entry in got.items():
        for f, t in entry._asdict().items():
            w = getattr(want[name], f)
            assert tuple(t.shape) == w.shape and str(t.dtype)[6:] == str(w.dtype), (name, f)
            assert not t.any()


# ---------------------------------------------------------------------------
# transport: the copies against the reference, NullDecoder
# ---------------------------------------------------------------------------

CHURN_SCENARIOS = {
    # the reference's serving worker: replicas 0/2/4, fail at epoch // 3
    "worker": dict(replicas=[0, 2, 4], batch=2, max_new=4, n=8,
                   fail=lambda ep: (ep // 3, ep // 3 + max(2, ep // 4))),
    # the reference's example: replicas 0/3, fail mid-epoch
    "example": dict(replicas=[0, 3], batch=2, max_new=6, n=10,
                    fail=lambda ep: (ep // 2, ep // 2 + max(2, ep // 4))),
    "no-churn": dict(replicas=[0, 2, 4], batch=2, max_new=4, n=8, fail=None),
}


def _serve(pkg, scenario, decoder, sc, *, vocab=128, prompt_len=(4, 12)):
    scn = scenario()
    fleet = pkg.ReplicaFleet(sc["replicas"], sc["batch"], decoder)
    eng = pkg.ServingEngine.from_scenario(scn, fleet)
    work = pkg.synthesize_workload(sc["n"], scn.ground_ids, rate_per_slot=1.0,
                                   max_new=sc["max_new"], vocab=vocab, prompt_len=prompt_len)
    fail_at, restore_at = sc["fail"](eng.epoch) if sc["fail"] else (-1, -1)

    def on_slot(engine, slot):
        if slot == fail_at:
            engine.fail(sc["replicas"][0])
        elif slot == restore_at:
            engine.restore(sc["replicas"][0])

    report = eng.run(work, on_slot=on_slot)
    verdict = pkg.audit_serving_run(report.records, report.requests, eng.base_rels,
                                    gateways=eng.gateways, replicas=sc["replicas"])
    return report, verdict


def _plain(obj):
    """A dataclass tree as plain Python (field names and values)."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, (set, frozenset)):
        return sorted(_plain(v) for v in obj)
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj


@pytest.mark.parametrize("name", sorted(CHURN_SCENARIOS))
def test_transport_bitwise_against_reference(name):
    import repro.serving as j_serving

    import repro_torch.serving as serving

    sc = CHURN_SCENARIOS[name]
    R = len(sc["replicas"])
    jr, jv = _serve(j_serving, j_smoke_scenario, j_serving.NullDecoder(R, sc["batch"]), sc)
    tr, tv = _serve(serving, smoke_scenario, serving.NullDecoder(R, sc["batch"]), sc)
    assert _plain(tr.records) == _plain(jr.records)
    assert tr.summary() == jr.summary()
    assert [(r.rid, r.out, r.status, r.replica, r.retries) for r in tr.requests] == \
        [(r.rid, r.out, r.status, r.replica, r.retries) for r in jr.requests]
    assert tv.ok and jv.ok
    assert (tv.n_hops, tv.n_windows, tv.n_payloads) == (jv.n_hops, jv.n_windows, jv.n_payloads)
    assert _plain(tv.violations) == _plain(jv.violations)
    if sc["fail"]:
        assert tr.summary()["retries"] > 0


@pytest.mark.parametrize("grace", [0, 1, 2])
def test_replica_membership_matches_reference(grace):
    rng = np.random.default_rng(grace)
    replicas = [0, 2, 4, 5]
    mine, theirs = elastic.ReplicaMembership(replicas, grace), \
        j_elastic.ReplicaMembership(replicas, grace)
    for _ in range(60):
        visible = {int(v) for v in np.flatnonzero(rng.random(8) < 0.6)}
        a, b = mine.update(visible), theirs.update(visible)
        assert (a.drained, a.admitted, a.changed) == (b.drained, b.admitted, b.changed)
        assert (mine.active, mine.drained) == (theirs.active, theirs.drained)


def test_elastic_host_helpers_match_reference():
    from repro.core.schedule import round_robin_tournament as j_round_robin
    from repro_torch.core.schedule import round_robin_tournament

    mine, theirs = elastic.HealthTracker(5, 2.0), j_elastic.HealthTracker(5, 2.0)
    for node, t in [(0, 0.0), (1, 1.0), (3, 2.5), (4, 4.0)]:
        mine.beat(node, t)
        theirs.beat(node, t)
    for now in (1.0, 3.0, 5.0):
        assert mine.alive(now) == theirs.alive(now) and mine.dead(now) == theirs.dead(now)
    progress = np.array([5, 3, 7, 1])
    assert (elastic.SlotDeadline(2).participate(progress, 5)
            == j_elastic.SlotDeadline(2).participate(progress, 5)).all()
    got = elastic.reschedule(round_robin_tournament(6), {0, 1, 2, 4})
    want = j_elastic.reschedule(j_round_robin(6), {0, 1, 2, 4})
    assert [r.edge_list() for r in got] == [r.edge_list() for r in want]


# ---------------------------------------------------------------------------
# ModelDecoder
# ---------------------------------------------------------------------------

def _port_decoder(n_replicas, batch, params_np, cfg, max_len=40):
    from repro_torch.serving import ModelDecoder

    dec = ModelDecoder(cfg, n_replicas, batch, max_len, device="cpu")
    dec.params = params_from_jax(params_np, "cpu")
    return dec


def test_model_decoder_one_replica_matches_reference():
    """The engine with one replica, float32 compute: the port's decoder and
    the reference's (one CPU device) deliver the same token streams."""
    import repro.serving as j_serving

    import repro_torch.serving as serving

    jcfg, tcfg = _cfgs()
    sc = dict(replicas=[0], batch=2, max_new=5, n=6, fail=None)
    jdec = j_serving.ModelDecoder(jcfg, 1, 2, max_len=40)
    tdec = _port_decoder(1, 2, jax.tree.map(np.asarray, jdec.params), tcfg)
    jr, _ = _serve(j_serving, j_smoke_scenario, jdec, sc, prompt_len=(4, 20))
    tr, tv = _serve(serving, smoke_scenario, tdec, sc, prompt_len=(4, 20))
    assert tv.ok and not tr.summary()["undelivered"]
    assert [r.out for r in tr.requests] == [r.out for r in jr.requests]
    assert all(len(r.out) == 5 for r in tr.requests)


def _snapshot(dec, ridx):
    from repro_torch.pytree import tree_leaves

    return [leaf[ridx].clone() for leaf in tree_leaves(dec._cache["units"])], \
        int(dec._cache["pos"][ridx])


def test_model_decoder_folds_replicas_like_separate_runs(ref_params):
    """Two replicas folded into one batch with staggered admissions: each
    replica's tokens equal a one-replica decoder's run of its own waves, and
    its cache agrees at float32 rounding (rtol 1e-5: the folded matmuls have
    more rows); a replica outside a call keeps its cache and pos bit for
    bit."""
    _, tcfg = _cfgs()
    params_np = jax.tree.map(np.asarray, ref_params)
    rng = np.random.default_rng(4)

    def wave(*lengths):
        return [rng.integers(0, 128, n).astype(np.int32) for n in lengths]

    # a call pads every wave it admits to one bucket (as the reference does),
    # so waves admitted together here share theirs: 16 for a and c, 32 for b
    wave_a, wave_b, wave_c = wave(7, 12), wave(17), wave(10, 14)
    both = _port_decoder(2, 2, params_np, tcfg)
    solo = [_port_decoder(1, 2, params_np, tcfg) for _ in range(2)]
    streams = {0: [], 1: []}
    solo_streams = {0: [], 1: []}

    def prefill(waves):
        firsts = both.prefill_waves(waves)
        for r, w in waves.items():
            streams[r].append(firsts[r])
            solo_streams[r].append(solo[r].prefill_waves({0: w})[0])

    def step(active):
        toks = both.step(np.array(active))
        for r in (0, 1):
            if active[r]:
                streams[r].append(toks[r].tolist())
                solo_streams[r].append(solo[r].step(np.array([True]))[0].tolist())

    idle_cache, idle_pos = _snapshot(both, 1)
    prefill({0: wave_a})
    step([True, False])
    step([True, False])
    after_cache, after_pos = _snapshot(both, 1)
    assert idle_pos == after_pos == 0
    assert all(torch.equal(a, b) for a, b in zip(idle_cache, after_cache))
    prefill({1: wave_b})                   # replica 0 mid-wave, not re-prefilled
    step([True, True])
    step([True, True])
    frozen_cache, frozen_pos = _snapshot(both, 0)
    step([False, True])
    step([False, True])
    cache0, pos0 = _snapshot(both, 0)
    assert pos0 == frozen_pos == 16 + 4    # prefill bucket + 4 decode steps
    assert all(torch.equal(a, b) for a, b in zip(frozen_cache, cache0))
    prefill({0: wave_c, 1: wave_a})        # both admitted, different buckets
    step([True, True])
    assert streams == solo_streams
    assert int(both._cache["pos"][1]) == int(solo[1]._cache["pos"][0]) == 16 + 1
    for r in (0, 1):
        got, _ = _snapshot(both, r)
        want, _ = _snapshot(solo[r], 0)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.to(torch.float32).numpy(), b.to(torch.float32).numpy(),
                                       rtol=1e-5, atol=1e-6)


def _reference_two_replicas(out_path: str) -> None:
    """Child process (two forced JAX host devices): the reference engine
    with a two-replica ModelDecoder (float32 compute) under the example's
    churn; saves its params and every request's tokens."""
    import repro.serving as j_serving

    jcfg, _ = _cfgs()
    dec = j_serving.ModelDecoder(jcfg, 2, 2, max_len=40)
    report, verdict = _serve(j_serving, j_smoke_scenario, dec, CHURN_SCENARIOS["example"],
                             prompt_len=(4, 20))
    assert verdict.ok
    flat, _ = jax.tree_util.tree_flatten_with_path(dec.params)
    out = {"param/" + jax.tree_util.keystr(k): np.asarray(v) for k, v in flat}
    for r in report.requests:
        out[f"tokens/{r.rid}"] = np.asarray(r.out, np.int64)
    np.savez(out_path, **out)


@pytest.mark.slow
def test_model_decoder_two_replicas_match_reference_engine(tmp_path):
    """The example's churn with two replicas: the port (lanes folded) and the
    reference (one replica per device) deliver the same token streams."""
    import repro.serving as j_serving

    import repro_torch.serving as serving

    out = tmp_path / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=f"{ROOT / 'src'}:{ROOT / 'tests'}:" + os.environ.get("PYTHONPATH", ""))
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2 " + env.get("XLA_FLAGS", "")
    proc = subprocess.run([sys.executable, __file__, str(out)], capture_output=True,
                          text=True, env=env, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    saved = dict(np.load(out))
    jcfg, tcfg = _cfgs()
    shapes, _ = j_registry.param_specs(jcfg)
    flat, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    params_np = jax.tree_util.tree_unflatten(
        treedef, [saved["param/" + jax.tree_util.keystr(k)] for k, _ in flat])
    tdec = _port_decoder(2, 2, params_np, tcfg)
    report, verdict = _serve(serving, smoke_scenario, tdec, CHURN_SCENARIOS["example"],
                             prompt_len=(4, 20))
    assert verdict.ok and report.summary()["retries"] > 0
    assert {r.rid: r.out for r in report.requests} == \
        {int(k.split("/")[1]): v.tolist() for k, v in saved.items() if k.startswith("tokens/")}
    del j_serving


# ---------------------------------------------------------------------------
# launchers
# ---------------------------------------------------------------------------

def test_serve_constellation_model_smoke_on_cpu(capsys):
    from repro_torch import kernels
    from repro_torch.launch import serve_constellation

    before = kernels.launch_counts()
    res = serve_constellation.main(["--device", "cpu", "--model", "--smoke"])
    summ = res.report.summary()
    assert res.verdict.ok and summ["delivered"] == summ["n_requests"] == 10
    assert all(len(r.out) == serve_constellation.MAX_NEW for r in res.report.requests)
    assert summ["retries"] > 0                        # the mid-epoch failure re-routed
    out = capsys.readouterr().out
    assert "route-provenance audit" in out and "OK" in out and "restored" in out
    assert kernels.launch_counts() == before             # CPU tensors never reach the kernel


def test_serve_constellation_null_decoder_matches_reference_example():
    """Without --model the launcher is the reference example's run."""
    import repro.serving as j_serving

    from repro_torch.launch import serve_constellation

    res = serve_constellation.run(log=lambda _: None)
    sc = CHURN_SCENARIOS["example"]
    jr, _ = _serve(j_serving, j_smoke_scenario, j_serving.NullDecoder(2, 2), sc)
    assert res.report.summary() == jr.summary()
    assert [r.out for r in res.report.requests] == [r.out for r in jr.requests]


def test_model_entry_points_default_to_the_card(monkeypatch):
    from repro_torch.launch import serve, serve_constellation

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_constellation.main(["--model", "--smoke"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "mamba2-780m", "--smoke"])


def test_batched_server_on_cpu(capsys):
    """``launch.serve`` finishes its requests: the CLI, and the server
    driven directly, every request with its full output."""
    from repro_torch.launch import serve

    srv = serve.main(["--arch", "mamba2-780m", "--smoke", "--device", "cpu",
                      "--requests", "5", "--batch", "2", "--max-new", "4"])
    assert not srv.queue and not srv.active
    assert "served 5 requests, 20 tokens" in capsys.readouterr().out
    _, tcfg = _cfgs()
    srv = serve.BatchedServer(tcfg, 2, 32, device="cpu")
    rng = np.random.default_rng(0)
    reqs = [serve.Request(rid=i, prompt=rng.integers(0, 128, 6).astype(np.int32),
                          max_new=3 + i % 3) for i in range(5)]
    for r in reqs:
        srv.submit(r)
    while srv.step():
        pass
    assert [len(r.out) for r in reqs] == [r.max_new for r in reqs]


if __name__ == "__main__":
    _reference_two_replicas(sys.argv[1])
