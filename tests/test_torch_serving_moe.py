"""The port's MoE serving slice against the reference's, on qwen3-moe-30b-a3b.

Every test runs the qwen3-moe smoke config (2 layers, 4 experts top-2,
expert d_ff 32, GQA 4/2, hd 16) at a binding capacity factor of 0.5, so that
experts overflow at prefill and at decode, and asserts that drops happened
(the smoke config's own factor of 4.0 never drops, which would hide a
dispatch that groups tokens wrongly). Reference params are carried across
with ``weights.params_from_jax``.

- Model: ``transformer.prefill`` / ``decode_step`` against the reference's,
  on qwen3-moe and on kimi-k2-1t-a32b's smoke config (2 layers, bf16
  params as published, an untied head),
  prompts of 16 tokens, then 4 greedy decode steps of 3 lanes (one decode
  group of 3 tokens on both sides). Logits and the K/V cache: float32
  compute within rtol 2e-5 with an absolute floor of 2e-5 x the tensor's
  largest magnitude (summation order), greedy tokens equal; bf16 compute
  within 2e-2 x the largest magnitude (the reference's bf16 ``silu`` rounds
  its sigmoid first, and eager PyTorch rounds each bf16 op where XLA may
  fuse).
- ``ModelDecoder`` with two replicas folded into one batch at different
  ``pos``: each replica's tokens equal a one-replica decoder's run of its
  own waves (each replica is its own MoE decode group), and its caches agree
  at float32 rounding.
- Against the reference's two-replica decoder (two forced JAX host devices,
  one replica per device, run as a child script, ``slow``): under the
  example's churn both engines deliver the same tokens, request for
  request. With every decode tick routed as one group (``groups`` ignored),
  the tokens differ: the test that fails without per-replica groups.
- ``serve_constellation --model --smoke --arch qwen3-moe-30b-a3b`` and the
  batched server on the CPU: every request delivered, the audit clean.
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
from repro.models import registry as j_registry
from repro_torch.configs import archs
from repro_torch.constellation.scenario import smoke_scenario
from repro_torch.kernels.flash_attention import flash_attention as fa_kern
from repro_torch.models import moe, registry, transformer
from repro_torch.weights import params_from_jax
from test_torch_serving import CHURN_SCENARIOS, _serve, _snapshot

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "qwen3-moe-30b-a3b"
BINDING_CF = 0.5
PROMPT, MAX_LEN, DECODE_STEPS = 16, 27, 4


def _cfgs(compute_dtype="float32", arch=ARCH):
    out = []
    for pkg in (j_archs, archs):
        c = pkg.smoke_cfg(pkg.get(arch))
        out.append(c.replace(compute_dtype=compute_dtype,
                             moe=dataclasses.replace(c.moe, capacity_factor=BINDING_CF)))
    return tuple(out)


_REF_PARAMS = {}


def _ref_params_of(arch):
    if arch not in _REF_PARAMS:
        jcfg, _ = _cfgs(arch=arch)
        _REF_PARAMS[arch] = j_registry.bundle(jcfg).init(jax.random.PRNGKey(0))[0]
    return _REF_PARAMS[arch]


@pytest.fixture(scope="module")
def ref_params():
    return _ref_params_of(ARCH)


def _dropped(tally, kind) -> int:
    """Assignments dropped over capacity in the calls of ``kind``."""
    return sum(int(t[1]) for t in tally[kind])


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else
                      np.asarray(jnp.asarray(x).astype(jnp.float32)), np.float32)


def _close(got, want, rtol, floor, what):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=floor * float(np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("arch", [ARCH, "kimi-k2-1t-a32b"])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(compute_dtype, arch):
    ref_params = _ref_params_of(arch)
    jcfg, tcfg = _cfgs(compute_dtype, arch)
    assert [d.ffn for d in transformer.scan_unit(tcfg)] == ["moe"]
    jb, tb = j_registry.bundle(jcfg), registry.bundle(tcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, ref_params), "cpu")
    rtol, floor = (2e-5, 2e-5) if compute_dtype == "float32" else (0.0, 2e-2)
    toks = np.random.default_rng(7).integers(0, tcfg.vocab_size, (3, PROMPT))
    jl, jc = jb.prefill_fn(ref_params, {"tokens": jnp.asarray(toks, jnp.int32)}, MAX_LEN)
    with moe.count_drops() as tally:
        tl, tc = tb.prefill_fn(tp, {"tokens": torch.from_numpy(toks)}, MAX_LEN)

        def check(step):
            _close(tl, jl, rtol, floor, f"logits at step {step}")
            for f in ("k", "v"):
                got = getattr(tc["units"]["kv0"], f)
                _close(got, getattr(jc["units"]["kv0"], f), rtol, floor, f"kv0.{f} at {step}")
                assert got.dtype == getattr(torch, compute_dtype)
            assert int(tc["pos"]) == int(jc["pos"]) == PROMPT + step

        check(0)
        for step in range(1, DECODE_STEPS + 1):
            jt = np.argmax(np.asarray(jl)[:, -1], axis=-1)
            tt = torch.argmax(tl[:, -1], dim=-1).numpy()
            if compute_dtype == "float32":
                np.testing.assert_array_equal(tt, jt)
            jl, jc = jb.decode_fn(ref_params, jc, {"token": jnp.asarray(jt[:, None], jnp.int32)})
            tl, tc = tb.decode_fn(tp, tc, {"token": torch.from_numpy(jt[:, None])})
            check(step)
    assert _dropped(tally, "prefill") > 0 and _dropped(tally, "decode") > 0


def _port_decoder(n_replicas, batch, params_np, cfg, max_len=40):
    from repro_torch.serving import ModelDecoder

    dec = ModelDecoder(cfg, n_replicas, batch, max_len, device="cpu")
    dec.params = params_from_jax(params_np, "cpu")
    return dec


def test_model_decoder_folds_replicas_at_different_pos(ref_params):
    """Two replicas folded into one batch, admitted at different times: each
    replica's tokens equal a one-replica decoder's run of its own waves, and
    its caches agree at float32 rounding (rtol 1e-5: the folded products
    have more rows). Drops happen in the shared ticks."""
    _, tcfg = _cfgs()
    params_np = jax.tree.map(np.asarray, ref_params)
    rng = np.random.default_rng(4)
    wave_a = [rng.integers(0, 128, n).astype(np.int32) for n in (7, 12)]
    wave_b = [rng.integers(0, 128, n).astype(np.int32) for n in (17, 30)]
    both = _port_decoder(2, 2, params_np, tcfg)
    solo = [_port_decoder(1, 2, params_np, tcfg) for _ in range(2)]
    streams, solo_streams = {0: [], 1: []}, {0: [], 1: []}

    def prefill(r, w):
        streams[r].append(both.prefill_waves({r: w})[r])
        solo_streams[r].append(solo[r].prefill_waves({0: w})[0])

    def step(active):
        toks = both.step(np.array(active))
        for r in (0, 1):
            if active[r]:
                streams[r].append(toks[r].tolist())
                solo_streams[r].append(solo[r].step(np.array([True]))[0].tolist())

    prefill(0, wave_a)                     # bucket 16
    step([True, False])
    prefill(1, wave_b)                     # bucket 32, replica 0 at pos 17
    with moe.count_drops() as tally:
        for _ in range(5):
            step([True, True])
    assert _dropped(tally, "decode") > 0
    assert [int(p) for p in both._cache["pos"]] == [16 + 6, 32 + 5]
    assert streams == solo_streams
    for r in (0, 1):
        got, _ = _snapshot(both, r)
        want, _ = _snapshot(solo[r], 0)
        for a, b in zip(got, want):
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-6)


def _reference_two_replicas(out_path: str) -> None:
    """Child process (two forced JAX host devices): the reference engine
    with a two-replica ModelDecoder (float32 compute, binding capacity)
    under the example's churn; saves its params and every request's
    tokens."""
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


@pytest.fixture(scope="module")
def reference_two_replicas(tmp_path_factory):
    out = tmp_path_factory.mktemp("moe_ref") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=f"{ROOT / 'src'}:{ROOT / 'tests'}:" + os.environ.get("PYTHONPATH", ""))
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2 " + env.get("XLA_FLAGS", "")
    proc = subprocess.run([sys.executable, __file__, str(out)], capture_output=True,
                          text=True, env=env, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(out))


@pytest.mark.slow
@pytest.mark.parametrize("grouping", ["per-replica", "one-group"])
def test_model_decoder_two_replicas_match_reference_engine(reference_two_replicas,
                                                           monkeypatch, grouping):
    """The example's churn with two replicas: the port (lanes folded, one MoE
    decode group per replica) and the reference (one replica per device)
    deliver the same tokens. Routing every tick as one group instead, the
    tokens differ from the reference's."""
    import repro_torch.serving as serving

    saved = reference_two_replicas
    jcfg, tcfg = _cfgs()
    shapes, _ = j_registry.param_specs(jcfg)
    flat, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    params_np = jax.tree_util.tree_unflatten(
        treedef, [saved["param/" + jax.tree_util.keystr(k)] for k, _ in flat])
    if grouping == "one-group":
        apply = moe.moe_apply
        monkeypatch.setattr(moe, "moe_apply",
                            lambda p, x, cfg, groups=None: apply(p, x, cfg))
    tdec = _port_decoder(2, 2, params_np, tcfg)
    with moe.count_drops() as tally:
        report, verdict = _serve(serving, smoke_scenario, tdec, CHURN_SCENARIOS["example"],
                                 prompt_len=(4, 20))
    assert verdict.ok and report.summary()["retries"] > 0
    assert _dropped(tally, "decode") > 0
    got = {r.rid: r.out for r in report.requests}
    want = {int(k.split("/")[1]): v.tolist() for k, v in saved.items()
            if k.startswith("tokens/")}
    assert (got == want) == (grouping == "per-replica")


def test_serve_constellation_model_smoke_on_cpu(capsys):
    """``--model --smoke --arch qwen3-moe-30b-a3b`` on the CPU (the smoke
    config's own capacity factor): 10 of 10 delivered, the audit clean, and
    no kernel launched."""
    from repro_torch.launch import serve_constellation

    before = fa_kern.launch_counts()
    res = serve_constellation.main(["--device", "cpu", "--model", "--smoke", "--arch", ARCH])
    summ = res.report.summary()
    assert res.decoder.cfg.name == ARCH and res.decoder.cfg.moe is not None
    assert res.verdict.ok and summ["delivered"] == summ["n_requests"] == 10
    assert all(len(r.out) == serve_constellation.MAX_NEW for r in res.report.requests)
    assert summ["retries"] > 0
    out = capsys.readouterr().out
    assert "route-provenance audit" in out and "OK" in out
    assert fa_kern.launch_counts() == before


def test_batched_server_serves_moe_smoke(capsys):
    from repro_torch.launch import serve

    srv = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "3",
                      "--batch", "2", "--max-new", "3"])
    assert not srv.queue and not srv.active
    assert "served 3 requests, 9 tokens" in capsys.readouterr().out


if __name__ == "__main__":
    _reference_two_replicas(sys.argv[1])
