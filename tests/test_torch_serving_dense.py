"""The port's dense-family serving slice against the reference's, on gemma2-9b
and, for the model itself, the other dense archs.

- Model: ``transformer.prefill`` / ``decode_step`` on the gemma2-9b smoke
  config (4 layers, local/global alternating, window 16, GQA 4/2, hd 16,
  softcaps) and on the smoke configs of gemma2-27b, granite-20b (MQA, the
  2-matrix MLP; 2 layers, every one global) and qwen2-72b (QKV bias, an
  untied head, rope theta 1e6), reference params carried across with
  ``weights.params_from_jax``; prompts of 14 tokens (shorter than the window:
  the local caches are padded, and decoding wraps their ring at position
  16) and 20 tokens (longer: the prefill writes the ring), then 4 greedy
  decode steps. Logits and the K/V caches of a local and a global layer:
  float32 compute within rtol 2e-5 with an absolute floor of 2e-5 x the
  tensor's largest magnitude (summation order), greedy tokens equal; bf16
  compute within 1.5e-2 x the tensor's largest magnitude (measured up to
  5.5e-3): the reference's prefill attention (``naive_attention``, S below its
  1024 block) rounds p to bf16 before the PV product while the port's
  attention keeps p in float32 (the Pallas kernel's function), and eager
  PyTorch rounds each bf16 op where XLA may fuse.
- ``_prefill_kv_cache``: both ring branches and the padded layout equal the
  reference's.
- ``weights.params_from_jax`` carries reference decode caches across
  (``KVCache`` and ``MambaCache`` keep their type, fields and values), and
  the port decodes on from a reference prefill's cache.
- ``ModelDecoder``: one replica against the reference's one-replica decoder
  (float32 compute, same params): the same tokens. Two replicas folded into
  one batch at different ``pos``: each replica's tokens and cache equal a
  one-replica run of its own waves.
- The launchers on the CPU with gemma2-9b: ``serve_constellation --model
  --smoke`` (the default arch; also mamba2-780m and jamba-1.5-large-398b)
  and the batched server.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import archs as j_archs
from repro.constellation.scenario import smoke_scenario as j_smoke_scenario
from repro.models import mamba2 as j_mamba
from repro.models import registry as j_registry
from repro.models import transformer as j_transformer
from repro_torch import kernels
from repro_torch.configs import archs
from repro_torch.constellation.scenario import smoke_scenario
from repro_torch.models import registry, transformer
from repro_torch.weights import params_from_jax
from test_torch_serving import _serve, _snapshot

ARCH = "gemma2-9b"
# the dense archs held to the reference: gemma2-27b (local/global, hd 128 at
# full size), granite-20b (MQA, the 2-matrix MLP), qwen2-72b (QKV bias, an
# untied head, rope theta 1e6)
DENSE_ARCHS = (ARCH, "gemma2-27b", "granite-20b", "qwen2-72b")
MAX_LEN, DECODE_STEPS = 27, 4


def _cfgs(compute_dtype="float32", arch=ARCH):
    j = j_archs.smoke_cfg(j_archs.get(arch)).replace(compute_dtype=compute_dtype)
    t = archs.smoke_cfg(archs.get(arch)).replace(compute_dtype=compute_dtype)
    return j, t


_REF_PARAMS = {}


def _ref_params_of(arch):
    if arch not in _REF_PARAMS:
        jcfg, _ = _cfgs(arch=arch)
        _REF_PARAMS[arch] = j_registry.bundle(jcfg).init(jax.random.PRNGKey(0))[0]
    return _REF_PARAMS[arch]


@pytest.fixture(scope="module")
def ref_params():
    return _ref_params_of(ARCH)


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else
                      np.asarray(x, np.float32), np.float32)


def _close(got, want, rtol, floor, what):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=floor * float(np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("prompt", [14, 20])
def test_prefill_and_decode_match_reference(prompt, compute_dtype, arch):
    ref_params = _ref_params_of(arch)
    jcfg, tcfg = _cfgs(compute_dtype, arch)
    local = tcfg.local_global_alternate
    assert [d.local for d in transformer.scan_unit(tcfg)] == ([True, False] if local else
                                                              [False])
    names = ("kv0", "kv1") if local else ("kv0",)      # local (ring of 16), global (27)
    jb, tb = j_registry.bundle(jcfg), registry.bundle(tcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, ref_params), "cpu")
    rtol, floor = (2e-5, 2e-5) if compute_dtype == "float32" else (0.0, 1.5e-2)
    toks = np.random.default_rng(prompt).integers(0, tcfg.vocab_size, (3, prompt))
    jl, jc = jb.prefill_fn(ref_params, {"tokens": jnp.asarray(toks, jnp.int32)}, MAX_LEN)
    tl, tc = tb.prefill_fn(tp, {"tokens": torch.from_numpy(toks)}, MAX_LEN)

    def check(step):
        _close(tl, jl, rtol, floor, f"logits at step {step}")
        for name in names:
            for f in ("k", "v"):
                got = getattr(tc["units"][name], f)
                _close(got, getattr(jc["units"][name], f), rtol, floor,
                       f"{name}.{f} at step {step}")
                assert got.dtype == getattr(torch, compute_dtype)
        assert tc["units"][names[-1]].k.shape[2] == MAX_LEN
        assert not local or tc["units"]["kv0"].k.shape[2] == 16
        assert int(tc["pos"]) == int(jc["pos"]) == prompt + step

    check(0)
    for step in range(1, DECODE_STEPS + 1):
        jt = np.argmax(np.asarray(jl)[:, -1], axis=-1)
        tt = torch.argmax(tl[:, -1], dim=-1).numpy()
        if compute_dtype == "float32":
            np.testing.assert_array_equal(tt, jt)
        jl, jc = jb.decode_fn(ref_params, jc, {"token": jnp.asarray(jt[:, None], jnp.int32)})
        tl, tc = tb.decode_fn(tp, tc, {"token": torch.from_numpy(jt[:, None])})
        check(step)


@pytest.mark.parametrize("S", [8, 16, 20, 37])
def test_prefill_kv_cache_layouts_match_reference(S):
    """Local layers: padded (S < W), the ring written from the prompt's tail
    (S >= W); global layers: padded to max_len."""
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(S)
    k, v = (rng.standard_normal((2, S, 2, 16)).astype(np.float32) for _ in range(2))
    for local in (True, False):
        for max_len in (23, 40):
            if not local and S > max_len:
                continue
            got = transformer._prefill_kv_cache(
                torch.from_numpy(k), torch.from_numpy(v), tcfg,
                transformer.LayerDesc("attn", local=local, ffn="dense"), max_len)
            want = j_transformer._prefill_kv_cache(
                jnp.asarray(k), jnp.asarray(v), jcfg,
                j_transformer.LayerDesc("attn", local=local, ffn="dense"), max_len)
            assert isinstance(got, transformer.KVCache)
            np.testing.assert_array_equal(got.k.numpy(), np.asarray(want.k))
            np.testing.assert_array_equal(got.v.numpy(), np.asarray(want.v))


def test_weights_carry_reference_caches():
    """A reference ``KVCache`` and ``MambaCache`` (bf16 and f32 leaves)
    convert field by field and keep their types and values."""
    rng = np.random.default_rng(5)
    k = jnp.asarray(rng.standard_normal((2, 6, 2, 4)), jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((2, 6, 2, 4)), jnp.bfloat16)
    ssm = jnp.asarray(rng.standard_normal((2, 3, 4, 5)), jnp.float32)
    conv = jnp.asarray(rng.standard_normal((2, 3, 7)), jnp.bfloat16)
    tree = {"pos": jnp.asarray(6, jnp.int32),
            "units": {"kv0": j_transformer.KVCache(k=k, v=v),
                      "mamba1": j_mamba.MambaCache(ssm=ssm, conv=conv)}}
    got = params_from_jax(jax.tree.map(np.asarray, tree), "cpu")
    kv, mc = got["units"]["kv0"], got["units"]["mamba1"]
    assert type(kv) is j_transformer.KVCache and kv._fields == ("k", "v")
    assert type(mc) is j_mamba.MambaCache and mc._fields == ("ssm", "conv")
    for t, want, dt in ((kv.k, k, torch.bfloat16), (kv.v, v, torch.bfloat16),
                        (mc.ssm, ssm, torch.float32), (mc.conv, conv, torch.bfloat16)):
        assert isinstance(t, torch.Tensor) and t.dtype == dt and t.shape == want.shape
        np.testing.assert_array_equal(_np(t), np.asarray(want, np.float32))
    assert int(got["pos"]) == 6


def test_decode_continues_a_reference_prefill_cache(ref_params):
    """The reference's prefill cache, carried across: the port's decode
    steps from it give the reference's logits (float32 compute)."""
    jcfg, tcfg = _cfgs()
    jb, tb = j_registry.bundle(jcfg), registry.bundle(tcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, ref_params), "cpu")
    toks = np.random.default_rng(9).integers(0, tcfg.vocab_size, (2, 18))
    jl, jc = jb.prefill_fn(ref_params, {"tokens": jnp.asarray(toks, jnp.int32)}, MAX_LEN)
    tc = params_from_jax(jax.tree.map(np.asarray, jc), "cpu")
    for _ in range(3):
        tok = np.argmax(np.asarray(jl)[:, -1], axis=-1)[:, None]
        jl, jc = jb.decode_fn(ref_params, jc, {"token": jnp.asarray(tok, jnp.int32)})
        tl, tc = tb.decode_fn(tp, tc, {"token": torch.from_numpy(tok)})
        _close(tl, jl, 2e-5, 2e-5, "logits")


def _port_decoder(n_replicas, batch, params_np, cfg, max_len=40):
    from repro_torch.serving import ModelDecoder

    dec = ModelDecoder(cfg, n_replicas, batch, max_len, device="cpu")
    dec.params = params_from_jax(params_np, "cpu")
    return dec


def test_model_decoder_one_replica_matches_reference():
    """The engine with one replica, float32 compute: the port's decoder and
    the reference's (one CPU device) deliver the same token streams
    (prompts up to 20 tokens, so buckets 8 to 32 and the local ring)."""
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


def test_model_decoder_folds_replicas_at_different_pos(ref_params):
    """Two replicas folded into one batch, admitted at different times so
    their ``pos`` differ in the shared decode steps (rope, cache slot and
    kv_len per lane): each replica's tokens equal a one-replica decoder's
    run of its own waves, and its caches agree at float32 rounding (rtol
    1e-5: the folded matmuls have more rows)."""
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
    step([True, False])
    prefill(1, wave_b)                     # bucket 32, replica 0 at pos 18
    for _ in range(5):                     # pos 18-22 and 32-36, rings wrapped
        step([True, True])
    assert [int(p) for p in both._cache["pos"]] == [16 + 7, 32 + 5]
    assert streams == solo_streams
    for r in (0, 1):
        got, _ = _snapshot(both, r)
        want, _ = _snapshot(solo[r], 0)
        for a, b in zip(got, want):
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", [None, "mamba2-780m", "jamba-1.5-large-398b"])
def test_serve_constellation_model_smoke_on_cpu(arch, capsys):
    """``--model --smoke`` on the CPU, gemma2-9b by default (and the ssm and
    hybrid families): 10 of 10 delivered, the audit clean, and no kernel
    launched."""
    from repro_torch.launch import serve_constellation

    before = kernels.launch_counts()
    argv = ["--device", "cpu", "--model", "--smoke"] + (["--arch", arch] if arch else [])
    res = serve_constellation.main(argv)
    summ = res.report.summary()
    assert res.decoder.cfg.name == (arch or ARCH)
    assert res.verdict.ok and summ["delivered"] == summ["n_requests"] == 10
    assert all(len(r.out) == serve_constellation.MAX_NEW for r in res.report.requests)
    assert summ["retries"] > 0
    out = capsys.readouterr().out
    assert "route-provenance audit" in out and "OK" in out
    assert kernels.launch_counts() == before


def test_batched_server_serves_gemma2_smoke(capsys):
    from repro_torch.launch import serve

    srv = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "3",
                      "--batch", "2", "--max-new", "3"])
    assert not srv.queue and not srv.active
    assert "served 3 requests, 9 tokens" in capsys.readouterr().out
