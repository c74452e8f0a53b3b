"""nemotron-3-nano-30b-a3b (``nemotron_h``) in the port against its plain
float32 reference, ``tests/nemotron_h_ref.py`` (the port's own model: the
JAX package has no counterpart).

Every model test runs the smoke config (``archs.smoke_cfg``: the pattern
``ME*`` twice, d_model 64, Mamba-2 at 6 heads x 8 in 2 groups, so d_inner
48 is not ``expand * d_model``, with the norm per group of 24 channels;
attention 4 query heads over 2 kv heads, hd 16, no rope; 16 experts top-4
of width 32 and a shared expert of 48, sigmoid routing with a selection
bias and scale 2.5; vocabulary 128):

- prefill of 16 tokens, then 8 tokens decoded through the cache, against the
  reference's full forward over the 24: float32 compute within 2e-5 of the
  logits' largest magnitude (summation order: the port's chunked SSD,
  grouped expert products and f32 combine add in other orders than the
  reference), bfloat16 params and compute within 5e-2 of their norm
  (``||a - b|| / ||b||``; each bf16 product and activation rounds; 1-2%
  measured) at top-k = n_experts, where no rounding can flip a routing
  choice;
- ``ModelDecoder`` with two replicas folded at different ``pos``: each
  replica's tokens equal a one-replica decoder's, and each served token's
  reference logit lies within 2e-5 of the best at its position;
- the training forward over the same 24 tokens, and the loss's gradient
  reaching every leaf but the router's selection bias;
- the dropless MoE under adversarial routing (every token on the same 4
  experts): nothing dropped, the tally's counts, the reference's output;
- the grouped gated norm against the whole-d_inner norm;
- the planted faults of the reference, each outside the float32 tolerance;
- the published sizes: 31 577 940 288 parameters on meta tensors;
- the two copies of the reference (here and ``portbench/refs/``) alike.
"""

from __future__ import annotations

import pathlib

import numpy as np
import pytest
import torch

import nemotron_h_ref as ref
from repro_torch.configs import archs
from repro_torch.launch.steps import _OnMeta
from repro_torch.models import mamba2 as mamba_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import registry, transformer
from repro_torch.pytree import tree_leaves, tree_map
from repro_torch.serving import ModelDecoder

ARCH = "nemotron-3-nano-30b-a3b"
ROOT = pathlib.Path(__file__).resolve().parents[1]
F32_TOL = 2e-5          # of the logits' largest magnitude
BF16_TOL = 5e-2         # of the logits' norm


def ref_cfg(cfg) -> dict:
    """The port's config under the published config.json's key names."""
    mb, m = cfg.mamba, cfg.moe
    return {
        "hidden_size": cfg.d_model, "vocab_size": cfg.vocab_size,
        "num_hidden_layers": cfg.n_layers, "hybrid_override_pattern": cfg.pattern,
        "mamba_num_heads": mb.heads, "mamba_head_dim": mb.head_dim, "n_groups": mb.n_groups,
        "ssm_state_size": mb.d_state, "conv_kernel": mb.d_conv, "chunk_size": mb.chunk,
        "num_attention_heads": cfg.n_heads, "num_key_value_heads": cfg.n_kv_heads,
        "head_dim": cfg.head_dim, "n_routed_experts": m.n_experts,
        "num_experts_per_tok": m.top_k, "moe_intermediate_size": m.d_ff,
        "moe_shared_expert_intermediate_size": m.shared_d_ff,
        "routed_scaling_factor": m.routed_scale, "intermediate_size": cfg.d_ff,
        "layer_norm_epsilon": cfg.norm_eps, "norm_eps": cfg.norm_eps, "rope_theta": 10000.0,
    }


def smoke(dtype: str = "float32"):
    cfg = archs.smoke_cfg(archs.get(ARCH))
    return cfg.replace(param_dtype=dtype, compute_dtype=dtype)


def _params(cfg, seed: int = 0):
    return registry.bundle(cfg).init(torch.Generator().manual_seed(seed))


def ref_logits(params, tokens, cfg, fault=None) -> torch.Tensor:
    with ref.exact_matmuls():
        return ref.logits(params, ref.hidden(params, torch.as_tensor(tokens).long(),
                                             ref_cfg(cfg), fault=fault))


def port_logits(params, tokens: torch.Tensor, cfg, n_prompt: int) -> torch.Tensor:
    """Logits at every position from ``n_prompt - 1`` on: the prefill's last,
    then one decode step per remaining token. (S - n_prompt + 1, V) f32."""
    b = registry.bundle(cfg)
    lg, cache = b.prefill_fn(params, {"tokens": tokens[None, :n_prompt]}, tokens.numel() + 1)
    out = [lg[0, -1]]
    for t in range(n_prompt, tokens.numel()):
        lg, cache = b.decode_fn(params, cache, {"token": tokens[None, t:t + 1]})
        out.append(lg[0, -1])
    return torch.stack(out).float()


def _tokens(n: int, seed: int = 1) -> torch.Tensor:
    return torch.as_tensor(np.random.default_rng(seed).integers(0, 128, n)).long()


@pytest.fixture(scope="module")
def f32_run():
    cfg = smoke()
    params = _params(cfg)
    tokens = _tokens(24)
    with torch.no_grad():
        got = port_logits(params, tokens, cfg, 16)
    want = ref_logits(params, tokens, cfg)[15:]
    return cfg, params, tokens, got, want


def test_smoke_config_shapes():
    cfg = smoke()
    assert cfg.pattern == "ME*" and cfg.n_layers == 6 and transformer.n_units(cfg) == 2
    assert cfg.mamba.d_inner(cfg.d_model) == 48 != cfg.mamba.expand * cfg.d_model
    assert cfg.n_heads // cfg.n_kv_heads == 2 and cfg.mamba.n_groups == 2
    assert (cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.shared_d_ff) == (16, 4, 48)
    p = _params(cfg)
    assert set(p["units"]["L1"]) == {"ln", "ffn"} and set(p["units"]["L2"]) == {"ln", "attn"}
    assert set(p["units"]["L1"]["ffn"]) == {"router", "router_bias", "wi", "wo", "shared"}
    assert sum(t.numel() for t in tree_leaves(p)) == cfg.param_count()


def test_prefill_then_decode_matches_reference_f32(f32_run):
    _, _, _, got, want = f32_run
    err = float((got - want).abs().max())
    assert err <= F32_TOL * float(want.abs().max()), err


def test_prefill_then_decode_matches_reference_bf16():
    """At top-k = n_experts, where no bf16 rounding can flip a routing
    choice (at top-4 a flipped expert moves a position's logits by up to
    70% of their norm, measured; sigmoid routing is discontinuous)."""
    cfg = smoke("bfloat16")
    cfg = cfg.replace(moe=cfg.moe.__class__(**{**cfg.moe.__dict__, "top_k": 16}))
    params = _params(cfg)
    tokens = _tokens(24)
    with torch.no_grad():
        got = port_logits(params, tokens, cfg, 16)
    want = ref_logits(params, tokens, cfg)[15:]
    rel = float((got - want).norm() / want.norm())
    assert rel <= BF16_TOL, rel


def test_training_forward_matches_reference_f32(f32_run):
    """``forward_train`` (the chunked SSD with autograd, attention through
    ``flash_attention_train``) over all 24 tokens gives the reference's
    logits within the float32 tolerance, and the loss's gradient reaches
    every leaf but the selection bias, finite (the router's through the
    chosen scores)."""
    cfg, params, tokens, _, _ = f32_run
    want = ref_logits(params, tokens, cfg)
    h, aux = transformer.forward_train(params, tokens[None], cfg)
    got = transformer.lm_logits(params["embed"], h, cfg)[0]
    err = float((got - want).abs().max())
    assert err <= F32_TOL * float(want.abs().max()), err
    assert float(aux["moe_aux"]) == 0.0 == float(aux["moe_zloss"])
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = transformer.loss_fn(params, {"tokens": tokens[None, :16],
                                           "labels": tokens[None, 1:17]},
                                  cfg.replace(loss_chunk=8))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    for t in leaves:
        t.requires_grad_(False)
    grad_of = {id(t): g for t, g in zip(leaves, grads)}
    biases = {id(params["units"][f"L{j}"]["ffn"]["router_bias"])
              for j, kind in enumerate(cfg.pattern) if kind == "E"}
    for t in leaves:
        if id(t) in biases:             # selection only: no gradient, as published
            assert grad_of[id(t)] is None
        else:
            assert grad_of[id(t)] is not None and bool(torch.isfinite(grad_of[id(t)]).all())
    assert float(grad_of[id(params["units"]["L1"]["ffn"]["router"])].abs().max()) > 0


@pytest.mark.parametrize("fault", ref.FAULTS)
def test_planted_faults_are_caught(f32_run, fault):
    cfg, params, tokens, got, _ = f32_run
    bad = ref_logits(params, tokens, cfg, fault=fault)[15:]
    err = float((got - bad).abs().max())
    assert err > 10 * F32_TOL * float(bad.abs().max()), (fault, err)


def test_model_decoder_two_replicas_folded_at_different_pos():
    cfg = smoke()
    params = _params(cfg, seed=2)
    rng = np.random.default_rng(4)
    wave_a = [rng.integers(0, 128, n).astype(np.int32) for n in (7, 12)]
    wave_b = [rng.integers(0, 128, n).astype(np.int32) for n in (17, 30)]
    both = ModelDecoder(cfg, 2, 2, 48, device="cpu", params=params)
    solo = [ModelDecoder(cfg, 1, 2, 48, device="cpu", params=params) for _ in range(2)]
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
    for _ in range(5):
        step([True, True])
    assert [int(p) for p in both._cache["pos"]] == [16 + 7, 32 + 5]
    assert streams == solo_streams
    for r, (wave, bucket) in enumerate(((wave_a, 16), (wave_b, 32))):
        for lane, prompt in enumerate(wave):
            served = [s[lane] for s in streams[r]]
            seq = np.concatenate([np.zeros(bucket - len(prompt), np.int64), prompt,
                                  np.asarray(served[:-1], np.int64)])
            lg = ref_logits(params, seq, cfg)[bucket - 1:]
            gap = lg.max(-1).values - lg.gather(1, torch.as_tensor(served)[:, None])[:, 0]
            assert float(gap.max()) <= F32_TOL * float(lg.abs().max()), (r, lane)


def test_model_decoder_given_params_draws_nothing(monkeypatch):
    cfg = smoke()
    params = _params(cfg)

    def refuse(*a, **k):
        raise AssertionError("drew params")

    monkeypatch.setattr(registry.ModelBundle, "init", refuse)
    dec = ModelDecoder(cfg, 2, 2, 16, device="cpu", params=params)
    assert dec.params is params
    with pytest.raises(AssertionError, match="drew"):
        ModelDecoder(cfg, 2, 2, 16, device="cpu")


def test_dropless_under_adversarial_routing():
    """Every token chooses the same 4 experts (a zero router and a bias on
    experts 3, 5, 9, 12): all 4 x T assignments computed, none dropped, the
    output the reference's."""
    cfg = smoke()
    p = dict(_params(cfg)["units"]["L1"]["ffn"])
    p = tree_map(lambda t: t[0].clone(), p)
    p["router"].zero_()
    p["router_bias"].zero_()
    p["router_bias"][[3, 5, 9, 12]] = torch.tensor([0.4, 0.3, 0.2, 0.1])
    x = torch.randn(3, 8, cfg.d_model, generator=torch.Generator().manual_seed(5))
    with moe_lib.count_routes() as tally, torch.no_grad():
        out, aux = moe_lib.moe_apply(p, x, cfg)
    (entry,) = tally["prefill"]
    assert entry.tolist() == [3 * 8 * 4, 4, 0]
    with ref.exact_matmuls():
        want = ref.moe(p, x.reshape(24, -1), ref_cfg(cfg), "f32", None)
    torch.testing.assert_close(out.reshape(24, -1), want, rtol=1e-5, atol=1e-6)
    assert float(aux["moe_aux"]) == 0.0
    # one token per lane at decode: the same experts, logged under "decode"
    with moe_lib.count_routes() as tally, torch.no_grad():
        moe_lib.moe_apply(p, x[:, :1], cfg)
    assert tally["decode"][0].tolist() == [3 * 4, 4, 0]


def test_dropless_refuses_gated_experts():
    """The dropless path's experts have no gate: a config asking for one is
    refused when its params are drawn and when the layer runs."""
    cfg = smoke()
    gated = cfg.replace(gated_mlp=True)
    with pytest.raises(ValueError, match="without a gate"):
        moe_lib.init_moe(torch.Generator().manual_seed(0), gated)
    p = tree_map(lambda t: t[0].clone(), dict(_params(cfg)["units"]["L1"]["ffn"]))
    with pytest.raises(ValueError, match="without a gate"), torch.no_grad():
        moe_lib.moe_apply(p, torch.zeros(1, 2, cfg.d_model), gated)


def test_grouped_norm_against_whole_norm():
    cfg = smoke()
    y = torch.randn(2, 3, 48, generator=torch.Generator().manual_seed(1))
    z = torch.randn(2, 3, 48, generator=torch.Generator().manual_seed(2))
    scale = 0.1 * torch.randn(48, generator=torch.Generator().manual_seed(3))
    whole = cfg.replace(mamba=cfg.mamba.__class__(**{**cfg.mamba.__dict__,
                                                      "norm_per_group": False}))
    got = mamba_lib.gated_norm(y, z, scale, cfg)
    g = (y * torch.nn.functional.silu(z)).reshape(2, 3, 2, 24)
    want = g * torch.rsqrt(g.square().mean(-1, keepdim=True) + cfg.norm_eps)
    want = (want * (1 + scale.reshape(2, 24))).reshape(2, 3, 48)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    flat = mamba_lib.gated_norm(y, z, scale, whole)
    assert float((flat - got).abs().max()) > 1e-2
    one = cfg.replace(mamba=cfg.mamba.__class__(**{**cfg.mamba.__dict__, "n_groups": 1}))
    assert torch.equal(mamba_lib.gated_norm(y, z, scale, one),
                       mamba_lib.gated_norm(y, z, scale, whole.replace(
                           mamba=one.mamba.__class__(**{**one.mamba.__dict__,
                                                        "norm_per_group": False}))))


def test_published_sizes_on_meta_tensors():
    cfg = archs.get(ARCH)
    assert cfg.n_layers == 52 and transformer.n_units(cfg) == 1
    assert cfg.mamba.d_inner(cfg.d_model) == 4096 and cfg.mamba.n_heads(cfg.d_model) == 64
    kinds = [d.mixer or d.ffn for d in transformer.scan_unit(cfg)]
    assert (kinds.count("mamba"), kinds.count("moe"), kinds.count("attn")) == (23, 23, 6)
    with _OnMeta():
        params = transformer.init_params(torch.Generator(), cfg)
    leaves = tree_leaves(params)
    assert all(t.is_meta for t in leaves)
    n = sum(t.numel() for t in leaves)
    assert n == cfg.param_count() == 31_577_940_288
    assert ref.param_count({**ref_cfg(cfg), "intermediate_size": 1856}) == n
    assert {t.dtype for t in tree_leaves(params["units"]["L1"]["ffn"]["wi"])} == {torch.bfloat16}


def test_reference_copies_agree():
    import importlib.util

    here = (ROOT / "tests" / "nemotron_h_ref.py").read_bytes()
    there = ROOT / "portbench" / "refs" / "nemotron_h.py"
    assert here == there.read_bytes()
    spec = importlib.util.spec_from_file_location("portbench_nemotron_h_copy", there)
    other = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(other)
    cfg = smoke()
    params = _params(cfg)
    tokens = _tokens(12)
    rc = ref_cfg(cfg)
    a = ref.logits(params, ref.hidden(params, tokens, rc))
    b = other.logits(params, other.hidden(params, tokens, rc))
    assert torch.equal(a, b)


def test_existing_configs_keep_their_norm_and_moe():
    """mamba2-780m's norm has one group, jamba keeps the whole-d_inner norm
    at 8 groups and its capacity MoE; neither config names a pattern."""
    m = archs.get("mamba2-780m")
    j = archs.get("jamba-1.5-large-398b")
    assert m.pattern is None and j.pattern is None and m.rope and j.rope
    assert m.mamba.n_groups == 1 and not m.mamba.norm_per_group and m.mamba.heads == 0
    assert j.mamba.n_groups == 8 and not j.mamba.norm_per_group
    assert not j.moe.dropless and j.gated_mlp and j.moe.shared_d_ff == 0
    assert m.mamba.d_inner(m.d_model) == 2 * 1536
