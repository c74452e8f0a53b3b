"""The port's encoder-decoder family (whisper-base) and its rectangular
attention against the JAX reference, on the CPU.

Inputs come from numpy seeds; params are the reference's own init, carried
across with ``weights.params_from_jax``; the reference runs in this process
on the CPU.

- Rectangular attention (Sq queries against Skv keys, masks aligned
  top-left): the kernels' plain versions (``ref.attention_ref``,
  ``attention_lse_ref``, ``attention_bwd_ref``) and the port's
  ``flash_attention_train`` (blocked route where Sq and Skv tile into the
  blocks, naive route where they do not) against ``jax.vjp`` of the
  reference's ``naive_attention`` and ``flash_attention_train``: causal and
  not, Sq below and above Skv, a window, a softcap, a ragged Skv; the
  reference jitted. float32: within 2e-5 of each tensor's largest
  magnitude (the same algebra summed in another order, as
  ``tests/test_torch_train.py`` holds the square cases); the lse within
  1e-6 of its largest magnitude.
- The head-dim padding the kernels' wrapper applies (kimi-k2's 112 to 128,
  40 to 64): the plain versions on zero-padded q, k, v (and out, g) with
  the true head dim's scale, sliced back, equal the unpadded ones bit for
  bit in float32 (zero lanes add exact zeros to every dot product).
- whisper-base's smoke config with 2 encoder layers (2 decoder layers,
  12 frames, float32 compute, attention blocks of 4 so every attention
  takes the blocked route on both sides): ``loss_fn`` within rtol 2e-5 and every
  gradient (the encoder's included, through the checkpointed units'
  cross-attention) within 1e-4 of its largest magnitude, as the dense
  archs' (``tests/test_torch_train.py``); ``prefill``'s logits and every
  cache (self and ``cross{j}``) within 2e-5 of their scale, then 4 decode
  ticks' logits against the reference's (2e-5: the same sums, eager); a
  decode replay from an empty cache (the cross caches copied in) against
  the prefill's logits, as the reference's
  ``test_prefill_matches_decode_replay`` (rtol and atol 2e-3, its bound).
- ``launch.train.main(["--arch", "whisper-base", "--smoke", ...])`` against
  the reference's CLI from one step-0 checkpoint (the smoke config's 6
  encoder layers): the losses of 2 steps within rtol 2e-3 (bf16 compute,
  as the gemma2-9b run's).
- ``ModelDecoder`` refuses an encoder-decoder config (the reference's
  cannot serve one either: its prefill passes only the tokens), and a
  prefill or loss without ``enc_embeds`` raises.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as j_ckpt
from repro.configs import archs as j_archs
from repro.launch import steps as j_steps
from repro.launch import train as j_train
from repro.models import attention as j_attention
from repro.models import registry as j_registry
from repro.optim import adamw as j_adamw
from repro_torch.configs import archs
from repro_torch.kernels.flash_attention import flash_attention as kern
from repro_torch.kernels.flash_attention import ref
from repro_torch.launch import train
from repro_torch.models import attention, registry, transformer
from repro_torch.pytree import tree_leaves, tree_map
from repro_torch.serving import ModelDecoder
from repro_torch.weights import params_from_jax

ARCH = "whisper-base"


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _scale_close(got, want, frac: float, what: str):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, f"{what}: {got.shape} != {want.shape}"
    bound = frac * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= bound, f"{what}: max |diff| {err:.3g} > {bound:.3g}"


# ---------------------------------------------------------------------------
# rectangular attention
# ---------------------------------------------------------------------------

# (B, Sq, Skv, H, KV, causal, window, softcap, block); the blocked route
# when Sq and Skv are multiples of the block, else the naive one. Every
# query row sees at least one key.
RECT_CASES = [
    (2, 16, 24, 4, 2, False, None, None, 8),     # blocked, cross-attention
    (2, 16, 24, 4, 2, True, None, 50.0, 8),      # blocked, causal, Sq < Skv
    (1, 24, 16, 4, 4, True, 12, None, 8),        # blocked, causal, Sq > Skv, window
    (2, 12, 20, 4, 2, False, None, None, 8),     # naive, ragged Skv
    (1, 7, 30, 4, 1, False, 9, 50.0, 8),         # naive, non-causal window, MQA
    (2, 5, 13, 4, 2, True, None, None, 8),       # naive, causal rectangle
]


def _jax_vjp(fn, q, k, v, g):
    """(fn(q, k, v), its gradients for the output gradient g), jitted as
    one program (the reference's numerics under ``jit``)."""
    def run(a, b, c, d):
        out, vjp = jax.vjp(fn, a, b, c)
        return out, vjp(d)

    return jax.jit(run)(*(jnp.asarray(x) for x in (q, k, v, g)))


def _rect_inputs(case, hd=16):
    B, Sq, Skv, H, KV = case[:5]
    rng = np.random.default_rng(Sq * 31 + Skv)
    q, g = (rng.standard_normal((B, Sq, H, hd)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, Skv, KV, hd)).astype(np.float32) for _ in range(2))
    return q, k, v, g


@pytest.mark.parametrize("case", RECT_CASES, ids=lambda c: "-".join(map(str, c)))
def test_rect_plain_versions_match_reference(case):
    """ref.attention_ref, attention_lse_ref and attention_bwd_ref at Sq !=
    Skv against jax.vjp of the reference's naive_attention."""
    causal, window, cap = case[5:8]
    q, k, v, g = _rect_inputs(case)
    spec = j_attention.AttnSpec(causal=causal, window=window, softcap=cap)
    jout, jgrads = _jax_vjp(lambda a, b, c: j_attention.naive_attention(a, b, c, spec),
                            q, k, v, g)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    kw = dict(causal=causal, window=window, softcap=cap)
    out = ref.attention_ref(tq, tk, tv, **kw)
    _scale_close(out, jout, 2e-5, "out")
    lse = ref.attention_lse_ref(tq, tk, **kw)
    # the lse against log(sum exp) of the reference's own masked scores
    s = np.einsum("bqhd,bshd->bhqs", q, np.repeat(k, q.shape[2] // k.shape[2], axis=2))
    s = s * q.shape[-1] ** -0.5
    if cap is not None:
        s = cap * np.tanh(s / cap)
    qpos, kpos = np.arange(q.shape[1])[:, None], np.arange(k.shape[1])[None]
    mask = np.ones_like(s[0, 0], dtype=bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = np.where(mask, s, -np.inf)
    want_lse = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    _scale_close(lse, want_lse, 1e-6, "lse")
    for name, got, want in zip(("dq", "dk", "dv"),
                               ref.attention_bwd_ref(tq, tk, tv, out, lse, tg, **kw), jgrads):
        _scale_close(got, want, 2e-5, name)


@pytest.mark.parametrize("case", RECT_CASES, ids=lambda c: "-".join(map(str, c)))
def test_rect_flash_attention_train_matches_reference(case):
    """The port's flash_attention_train (blocked or naive, as the reference
    picks) against the reference's, forward and gradients."""
    causal, window, cap, block = case[5:]
    q, k, v, g = _rect_inputs(case)
    jspec = j_attention.AttnSpec(causal=causal, window=window, softcap=cap, block_q=block,
                                 block_k=block)
    tspec = attention.AttnSpec(causal=causal, window=window, softcap=cap, block_q=block,
                               block_k=block)
    jout, jgrads = _jax_vjp(lambda a, b, c: j_attention.flash_attention_train(a, b, c, jspec),
                            q, k, v, g)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    assert attention._divisible(tq, tk, tspec) == (q.shape[1] % block == 0
                                                   and k.shape[1] % block == 0)
    tout = attention.flash_attention_train(tq, tk, tv, tspec)
    tgrads = torch.autograd.grad(tout, (tq, tk, tv), torch.from_numpy(g))
    _scale_close(tout, jout, 2e-5, "out")
    for name, got, want in zip(("dq", "dk", "dv"), tgrads, jgrads):
        _scale_close(got, want, 2e-5, name)


@pytest.mark.parametrize("hd", [112, 40])
def test_head_dim_padding_is_exact(hd):
    """What the kernels' wrapper does for a head dim outside HEAD_DIMS, on
    the plain versions: pad -> attention (true hd's scale) -> slice equals
    the unpadded attention, its lse and its gradients bit for bit."""
    hd_pad = kern.padded_head_dim(hd)
    assert hd_pad == {112: 128, 40: 64}[hd]
    gen = torch.Generator().manual_seed(hd)
    B, Sq, Skv, H, KV = 2, 24, 40, 8, 2
    q, g = (torch.randn(B, Sq, H, hd, generator=gen) for _ in range(2))
    k, v = (torch.randn(B, Skv, KV, hd, generator=gen) for _ in range(2))
    qp, kp, vp = (kern.pad_head_dim(x, hd_pad) for x in (q, k, v))
    assert qp.shape[-1] == hd_pad and torch.equal(qp[..., :hd], q) and not qp[..., hd:].any()
    scale = hd ** -0.5
    for causal in (True, False):
        kw = dict(causal=causal, window=None, softcap=50.0)
        out = ref.attention_ref(q, k, v, **kw)
        out_p = ref.attention_ref(qp, kp, vp, scale=scale, **kw)
        assert torch.equal(out_p[..., :hd], out) and not out_p[..., hd:].any()
        lse = ref.attention_lse_ref(q, k, **kw)
        assert torch.equal(ref.attention_lse_ref(qp, kp, scale=scale, **kw), lse)
        grads = ref.attention_bwd_ref(q, k, v, out, lse, g, **kw)
        grads_p = ref.attention_bwd_ref(qp, kp, vp, out_p, lse, kern.pad_head_dim(g, hd_pad),
                                        scale=scale, **kw)
        for name, a, b in zip(("dq", "dk", "dv"), grads, grads_p):
            assert torch.equal(b[..., :hd], a), name
    with pytest.raises(ValueError, match="head dim"):
        kern.padded_head_dim(257)


# ---------------------------------------------------------------------------
# whisper-base smoke
# ---------------------------------------------------------------------------

def _cfgs(**kw):
    j = j_archs.smoke_cfg(j_archs.get(ARCH)).replace(**kw)
    t = archs.smoke_cfg(archs.get(ARCH)).replace(**kw)
    return j, t


def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1))
    enc = rng.standard_normal((B, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    return toks, enc


def _compare_trees(got, want, frac: float, what: str):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _compare_trees(got[k], want[k], frac, f"{what}/{k}")
        return
    if isinstance(want, tuple):
        for i, (g_, w_) in enumerate(zip(got, want)):
            _compare_trees(g_, w_, frac, f"{what}/{i}")
        return
    _scale_close(got, want, frac, what)


@pytest.fixture(scope="module")
def f32_params():
    """The reference's smoke params (float32 compute, blocks of 4, 2
    encoder layers) and the port's copy."""
    jcfg, tcfg = _cfgs(compute_dtype="float32", attn_block_q=4, attn_block_k=4,
                       n_enc_layers=2)
    params = jax.jit(lambda key: j_registry.bundle(jcfg).init(key)[0])(jax.random.PRNGKey(1))
    return jcfg, tcfg, params, params_from_jax(jax.tree.map(np.asarray, params), "cpu")


def test_params_land_where_the_port_reads_them(f32_params):
    """params_from_jax carries the encoder's stacked blocks and the cross
    leaves; the tree is the one the port's own init draws."""
    jcfg, tcfg, _, tp = f32_params
    mine = transformer.init_params(torch.Generator().manual_seed(0), tcfg)
    assert tree_map(lambda t: (tuple(t.shape), t.dtype), tp) == \
        tree_map(lambda t: (tuple(t.shape), t.dtype), mine)
    assert tp["encoder"]["blocks"]["attn"]["wq"].shape[0] == jcfg.n_enc_layers == 2
    assert set(tp["units"]["L0"]) == {"ln", "attn", "cross_ln", "cross", "ln2", "ffn"}


def test_whisper_loss_and_grads_match_reference(f32_params):
    jcfg, tcfg, params, tp = f32_params
    toks, enc = _batch(tcfg, 2, 16, 11)
    jbatch = {"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
              "labels": jnp.asarray(toks[:, 1:], jnp.int32), "enc_embeds": jnp.asarray(enc)}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: j_registry.bundle(jcfg).loss_fn(p, jbatch), has_aux=True))(params)
    tp = tree_map(lambda t: t.clone().requires_grad_(True), tp)
    tbatch = {"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:]),
              "enc_embeds": torch.from_numpy(enc)}
    assert transformer.n_units(tcfg) == 2 and tcfg.remat == "full"
    tloss, metrics = registry.bundle(tcfg).loss_fn(tp, tbatch)
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=2e-5)
    assert metrics["ce_loss"].item() == tloss.item()
    grads = tree_map(lambda t: t.grad, tp)
    assert float(grads["encoder"]["blocks"]["attn"]["wq"].abs().max()) > 0
    _compare_trees(grads, jax.tree.map(np.asarray, jgrads), 1e-4, ARCH)


def test_whisper_prefill_and_decode_match_reference(f32_params):
    jcfg, tcfg, params, tp = f32_params
    B, S, max_len = 2, 8, 16
    toks, enc = _batch(tcfg, B, S + 4, 12)
    jb, tb = j_registry.bundle(jcfg), registry.bundle(tcfg)
    jl, jc = jax.jit(lambda p, bt: jb.prefill_fn(p, bt, max_len))(
        params, {"tokens": jnp.asarray(toks[:, :S], jnp.int32), "enc_embeds": jnp.asarray(enc)})
    with torch.no_grad():
        tl, tc = tb.prefill_fn(tp, {"tokens": torch.from_numpy(toks[:, :S]),
                                    "enc_embeds": torch.from_numpy(enc)}, max_len)
    _scale_close(tl, jl, 2e-5, "prefill logits")
    assert set(tc["units"]) == {"kv0", "cross0"} and int(tc["pos"]) == int(jc["pos"]) == S
    _compare_trees(tc["units"], jax.tree.map(np.asarray, jc["units"]), 2e-5, "cache")
    assert tuple(tc["units"]["cross0"].k.shape) == (2, B, tcfg.enc_frames, tcfg.n_kv_heads,
                                                    tcfg.head_dim)
    jdec = jax.jit(jb.decode_fn)
    for t in range(S, S + 4):
        jl, jc = jdec(params, jc, {"token": jnp.asarray(toks[:, t:t + 1], jnp.int32)})
        with torch.no_grad():
            tl, tc = tb.decode_fn(tp, tc, {"token": torch.from_numpy(toks[:, t:t + 1])})
        _scale_close(tl, jl, 2e-5, f"decode logits at {t}")
    _compare_trees(tc["units"], jax.tree.map(np.asarray, jc["units"]), 2e-5, "cache after")


def test_whisper_decode_replay_matches_prefill(f32_params):
    """Decoding token by token from an empty cache (its cross caches copied
    from the prefill's) reproduces the prefill's logits."""
    _, tcfg, _, tp = f32_params
    B, S = 1, 8
    toks, enc = _batch(tcfg, B, S, 2)
    tb = registry.bundle(tcfg)
    with torch.no_grad():
        want, pre = tb.prefill_fn(tp, {"tokens": torch.from_numpy(toks[:, :S]),
                                       "enc_embeds": torch.from_numpy(enc)}, S + 4)
        cache = tb.init_cache(B, S + 4, "cpu")
        cache["units"]["cross0"] = pre["units"]["cross0"]
        for t in range(S):
            got, cache = tb.decode_fn(tp, cache, {"token": torch.from_numpy(toks[:, t:t + 1])})
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-3, atol=2e-3)


def test_whisper_cache_keeps_enc_len(f32_params):
    """The cross decode's kv_len, every lane's frame count, is made once per
    cache (by ``prefill`` and ``init_cache``) and carried by each decode
    step, not made anew per tick."""
    _, tcfg, _, tp = f32_params
    B, S = 2, 4
    toks, enc = _batch(tcfg, B, S + 2, 5)
    tb = registry.bundle(tcfg)
    with torch.no_grad():
        _, cache = tb.prefill_fn(tp, {"tokens": torch.from_numpy(toks[:, :S]),
                                      "enc_embeds": torch.from_numpy(enc)}, S + 2)
        made = cache["enc_len"]
        for t in range(S, S + 2):
            _, cache = tb.decode_fn(tp, cache, {"token": torch.from_numpy(toks[:, t:t + 1])})
    assert cache["enc_len"] is made and made.dtype == torch.int32
    assert made.tolist() == [tcfg.enc_frames] * B and int(cache["pos"]) == S + 2
    assert tb.init_cache(B, 8, "cpu")["enc_len"].tolist() == [tcfg.enc_frames] * B
    assert "enc_len" not in registry.bundle(archs.smoke_cfg(archs.get("gemma2-9b"))).init_cache(
        B, 8, "cpu")


def test_encoder_decoder_needs_enc_embeds_and_is_not_served():
    _, tcfg = _cfgs()
    params = transformer.init_params(torch.Generator().manual_seed(0), tcfg)
    tokens = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(ValueError, match="enc_embeds"):
        transformer.prefill(params, tokens, tcfg, 16)
    with pytest.raises(ValueError, match="enc_embeds"):
        transformer.loss_fn(params, {"tokens": tokens, "labels": tokens}, tcfg)
    with pytest.raises(ValueError, match="encoder-decoder"):
        ModelDecoder(tcfg, 2, 2, 16, device="cpu")
    assert len(tree_leaves(params["encoder"])) == 10


def test_whisper_train_main_matches_reference(tmp_path, capsys):
    argv = ["--arch", ARCH, "--smoke", "--steps", "2", "--seq", "16", "--batch", "2",
            "--restore", "--seed", "4"]
    cfg = j_archs.smoke_cfg(j_archs.get(ARCH))
    opt = j_adamw.OptConfig(peak_lr=3e-3, warmup_steps=5, decay_steps=10)
    start = jax.jit(lambda key: j_steps.init_state(key, cfg, opt))(jax.random.PRNGKey(9))
    for name in ("ref", "port"):
        j_ckpt.save(tmp_path / name, 0, start, async_save=False)
    want = j_train.main(argv + ["--ckpt", str(tmp_path / "ref")])
    got = train.main(argv + ["--ckpt", str(tmp_path / "port"), "--device", "cpu"])
    assert "restored checkpoint at step 0" in capsys.readouterr().out
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=2e-3)
