"""The port's attention against the reference's, on the CPU.

Inputs are drawn with numpy from a seed and handed to both packages.

- The plain version of the kernel (``kernels/flash_attention/ref.py``
  ``attention_ref``, which ``ops.flash_attention`` runs for CPU tensors)
  against the reference's ``attention_ref`` and its Pallas kernel in
  interpret mode (``interpret=True``, as the reference's own tests run it):
  causal, window < S, softcap, G 1 and 2, hd 16 and 256. Both compute in
  float32; held to ``fa_tolerance`` (1e-5 of the output's scale, plus one
  bf16 ulp of each entry for bf16 outputs). One exception, stated: at hd 16
  the reference's wrapper pads hd to the TPU's 128 lanes and multiplies q by
  sqrt(128 / 16) in q's dtype, so in bf16 q is rounded a second time (up to
  2^-9 of each entry) and the Pallas result is a different function; there
  the bound is 3e-2 of the output's scale. The port takes ``hd ** -0.5`` of
  the true hd and pads nothing.
- ``attention_ref(p_dtype=v.dtype)`` against the reference's model
  attention (its XLA path): ``naive_attention`` (with ``q_offset`` and
  ``kv_len``), the blocked ``flash_attention_train`` forward at block 8, and
  ``flash_attention_decode`` against a per-row ``kv_len`` (the reference
  takes a scalar, so each row is run alone there). Both round p to bf16
  before the PV product in bf16: f32 within rtol 1e-5, bf16 within
  ``fa_tolerance`` plus one bf16 ulp of the output's scale (a p on a
  rounding boundary may go either way).
- ``transformer._attn_spec`` gives each layer of gemma2-9b (local and
  global) and of a plain dense model the reference's causal, window and
  softcap; the dense family's training forward and loss run (attention's
  backward is ported), an unported family's still raises.
- ``ops.flash_attention_decode``'s plain path keeps p in float32 (the
  kernel's function); the reference's decode rounds p to bf16, so in bf16
  they differ by that rounding: held to 2e-2 of the output's scale
  (measured up to 2.7e-3); in f32 to rtol 1e-5.
- The wrappers' checks raise on what the kernels do not take, and CPU
  tensors never reach a kernel.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as j_fa_ops
from repro.kernels.flash_attention import ref as j_fa_ref
from repro.configs import archs as j_archs
from repro.models import attention as j_attn
from repro.models import transformer as j_transformer
from repro_torch.configs import archs
from repro_torch.kernels.flash_attention import flash_attention as kern
from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.models import transformer

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}

# (B, S, H, KV, hd, causal, window, softcap)
CASES = [
    (2, 16, 2, 2, 16, True, None, None),      # G 1
    (2, 16, 4, 2, 16, True, 8, 50.0),         # G 2, window < S, softcap
    (1, 24, 4, 2, 16, False, None, 50.0),     # bidirectional
    (1, 16, 4, 2, 256, True, 8, 50.0),        # gemma2-9b's head dim
    (1, 16, 2, 2, 256, True, None, None),
]


def _ids(c):
    return "B{}-S{}-H{}-KV{}-hd{}-{}-w{}-cap{}".format(
        *c[:5], "causal" if c[5] else "bidi", c[6], c[7])


def _draw(shape, seed, dtypes):
    """The same values in both packages (bf16 rounded once, by JAX)."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    j = jnp.asarray(x, dtypes[0])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(dtypes[1])


def _qkv(case, dt, seed=0, Sq=None, Skv=None):
    B, S, H, KV, hd = case[:5]
    dtypes = DTYPES[dt]
    q = _draw((B, Sq or S, H, hd), seed, dtypes)
    k = _draw((B, Skv or S, KV, hd), seed + 1, dtypes)
    v = _draw((B, Skv or S, KV, hd), seed + 2, dtypes)
    return (q[0], k[0], v[0]), (q[1], k[1], v[1])


def _f32(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else
                      np.asarray(x, np.float32), np.float32)


def _assert_fa_close(got, want_np, want_dtype, what, extra=0.0):
    """|got - want| <= fa_tolerance(want) + extra x max|want|."""
    want = torch.from_numpy(_f32(want_np)).to(want_dtype)
    g = torch.from_numpy(_f32(got))
    bound = ref.fa_tolerance(want) + extra * want.float().abs().max()
    diff = (g - want.float()).abs()
    assert bool((diff <= bound).all()), f"{what}: max |diff| {float(diff.max()):.3g}"


def _bf16_ulp_at_scale(x):
    top = float(np.abs(_f32(x)).max())
    return 2.0 ** (np.floor(np.log2(top)) - 7)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_plain_version_matches_reference_and_pallas(case, dt):
    B, S, H, KV, hd, causal, window, cap = case
    (jq, jk, jv), (tq, tk, tv) = _qkv(case, dt)
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window, softcap=cap)
    assert got.dtype == DTYPES[dt][1] and got.shape == (B, S, H, hd)
    assert torch.equal(got, ref.attention_ref(tq, tk, tv, causal=causal, window=window,
                                              softcap=cap))
    want = j_fa_ref.attention_ref(jq, jk, jv, causal=causal, window=window, softcap=cap)
    _assert_fa_close(got, want, DTYPES[dt][1], "vs attention_ref")
    pallas = j_fa_ops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                      softcap=cap, block_q=8, block_k=8, interpret=True)
    # hd 16 in bf16: the reference wrapper's extra bf16 rounding of sqrt(8) q
    extra = 3e-2 if (dt == "bf16" and hd < 128) else 0.0
    _assert_fa_close(got, pallas, DTYPES[dt][1], "vs the Pallas kernel (interpret)", extra)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_model_attention_matches_reference(case, dt):
    """``attention_ref`` with p rounded to v's dtype is the reference's
    ``naive_attention`` (also at ``q_offset`` 3 with ``kv_len`` S - 2) and its
    blocked training forward (block 8: the blocked path at S 16 and 24, with
    its static block skip)."""
    B, S, H, KV, hd, causal, window, cap = case
    (jq, jk, jv), (tq, tk, tv) = _qkv(case, dt, seed=3)
    kw = dict(causal=causal, window=window, softcap=cap)
    jspec = j_attn.AttnSpec(**kw, block_q=8, block_k=8)
    naive = ref.attention_ref(tq, tk, tv, **kw, p_dtype=tv.dtype)
    pairs = [
        (naive, j_attn.naive_attention(jq, jk, jv, jspec)),
        (naive, j_attn.flash_attention_train(jq, jk, jv, jspec)),
        (ref.attention_ref(tq, tk, tv, **kw, q_offset=3, p_dtype=tv.dtype,
                           kv_len=torch.full((B,), S - 2, dtype=torch.int32)),
         j_attn.naive_attention(jq, jk, jv, jspec, q_offset=3, kv_len=S - 2)),
    ]
    for i, (got, want) in enumerate(pairs):
        if dt == "f32":
            np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5,
                                       atol=1e-5 * np.abs(_f32(want)).max(), err_msg=str(i))
        else:
            _assert_fa_close(got, want, torch.bfloat16, f"pair {i}",
                             extra=_bf16_ulp_at_scale(want) / np.abs(_f32(want)).max())


@pytest.mark.parametrize("arch", ["gemma2-9b", "qwen2-72b"])
def test_attn_spec_matches_reference(arch):
    for t_cfg, j_cfg in ((archs.get(arch), j_archs.get(arch)),
                         (archs.smoke_cfg(archs.get(arch)), j_archs.smoke_cfg(j_archs.get(arch)))):
        descs = transformer.scan_unit(t_cfg)
        j_descs = j_transformer.scan_unit(j_cfg)
        assert [d.local for d in descs] == [d.local for d in j_descs]
        for d, jd in zip(descs, j_descs):
            got, want = transformer._attn_spec(t_cfg, d), j_transformer._attn_spec(j_cfg, jd)
            assert (got.causal, got.window, got.softcap) == \
                (want.causal, want.window, want.softcap)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("hd,Sq", [(16, 1), (256, 1), (16, 2)])
def test_decode_with_per_row_kv_len_matches_reference(hd, Sq, dt):
    """A cache of 20 slots, rows filled to 1, 9 and 20 (one decode step each
    at pos kv_len - 1): ``attention_ref`` with one kv_len per row and p
    rounded to v's dtype equals the reference's decode run row by row with a
    scalar kv_len; the kernel's plain path (p in float32) equals it in f32
    and within bf16 rounding of p in bf16."""
    B, L, H, KV = 3, 20, 4, 2
    kv_len = np.array([1, 9, 20], np.int32)
    (jq, jk, jv), (tq, tk, tv) = _qkv((B, L, H, KV, hd), dt, seed=7, Sq=Sq, Skv=L)
    cap = 50.0
    jspec = j_attn.AttnSpec(causal=False, softcap=cap, block_q=8, block_k=8)
    want = np.concatenate([
        _f32(j_attn.flash_attention_decode(jq[b:b + 1], jk[b:b + 1], jv[b:b + 1], jspec,
                                           q_offset=int(kv_len[b]) - 1,
                                           kv_len=int(kv_len[b])))
        for b in range(B)])
    tl = torch.from_numpy(kv_len)
    model = ref.attention_ref(tq, tk, tv, causal=False, softcap=cap, kv_len=tl,
                              p_dtype=tv.dtype)
    plain = ops.flash_attention_decode(tq, tk, tv, tl, softcap=cap)
    assert plain.shape == (B, Sq, H, hd) and plain.dtype == DTYPES[dt][1]
    assert torch.equal(plain, ref.attention_ref(tq, tk, tv, causal=False, softcap=cap,
                                                kv_len=tl))
    scale = np.abs(want).max()
    if dt == "f32":
        for got in (model, plain):
            np.testing.assert_allclose(_f32(got), want, rtol=1e-5, atol=1e-5 * scale)
    else:
        _assert_fa_close(model, want, torch.bfloat16, "model decode",
                         extra=_bf16_ulp_at_scale(want) / scale)
        assert np.abs(_f32(plain) - want).max() <= 2e-2 * scale


def test_dense_training_forward_raises():
    """The dense family trains since attention's backward was ported (its
    parity with the reference is ``tests/test_torch_train.py``): the
    training forward and loss run, with zero MoE aux losses; a family not
    ported yet (the hybrid jamba) still raises."""
    cfg = archs.smoke_cfg(archs.get("gemma2-9b"))
    tokens = torch.zeros((1, 8), dtype=torch.long)
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    h, aux = transformer.forward_train(params, tokens, cfg)
    assert h.shape == (1, 8, cfg.d_model) and bool(torch.isfinite(h).all())
    assert float(aux["moe_aux"]) == float(aux["moe_zloss"]) == 0.0
    loss, metrics = transformer.loss_fn(params, {"tokens": tokens, "labels": tokens}, cfg)
    assert bool(torch.isfinite(loss)) and float(metrics["ce_loss"]) == float(loss)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        transformer.forward_train(params, tokens, archs.get("jamba-1.5-large-398b"))


def test_wrappers_check_and_cpu_never_reaches_a_kernel():
    before = kern.launch_counts()
    q = torch.zeros(1, 8, 4, 16)
    k = torch.zeros(1, 8, 2, 16)
    kl = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kern.flash_attention_fwd(q, k, k)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.flash_attention(q, k, k, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        kern.flash_attention_decode(q[:, :1], k, k, kl)
    with pytest.raises(ValueError, match="head dim"):
        kern.flash_attention_fwd(torch.zeros(1, 8, 4, 24), torch.zeros(1, 8, 2, 24),
                                 torch.zeros(1, 8, 2, 24))
    with pytest.raises(ValueError, match="kv heads"):
        kern.flash_attention_fwd(torch.zeros(1, 8, 3, 16), k, k)
    with pytest.raises(ValueError, match="rows per block"):
        kern.flash_attention_decode(torch.zeros(1, 9, 4, 16), k, k, kl)
    with pytest.raises(ValueError, match="window"):
        kern.flash_attention_fwd(q, k, k, window=0)
    with pytest.raises(ValueError, match="softcap"):
        kern.flash_attention_fwd(q, k, k, softcap=0.0)
    with pytest.raises(ValueError, match="unknown impl"):
        ops.flash_attention(q, k, k, impl="pallas")
    ops.flash_attention(q, k, k)
    ops.flash_attention_decode(q[:, :1], k, k, kl)
    assert kern.launch_counts() == before
