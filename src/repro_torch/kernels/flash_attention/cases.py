"""The attention kernels held to their plain versions on the card: the cases
that the card tests (``tests/test_torch_cuda.py``) run.

Serving (:func:`check_prefill_case`, :func:`check_decode_case`): the
prefill and the decode at the MoE serving cell's shapes (qwen3-moe-30b-a3b,
a GQA group of 8 at head dim 128, no softcap, no window) and at
nemotron-3-nano-30b-a3b's (G 16, hd 128, the decode's 16 rows a block
exactly ``MAX_DECODE_ROWS``), each launched
twice, bit-identical, within ``ref.fa_tolerance`` of the plain version
(``ref.attention_ref``, with ``kv_len`` for the decode); a bf16 prefill on
the tensor-core kernel.

Training: each case draws q, k, v and an output gradient g from a seed on the card,
runs ``flash_attention_fwd(..., lse=True)`` twice and
``flash_attention_bwd`` twice on the kernels' own (out, lse), and checks:
the two launches of each bit-identical; the lse within ``ref.lse_close`` of
``ref.attention_lse_ref``; the output within ``ref.fa_tolerance`` of
``ref.attention_ref``; dq, dk and dv within ``ref.bwd_tolerance`` of
``ref.attention_bwd_ref`` on the same (q, k, v, out, lse, g).

Rectangular and padded (:func:`check_rect_case`): Sq queries against Skv
keys (whisper-base's encoder, its cross-attention in serving and training,
against its 1536 padded frames and its true 1500, its decoder's causal
self-attention in training, and causal rectangles both ways, masks
aligned top-left), and head dims outside the kernels' own
(kimi-k2's 112, padded to 128 by the wrapper; 40, padded to 64): the
prefill without lse (bf16 on the tensor-core kernel), the same with lse
(its output the same bits), then the backward, each launched twice
bit-identical and held as the training cases; the decode cases of
whisper-base (the cross-attention against its frozen encoder cache, G 1 at
hd 64, and its self-attention against 448 slots), of kimi-k2's heads
(64 / 8 x 112) and of qwen2-vl-72b's (64 / 8 x 128) by
:func:`check_decode_case`.

:func:`check_first_step` holds one train step taken on the kernels to the
same step taken on their plain versions.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.pytree import tree_leaves

# (B, S, H, KV, hd, causal, window, softcap): f32 and bf16 each; head dims
# 16 to 256, G 1, 2 and 4 (G 4 at hd 256, where the bf16 passes split the
# dims of dK and dV over two warpgroups), MQA (KV 1, at hd 64 and 128),
# ragged S (33-300, not a multiple of the 32-row f32 tiles; 65, 127 and 191
# across the 64-row bf16 tiles), windows whose edges fall inside a tile (5,
# 40, 48, 100) and one that bites at S 1024 (256), softcap 50 and none, one
# non-causal window, and the training cell's local layers (B 2, S 4096,
# 16 / 8 heads x 256, causal, window 4096, softcap 50), and a GQA group of 8
# at hd 128 with no softcap (qwen3-moe-30b-a3b's group and head dim)
BWD_CASES = [
    (2, 33, 4, 2, 16, True, 5, 50.0),
    (2, 64, 4, 2, 128, True, None, 50.0),
    (1, 77, 2, 2, 256, True, None, 50.0),
    (2, 200, 4, 1, 128, True, 48, None),
    (1, 300, 16, 8, 256, True, 100, 50.0),
    (2, 130, 8, 2, 64, False, 30, 50.0),
    (1, 1024, 4, 2, 256, True, 256, 50.0),
    (1, 160, 8, 2, 32, True, None, None),
    (2, 65, 4, 2, 128, True, None, 50.0),
    (2, 127, 4, 1, 64, True, 40, None),
    (1, 191, 8, 2, 256, True, None, 50.0),
    (2, 4096, 16, 8, 256, True, 4096, 50.0),
    (1, 300, 16, 2, 128, True, None, None),
]

# the MoE serving cell's attention (qwen3-moe-30b-a3b: 32 query / 4 kv
# heads x 128, so G 8; causal, no window, no softcap): the prefill at its
# 4 and 8 lanes and bucket 512, (B, S, H, KV, hd, causal, window, softcap);
# the decode at 8 lanes against its 529-slot cache with ragged kv_len,
# (B, L, H, KV, hd, kv_len of each row)
SERVE_PREFILL_CASES = [
    (4, 512, 32, 4, 128, True, None, None),
    (8, 512, 32, 4, 128, True, None, None),
]
SERVE_DECODE_CASES = [
    (8, 529, 32, 4, 128, (1, 2, 129, 256, 257, 400, 528, 529)),
]

# nemotron-3-nano-30b-a3b's attention (32 query / 2 kv heads x 128, so G
# 16, exactly ``MAX_DECODE_ROWS``; causal, no rope, no window, no softcap):
# the prefill at its serving cell's 16 lanes x bucket 1024 and 32 lanes x
# bucket 256; the decode at 32 lanes against its 1153-slot cache (bucket
# 1024 + 128 new tokens + 1) with ragged kv_len
NEMOTRON_PREFILL_CASES = [
    (16, 1024, 32, 2, 128, True, None, None),
    (32, 256, 32, 2, 128, True, None, None),
]
NEMOTRON_DECODE_CASES = [
    (32, 1153, 32, 2, 128, (1, 2, 3, 15, 16, 17, 63, 64, 65, 127, 128, 129, 255, 256, 257,
                            300, 511, 512, 513, 700, 1000, 1023, 1024, 1025, 1100, 1140,
                            1150, 1151, 1152, 1153, 1153, 777)),
]


# (B, Sq, Skv, H, KV, hd, causal, window, softcap): whisper-base (8 / 8
# heads x 64, no softcap): the encoder's non-causal self-attention at 8
# lanes x 1536 frames; the cross-attention of the serving prefill (a
# 4-token prompt, and 17 tokens) against 1536 frames and against 1500
# (not a multiple of any tile); the cross-attention of the training cell
# (B 16, S 4096 against 1536 frames) and its decoder self-attention (B 16,
# S 4096, causal); a causal rectangle each way (96 x 160, 160 x 96) and one
# with a window (every row sees a key); kimi-k2's heads (64 / 8 x 112,
# causal) and a hd-40 one with a non-causal window
RECT_CASES = [
    (8, 1536, 1536, 8, 8, 64, False, None, None),
    (8, 4, 1536, 8, 8, 64, False, None, None),
    (8, 17, 1536, 8, 8, 64, False, None, None),
    (8, 4, 1500, 8, 8, 64, False, None, None),
    (8, 17, 1500, 8, 8, 64, False, None, None),
    (16, 4096, 1536, 8, 8, 64, False, None, None),
    (16, 4096, 4096, 8, 8, 64, True, None, None),
    (2, 96, 160, 4, 2, 64, True, None, None),
    (2, 160, 96, 4, 2, 64, True, None, None),
    (1, 100, 77, 8, 2, 128, True, 40, 50.0),
    (2, 200, 200, 64, 8, 112, True, None, None),
    (1, 33, 65, 4, 4, 40, False, 20, 50.0),
]
# decode: (B, L, H, KV, hd, kv_len of each row): whisper-base's cross
# decode against its frozen encoder cache (1536 frames, and 1500), its self
# decode against the 448-slot text cache, kimi-k2's heads against 529
# slots, and qwen2-vl-72b's served decode (64 / 8 heads x 128, 8 lanes
# against its 529-slot cache, ragged kv_len)
RECT_DECODE_CASES = [
    (8, 1536, 8, 8, 64, (1536,) * 8),
    (8, 1500, 8, 8, 64, (1500,) * 8),
    (8, 448, 8, 8, 64, (1, 2, 5, 64, 100, 200, 447, 448)),
    (4, 529, 64, 8, 112, (1, 100, 528, 529)),
    (8, 529, 64, 8, 128, (1, 2, 129, 256, 257, 400, 528, 529)),
]


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _draw(gen, dtype, device, *shape):
    return torch.randn(*shape, generator=gen, device=device).to(dtype)


def check_prefill_case(case, dtype: torch.dtype, device, seed: int = 0) -> float:
    """Run one prefill case; raise AssertionError on any failed check.
    Returns the max |diff| from the plain version."""
    from repro_torch import kernels

    B, S, H, KV, hd, causal, window, cap = case
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (_draw(gen, dtype, device, B, S, n, hd) for n in (H, KV, KV))
    kw = dict(causal=causal, window=window, softcap=cap)
    what = f"prefill {case} {dtype}"
    before = kernels.launch_counts()
    got = [ops.flash_attention(q, k, v, impl="cuda", **kw) for _ in range(2)]
    after = kernels.launch_counts()
    torch.cuda.synchronize(device)
    assert torch.equal(got[0], got[1]), f"{what}: two launches differ"
    wgmma = after["flash_attention_fwd_wgmma"] - before["flash_attention_fwd_wgmma"]
    assert wgmma == (2 if dtype == torch.bfloat16 else 0), f"{what}: {wgmma} on tensor cores"
    ok, err = ref.fa_close(got[0], ref.attention_ref(q, k, v, **kw))
    assert ok, f"{what}: outside fa_tolerance ({err})"
    return err


def check_decode_case(case, dtype: torch.dtype, device, seed: int = 0) -> float:
    """Run one decode case (one new token per row, no softcap); raise
    AssertionError on any failed check. Returns the max |diff| from the
    plain version."""
    B, L, H, KV, hd, lens = case
    gen = torch.Generator(device=device).manual_seed(seed)
    q = _draw(gen, dtype, device, B, 1, H, hd)
    k, v = (_draw(gen, dtype, device, B, L, KV, hd) for _ in range(2))
    kv_len = torch.tensor(lens, dtype=torch.int32, device=device)
    what = f"decode {case} {dtype}"
    got = [ops.flash_attention_decode(q, k, v, kv_len, impl="cuda") for _ in range(2)]
    torch.cuda.synchronize(device)
    assert torch.equal(got[0], got[1]), f"{what}: two launches differ"
    ok, err = ref.fa_close(got[0], ops.flash_attention_decode(q, k, v, kv_len, impl="ref"))
    assert ok, f"{what}: outside fa_tolerance ({err})"
    return err


def check_bwd_case(case, dtype: torch.dtype, device, seed: int = 0) -> Dict[str, float]:
    """Run one case; raise AssertionError on any failed check. Returns the
    max |diff| of the output, the lse and each gradient."""
    B, S, H, KV, hd, causal, window, cap = case
    return _check_train((B, S, S, H, KV, hd, causal, window, cap), dtype, device, seed,
                        f"{case} {dtype}")


def check_rect_case(case, dtype: torch.dtype, device, seed: int = 0) -> Dict[str, float]:
    """Run one rectangular or padded case ``(B, Sq, Skv, H, KV, hd, causal,
    window, softcap)``: the prefill without lse twice (bit-identical, bf16 on
    the tensor-core kernel), then :func:`check_bwd_case`'s checks, the lse
    forward's output equal to the lse-less one bit for bit. Raises
    AssertionError on any failed check; returns the max |diff| of the
    output, the lse and each gradient."""
    from repro_torch import kernels

    B, Sq, Skv, H, KV, hd, causal, window, cap = case
    gen = torch.Generator(device=device).manual_seed(seed)
    q = _draw(gen, dtype, device, B, Sq, H, hd)
    k, v = (_draw(gen, dtype, device, B, Skv, KV, hd) for _ in range(2))
    kw = dict(causal=causal, window=window, softcap=cap)
    what = f"rect {case} {dtype}"
    before = kernels.launch_counts()
    plain = [ops.flash_attention(q, k, v, impl="cuda", **kw) for _ in range(2)]
    after = kernels.launch_counts()
    torch.cuda.synchronize(device)
    assert torch.equal(plain[0], plain[1]), f"{what}: two launches differ"
    wgmma = after["flash_attention_fwd_wgmma"] - before["flash_attention_fwd_wgmma"]
    assert wgmma == (2 if dtype == torch.bfloat16 else 0), f"{what}: {wgmma} on tensor cores"
    with_lse = ops.flash_attention(q, k, v, impl="cuda", lse=True, **kw)[0]
    assert torch.equal(with_lse, plain[0]), f"{what}: the lse forward's output differs"
    return _check_train(case, dtype, device, seed, what)


def _check_train(case, dtype, device, seed: int, what: str) -> Dict[str, float]:
    B, Sq, Skv, H, KV, hd, causal, window, cap = case
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(*shape):
        return torch.randn(*shape, generator=gen, device=device).to(dtype)

    q, k, v = draw(B, Sq, H, hd), draw(B, Skv, KV, hd), draw(B, Skv, KV, hd)
    g = draw(B, Sq, H, hd)
    kw = dict(causal=causal, window=window, softcap=cap)
    fwd = [ops.flash_attention(q, k, v, impl="cuda", lse=True, **kw) for _ in range(2)]
    bwd = [ops.flash_attention_bwd(q, k, v, *fwd[0], g, impl="cuda", **kw) for _ in range(2)]
    torch.cuda.synchronize(device)
    assert _same(fwd[0], fwd[1]), f"{what}: two forward launches differ"
    assert _same(bwd[0], bwd[1]), f"{what}: two backward launches differ"
    out, lse = fwd[0]
    errs = {}
    ok, errs["out"] = ref.fa_close(out, ref.attention_ref(q, k, v, **kw))
    assert ok, f"{what}: output outside fa_tolerance ({errs['out']})"
    ok, errs["lse"] = ref.lse_close(lse, ref.attention_lse_ref(q, k, **kw))
    assert ok, f"{what}: lse outside F32_RTOL ({errs['lse']})"
    want = ref.attention_bwd_ref(q, k, v, out, lse, g, **kw)
    for name, got, w in zip(("dq", "dk", "dv"), bwd[0], want):
        assert got.dtype == w.dtype and got.shape == w.shape, f"{what}: {name} dtype/shape"
        ok, errs[name] = ref.bwd_close(got, w)
        assert ok, f"{what}: {name} outside bwd_tolerance ({errs[name]})"
    return errs


def check_first_step(got: Dict[str, Any], got_metrics: Dict[str, Any],
                     want: Dict[str, Any], want_metrics: Dict[str, Any], opt_cfg, *,
                     loss_rtol: float, gnorm_rtol: float, mu_rtol: float) -> Dict[str, Any]:
    """Hold the train state ``got`` after one AdamW step from zero float32
    moments to ``want``, the same step from the same state and batch on
    another path; raise AssertionError on any failed check:

    - the loss within ``loss_rtol`` and the grad norm within ``gnorm_rtol``,
      relative;
    - each leaf's first moment, which one step makes ``(1 - b1) * clip * g``,
      within ``mu_rtol`` of that leaf's largest |mu|: the gradient's size,
      entry by entry, which the loss and the step's sign cannot show;
    - each param entry within 1e-6 (a few f32 ulps of the params) plus what
      that mu tolerance lets Adam's first step move it. The step is
      ``lr * f(x)`` with ``f(x) = x / (|x| + eps)`` and ``x = mu / (1 - b1)``,
      so an entry whose x lies within the tolerance of zero may flip its
      sign (up to 2 lr) and any other moves by ``lr * |f(x +- tol) - f(x)|``.

    Returns :func:`step_gap`'s readings and ``param_gap`` (the largest
    |param diff|), ``param_slack`` (the smallest of bound minus |param
    diff|) and ``flips`` (entries more than 1e-6 apart)."""
    assert int(got["opt"]["count"]) == int(want["opt"]["count"]) == 1, "not a first step"
    f64 = torch.float64
    lr = float(want_metrics["lr"])
    lead = 1.0 - opt_cfg.b1

    def adam_step(y):
        return y / (y.abs() + opt_cfg.eps)

    read = step_gap(got, got_metrics, want, want_metrics)
    read.update(param_gap=0.0, param_slack=float("inf"), flips=0)
    leaves = zip(tree_leaves(got["params"]), tree_leaves(want["params"]),
                 tree_leaves(want["opt"]["mu"]))
    for p_got, p_want, mu_want in leaves:
        mu_w = mu_want.to("cpu", f64)
        scale = max(float(mu_w.abs().max()), 1e-30)
        x, tol = mu_w / lead, mu_rtol * scale / lead
        at = adam_step(x)
        bound = lr * torch.maximum((adam_step(x + tol) - at).abs(),
                                   (adam_step(x - tol) - at).abs()) + 1e-6
        diff = (p_got.to("cpu", f64) - p_want.to("cpu", f64)).abs()
        read["param_gap"] = max(read["param_gap"], float(diff.max()))
        read["param_slack"] = min(read["param_slack"], float((bound - diff).min()))
        read["flips"] += int((diff > 1e-6).sum())
    failed = [what for what, ok in (
        (f"loss rel > {loss_rtol}", read["loss_rel"] <= loss_rtol),
        (f"grad norm rel > {gnorm_rtol}", read["gnorm_rel"] <= gnorm_rtol),
        (f"mu > {mu_rtol} of its leaf's scale", read["mu_frac"] <= mu_rtol),
        ("a param entry past its bound", read["param_slack"] >= 0)) if not ok]
    assert not failed, f"first step: {', '.join(failed)}; readings {read}"
    return read


def _named_leaves(tree, path: str = ""):
    """(path, leaf) in ``tree_leaves``' order (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _named_leaves(t, f"{path}/{i}")
    else:
        yield path, tree


def step_gap(got: Dict[str, Any], got_metrics: Dict[str, Any],
             want: Dict[str, Any], want_metrics: Dict[str, Any]) -> Dict[str, Any]:
    """How far one train step's state ``got`` lies from ``want`` (float32
    moments), read and not checked: ``loss_rel`` and ``gnorm_rel``
    (relative), ``mu_frac`` (the largest |mu diff| over its leaf's largest
    |mu|) and ``mu_leaf``, that leaf's path in the params."""
    f64 = torch.float64
    read = {"loss_rel": abs(float(got_metrics["loss"]) / float(want_metrics["loss"]) - 1.0),
            "gnorm_rel": abs(float(got_metrics["grad_norm"]) / float(want_metrics["grad_norm"])
                             - 1.0),
            "mu_frac": 0.0, "mu_leaf": ""}
    for (name, mu_got), mu_want in zip(_named_leaves(got["opt"]["mu"]),
                                       tree_leaves(want["opt"]["mu"])):
        assert mu_got.dtype == mu_want.dtype == torch.float32, "moments not float32"
        mu_w = mu_want.to("cpu", f64)
        scale = max(float(mu_w.abs().max()), 1e-30)
        frac = float((mu_got.to("cpu", f64) - mu_w).abs().max()) / scale
        if frac > read["mu_frac"]:
            read["mu_frac"], read["mu_leaf"] = frac, name
    return read
