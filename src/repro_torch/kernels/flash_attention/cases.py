"""The training attention kernels held to their plain versions on the card:
the cases that ``chip_smoke.py`` and the card tests both run.

Each case draws q, k, v and an output gradient g from a seed on the card,
runs ``flash_attention_fwd(..., lse=True)`` twice and
``flash_attention_bwd`` twice on the kernels' own (out, lse), and checks:
the two launches of each bit-identical; the lse within ``ref.lse_close`` of
``ref.attention_lse_ref``; the output within ``ref.fa_tolerance`` of
``ref.attention_ref``; dq, dk and dv within ``ref.bwd_tolerance`` of
``ref.attention_bwd_ref`` on the same (q, k, v, out, lse, g).

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
# 16 / 8 heads x 256, causal, window 4096, softcap 50)
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
]


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def check_bwd_case(case, dtype: torch.dtype, device, seed: int = 0) -> Dict[str, float]:
    """Run one case; raise AssertionError on any failed check. Returns the
    max |diff| of the output, the lse and each gradient."""
    B, S, H, KV, hd, causal, window, cap = case
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(*shape):
        return torch.randn(*shape, generator=gen, device=device).to(dtype)

    q, k, v = draw(B, S, H, hd), draw(B, S, KV, hd), draw(B, S, KV, hd)
    g = draw(B, S, H, hd)
    kw = dict(causal=causal, window=window, softcap=cap)
    what = f"{case} {dtype}"
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
                     loss_rtol: float, gnorm_rtol: float, mu_rtol: float) -> Dict[str, float]:
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

    Returns the readings: ``loss_rel``, ``gnorm_rel``, ``mu_frac`` (the
    largest |mu diff| over its leaf's largest |mu|), ``param_gap`` (the
    largest |param diff|), ``param_slack`` (the smallest of bound minus
    |param diff|) and ``flips`` (entries more than 1e-6 apart)."""
    assert int(got["opt"]["count"]) == int(want["opt"]["count"]) == 1, "not a first step"
    f64 = torch.float64
    lr = float(want_metrics["lr"])
    lead = 1.0 - opt_cfg.b1

    def adam_step(y):
        return y / (y.abs() + opt_cfg.eps)

    read = {"loss_rel": abs(float(got_metrics["loss"]) / float(want_metrics["loss"]) - 1.0),
            "gnorm_rel": abs(float(got_metrics["grad_norm"]) / float(want_metrics["grad_norm"])
                             - 1.0),
            "mu_frac": 0.0, "param_gap": 0.0, "param_slack": float("inf"), "flips": 0}
    leaves = zip(tree_leaves(got["params"]), tree_leaves(want["params"]),
                 tree_leaves(got["opt"]["mu"]), tree_leaves(want["opt"]["mu"]))
    for p_got, p_want, mu_got, mu_want in leaves:
        assert mu_got.dtype == mu_want.dtype == torch.float32, "moments not float32"
        mu_w = mu_want.to("cpu", f64)
        scale = max(float(mu_w.abs().max()), 1e-30)
        read["mu_frac"] = max(read["mu_frac"],
                              float((mu_got.to("cpu", f64) - mu_w).abs().max()) / scale)
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
