"""The bf16 attention backward's precision design, modelled on the CPU.

``flash_attention_bwd``'s bf16 passes run their products on tensor cores
with bf16 operands. q, k, v and the output gradient g are bf16 already, so
S = q k^T and dP = g v^T are exact products summed in float32; p and ds are
float32 and enter dv += p^T g, dk += ds^T q and dq += ds k as two bf16
operands, hi = bf16(x) and lo = bf16(x - hi), two products each
(``csrc/flash_attention.cu`` ``tc_scores`` / ``tc_accumulate``). This file
emulates that arithmetic in float32 on the CPU and holds it to the plain
version (``ref.attention_bwd_ref``) within ``ref.bwd_tolerance``, the bound
the card holds the kernel to; and shows that one bf16 rounding of p and ds
(no lo term) leaves that bound, which is why the split is there. It tests
no kernel code: ``chip_smoke.py`` and the card tests do.
"""

from __future__ import annotations

import pytest
import torch

from repro_torch.kernels.flash_attention import ref

F32 = torch.float32


def _emulate(q, k, v, out, lse, g, *, causal, window, softcap, split: bool):
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    q5, g5 = q.reshape(B, S, KV, G, hd), g.reshape(B, S, KV, G, hd).to(F32)
    s, t = ref._masked_scores(q5, k, causal=causal, window=window, softcap=softcap)
    delta = torch.einsum("bqkgh,bqkgh->bkgq", g5, out.reshape(B, S, KV, G, hd).to(F32))
    p = torch.exp(s - lse.reshape(B, KV, G, S)[..., None])
    ds = p * (torch.einsum("bqkgh,bskh->bkgqs", g5, v.to(F32)) - delta[..., None])
    if t is not None:
        ds = ds * (1.0 - t * t)
    ds = ds * hd ** -0.5

    def terms(x):
        hi = x.to(torch.bfloat16).to(F32)
        return (hi, (x - hi).to(torch.bfloat16).to(F32)) if split else (hi,)

    dq = sum(torch.einsum("bkgqs,bskh->bqkgh", a, k.to(F32)) for a in terms(ds))
    dk = sum(torch.einsum("bkgqs,bqkgh->bskh", a, q5.to(F32)) for a in terms(ds))
    dv = sum(torch.einsum("bkgqs,bqkgh->bskh", a, g5) for a in terms(p))
    return dq.reshape(B, S, H, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# (B, S, H, KV, hd, causal, window, softcap): gemma2-9b's heads and head dim,
# an MQA case with a window inside the 32-row tiles
CASES = [
    (1, 256, 4, 2, 256, True, None, 50.0),
    (2, 200, 4, 1, 128, True, 48, None),
    (1, 512, 16, 8, 256, True, 100, 50.0),
]


@pytest.mark.parametrize("split", [True, False], ids=["hi+lo", "one-rounding"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_bf16_backward_needs_hi_lo_operands(case, split):
    B, S, H, KV, hd, causal, window, cap = case
    gen = torch.Generator().manual_seed(S + hd)
    q, g = (torch.randn(B, S, H, hd, generator=gen).to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(B, S, KV, hd, generator=gen).to(torch.bfloat16) for _ in range(2))
    kw = dict(causal=causal, window=window, softcap=cap)
    out = ref.attention_ref(q, k, v, **kw)
    lse = ref.attention_lse_ref(q, k, **kw)
    want = ref.attention_bwd_ref(q, k, v, out, lse, g, **kw)
    got = _emulate(q, k, v, out, lse, g, split=split, **kw)
    close = [ref.bwd_close(a, w)[0] for a, w in zip(got, want)]
    if split:
        assert all(close), close
    else:
        assert not any(close), close
