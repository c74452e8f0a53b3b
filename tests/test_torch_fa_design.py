"""The arithmetic of the two attention kernels' designs, on the CPU.

The CUDA kernels (``csrc/flash_attention.cu``) run only on the card, where
``tests/test_torch_cuda.py`` holds them to the plain version. What
follows models, in torch, the order and precision of each
kernel's operations, and holds the model to the same bound the card tests
use, ``fa_tolerance`` (1e-5 of the output's scale, plus one bf16 ulp of
each entry for bf16 outputs): it records why the designs are within the
bound, and it is no test of the kernels' code. Inputs are drawn with numpy
from a seed.

- The tensor-core prefill (``fa_prefill_tc_kernel``): QK^T of bf16 inputs
  summed in f32 (the products of two bf16 values are exact), the online
  softmax over 64-key tiles in log2 units with the kernel's folded
  constants, the running max moved only when a row of a warp's 16 grows
  by more than 8, and p handed to the PV product as two bf16 terms,
  hi = bf16(p) and lo = bf16(p - hi). Within the bound at gemma2-9b's head
  shape (hd 256, G 2, causal, softcap 50) at S 64 and 512; p rounded once
  to bf16 is outside it, which is why the kernel splits p.
- The split-KV decode (``fa_decode_split_kernel``): chunks cut by the
  wrapper's own ``split_cache`` and ``decode_plan``, teams of lanes each
  keeping an online softmax over U keys a step, merged by a butterfly in
  the warp, the warps in order, then the chunks in order; n_split 1, 2, 7
  and L, kv_len 1, one past a chunk edge and L (chunks wholly past kv_len
  give empty partials), and the plan at gemma2-9b's serving shape.
- ``flash_attention.decode_plan``, the wrapper's pure-Python choice of
  ``n_split`` and of the partials' shapes: the chunks cover [0, L), none is
  empty or (but for a whole cache) shorter than ``DECODE_MIN_CHUNK``, and
  there are at least two blocks per SM where the cache and
  ``DECODE_MAX_SPLIT`` allow.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention as kern
from repro_torch.kernels.flash_attention import ref

NEG = ref.NEG_INF
TILE = 64
LOG2E = 1.4426950408889634


def _inputs(seed, q_shape, kv_shape, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dtype)
                 for s in (q_shape, kv_shape, kv_shape))


def _round_bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _exp2_ftz(x):
    """2^x with subnormal results flushed to 0, as ``ex2.approx.ftz``."""
    p = torch.exp2(x)
    return torch.where(p < 2.0 ** -126, torch.zeros(()), p)


def tc_prefill(q, k, v, *, causal, window, softcap, p_terms):
    """The tensor-core prefill's numerics (``fa_prefill_tc_kernel``) in
    torch: 64-key tiles; f32 scores in log2 units with the kernel's folded
    constants (``cap log2 e * tanh(s * scale / cap)``, or ``s * scale
    log2 e``); the online softmax whose running max moves only when a row of
    the warp's 16 rows has grown by more than 8, and then for all 16; 2^x
    flushed to zero below the normal range; p as ``p_terms`` before the PV
    product: "hi_lo" (two bf16 terms, the kernel's choice) or "bf16" (one
    rounding). A model of the design's arithmetic, not the kernel: the card
    tests hold the kernel itself to the plain version."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    f32 = torch.float32
    rows = -(-S // 16) * 16                    # whole warps of 16 query rows
    qf = torch.zeros(B, rows, KV, G, hd)
    qf[:, :S] = q.to(f32).reshape(B, S, KV, G, hd)
    kf, vf = k.to(f32), v.to(f32)
    scale = torch.tensor(hd ** -0.5, dtype=f32)
    log2e = torch.tensor(LOG2E, dtype=f32)
    if softcap is not None:
        arg_mul, cap_mul = scale / torch.tensor(softcap, dtype=f32), softcap * log2e
    else:
        arg_mul = scale * log2e
    m = torch.full((B, KV, G, rows), NEG)
    l = torch.zeros((B, KV, G, rows))
    o = torch.zeros((B, KV, G, rows, hd))
    qpos = torch.arange(rows)[:, None]
    for k_lo in range(0, S, TILE):
        kt, vt = kf[:, k_lo:k_lo + TILE], vf[:, k_lo:k_lo + TILE]
        s = torch.einsum("bqkgh,bskh->bkgqs", qf, kt) * arg_mul
        if softcap is not None:
            s = cap_mul * torch.tanh(s)
        kpos = k_lo + torch.arange(kt.shape[1])[None, :]
        ok = torch.ones_like(kpos - qpos, dtype=torch.bool)
        if causal:
            ok &= kpos <= qpos
        if window is not None:
            ok &= kpos > qpos - window
        s = torch.where(ok, s, torch.full((), NEG))
        mx = torch.maximum(m, s.amax(-1))
        grow = (mx > m + 8.0).unflatten(-1, (rows // 16, 16)).any(-1)
        grow = grow.repeat_interleave(16, dim=-1)
        alpha = torch.where(grow, _exp2_ftz(m - mx), torch.ones(()))
        m = torch.where(grow, mx, m)
        l = l * alpha
        o = o * alpha[..., None]
        m_use = torch.where(m == NEG, torch.zeros(()), m)
        p = _exp2_ftz(s - m_use[..., None])
        l = l + p.sum(-1)
        if p_terms == "hi_lo":
            hi = _round_bf16(p)
            pv = (torch.einsum("bkgqs,bskh->bkgqh", hi, vt)
                  + torch.einsum("bkgqs,bskh->bkgqh", _round_bf16(p - hi), vt))
        else:
            pv = torch.einsum("bkgqs,bskh->bkgqh", _round_bf16(p), vt)
        o = o + pv
    out = (o / l.clamp_min(1e-30)[..., None])[:, :, :, :S]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd).to(q.dtype)


@pytest.mark.parametrize("S", [64, 512])
def test_tc_prefill_with_hi_lo_p_is_within_tolerance(S):
    q, k, v = _inputs(S, (1, S, 4, 256), (1, S, 2, 256))
    kw = dict(causal=True, window=None, softcap=50.0)
    want = ref.attention_ref(q, k, v, **kw)
    got = tc_prefill(q, k, v, p_terms="hi_lo", **kw)
    ok, err = ref.fa_close(got, want)
    assert ok, err


@pytest.mark.parametrize("S", [64, 512])
def test_tc_prefill_with_one_bf16_rounding_of_p_is_outside_tolerance(S):
    q, k, v = _inputs(S, (1, S, 4, 256), (1, S, 2, 256))
    kw = dict(causal=True, window=None, softcap=50.0)
    want = ref.attention_ref(q, k, v, **kw)
    got = tc_prefill(q, k, v, p_terms="bf16", **kw)
    diff = (got.float() - want.float()).abs()
    outside = int((diff > ref.fa_tolerance(want)).sum())
    assert outside > 0
    assert not ref.fa_close(got, want)[0]


def test_tc_prefill_window_and_ragged_tiles():
    """A window below S and a ragged last tile (S 100 = 64 + 36) through the
    same emulation, G 2, hd 64, no softcap."""
    q, k, v = _inputs(7, (2, 100, 4, 64), (2, 100, 2, 64))
    kw = dict(causal=True, window=40, softcap=None)
    ok, err = ref.fa_close(tc_prefill(q, k, v, p_terms="hi_lo", **kw),
                           ref.attention_ref(q, k, v, **kw))
    assert ok, err


DEC_WARPS = 4                                  # kDecWarps


def decode_geometry(dtype, hd):
    """``DecodeGeom`` of ``fa_decode_split_kernel`` (csrc/flash_attention.cu):
    (teams per block, keys per team step U, teams per warp). A team of
    lanes owns one key row at a time, each lane 16 bytes or hd / 32 dims."""
    vec = 16 // (2 if dtype == torch.bfloat16 else 4)
    dpl = max(hd // 32, vec)
    per_warp = 32 // (hd // dpl)
    return DEC_WARPS * per_warp, 4 if dtype == torch.bfloat16 else 2, per_warp


def _merge(a, b):
    """Two online-softmax states (m, l, acc) merged, ``a``'s terms first."""
    m = torch.maximum(a[0], b[0])
    fa, fb = torch.exp(a[0] - m), torch.exp(b[0] - m)
    return m, a[1] * fa + b[1] * fb, a[2] * fa[..., None] + b[2] * fb[..., None]


def _merge_in_order(states):
    """States merged as the kernel merges warps and chunks: the max over all,
    then the scaled sums added in order."""
    m = states[0][0]
    for st in states[1:]:
        m = torch.maximum(m, st[0])
    total_l = torch.zeros_like(m)
    total = torch.zeros_like(states[0][2])
    for sm, sl, sacc in states:
        f = torch.exp(sm - m)
        total_l = total_l + f * sl
        total = total + f[..., None] * sacc
    return m, total_l, total


def split_kv_decode(q, k, v, kv_len, n_split, chunk, softcap):
    """The split-KV decode's order of operations, in torch: chunk p covers
    slots [p * chunk, (p + 1) * chunk) below L and kv_len[b]; in it, team t
    of a block takes keys c0 + t + teams * (U * step + u) and keeps an online
    softmax (m, l, acc) per query row over U keys a step; the teams of a
    warp merge by a butterfly, the warps in warp order, then the chunks in
    chunk order. A chunk with no key below kv_len gives an empty partial
    (m = -1e30, l = 0). A model of the kernel's algebra, not the kernel:
    the card tests hold the kernel itself to the plain version."""
    B, Sq, H, hd = q.shape
    L, KV = k.shape[1], k.shape[2]
    G = H // KV
    R = G * Sq
    teams, U, per_warp = decode_geometry(q.dtype, hd)
    f32 = torch.float32
    qr = q.to(f32).reshape(B, Sq, KV, G, hd).permute(0, 2, 1, 3, 4).reshape(B, KV, R, hd)
    kf, vf = k.to(f32).permute(0, 2, 1, 3), v.to(f32).permute(0, 2, 1, 3)
    scale = hd ** -0.5
    parts = []
    for p in range(n_split):
        c0 = p * chunk
        c1 = torch.clamp(kv_len.long(), max=min(c0 + chunk, L))[:, None, None]   # (B, 1, 1)
        states = []
        for team in range(teams):
            m = torch.full((B, KV, R), NEG)
            l = torch.zeros((B, KV, R))
            acc = torch.zeros((B, KV, R, hd))
            for base in range(c0 + team, min(c0 + chunk, L), teams * U):
                keys = [t for t in (base + teams * u for u in range(U)) if t < L]
                xs = []
                for t in keys:
                    x = torch.einsum("bkrh,bkh->bkr", qr, kf[:, :, t]) * scale
                    if softcap is not None:
                        x = softcap * torch.tanh(x / softcap)
                    xs.append(x)
                mx = m
                for t, x in zip(keys, xs):
                    mx = torch.where(t < c1, torch.maximum(mx, x), mx)
                alpha = torch.exp(m - mx)
                l, acc = l * alpha, acc * alpha[..., None]
                for t, x in zip(keys, xs):
                    pt = torch.where(t < c1, torch.exp(x - mx), torch.zeros(()))
                    l = l + pt
                    acc = acc + pt[..., None] * vf[:, :, t][:, :, None, :]
                m = mx
            states.append((m, l, acc))
        warps = []
        for w in range(DEC_WARPS):
            st = states[w * per_warp:(w + 1) * per_warp]
            o = 1
            while o < per_warp:
                st = [_merge(st[i], st[i ^ o]) for i in range(per_warp)]
                o *= 2
            warps.append(st[0])
        parts.append(_merge_in_order(warps))
    _, total_l, total = parts[0] if n_split == 1 else _merge_in_order(parts)
    out = total / total_l.clamp_min(1e-30)[..., None]
    return out.reshape(B, KV, Sq, G, hd).permute(0, 2, 1, 3, 4).reshape(B, Sq, H, hd).to(q.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n_split", [1, 2, 7, "L"])
def test_split_kv_merge_equals_plain(n_split, dtype):
    """Chunks cut as the wrapper cuts them (``split_cache``: 7 asked over 23
    slots gives 8 chunks of 3), kv_len 1, one past the first chunk's edge
    and L, so that some chunks lie wholly past kv_len."""
    L, KV, G, hd = 23, 2, 2, 64
    n, chunk = kern.split_cache(L, L if n_split == "L" else n_split)
    q, k, v = _inputs(n, (3, 1, KV * G, hd), (3, L, KV, hd), dtype)
    kv_len = torch.tensor([1, min(chunk + 1, L), L], dtype=torch.int32)
    got = split_kv_decode(q, k, v, kv_len, n, chunk, 50.0)
    want = ref.attention_ref(q, k, v, causal=False, softcap=50.0, kv_len=kv_len)
    ok, err = ref.fa_close(got, want)
    assert ok, err


def test_split_kv_merge_with_several_query_rows():
    """Sq 2 and G 4 (8 rows per block), 5 chunks over L 40 with kv_len
    reaching only the first chunk of one lane."""
    q, k, v = _inputs(3, (2, 2, 8, 32), (2, 40, 2, 32))
    n, chunk = kern.split_cache(40, 5)
    kv_len = torch.tensor([5, 40], dtype=torch.int32)
    got = split_kv_decode(q, k, v, kv_len, n, chunk, None)
    want = ref.attention_ref(q, k, v, causal=False, kv_len=kv_len)
    ok, err = ref.fa_close(got, want)
    assert ok, err


def test_split_kv_at_the_serving_plan():
    """gemma2-9b's serving decode as ``decode_plan`` cuts it for 4 lanes on
    132 SMs (8 kv heads, 2 rows each, hd 256, a 529-slot cache), bf16,
    softcap 50, kv_len from 1 to full."""
    B, KV, L, hd = 4, 8, 529, 256
    n, chunk, _, _ = kern.decode_plan(B, KV, L, 2, hd)
    assert n > 1
    q, k, v = _inputs(11, (B, 1, 2 * KV, hd), (B, L, KV, hd))
    kv_len = torch.tensor([1, chunk + 1, 300, L], dtype=torch.int32)
    got = split_kv_decode(q, k, v, kv_len, n, chunk, 50.0)
    want = ref.attention_ref(q, k, v, causal=False, softcap=50.0, kv_len=kv_len)
    ok, err = ref.fa_close(got, want)
    assert ok, err


@pytest.mark.parametrize("L", [1, 23, 529, 4096])
def test_decode_plan_covers_the_cache(L):
    for pairs in (2, 3, 6, 8, 16, 24, 32, 64):
        for rows, hd in ((1, 16), (2, 256), (16, 64)):
            n, chunk, acc_shape, ml_shape = kern.decode_plan(pairs, 1, L, rows, hd)
            bounds = [(p * chunk, min((p + 1) * chunk, L)) for p in range(n)]
            assert bounds[0][0] == 0 and bounds[-1][1] == L
            assert all(lo < hi for lo, hi in bounds)
            assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
            assert 1 <= n <= kern.DECODE_MAX_SPLIT
            assert n == 1 or chunk >= kern.DECODE_MIN_CHUNK
            want = -(-kern.DECODE_WAVES * kern.H100_SMS // pairs)
            if want <= min(kern.DECODE_MAX_SPLIT, L // kern.DECODE_MIN_CHUNK):
                assert pairs * n >= kern.DECODE_WAVES * kern.H100_SMS
            assert acc_shape == (pairs, n, rows, hd)
            assert ml_shape == (pairs, n, rows, 2)


@pytest.mark.parametrize("lanes,want_blocks", [(4, 264), (8, 264)])
def test_decode_plan_at_the_serving_shape(lanes, want_blocks):
    """gemma2-9b's serving decode (8 kv heads, a 529-slot cache, 2 rows per
    kv head): at least two waves of blocks over the H100's 132 SMs."""
    n, chunk, acc_shape, _ = kern.decode_plan(lanes, 8, 529, 2, 256)
    assert lanes * 8 * n >= want_blocks
    assert (n - 1) * chunk < 529 <= n * chunk
    assert acc_shape == (lanes * 8, n, 2, 256)
