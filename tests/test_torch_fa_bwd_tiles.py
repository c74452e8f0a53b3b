"""The bf16 attention backward's tile schedule and summation order, modelled
on the CPU.

``csrc/flash_attention.cu`` ``bwd_wgmma_pass`` runs two passes over 64-row
tiles: the dq pass (one block per lane, head and query tile) walks the key
tiles of ``_kv_block_range``; the dk/dv pass (one block per lane, kv head
and key tile) walks, for each of the G query heads, the query tiles that
see its key tile. The range functions and the full-tile test below are
mirrored by hand from ``bwd_wgmma_pass`` and its launcher, and must be
edited together with them: these tests check the Python copy, and only the
card cases (``cases.BWD_CASES``, ragged S and window edges inside tiles)
hold the kernel's own code. The tests check that each pass visits every unmasked (query, key)
pair exactly once and no tile without one, that the per-entry mask is
skipped only on tiles that no causal, window or ragged edge cuts, and that
the grid launches the heavy tiles first. Then the kernel's order of
accumulation (per streamed 64-row tile, per 16-row k-step of it, the hi
then the lo bf16 term of p or ds) is emulated in float32 and held to ``ref.attention_bwd_ref`` within
``ref.bwd_tolerance`` at gemma2-9b's head shapes. It tests no kernel code:
``chip_smoke.py`` and the card tests do.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.kernels.flash_attention import ref

TILE = 64
F32 = torch.float32


def n_tiles(S: int) -> int:
    return -(-S // TILE)


def dq_key_tiles(q_tile: int, S: int, causal: bool, window: Optional[int]) -> range:
    """The key tiles the dq pass's block of query tile ``q_tile`` walks, in
    order (``_kv_block_range`` at 64 rows)."""
    r_lo = q_tile * TILE
    lo, hi = 0, S
    if causal:
        hi = min(hi, r_lo + TILE)
    if window:
        lo = max(lo, r_lo - window + 1)
    return range(lo // TILE, -(-hi // TILE))


def dkdv_query_tiles(k_tile: int, S: int, causal: bool, window: Optional[int]) -> range:
    """The query tiles the dk/dv pass's block of key tile ``k_tile`` walks for
    each head, in order: causal from the tile's first key, a window up to its
    last key + window - 1, walked from the last (so the blocks of one kv head
    start on the same tiles)."""
    r_lo = k_tile * TILE
    r_last = min(S, r_lo + TILE) - 1
    q_first, q_last = (r_lo if causal else 0), S - 1
    if window:
        q_last = min(q_last, r_last + window - 1)
    return range(q_last // TILE, q_first // TILE - 1, -1)


def dkdv_items(k_tile: int, G: int, S: int, causal: bool, window: Optional[int]):
    """(head within the kv group, query tile) in the dk/dv block's order."""
    return [(hh, qt) for hh in range(G) for qt in dkdv_query_tiles(k_tile, S, causal, window)]


def dq_launch_order(S: int):
    """Query tiles in the dq grid's launch order for each (lane, head)
    (``blockIdx.x``, the fastest): most key tiles first."""
    return [n_tiles(S) - 1 - y for y in range(n_tiles(S))]


def dkdv_launch_order(S: int):
    """Key tiles in the dk/dv grid's launch order for each (lane, kv head):
    key tile 0, which the most query tiles see under causality, first."""
    return list(range(n_tiles(S)))


def full_tile(q_lo: int, k_lo: int, S: int, causal: bool, window: Optional[int]) -> bool:
    """The kernel's test for a tile that no edge cuts (no per-entry mask)."""
    return (q_lo + TILE <= S and k_lo + TILE <= S and (not causal or k_lo + TILE - 1 <= q_lo)
            and (not window or k_lo > q_lo + TILE - 1 - window))


def visible(q: int, k: int, S: int, causal: bool, window: Optional[int]) -> bool:
    return q < S and k < S and (not causal or k <= q) and (not window or k > q - window)


def _tiles_with_a_visible_pair(S, causal, window):
    return {(q // TILE, k // TILE) for q in range(S) for k in range(S)
            if visible(q, k, S, causal, window)}


@settings(max_examples=60, deadline=None)
@given(S=st.integers(1, 400), causal=st.booleans(),
       window=st.one_of(st.none(), st.integers(1, 450)))
def test_each_pass_visits_every_visible_tile_once(S, causal, window):
    want = _tiles_with_a_visible_pair(S, causal, window)
    dq = Counter((qt, kt) for qt in range(n_tiles(S)) for kt in dq_key_tiles(qt, S, causal, window))
    dkdv = Counter((qt, kt) for kt in range(n_tiles(S))
                   for _, qt in dkdv_items(kt, 1, S, causal, window))
    for name, seen in (("dq", dq), ("dk/dv", dkdv)):
        assert set(seen) == want, f"{name}: visits {sorted(set(seen) ^ want)} wrongly"
        assert max(seen.values()) == 1, f"{name}: a tile pair visited twice"
    # G heads: each (head, query tile) once per key tile
    for kt in range(n_tiles(S)):
        items = dkdv_items(kt, 4, S, causal, window)
        assert len(items) == len(set(items)) == 4 * len(dkdv_query_tiles(kt, S, causal, window))


@settings(max_examples=60, deadline=None)
@given(S=st.integers(1, 400), causal=st.booleans(),
       window=st.one_of(st.none(), st.integers(1, 450)))
def test_mask_skipped_only_on_uncut_tiles(S, causal, window):
    for qt, kt in _tiles_with_a_visible_pair(S, causal, window):
        q_lo, k_lo = qt * TILE, kt * TILE
        uncut = all(visible(q, k, S, causal, window)
                    for q in range(q_lo, q_lo + TILE) for k in range(k_lo, k_lo + TILE))
        assert full_tile(q_lo, k_lo, S, causal, window) == uncut, (qt, kt)


@pytest.mark.parametrize("S", [64, 191, 4096])
def test_heavy_tiles_launch_first_under_causality(S):
    for window in (None, 4096):
        dq_work = [len(dq_key_tiles(qt, S, True, window)) for qt in dq_launch_order(S)]
        dkdv_work = [len(dkdv_items(kt, 2, S, True, window)) for kt in dkdv_launch_order(S)]
        assert dq_work == sorted(dq_work, reverse=True)
        assert dkdv_work == sorted(dkdv_work, reverse=True)
    # the training cell: 64 key tiles x 16 (lane, kv head) and 64 query
    # tiles x 32 (lane, head) blocks
    if S == 4096:
        assert n_tiles(S) * 2 * 8 == 1024 and n_tiles(S) * 2 * 16 == 2048


def _split(x):
    hi = x.to(torch.bfloat16).to(F32)
    return hi, (x - hi).to(torch.bfloat16).to(F32)


def _emulate(q, k, v, out, lse, g, *, causal, window, softcap):
    """The bf16 passes' arithmetic in float32: p and ds entry by entry as
    the reference computes them, then dq summed over the key tiles in the
    dq block's order (ascending) and dk, dv over the (head, query tile)
    items in the dk/dv block's order (heads outer, query tiles descending),
    as the kernel's ``kk`` loop adds them: per 16-row k-step of a tile, the
    hi term then the lo term. Within a k-step the 16 products are summed in
    one ``einsum``, not in the tensor cores' order, so that order is only
    approximated."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    q5, g5 = q.reshape(B, S, KV, G, hd).to(F32), g.reshape(B, S, KV, G, hd).to(F32)
    kf, vf = k.to(F32), v.to(F32)
    s, t = ref._masked_scores(q.reshape(B, S, KV, G, hd), k, causal=causal, window=window,
                              softcap=softcap)
    delta = torch.einsum("bqkgh,bqkgh->bkgq", g5, out.reshape(B, S, KV, G, hd).to(F32))
    p = torch.exp(s - lse.reshape(B, KV, G, S)[..., None])
    ds = p * (torch.einsum("bqkgh,bskh->bkgqs", g5, vf) - delta[..., None])
    if t is not None:
        ds = ds * (1.0 - t * t)
    ds = ds * hd ** -0.5
    p_hl, ds_hl = _split(p), _split(ds)
    T = n_tiles(S)

    def steps(i):
        # the 16-row k-steps of tile i (rows past S are zero in the kernel)
        end = min(S, (i + 1) * TILE)
        return [slice(a, min(end, a + 16)) for a in range(i * TILE, end, 16)]

    # dq: every query row over the key tiles in ascending order (tiles a
    # block does not walk hold p = ds = 0 exactly, so adding them is exact)
    dq = torch.zeros(B, KV, G, S, hd)
    for kt in range(T):
        for c in steps(kt):
            for term in ds_hl:
                dq = dq + torch.einsum("bkgqs,bskh->bkgqh", term[..., c], kf[:, c])
    # dk, dv: every key row over (head, query tile) items, heads outer
    dk = torch.zeros(B, S, KV, hd)
    dv = torch.zeros(B, S, KV, hd)
    for hh in range(G):
        for qt in reversed(range(T)):
            for rows in steps(qt):
                for term in ds_hl:
                    dk = dk + torch.einsum("bkqs,bqkh->bskh", term[:, :, hh, rows],
                                           q5[:, rows, :, hh])
                for term in p_hl:
                    dv = dv + torch.einsum("bkqs,bqkh->bskh", term[:, :, hh, rows],
                                           g5[:, rows, :, hh])
    dq = dq.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# (B, S, H, KV, hd, causal, window, softcap): gemma2-9b's heads and head
# dim (G 2, softcap 50) as a global and as a local layer (window edges
# inside the tiles), a ragged S across the 64-row tiles with G 4, and MQA
# at hd 64 without causality or softcap (a ragged last k-step of 15 rows)
EMU_CASES = [
    (1, 512, 4, 2, 256, True, None, 50.0),
    (1, 512, 4, 2, 256, True, 100, 50.0),
    (1, 191, 8, 2, 256, True, None, 50.0),
    (2, 127, 4, 1, 64, False, None, None),
]


@pytest.mark.parametrize("case", EMU_CASES, ids=lambda c: "-".join(map(str, c)))
def test_tiled_hi_lo_order_within_bwd_tolerance(case):
    B, S, H, KV, hd, causal, window, cap = case
    gen = torch.Generator().manual_seed(S + H)
    q, g = (torch.randn(B, S, H, hd, generator=gen).to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(B, S, KV, hd, generator=gen).to(torch.bfloat16) for _ in range(2))
    kw = dict(causal=causal, window=window, softcap=cap)
    out = ref.attention_ref(q, k, v, **kw)
    lse = ref.attention_lse_ref(q, k, **kw)
    want = ref.attention_bwd_ref(q, k, v, out, lse, g, **kw)
    got = _emulate(q, k, v, out, lse, g, **kw)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        ok, err = ref.bwd_close(a, w)
        assert ok, f"{name}: max |diff| {err}"
