"""The bf16 attention backward's tile schedule and summation order, modelled
on the CPU.

``csrc/flash_attention.cu`` ``bwd_wgmma_pass`` runs two passes over 64-row
tiles: the dq pass (one block per lane, head and query tile) walks the key
tiles of ``_kv_block_range``; the dk/dv pass (one block per lane, kv head
and key tile) walks, for each of the G query heads, the query tiles that
see its key tile. Queries run to Sq and keys to Skv (cross-attention has
Sq decoder tokens against Skv encoder frames), the masks aligned top-left.
The range functions and the full-tile test below are
mirrored by hand from ``bwd_wgmma_pass`` and its launcher, and must be
edited together with them: these tests check the Python copy, and only the
card cases (``cases.BWD_CASES`` and ``cases.RECT_CASES``: ragged Sq and Skv,
window edges inside tiles) hold the kernel's own code. The tests check that each pass visits every unmasked (query, key)
pair exactly once and no tile without one, that the per-entry mask is
skipped only on tiles that no causal, window or ragged edge cuts, and that
the grid launches the heavy tiles first. Then the kernel's order of
accumulation (per streamed 64-row tile, per 16-row k-step of it, the hi
then the lo bf16 term of p or ds) is emulated in float32 and held to ``ref.attention_bwd_ref`` within
``ref.bwd_tolerance`` at gemma2-9b's head shapes. It tests no kernel code:
the card tests do.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional

import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from repro_torch.kernels.flash_attention import ref

TILE = 64
F32 = torch.float32


def n_tiles(S: int) -> int:
    return -(-S // TILE)


def dq_key_tiles(q_tile: int, Skv: int, causal: bool, window: Optional[int]) -> range:
    """The key tiles the dq pass's block of query tile ``q_tile`` walks, in
    order (``_kv_block_range`` at 64 rows, below Skv; none when the window
    starts at or past the last key the tile may see)."""
    r_lo = q_tile * TILE
    lo, hi = 0, Skv
    if causal:
        hi = min(hi, r_lo + TILE)
    if window:
        lo = max(lo, r_lo - window + 1)
    return range(lo // TILE, -(-hi // TILE) if lo < hi else lo // TILE)


def dkdv_query_tiles(k_tile: int, Sq: int, Skv: int, causal: bool,
                     window: Optional[int]) -> range:
    """The query tiles the dk/dv pass's block of key tile ``k_tile`` walks for
    each head, in order: causal from the tile's first key, a window up to its
    last key + window - 1, below Sq, walked from the last (so the blocks of
    one kv head start on the same tiles)."""
    r_lo = k_tile * TILE
    r_last = min(Skv, r_lo + TILE) - 1
    q_first, q_last = (r_lo if causal else 0), Sq - 1
    if window:
        q_last = min(q_last, r_last + window - 1)
    return range(q_last // TILE, q_first // TILE - 1, -1)


def dkdv_items(k_tile: int, G: int, Sq: int, Skv: int, causal: bool,
               window: Optional[int]):
    """(head within the kv group, query tile) in the dk/dv block's order."""
    return [(hh, qt) for hh in range(G)
            for qt in dkdv_query_tiles(k_tile, Sq, Skv, causal, window)]


def dq_launch_order(S: int):
    """Query tiles in the dq grid's launch order for each (lane, head)
    (``blockIdx.x``, the fastest): most key tiles first."""
    return [n_tiles(S) - 1 - y for y in range(n_tiles(S))]


def dkdv_launch_order(S: int):
    """Key tiles in the dk/dv grid's launch order for each (lane, kv head):
    key tile 0, which the most query tiles see under causality, first."""
    return list(range(n_tiles(S)))


def full_tile(q_lo: int, k_lo: int, Sq: int, Skv: int, causal: bool,
              window: Optional[int]) -> bool:
    """The kernel's test for a tile that no edge cuts (no per-entry mask)."""
    return (q_lo + TILE <= Sq and k_lo + TILE <= Skv and (not causal or k_lo + TILE - 1 <= q_lo)
            and (not window or k_lo > q_lo + TILE - 1 - window))


def visible(q: int, k: int, Sq: int, Skv: int, causal: bool, window: Optional[int]) -> bool:
    return q < Sq and k < Skv and (not causal or k <= q) and (not window or k > q - window)


def _tiles_with_a_visible_pair(Sq, Skv, causal, window):
    return {(q // TILE, k // TILE) for q in range(Sq) for k in range(Skv)
            if visible(q, k, Sq, Skv, causal, window)}


# Sq and Skv drawn apart, and as often equal (self-attention)
_LENGTHS = st.one_of(st.integers(1, 400).map(lambda n: (n, n)),
                     st.tuples(st.integers(1, 400), st.integers(1, 400)))


@settings(max_examples=60, deadline=None)
@given(lengths=_LENGTHS, causal=st.booleans(),
       window=st.one_of(st.none(), st.integers(1, 450)))
# query tile 1's window starts at key 63, past the one key: it walks none
@example(lengths=(65, 1), causal=False, window=2)
def test_each_pass_visits_every_visible_tile_once(lengths, causal, window):
    Sq, Skv = lengths
    want = _tiles_with_a_visible_pair(Sq, Skv, causal, window)
    dq = Counter((qt, kt) for qt in range(n_tiles(Sq))
                 for kt in dq_key_tiles(qt, Skv, causal, window))
    dkdv = Counter((qt, kt) for kt in range(n_tiles(Skv))
                   for _, qt in dkdv_items(kt, 1, Sq, Skv, causal, window))
    for name, seen in (("dq", dq), ("dk/dv", dkdv)):
        assert set(seen) == want, f"{name}: visits {sorted(set(seen) ^ want)} wrongly"
        assert max(seen.values()) == 1, f"{name}: a tile pair visited twice"
    # G heads: each (head, query tile) once per key tile
    for kt in range(n_tiles(Skv)):
        items = dkdv_items(kt, 4, Sq, Skv, causal, window)
        assert len(items) == len(set(items)) == \
            4 * len(dkdv_query_tiles(kt, Sq, Skv, causal, window))


@settings(max_examples=60, deadline=None)
@given(lengths=_LENGTHS, causal=st.booleans(),
       window=st.one_of(st.none(), st.integers(1, 450)))
def test_mask_skipped_only_on_uncut_tiles(lengths, causal, window):
    Sq, Skv = lengths
    for qt, kt in _tiles_with_a_visible_pair(Sq, Skv, causal, window):
        q_lo, k_lo = qt * TILE, kt * TILE
        uncut = all(visible(q, k, Sq, Skv, causal, window)
                    for q in range(q_lo, q_lo + TILE) for k in range(k_lo, k_lo + TILE))
        assert full_tile(q_lo, k_lo, Sq, Skv, causal, window) == uncut, (qt, kt)


@pytest.mark.parametrize("S", [64, 191, 4096])
def test_heavy_tiles_launch_first_under_causality(S):
    for window in (None, 4096):
        dq_work = [len(dq_key_tiles(qt, S, True, window)) for qt in dq_launch_order(S)]
        dkdv_work = [len(dkdv_items(kt, 2, S, S, True, window)) for kt in dkdv_launch_order(S)]
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
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    q5, g5 = q.reshape(B, Sq, KV, G, hd).to(F32), g.reshape(B, Sq, KV, G, hd).to(F32)
    kf, vf = k.to(F32), v.to(F32)
    s, t = ref._masked_scores(q.reshape(B, Sq, KV, G, hd), k, causal=causal, window=window,
                              softcap=softcap)
    delta = torch.einsum("bqkgh,bqkgh->bkgq", g5, out.reshape(B, Sq, KV, G, hd).to(F32))
    p = torch.exp(s - lse.reshape(B, KV, G, Sq)[..., None])
    ds = p * (torch.einsum("bqkgh,bskh->bkgqs", g5, vf) - delta[..., None])
    if t is not None:
        ds = ds * (1.0 - t * t)
    ds = ds * hd ** -0.5
    p_hl, ds_hl = _split(p), _split(ds)

    def steps(i, n):
        # the 16-row k-steps of tile i of n rows (rows past n are zero in the kernel)
        end = min(n, (i + 1) * TILE)
        return [slice(a, min(end, a + 16)) for a in range(i * TILE, end, 16)]

    # dq: every query row over the key tiles in ascending order (tiles a
    # block does not walk hold p = ds = 0 exactly, so adding them is exact)
    dq = torch.zeros(B, KV, G, Sq, hd)
    for kt in range(n_tiles(Skv)):
        for c in steps(kt, Skv):
            for term in ds_hl:
                dq = dq + torch.einsum("bkgqs,bskh->bkgqh", term[..., c], kf[:, c])
    # dk, dv: every key row over (head, query tile) items, heads outer
    dk = torch.zeros(B, Skv, KV, hd)
    dv = torch.zeros(B, Skv, KV, hd)
    for hh in range(G):
        for qt in reversed(range(n_tiles(Sq))):
            for rows in steps(qt, Sq):
                for term in ds_hl:
                    dk = dk + torch.einsum("bkqs,bqkh->bskh", term[:, :, hh, rows],
                                           q5[:, rows, :, hh])
                for term in p_hl:
                    dv = dv + torch.einsum("bkqs,bqkh->bskh", term[:, :, hh, rows],
                                           g5[:, rows, :, hh])
    dq = dq.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# (B, S, H, KV, hd, causal, window, softcap[, Skv]): gemma2-9b's heads and
# head dim (G 2, softcap 50) as a global and as a local layer (window edges
# inside the tiles), a ragged S across the 64-row tiles with G 4, and MQA
# at hd 64 without causality or softcap (a ragged last k-step of 15 rows);
# then Sq = S against Skv: whisper-base's cross-attention heads (8 / 8 x 64,
# non-causal, no softcap) at 100 decoder rows against 300 frames (ragged
# both ways), and a causal rectangle (96 queries, 160 keys)
EMU_CASES = [
    (1, 512, 4, 2, 256, True, None, 50.0),
    (1, 512, 4, 2, 256, True, 100, 50.0),
    (1, 191, 8, 2, 256, True, None, 50.0),
    (2, 127, 4, 1, 64, False, None, None),
    (1, 100, 8, 8, 64, False, None, None, 300),
    (1, 96, 4, 2, 64, True, None, None, 160),
]


@pytest.mark.parametrize("case", EMU_CASES, ids=lambda c: "-".join(map(str, c)))
def test_tiled_hi_lo_order_within_bwd_tolerance(case):
    B, S, H, KV, hd, causal, window, cap = case[:8]
    Skv = case[8] if len(case) > 8 else S
    gen = torch.Generator().manual_seed(S + H)
    q, g = (torch.randn(B, S, H, hd, generator=gen).to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(B, Skv, KV, hd, generator=gen).to(torch.bfloat16) for _ in range(2))
    kw = dict(causal=causal, window=window, softcap=cap)
    out = ref.attention_ref(q, k, v, **kw)
    lse = ref.attention_lse_ref(q, k, **kw)
    want = ref.attention_bwd_ref(q, k, v, out, lse, g, **kw)
    got = _emulate(q, k, v, out, lse, g, **kw)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        ok, err = ref.bwd_close(a, w)
        assert ok, f"{name}: max |diff| {err}"
