"""The arithmetic of the bf16 SSD-scan kernel's design, on the CPU.

The CUDA kernels (``csrc/ssd_scan.cu``, three passes on the tensor cores)
run only on the card, where ``tests/test_torch_cuda.py`` holds them to
the plain version. What follows models, in
torch, the order and precision of the passes' operations, and holds the
model to the bound the card tests use, ``ssd_tolerance`` (1e-4 of the
output's scale, plus one bf16 ulp for bf16 outputs), against
``ref.ssd_scan_ref``: it records why the design is within the bound, and it
is no test of the kernels' code. Inputs are drawn with numpy from a seed.

- ``cum`` is made once per (row, chunk), by the kernel's warp scan (runs of
  consecutive steps per lane, a shuffle scan of the run totals), and the
  same bits feed the chunk-state pass, the state passing and the chunk
  scan.
- Chunk state: the decayed ``xw = x exp(cum_Q - cum_s) dt_s`` as two bf16
  terms (hi + lo) times bf16 B, summed in float32 over 64-step tiles.
- State passing: ``S_c = exp(cum_Q) S_{c-1} + term_c``; S_prev handed on as
  hi + lo.
- Chunk scan, per 64-row t-tile: for each s-tile at or below the
  diagonal, ``CB = C_t B_s^T`` from bf16 operands summed in float32,
  ``W = CB exp(cum_t - cum_s) dt_s`` with the mask before ``exp`` (strong
  decay at chunk 256 overflows above the diagonal), and ``y += W x_s`` with
  W as hi + lo; then ``y += exp(cum_t) C_t S_prev^T``; y rounded to bf16
  once.

Within the bound at mamba2-780m's row shape (P 64, N 128, chunk 256, S 512)
for the model-init dt and A and for strong decay, and at a ragged chunk of
96. One bf16 rounding of W or of S_prev moves y outside it, and one of xw
the final state: that is why the kernel splits all three. The wrapper's
pure-Python ``scan_plan`` (the passes' grids and scratch shapes) is tested
here too.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.ssd_scan import ref
from repro_torch.kernels.ssd_scan import ssd_scan as kern

TILE = kern.TILE
F32 = torch.float32


def _inputs(seed, rows, S, P, N, *, strong=False):
    """Kernel-layout inputs: x, B, C ~ N(0, 1) in bf16; dt and A as the
    model's init draws them (dt log-uniform in [1e-3, 0.1], A = -U(1, 16)),
    or strong decay (dt in [0.05, 0.1], A = -16)."""
    rng = np.random.default_rng(seed)

    def bf16(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)

    x, B, C = bf16((rows, S, P)), bf16((rows, S, N)), bf16((rows, S, N))
    if strong:
        dt = 0.05 + 0.05 * rng.random((rows, S, 1))
        A = np.full((rows, 1), -16.0)
    else:
        dt = np.exp(rng.random((rows, S, 1)) * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
        A = -(1.0 + 15.0 * rng.random((rows, 1)))
    return (x, torch.from_numpy(dt.astype(np.float32)), torch.from_numpy(A.astype(np.float32)),
            B, C)


def _bf16(v):
    return v.to(torch.bfloat16).to(F32)


def _terms(v, how):
    """v as the tensor-core operand(s): "hi_lo" two bf16 terms, hi = bf16(v)
    and lo = bf16(v - hi) (the kernel's choice), or "bf16" one rounding."""
    hi = _bf16(v)
    return (hi, _bf16(v - hi)) if how == "hi_lo" else (hi,)


def warp_cumsum(v):
    """``chunk_cumsum`` of csrc/ssd_scan.cu on (rows, Q) float32 steps: lane
    l of warp 0 sums the run of ``ceil(Q / 32)`` consecutive steps from
    ``l * per`` in order, a Hillis-Steele shuffle scan adds the run totals,
    and each lane adds its exclusive prefix to its run."""
    rows, Q = v.shape
    per = -(-Q // 32)
    run = torch.zeros((rows, 32 * per), dtype=F32)
    run[:, :Q] = v
    run = run.reshape(rows, 32, per)
    cum = torch.zeros_like(run)
    acc = torch.zeros((rows, 32), dtype=F32)
    for i in range(per):
        acc = acc + run[:, :, i]
        cum[:, :, i] = acc
    incl = acc.clone()
    lane = torch.arange(32)
    off = 1
    while off < 32:
        shifted = torch.cat([torch.zeros((rows, off), dtype=F32), incl[:, :-off]], dim=1)
        incl = torch.where(lane >= off, incl + shifted, incl)
        off *= 2
    excl = incl - acc
    cum = torch.where(lane[:, None] > 0, cum + excl[:, :, None], cum)
    return cum.reshape(rows, 32 * per)[:, :Q]


def tc_scan(x, dt, A, B, C, *, chunk, w_terms="hi_lo", s_terms="hi_lo", xw_terms="hi_lo"):
    """The bf16 passes' numerics (kernel layout: x (BH, S, P), dt (BH, S, 1),
    A (BH, 1), B and C (BH, S, N)) -> (y in x's dtype, final state f32). A
    model of the design's arithmetic, not the kernels: the card tests hold
    the kernels themselves to the plain version."""
    BH, S, P = x.shape
    N = B.shape[-1]
    Q, nc = chunk, S // chunk
    xf, Bf, Cf, dtf = x.to(F32), B.to(F32), C.to(F32), dt[..., 0].to(F32)
    a = A.to(F32)
    # pass 1: cum once per (row, chunk), and each chunk's own state term
    cums, terms = [], []
    for c in range(nc):
        sl = slice(c * Q, (c + 1) * Q)
        cum = warp_cumsum(dtf[:, sl] * a)                         # (BH, Q)
        decay = torch.exp(cum[:, -1:] - cum) * dtf[:, sl]
        xw = xf[:, sl] * decay[..., None]                          # (BH, Q, P)
        term = torch.zeros((BH, P, N), dtype=F32)
        for s0 in range(0, Q, TILE):
            st = slice(s0, min(s0 + TILE, Q))
            for part in _terms(xw[:, st], xw_terms):
                term = term + part.transpose(1, 2) @ Bf[:, sl][:, st]
        cums.append(cum)
        terms.append(term)
    # pass 2: state passing, S_prev handed on as operand terms
    state = torch.zeros((BH, P, N), dtype=F32)
    prevs = []
    for c in range(nc):
        prevs.append(_terms(state, s_terms))
        state = torch.exp(cums[c][:, -1])[:, None, None] * state + terms[c]
    # pass 3: per 64-row t-tile
    y = torch.zeros((BH, S, P), dtype=F32)
    for c in range(nc):
        base, cum = c * Q, cums[c]
        for t0 in range(0, Q, TILE):
            tr = torch.arange(t0, min(t0 + TILE, Q))
            Ct = Cf[:, base + tr]                                   # (BH, T, N)
            acc = torch.zeros((BH, len(tr), P), dtype=F32)
            for s0 in range(0, t0 + 1, TILE):
                sr = torch.arange(s0, min(s0 + TILE, Q))
                CB = Ct @ Bf[:, base + sr].transpose(1, 2)          # (BH, T, Ss)
                ok = sr[None, :] <= tr[:, None]
                diff = torch.where(ok, cum[:, tr][:, :, None] - cum[:, sr][:, None, :],
                                   torch.zeros(()))
                W = torch.where(ok, CB * torch.exp(diff) * dtf[:, base + sr][:, None, :],
                                torch.zeros(()))
                for part in _terms(W, w_terms):
                    acc = acc + part @ xf[:, base + sr]
            if c > 0:
                inter = torch.zeros_like(acc)
                for part in prevs[c]:
                    inter = inter + Ct @ part.transpose(1, 2)
                acc = acc + torch.exp(cum[:, tr])[..., None] * inter
            y[:, base + tr] = acc
    return y.to(x.dtype), state


def _held(inputs, chunk, **kw):
    """(y within ssd_tolerance, state within it, entries of y outside, of
    the state outside) for the model against ``ssd_scan_ref``."""
    y, s = tc_scan(*inputs, chunk=chunk, **kw)
    y_r, s_r = ref.ssd_scan_ref(*inputs, chunk=chunk)
    out = []
    for got, want in ((y, y_r), (s, s_r)):
        assert bool(torch.isfinite(got.float()).all())
        out.append(int(((got.float() - want.float()).abs() > ref.ssd_tolerance(want)).sum()))
    return out[0] == 0, out[1] == 0, out[0], out[1]


MAMBA2_780M = dict(S=512, P=64, N=128)       # one row of the serving prefill


@pytest.mark.parametrize("strong", [False, True], ids=["init", "strong_decay"])
def test_design_is_within_tolerance_at_mamba2_780m_row_shape(strong):
    inputs = _inputs(11 + strong, 3, **MAMBA2_780M, strong=strong)
    ok_y, ok_s, n_y, n_s = _held(inputs, 256)
    assert ok_y and ok_s, (n_y, n_s)


def test_design_is_within_tolerance_at_a_ragged_chunk():
    """chunk 96: the second t- and s-tile hold 32 steps (the kernel's
    zero-filled tile rows and masked entries)."""
    inputs = _inputs(5, 2, S=192, P=64, N=128)
    ok_y, ok_s, n_y, n_s = _held(inputs, 96)
    assert ok_y and ok_s, (n_y, n_s)


@pytest.mark.parametrize("operand", ["W", "S_prev", "xw"])
def test_one_bf16_rounding_of_an_operand_is_outside_tolerance(operand):
    """At mamba2-780m's row shape with the model-init dt and A, W (into
    W x) or S_prev (into C S_prev^T) rounded once to bf16 moves y outside
    ssd_tolerance, and the decayed xw rounded once moves the final state
    outside it: why the kernel hands each on as hi + lo."""
    inputs = _inputs(11, 3, **MAMBA2_780M)
    key = {"W": "w_terms", "S_prev": "s_terms", "xw": "xw_terms"}[operand]
    ok_y, ok_s, n_y, n_s = _held(inputs, 256, **{key: "bf16"})
    if operand == "xw":
        assert not ok_s and n_s > 0
    else:
        assert not ok_y and n_y > 0


def test_warp_cumsum_is_a_cumsum():
    """The modelled warp scan against a float64 cumsum, Q 1 to 256."""
    rng = np.random.default_rng(0)
    for Q in (1, 8, 31, 96, 256):
        v = torch.from_numpy(-rng.random((2, Q)).astype(np.float32))
        want = torch.cumsum(v.double(), dim=1)
        assert torch.allclose(warp_cumsum(v).double(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("lanes", [4, 8])
def test_scan_plan_at_the_serving_shape(lanes):
    """mamba2-780m's serving prefill (48 heads x 64, state 128, S 512 in
    chunks of 256): one pass-1 block per (row, chunk), 16 pass-2 blocks of
    512 entries per row, and one pass-3 block per 64-row t-tile of each
    (row, chunk), four per chunk (1 536 blocks at 4 lanes)."""
    plan = kern.scan_plan(lanes, 512, 48, 64, 128, 256)
    rows = lanes * 48
    assert plan.state_grid == (rows * 2,)
    assert plan.pass_grid == (rows, 16)
    assert plan.scan_grid == (rows * 2 * 4,)
    assert plan.cum == (rows, 512)
    assert plan.term == (rows, 2, 64, 128)
    assert plan.prev == (rows, 2, 2, 64, 128)
    if lanes == 4:
        assert plan.scan_grid == (1536,)


@pytest.mark.parametrize("S,P,N,chunk,t_tiles,pass_blocks", [
    (8, 64, 128, 8, 1, 16), (192, 64, 128, 96, 2, 16), (128, 16, 32, 32, 1, 1),
    (192, 32, 64, 64, 1, 4), (1024, 64, 128, 256, 4, 16)])
def test_scan_plan_covers_ragged_and_small_shapes(S, P, N, chunk, t_tiles, pass_blocks):
    """The card cases' shapes: t-tiles cover the chunk, pass-2 blocks cover
    every (p, n) entry at 4 per thread."""
    plan = kern.scan_plan(2, S, 4, P, N, chunk)
    assert plan.scan_grid == (2 * 4 * (S // chunk) * t_tiles,)
    assert plan.pass_grid == (8, pass_blocks)
    assert plan.pass_grid[1] * 512 >= P * N > (plan.pass_grid[1] - 1) * 512
    assert t_tiles * TILE >= chunk > (t_tiles - 1) * TILE


@pytest.mark.parametrize("P,N", [(60, 128), (64, 100)])
def test_wrapper_refuses_bf16_widths_off_the_tile_grid(P, N):
    """The bf16 passes copy 16-byte rows, so P and N are multiples of 8; the
    wrapper refuses others before it looks at the tensors' device (float32,
    on the CUDA-core kernel, takes them)."""
    t = lambda *shape, dtype=torch.bfloat16: torch.zeros(shape, dtype=dtype)  # noqa: E731
    with pytest.raises(ValueError, match="multiples of 8"):
        kern.ssd_scan_fwd(t(1, 16, 2, P), t(1, 16, 2, dtype=F32), t(2, dtype=F32),
                          t(1, 16, 1, N), t(1, 16, 1, N), chunk=8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kern.ssd_scan_fwd(t(1, 16, 2, P, dtype=F32), t(1, 16, 2, dtype=F32), t(2, dtype=F32),
                          t(1, 16, 1, N, dtype=F32), t(1, 16, 1, N, dtype=F32), chunk=8)
