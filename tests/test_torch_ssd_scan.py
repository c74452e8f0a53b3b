"""The port's SSD scan (``kernels/ssd_scan``) against the reference's.

Inputs are made from a seed with numpy and fed to both packages. The port's
``ops.ssd_scan`` on CPU tensors is its plain version (``ref.ssd_scan_ref``),
the function of the CUDA kernel. It is held to:

- the reference's Pallas kernel in interpret mode (``ssd_ops.ssd_scan(...,
  interpret=True)``). Both compute the chunked scan in float32 and differ
  only in summation order, so the bound is tight and relative to the
  output's scale: ``ref.ssd_tolerance``, 1e-4 x max|want| (a few ulps of the
  cumsum that ``exp`` turns into relative error), plus one bf16 ulp of the
  value for bf16 outputs;
- the reference's sequential oracle ``ssd_ref``, with the tolerances the
  reference's own kernel test uses against it (chunked and sequential sum in
  different orders: rtol/atol 2e-3/1e-2 in f32, 3e-2/3e-1 in bf16).

The port's own ``ref.ssd_ref`` is a copy of the reference's oracle and is
held to it at float32 rounding (rtol 1e-5).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ops as j_ops
from repro.kernels.ssd_scan import ref as j_ref
from repro_torch import kernels
from repro_torch.kernels.ssd_scan import ops, ref
from repro_torch.kernels.ssd_scan import ssd_scan as kern

# the reference's SSD_CASES (tests/test_kernels.py): (B, S, H, P, G, N, chunk)
SSD_CASES = [
    (1, 128, 2, 16, 1, 32, 32),
    (2, 256, 4, 64, 2, 64, 64),
    (1, 256, 4, 64, 4, 128, 128),
    (1, 128, 2, 32, 1, 64, 32),
]
CASES = [
    (B, S, H, P, G, N, chunk, dtype)
    for (B, S, H, P, _, N, chunk) in SSD_CASES
    for G in (1, 2, 4) if H % G == 0
    for dtype in ("float32", "bfloat16")
]


def _inputs(case, seed=0, strong=False):
    B, S, H, P, G, N, _chunk, _dtype = case
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((B, S, H, P)).astype(np.float32)
    if strong:
        # A = -16, dt 0.05-0.1: above the diagonal cum_t - cum_s passes 88
        dt = rng.uniform(0.05, 0.1, (B, S, H)).astype(np.float32)
        A = np.full((H,), -16.0, np.float32)
    else:
        dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
        A = -np.exp(rng.uniform(-1.0, 1.0, (H,))).astype(np.float32)
    Bv = rng.standard_normal((B, S, G, N)).astype(np.float32)
    Cv = rng.standard_normal((B, S, G, N)).astype(np.float32)
    return xh, dt, A, Bv, Cv


def _port(arrs, dtype, chunk):
    xh, dt, A, Bv, Cv = arrs
    td = getattr(torch, dtype)
    y, s = ops.ssd_scan(torch.from_numpy(xh).to(td), torch.from_numpy(dt),
                        torch.from_numpy(A), torch.from_numpy(Bv).to(td),
                        torch.from_numpy(Cv).to(td), chunk=chunk)
    return y, s


def _reference_kernel(arrs, dtype, chunk):
    xh, dt, A, Bv, Cv = arrs
    jd = getattr(jnp, dtype)
    y, s = j_ops.ssd_scan(jnp.asarray(xh, jd), jnp.asarray(dt), jnp.asarray(A),
                          jnp.asarray(Bv, jd), jnp.asarray(Cv, jd),
                          chunk=chunk, interpret=True)
    yt = torch.from_numpy(np.array(y.astype(jnp.float32))).to(getattr(torch, dtype))
    return yt, torch.from_numpy(np.array(s))


def _bf16_round(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(a).to(torch.bfloat16).to(torch.float32).numpy()


def _sequential(arrs, dtype):
    """The reference's oracle in kernel layout, folded back to model layout."""
    xh, dt, A, Bv, Cv = arrs
    if dtype == "bfloat16":
        xh, Bv, Cv = _bf16_round(xh), _bf16_round(Bv), _bf16_round(Cv)
    B, S, H, P = xh.shape
    G, N = Bv.shape[2:]
    r = H // G
    xf = xh.transpose(0, 2, 1, 3).reshape(B * H, S, P)
    dtf = dt.transpose(0, 2, 1).reshape(B * H, S)
    Af = np.broadcast_to(A[None], (B, H)).reshape(B * H)

    def heads(t):
        return np.broadcast_to(t[:, :, :, None, :], (B, S, G, r, N)).transpose(
            0, 2, 3, 1, 4).reshape(B * H, S, N)

    y, s = j_ref.ssd_ref(jnp.asarray(xf), jnp.asarray(dtf), jnp.asarray(Af),
                         jnp.asarray(heads(Bv)), jnp.asarray(heads(Cv)))
    y = np.asarray(y).reshape(B, H, S, P).transpose(0, 2, 1, 3)
    return y, np.asarray(s).reshape(B, H, P, N)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_plain_scan_matches_reference_kernel(case):
    """Port plain version == the reference's Pallas kernel (interpret mode),
    within ``ssd_tolerance``; y in the input dtype, state in float32."""
    chunk, dtype = case[6], case[7]
    arrs = _inputs(case, seed=sum(case[:7]))
    y, s = _port(arrs, dtype, chunk)
    y_r, s_r = _reference_kernel(arrs, dtype, chunk)
    assert y.dtype == getattr(torch, dtype) and s.dtype == torch.float32
    ok_y, err_y = ref.ssd_close(y, y_r)
    ok_s, err_s = ref.ssd_close(s, s_r)
    assert ok_y, f"y max |diff| {err_y}"
    assert ok_s, f"state max |diff| {err_s}"


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_plain_scan_matches_sequential_oracle(case):
    """Port plain version == the reference's sequential ``ssd_ref`` at the
    reference test's own tolerances."""
    chunk, dtype = case[6], case[7]
    arrs = _inputs(case, seed=sum(case[:7]))
    y, s = _port(arrs, dtype, chunk)
    y_o, s_o = _sequential(arrs, dtype)
    rtol, atol = (3e-2, 3e-1) if dtype == "bfloat16" else (2e-3, 1e-2)
    np.testing.assert_allclose(y.to(torch.float32).numpy(), y_o, rtol=rtol, atol=atol)
    np.testing.assert_allclose(s.numpy(), s_o, rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_strong_decay_at_published_chunk(dtype):
    """Chunk 256 (mamba2-780m's), A = -16, dt 0.05-0.1, two chunks: above the
    diagonal the exponent passes 88, so exp before the mask is inf. The
    port masks first; its y and state are finite and equal the reference
    kernel's (which selects 0 after the product) within ``ssd_tolerance``."""
    case = (2, 512, 4, 64, 1, 128, 256, dtype)
    arrs = _inputs(case, seed=5, strong=True)
    y, s = _port(arrs, dtype, 256)
    y_r, s_r = _reference_kernel(arrs, dtype, 256)
    assert bool(torch.isfinite(y.to(torch.float32)).all() and torch.isfinite(s).all())
    ok_y, err_y = ref.ssd_close(y, y_r)
    ok_s, err_s = ref.ssd_close(s, s_r)
    assert ok_y and ok_s, (err_y, err_s)


def test_port_sequential_oracle_is_the_reference():
    """``ref.ssd_ref`` (a copy of the reference's oracle) at float32 rounding."""
    rng = np.random.default_rng(3)
    BH, S, P, N = 3, 40, 8, 16
    x = rng.standard_normal((BH, S, P)).astype(np.float32)
    dt = rng.uniform(0.01, 1.0, (BH, S)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, (BH,)).astype(np.float32)
    B = rng.standard_normal((BH, S, N)).astype(np.float32)
    C = rng.standard_normal((BH, S, N)).astype(np.float32)
    init = rng.standard_normal((BH, P, N)).astype(np.float32)
    y, s = ref.ssd_ref(*map(torch.from_numpy, (x, dt, A, B, C, init)))
    y_r, s_r = j_ref.ssd_ref(*map(jnp.asarray, (x, dt, A, B, C)), init_state=jnp.asarray(init))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_r), rtol=1e-5, atol=1e-5)


def test_kernel_layout_fold_matches_reference_wrapper():
    """``ops.to_kernel_layout`` is the reference wrapper's fold: heads of a
    group see the group's B and C, rows ordered (batch, head)."""
    B, S, H, P, G, N = 2, 8, 4, 3, 2, 5
    rng = np.random.default_rng(9)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            ((B, S, H, P), (B, S, H), (H,), (B, S, G, N), (B, S, G, N))]
    xf, dtf, Af, Bh, Ch = ops.to_kernel_layout(*map(torch.from_numpy, arrs))
    assert xf.shape == (B * H, S, P) and dtf.shape == (B * H, S, 1) and Af.shape == (B * H, 1)
    xh, dt, A, Bv, Cv = arrs
    for b in range(B):
        for h in range(H):
            row = b * H + h
            np.testing.assert_array_equal(xf[row].numpy(), xh[b, :, h])
            np.testing.assert_array_equal(dtf[row, :, 0].numpy(), dt[b, :, h])
            assert float(Af[row, 0]) == A[h]
            np.testing.assert_array_equal(Bh[row].numpy(), Bv[b, :, h // (H // G)])
            np.testing.assert_array_equal(Ch[row].numpy(), Cv[b, :, h // (H // G)])


def test_cpu_tensors_never_reach_the_kernel():
    """``impl="auto"`` on CPU tensors is the plain version: no launch, no
    build; the wrapper refuses CPU tensors and ``ops`` refuses unknown impls."""
    case = (1, 16, 2, 4, 1, 8, 8, "float32")
    arrs = [torch.from_numpy(a) for a in _inputs(case)]
    before = kernels.launch_counts()
    ops.ssd_scan(*arrs, chunk=8)
    assert kernels.launch_counts() == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        kern.ssd_scan_fwd(*arrs, chunk=8)
    with pytest.raises(ValueError, match="unknown impl"):
        ops.ssd_scan(*arrs, chunk=8, impl="pallas")


@pytest.mark.parametrize("bad", ["chunk", "head_dim", "state", "groups"])
def test_wrapper_checks_shapes_before_the_device(bad):
    """The wrapper refuses what the kernel does not take (a chunk that does
    not divide S or exceeds 256, P > 64, N > 128, heads not a multiple of the
    groups) before it looks at the tensors' device."""
    B, S, H, P, G, N, chunk = 1, 16, 4, 4, 2, 8, 8
    if bad == "chunk":
        chunk = 6
    elif bad == "head_dim":
        P = 65
    elif bad == "state":
        N = 129
    else:
        G = 3
    t = torch.zeros
    with pytest.raises(ValueError):
        kern.ssd_scan_fwd(t(B, S, H, P), t(B, S, H), t(H), t(B, S, G, N),
                          t(B, S, G, N), chunk=chunk)
