"""The port's tdm_compress plain versions against the JAX reference.

Each torch function of ``repro_torch.kernels.tdm_compress.ref`` is held to
the jitted JAX ``ref.py`` function on the same numpy inputs, over the case
grid of ``tests/test_kernels.py`` (ragged tails, k = 0 and k = block,
k on both sides of the kernels' ``TOPK_SELECT_MAX_K``, all-equal
magnitudes and all-equal values, NaN/+-inf payloads, int16 q), and to the Pallas
kernels in interpret mode for a few shapes. The dispatch rules (CPU tensor
-> plain version, CUDA tensor -> kernel or raise) are checked here too; the
CUDA kernels themselves are held to these plain versions on the card
(``tests/test_torch_cuda.py``).

Tolerances: int8 codes and scales and top-k dense/vals/idxs are compared bit
for bit (NaN equal to NaN). The accumulates are held to one rounding: under
jit XLA fuses ``acc + w * v`` into one multiply-add, while the eager torch
version rounds ``w * v`` and then the sum, so the two may differ by half an
ulp of the product plus half an ulp of each result (``fma_gap_ok``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.tdm_compress import ops as q_ops
from repro.kernels.tdm_compress import ref as q_ref
from repro_torch import kernels
from repro_torch.kernels.tdm_compress import ops, ref
from repro_torch.kernels.tdm_compress import tdm_compress as kern

_ref_quantize = jax.jit(q_ref.quantize_ref, static_argnames=("block",))
_ref_quant_scaled = jax.jit(q_ref.quantize_scaled_ref, static_argnames=("block",))
_ref_dequant_acc = jax.jit(q_ref.dequant_acc_ref, static_argnames=("block",))
_ref_topk = jax.jit(q_ref.topk_sparsify_ref, static_argnums=(1,), static_argnames=("block",))
_ref_scatter_acc = jax.jit(q_ref.scatter_acc_ref, static_argnames=("block",))
_ref_scales = jax.jit(q_ref.blockwise_scales_ref, static_argnames=("block",))


def _payload(seed: int, n: int, kind: str) -> np.ndarray:
    """'normal' random scale, 'ties' only +-1, 'equal' one value repeated,
    'edge' with NaN/+-inf."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * rng.uniform(0.1, 10.0)).astype(np.float32)
    if kind == "ties":
        x = np.where(x >= 0, np.float32(1.0), np.float32(-1.0))
    elif kind == "equal":
        x = np.full(n, x[0], np.float32)
    elif kind == "edge":
        m = rng.random(n)
        x[m < 0.05] = np.nan
        x[(m >= 0.05) & (m < 0.10)] = np.inf
        x[(m >= 0.10) & (m < 0.15)] = -np.inf
    return x


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _assert_fma(got, want, prod) -> None:
    ok = ref.fma_gap_ok(_t(got), _t(want), _t(prod))
    assert bool(ok.all()), np.nonzero(~ok.numpy())


CASES = [
    # (n, block, kind): tests/test_kernels.py grids plus ragged/edge extras
    (1024, 256, "normal"), (4096, 1024, "normal"), (8192, 512, "normal"),
    (100, 64, "normal"), (1, 256, "normal"), (1023, 1024, "normal"),
    (1025, 1024, "edge"), (500, 128, "ties"), (2500, 256, "edge"),
    (3000, 512, "ties"), (777, 64, "edge"), (2048, 1024, "equal"),
    (777, 256, "equal"),
]
# k on both sides of the split between the kernels' select and sort paths
SELECT_KS = [kern.TOPK_SELECT_MAX_K, kern.TOPK_SELECT_MAX_K + 1]


@pytest.mark.parametrize("n,block,kind", CASES)
def test_quantize_bitwise(n, block, kind):
    x = _payload(n * 3 + block, n, kind)
    q_w, s_w = _ref_quantize(jnp.asarray(x), block=block)
    q, s = ref.quantize_ref(_t(x), block=block)
    assert q.dtype == torch.int8 and q.shape == (n,) and s.shape == (-(-n // block),)
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_w))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_w))
    np.testing.assert_array_equal(
        ref.blockwise_scales_ref(_t(x), block).numpy(),
        np.asarray(_ref_scales(jnp.asarray(x), block=block)))


@pytest.mark.parametrize("n,block", [(1, 128), (1000, 128), (3000, 512), (2049, 256)])
def test_quantize_scaled_and_dequantize(n, block):
    x = _payload(n, n, "normal")
    rng = np.random.default_rng(n + 2)
    scales = np.asarray(_ref_scales(jnp.asarray(x), block=block))
    shared = (scales * rng.uniform(1.0, 3.0, size=scales.shape)).astype(np.float32)
    np.testing.assert_array_equal(
        ref.quantize_scaled_ref(_t(x), _t(shared), block).numpy(),
        np.asarray(_ref_quant_scaled(jnp.asarray(x), jnp.asarray(shared), block=block)))
    q, s = ref.quantize_ref(_t(x), block)
    np.testing.assert_array_equal(
        ref.dequantize_ref(q, s, block).numpy(),
        np.asarray(q_ref.dequantize_ref(jnp.asarray(q.numpy()), jnp.asarray(s.numpy()), block)))


@pytest.mark.parametrize("n,block,kind", CASES)
@pytest.mark.parametrize("k", [0, 1, 7, *SELECT_KS, "block"])
def test_topk_sparsify_bitwise(n, block, kind, k):
    k = block if k == "block" else min(k, block)
    x = _payload(n + k, n, kind)
    d_w, v_w, i_w = _ref_topk(jnp.asarray(x), k, block=block)
    d, v, i = ref.topk_sparsify_ref(_t(x), k, block)
    nb = -(-n // block)
    assert d.shape == (n,) and v.shape == i.shape == (nb, k) and i.dtype == torch.int32
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_w))
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_w))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_w))


def test_topk_signed_zero_ties_go_to_lowest_index():
    x = np.array([-0.0, 0.0, 0.0, -0.0, 2.0, -2.0, 1.0, 0.0], np.float32)
    d_w, v_w, i_w = _ref_topk(jnp.asarray(x), 5, block=8)
    d, v, i = ref.topk_sparsify_ref(_t(x), 5, 8)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_w))
    np.testing.assert_array_equal(i.numpy()[0], [4, 5, 6, 0, 1])
    np.testing.assert_array_equal(np.signbit(v.numpy()), np.signbit(np.asarray(v_w)))


@pytest.mark.parametrize("n,block,kind", [c for c in CASES if c[2] != "edge"])
@pytest.mark.parametrize("k", sorted({0, 1, 33, *SELECT_KS}))
def test_scatter_accumulate_within_one_rounding(n, block, kind, k):
    k = min(k, block)
    x = _payload(n * 13 + k, n, kind)
    rng = np.random.default_rng(n + 1)
    acc = rng.standard_normal(n).astype(np.float32)
    acc[::7] = -0.0                       # -0.0 + w*0 must come out +0.0
    w = np.float32(rng.uniform(-1.5, 1.5))
    _, vals, idxs = _ref_topk(jnp.asarray(x), k, block=block)
    want = _ref_scatter_acc(vals, idxs, jnp.asarray(acc), w, block=block)
    got = ref.scatter_acc_ref(_t(vals), _t(idxs), _t(acc), float(w), block)
    dense = ref.scatter_acc_ref(_t(vals), _t(idxs), torch.zeros(n), 1.0, block)
    assert got.shape == (n,)
    _assert_fma(got, want, w * dense)
    np.testing.assert_array_equal(np.signbit(got.numpy()), np.signbit(np.asarray(want)))


@pytest.mark.parametrize("n,block", [(512, 256), (1000, 256), (77, 64), (2500, 128)])
@pytest.mark.parametrize("qtype", ["int8", "int16"])
def test_dequant_accumulate_within_one_rounding(n, block, qtype):
    rng = np.random.default_rng(n)
    nb = -(-n // block)
    if qtype == "int8":
        q, s = _ref_quantize(jnp.asarray(_payload(n, n, "normal")), block=block)
        q, s = np.asarray(q), np.asarray(s)
    else:
        q = rng.integers(-127 * 6, 127 * 6 + 1, size=n).astype(np.int16)
        s = rng.uniform(1e-4, 0.5, size=nb).astype(np.float32)
    acc = rng.standard_normal(n).astype(np.float32)
    w = np.float32(rng.uniform(-1.0, 1.0))
    want = _ref_dequant_acc(jnp.asarray(q), jnp.asarray(s), jnp.asarray(acc), w, block=block)
    got = ref.dequant_acc_ref(_t(q), _t(s), _t(acc), float(w), block)
    assert got.shape == (n,) and got.dtype == torch.float32
    _assert_fma(got, want, w * ref.dequantize_ref(_t(q), _t(s), block))


@pytest.mark.parametrize("n,block,k", [(1023, 1024, 7), (1025, 1024, 5), (500, 128, 32)])
def test_matches_pallas_interpret(n, block, k):
    """The plain versions against the Pallas kernels themselves."""
    x = _payload(n + k, n, "edge" if n == 1025 else "normal")
    q_p, s_p, _ = q_ops.quantize_payload(jnp.asarray(x), block=block, interpret=True)
    q, s = ref.quantize_ref(_t(x), block)
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_p))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_p))
    d_p, v_p, i_p = q_ops.topk_sparsify(jnp.asarray(x), k=k, block=block, interpret=True)
    d, v, i = ref.topk_sparsify_ref(_t(x), k, block)
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_p))
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_p))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_p))
    if n == 1025:
        return
    acc = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    w = np.float32(0.37)
    got = q_ops.scatter_accumulate(v_p, i_p, jnp.asarray(acc), w, block=block, interpret=True)
    mine = ref.scatter_acc_ref(v, i, _t(acc), float(w), block)
    dense = ref.scatter_acc_ref(v, i, torch.zeros(n), 1.0, block)
    _assert_fma(mine, got, w * dense)
    got = q_ops.dequant_accumulate(q_p, s_p, jnp.asarray(acc), w, block=block, interpret=True)
    mine = ref.dequant_acc_ref(q, s, _t(acc), float(w), block)
    _assert_fma(mine, got, w * ref.dequantize_ref(q, s, block))


@pytest.mark.parametrize("block", [64, 1024])
def test_stacked_rows_equal_per_row_calls(block):
    """The port's (rows, n) form == the reference's flat form row by row,
    with one weight per row."""
    rng = np.random.default_rng(block)
    x = rng.standard_normal((5, 3000)).astype(np.float32)
    acc = rng.standard_normal((5, 3000)).astype(np.float32)
    w = rng.uniform(-1, 1, 5).astype(np.float32)
    q, s = ref.quantize_ref(_t(x), block)
    d, v, i = ref.topk_sparsify_ref(_t(x), 3, block)
    da = ref.dequant_acc_ref(q, s, _t(acc), _t(w), block)
    sa = ref.scatter_acc_ref(v, i, _t(acc), _t(w), block)
    for r in range(5):
        q1, s1 = ref.quantize_ref(_t(x[r]), block)
        d1, v1, i1 = ref.topk_sparsify_ref(_t(x[r]), 3, block)
        assert torch.equal(q1, q[r]) and torch.equal(s1, s[r])
        assert torch.equal(d1, d[r]) and torch.equal(v1, v[r]) and torch.equal(i1, i[r])
        assert torch.equal(ref.dequant_acc_ref(q1, s1, _t(acc[r]), float(w[r]), block), da[r])
        assert torch.equal(ref.scatter_acc_ref(v1, i1, _t(acc[r]), float(w[r]), block), sa[r])


def test_dispatch_cpu_goes_to_plain_version():
    x = _t(_payload(5, 3000, "normal"))
    for impl in ("auto", "ref"):
        q, s = ops.quantize(x, block=256, impl=impl)
        q_r, s_r = ref.quantize_ref(x, 256)
        assert torch.equal(q, q_r) and torch.equal(s, s_r)
        d, v, i = ops.topk_sparsify(x, k=4, block=256, impl=impl)
        assert torch.equal(i, ref.topk_sparsify_ref(x, 4, 256)[2])
    before = kernels.launch_counts()
    ops.dequant_accumulate(q, s, x, 0.5, block=256)
    ops.scatter_accumulate(v, i, x, 0.5, block=256)
    assert kernels.launch_counts() == before


def test_kernel_wrappers_refuse_cpu_tensors():
    """No fallback: the CUDA route raises on what the kernel cannot take."""
    x = torch.zeros(2048)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kern.quantize_fwd(x)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.topk_sparsify(x, k=1, impl="cuda")
    with pytest.raises(ValueError, match="block"):
        kern.quantize_fwd(x, block=16)
    with pytest.raises(ValueError, match="unknown impl"):
        ops.quantize(x, impl="pallas")


def test_select_constants_match_the_source():
    """The wrapper's split and grid follow the C source's select paths: at
    most one result per lane (kSelectMaxK) and kWarpsPerCta blocks per
    thread block."""
    import re

    from repro_torch.kernels import build

    src = (build.CSRC_DIR / "tdm_compress.cu").read_text()
    max_k = int(re.search(r"constexpr int kSelectMaxK = (\d+);", src).group(1))
    per_cta = int(re.search(r"constexpr int kWarpsPerCta = (\d+);", src).group(1))
    assert 8 <= kern.TOPK_SELECT_MAX_K <= max_k == 32
    assert kern._SELECT_BLOCKS_PER_CTA == per_cta
    assert kern._path(kern.TOPK_SELECT_MAX_K) == ("select", per_cta)
    assert kern._path(kern.TOPK_SELECT_MAX_K + 1) == ("large", 1)


def test_fused_impl_resolution():
    from repro_torch.core import fused

    x = torch.zeros(2, 1024)
    assert fused._resolve_impl("auto", x) == "ref"
    assert fused._resolve_impl("ref", x) == "ref"
    assert fused._resolve_impl("cuda", x) == "cuda"
    with pytest.raises(ValueError):
        fused._resolve_impl("pallas", x)


def test_build_reports_missing_nvcc(monkeypatch, tmp_path):
    from repro_torch.kernels import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build("tdm_compress")
