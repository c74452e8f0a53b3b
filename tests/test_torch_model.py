"""The port's model, optimizer, data and flat layout against the reference.

Reference params (``jax.random`` init of the mamba2-780m smoke config) go
through numpy into the port (``params_from_jax``); both sides then see the
same inputs. Float32 compute is held to rtol 2e-5 (with an absolute floor
scaled to each tensor): the two frameworks sum matmuls and reductions in
different orders, which moves float32 results by a few ulps, and the
backward pass compounds a few such sums. The one bf16 case is held to rtol
5e-2: XLA keeps fused elementwise chains in float32 and rounds to bf16 once,
while eager torch rounds after every op (bf16 has 8 bits of mantissa,
ulp ~ 4e-3 relative).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import archs as j_archs
from repro.core import fused as j_fused
from repro.data import pipeline as j_pipeline
from repro.models import mamba2 as j_mamba
from repro.models import registry as j_registry
from repro.models import transformer as j_transformer
from repro.models.config import ShapeConfig as JShape
from repro.optim import adamw as j_adamw
from repro_torch.configs import archs
from repro_torch.core import fused
from repro_torch.data import pipeline
from repro_torch.models import mamba2, transformer
from repro_torch.models.config import ShapeConfig
from repro_torch.optim import adamw
from repro_torch.pytree import tree_leaves, tree_map
from repro_torch.weights import params_from_jax, to_numpy

SEQ, ROWS = 16, 2


def _cfgs(compute_dtype="float32"):
    j = j_archs.smoke_cfg(j_archs.get("mamba2-780m")).replace(compute_dtype=compute_dtype)
    t = archs.smoke_cfg(archs.get("mamba2-780m")).replace(compute_dtype=compute_dtype)
    return j, t


@pytest.fixture(scope="module")
def ref_params():
    jcfg, _ = _cfgs()
    params, _ = j_registry.bundle(jcfg).init(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def _batch(cfg_shape_seed=0):
    jcfg, _ = _cfgs()
    return j_pipeline.host_batch(jcfg, JShape("t", "train", SEQ, ROWS), step=3, seed=cfg_shape_seed)


def _close(got, want, rtol, what=""):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    atol = rtol * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize("seed,step", [(0, 0), (1000, 3), (1007, 9)])
def test_host_batch_tokens_equal(seed, step):
    jcfg, tcfg = _cfgs()
    a = j_pipeline.host_batch(jcfg, JShape("t", "train", 64, 3), step=step, seed=seed)
    b = pipeline.host_batch(tcfg, ShapeConfig("t", "train", 64, 3), step=step, seed=seed)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("block", [64, 1024])
def test_flat_spec_equals_reference(ref_params, block):
    j_spec = j_fused.build_spec(ref_params, block=block)
    stacked = tree_map(lambda t: t.unsqueeze(0).repeat((3,) + (1,) * t.dim()),
                       params_from_jax(ref_params, device="cpu"))
    spec = fused.build_spec(stacked, block=block)
    assert spec.bucket_sizes == j_spec.bucket_sizes
    assert spec.bucket_leaves == j_spec.bucket_leaves
    assert [(s.bucket, s.offset, s.size, s.shape) for s in spec.slots] == [
        (s.bucket, s.offset, s.size, s.shape) for s in j_spec.slots]
    # and the flattened buffer holds the reference's flatten, row by row
    buf = fused.flatten_pytree(spec, stacked)["float32"]
    want = np.asarray(j_fused.flatten_pytree(j_spec, ref_params)["float32"])
    for r in range(3):
        np.testing.assert_array_equal(buf[r].numpy(), want)
    back = fused.unflatten_pytree(spec, {"float32": buf})
    for a, b in zip(tree_leaves(back), tree_leaves(stacked)):
        assert torch.equal(a, b)


def test_ssd_chunked_matches_reference():
    rng = np.random.default_rng(0)
    B, S, H, P, G, N, chunk = 2, 32, 4, 8, 2, 16, 8
    xh = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, (B, S, H)).astype(np.float32)
    A = -rng.uniform(1.0, 16.0, (H,)).astype(np.float32)
    Bv = rng.standard_normal((B, S, G, N)).astype(np.float32)
    Cv = rng.standard_normal((B, S, G, N)).astype(np.float32)
    y_w, s_w = jax.jit(j_mamba.ssd_chunked, static_argnums=(5,))(
        *map(jnp.asarray, (xh, dt, A, Bv, Cv)), chunk)
    y, s = mamba2.ssd_chunked(*map(torch.from_numpy, (xh, dt, A, Bv, Cv)), chunk)
    _close(y.numpy(), y_w, 2e-5, "y")
    _close(s.numpy(), s_w, 2e-5, "state")


def test_ssd_grads_finite_at_published_chunk():
    """Reference fault, fixed in the port: at chunk 256 (mamba2-780m's) the
    decays summed above the diagonal overflow exp, and the reference's
    masked-after-exp kernel gives NaN gradients. The port masks the
    exponent: same forward, finite gradients, equal to the reference's
    wherever those are finite."""
    rng = np.random.default_rng(5)
    B, S, H, P, G, N = 1, 256, 2, 4, 1, 8
    xh = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = rng.uniform(0.05, 0.1, (B, S, H)).astype(np.float32)
    A = -np.array([16.0, 1.0], np.float32)           # 256 * 0.05 * 16 > 88
    Bv = rng.standard_normal((B, S, G, N)).astype(np.float32)
    Cv = rng.standard_normal((B, S, G, N)).astype(np.float32)

    def ref_fn(xh, dt, A, Bv, Cv):
        y, s = j_mamba.ssd_chunked(xh, dt, A, Bv, Cv, S)
        return jnp.sum(y) + jnp.sum(s)

    y_w, _ = j_mamba.ssd_chunked(*map(jnp.asarray, (xh, dt, A, Bv, Cv)), S)
    g_w = jax.grad(ref_fn, argnums=(0, 1))(*map(jnp.asarray, (xh, dt, A, Bv, Cv)))
    assert not np.isfinite(np.asarray(g_w[1])).all()   # the reference's NaNs
    ts = [torch.from_numpy(a).requires_grad_(i < 2) for i, a in enumerate((xh, dt, A, Bv, Cv))]
    y, s = mamba2.ssd_chunked(*ts, S)
    g = torch.autograd.grad(y.sum() + s.sum(), ts[:2])
    _close(y.detach().numpy(), y_w, 2e-5, "y")
    for got, want in zip(g, g_w):
        assert np.isfinite(got.numpy()).all()
        fin = np.isfinite(np.asarray(want))
        _close(got.numpy()[fin], np.asarray(want)[fin], 2e-5)


def test_mamba_forward_matches_reference(ref_params):
    jcfg, tcfg = _cfgs()
    p = jax.tree.map(lambda a: a[0], ref_params["units"]["L0"]["mamba"])
    x = np.random.default_rng(1).standard_normal((ROWS, SEQ, jcfg.d_model)).astype(np.float32)
    want = jax.jit(lambda p, x: j_mamba.mamba_forward(p, x, jcfg))(p, jnp.asarray(x))
    got = mamba2.mamba_forward(params_from_jax(p, device="cpu"), torch.from_numpy(x), tcfg)
    _close(got.numpy(), want, 2e-5)


def _ref_loss_and_grads(jcfg, params, batch):
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: j_transformer.loss_fn(p, b, jcfg)[0]))
    loss, grads = fn(params, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), jax.tree.map(np.asarray, grads)


def _port_loss_and_grads(tcfg, params_np, batch):
    from repro_torch.pytree import tree_flatten, tree_unflatten

    leaves, td = tree_flatten(params_from_jax(params_np, device="cpu"))
    leaves = [t.requires_grad_(True) for t in leaves]
    loss, _ = transformer.loss_fn(
        tree_unflatten(td, leaves), {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), to_numpy(tree_unflatten(td, list(grads)))


@pytest.mark.parametrize("compute_dtype,rtol", [("float32", 2e-5), ("bfloat16", 5e-2)])
def test_loss_and_grads_match_reference(ref_params, compute_dtype, rtol):
    jcfg, tcfg = _cfgs(compute_dtype)
    batch = _batch()
    loss_w, grads_w = _ref_loss_and_grads(jcfg, ref_params, batch)
    loss, grads = _port_loss_and_grads(tcfg, ref_params, batch)
    np.testing.assert_allclose(loss, loss_w, rtol=rtol)
    flat_w = jax.tree_util.tree_flatten_with_path(grads_w)[0]
    for path, g_w in flat_w:
        g = grads
        for key in path:
            g = g[key.key]
        # grads: one more sum order per backward op than the forward
        _close(g, g_w, 5 * rtol, jax.tree_util.keystr(path))


# Moments stored in bf16 round twice per step: a last-bit gap in the float32
# moment can flip that rounding, which moves the update by ~2^-8 of itself
# (|update| ~ 1 with unit-scale grads), i.e. a param by ~lr * 2^-8.
@pytest.mark.parametrize("opt_dtype,atol", [
    ("float32", 0.0), ("bfloat16", 5e-3 * 2**-7), ("int8", 0.0)])
def test_adamw_step_matches_reference(ref_params, opt_dtype, atol):
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(3)
    grads = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), ref_params)
    j_cfg = j_adamw.OptConfig(peak_lr=5e-3, warmup_steps=2, decay_steps=100, dtype=opt_dtype)
    t_cfg = adamw.OptConfig(peak_lr=5e-3, warmup_steps=2, decay_steps=100, dtype=opt_dtype)
    j_state = j_adamw.init_opt_state(ref_params, j_cfg)
    t_params = params_from_jax(ref_params, device="cpu")
    t_state = adamw.init_opt_state(t_params, t_cfg)
    step = jax.jit(lambda p, g, s: j_adamw.apply_updates(p, g, s, j_cfg))
    for _ in range(2):  # the second step reads back stored moments
        jp, j_state, jm = step(ref_params if _ == 0 else jp, grads, j_state)
        t_params, t_state, tm = adamw.apply_updates(
            t_params, params_from_jax(grads, device="cpu"), t_state, t_cfg)
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    assert int(t_state["count"]) == int(j_state["count"]) == 2
    for got, want in zip(tree_leaves(to_numpy(t_params)), jax.tree.leaves(jp)):
        if atol:
            np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol)
        else:
            _close(got, np.asarray(want), 2e-5)


def test_params_roundtrip_and_bf16():
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": {"c": jnp.asarray([1.5, -2.25], jnp.bfloat16)}}
    tree = jax.tree.map(np.asarray, tree)
    t = params_from_jax(tree, device="cpu")
    assert t["b"]["c"].dtype == torch.bfloat16
    back = to_numpy(t)
    np.testing.assert_array_equal(back["a"], tree["a"])
    np.testing.assert_array_equal(back["b"]["c"], tree["b"]["c"].astype(np.float32))


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    from repro_torch.device import resolve_device
    from repro_torch.launch import fl_train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    _, tcfg = _cfgs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fl_train._stack_init(0, tcfg, adamw.OptConfig(), 2)
    assert resolve_device("cpu").type == "cpu"


def test_unported_families_raise():
    """No family raises any more (the name is kept from when the hybrid
    one did): the hybrid (jamba: 8 layers a unit, the reference's
    ``(mixer, ffn)`` pairs), the MoE family and the encoder-decoder family
    (whisper: one attention layer with cross-attention per unit) all have
    their unit."""
    jamba = archs.get("jamba-1.5-large-398b")
    pairs = [(d.mixer, d.ffn) for d in transformer.scan_unit(jamba)]
    assert pairs == [(d.mixer, d.ffn) for d in j_transformer.scan_unit(j_archs.get(jamba.name))]
    assert pairs == [("attn", "dense")] + [("mamba", "moe" if j % 2 else "dense")
                                           for j in range(1, 8)]
    assert transformer.n_units(jamba) == 9
    assert [d.ffn for d in transformer.scan_unit(archs.get("qwen3-moe-30b-a3b"))] == ["moe"]
    assert [(d.mixer, d.cross) for d in transformer.scan_unit(archs.get("whisper-base"))] == \
        [("attn", True)]
