"""The port's M-RoPE (qwen2-vl) against the JAX reference, on the CPU.

Inputs come from numpy seeds; params are the reference's own init, carried
across with ``weights.params_from_jax``.

- ``layers.apply_mrope`` against the reference's at qwen2-vl-72b's sections
  (16, 24, 24) over head dim 128 (rope theta 1e6) and at the smoke config's
  (2, 3, 3) over 16, with image-grid positions: within 2e-6 of the
  output's largest magnitude (float32 angles on both sides; the two
  libraries' sin and cos differ in the last ulp, and a product of a
  position near 300 and a frequency near 1 puts that ulp at ~3e-5 of the
  angle, ~1e-7 of its sine), and a section split that does not cover hd/2
  raises.
- qwen2-vl-72b's smoke config (2 layers, QKV bias, untied head, float32
  compute) with Qwen2-VL's image-grid positions (a 4 x 4 grid of 16
  tokens at ``(t0, t0 + row, t0 + col)``, then text at ``max + 1 + i`` on
  all three components): ``loss_fn`` within rtol 2e-5 and every gradient
  within 1e-4 of its largest magnitude (as the dense archs',
  ``tests/test_torch_train.py``); ``prefill`` through the registry (the
  positions in the batch) and 4 decode ticks with explicit positions,
  then 2 with the default ones (the cache's ``pos`` on all three):
  logits and caches within rtol 2e-5 with an absolute floor of 2e-5 of
  their scale, greedy tokens equal (as ``tests/test_torch_serving_dense.py``
  holds the dense archs).
- ``serve_constellation --model --smoke --arch qwen2-vl-72b`` on the CPU:
  every request delivered (text positions, as the reference's decoder
  gives), the audit clean.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import archs as j_archs
from repro.models import layers as j_layers
from repro.models import registry as j_registry
from repro_torch.configs import archs
from repro_torch.models import layers, registry
from repro_torch.pytree import tree_map
from repro_torch.weights import params_from_jax

ARCH = "qwen2-vl-72b"


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _scale_close(got, want, frac: float, what: str):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, f"{what}: {got.shape} != {want.shape}"
    bound = frac * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= bound, f"{what}: max |diff| {err:.3g} > {bound:.3g}"


def _close(got, want, what):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5 * float(np.abs(want).max()),
                               err_msg=what)


def grid_positions(B: int, grid: int, text: int, t0: int = 0) -> np.ndarray:
    """Qwen2-VL's positions of a prompt that is one image of ``grid`` x
    ``grid`` patch tokens then ``text`` tokens: (B, grid^2 + text, 3) int32,
    the image at ``(t0, t0 + row, t0 + col)``, the text at ``max + 1 + i``
    on all three components."""
    rows, cols = np.divmod(np.arange(grid * grid), grid)
    image = np.stack([np.full_like(rows, t0), t0 + rows, t0 + cols], axis=-1)
    start = int(image.max()) + 1
    txt = np.repeat((start + np.arange(text))[:, None], 3, axis=1)
    pos = np.concatenate([image, txt])[None].repeat(B, axis=0)
    return pos.astype(np.int32)


@pytest.mark.parametrize("hd,sections,theta", [(128, (16, 24, 24), 1e6), (16, (2, 3, 3), 1e6)])
def test_apply_mrope_matches_reference(hd, sections, theta):
    rng = np.random.default_rng(hd)
    B, N = 2, 3
    pos = grid_positions(B, 16, 60, t0=5)
    x = rng.standard_normal((B, pos.shape[1], N, hd)).astype(np.float32)
    want = j_layers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), theta, sections)
    got = layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), theta, sections)
    assert got.dtype == torch.float32
    _scale_close(got, want, 2e-6, "apply_mrope")
    # one position stream on all three components is plain rope
    same = np.repeat(pos[..., :1], 3, axis=-1)
    a = layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(same), theta, sections)
    b = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(same[..., 0]), theta)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="sections"):
        layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), theta, (1, 1, 1))


def _cfgs(**kw):
    j = j_archs.smoke_cfg(j_archs.get(ARCH)).replace(compute_dtype="float32", **kw)
    t = archs.smoke_cfg(archs.get(ARCH)).replace(compute_dtype="float32", **kw)
    return j, t


@pytest.fixture(scope="module")
def ref_params():
    jcfg, _ = _cfgs()
    params, _ = j_registry.bundle(jcfg).init(jax.random.PRNGKey(3))
    return params


def test_qwen2vl_loss_and_grads_match_reference(ref_params):
    jcfg, tcfg = _cfgs()
    assert tcfg.qkv_bias and tcfg.mrope_sections == (2, 3, 3)
    B, S = 2, 32
    toks = np.random.default_rng(7).integers(0, tcfg.vocab_size, (B, S + 1))
    pos = grid_positions(B, 4, S - 16, t0=3)
    jbatch = {"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
              "labels": jnp.asarray(toks[:, 1:], jnp.int32), "positions": jnp.asarray(pos)}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: j_registry.bundle(jcfg).loss_fn(p, jbatch), has_aux=True))(ref_params)
    tp = tree_map(lambda t: t.requires_grad_(True),
                  params_from_jax(jax.tree.map(np.asarray, ref_params), "cpu"))
    tloss, _ = registry.bundle(tcfg).loss_fn(
        tp, {"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:]),
             "positions": torch.from_numpy(pos)})
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=2e-5)
    flat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    got = jax.tree_util.tree_leaves(tree_map(lambda t: t.grad, tp))
    assert len(flat) == len(got)
    for (path, want), g in zip(flat, got):
        _scale_close(g, want, 1e-4, jax.tree_util.keystr(path))


def test_qwen2vl_prefill_and_decode_match_reference(ref_params):
    jcfg, tcfg = _cfgs()
    B, grid, text, max_len = 2, 4, 8, 40
    S = grid * grid + text
    toks = np.random.default_rng(8).integers(0, tcfg.vocab_size, (B, S))
    pos = grid_positions(B, grid, text, t0=2)
    jb, tb = j_registry.bundle(jcfg), registry.bundle(tcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, ref_params), "cpu")
    jl, jc = jax.jit(lambda p, bt: jb.prefill_fn(p, bt, max_len))(
        ref_params, {"tokens": jnp.asarray(toks, jnp.int32), "positions": jnp.asarray(pos)})
    with torch.no_grad():
        tl, tc = tb.prefill_fn(tp, {"tokens": torch.from_numpy(toks),
                                    "positions": torch.from_numpy(pos)}, max_len)

    def check(what):
        _close(tl, jl, f"logits {what}")
        for f in ("k", "v"):
            _close(getattr(tc["units"]["kv0"], f), getattr(jc["units"]["kv0"], f),
                   f"kv0.{f} {what}")
        assert int(tc["pos"]) == int(jc["pos"])

    check("after prefill")
    jdec = jax.jit(jb.decode_fn)
    nxt = int(pos.max()) + 1
    for i in range(6):
        tok = np.argmax(np.asarray(jl)[:, -1], axis=-1)[:, None]
        np.testing.assert_array_equal(torch.argmax(tl[:, -1], -1).numpy(), tok[:, 0])
        jbt, tbt = {"token": jnp.asarray(tok, jnp.int32)}, {"token": torch.from_numpy(tok)}
        if i < 4:      # the next text position on all three components
            p3 = np.full((B, 1, 3), nxt + i, np.int32)
            jbt["positions"], tbt["positions"] = jnp.asarray(p3), torch.from_numpy(p3)
        jl, jc = jdec(ref_params, jc, jbt)
        with torch.no_grad():
            tl, tc = tb.decode_fn(tp, tc, tbt)
        check(f"after tick {i}")


def test_serve_constellation_qwen2vl_smoke_on_cpu(capsys):
    from repro_torch.launch import serve_constellation

    res = serve_constellation.main(["--device", "cpu", "--model", "--smoke", "--arch", ARCH])
    summ = res.report.summary()
    assert res.decoder.cfg.mrope_sections is not None
    assert res.verdict.ok and summ["delivered"] == summ["n_requests"] == 10
    assert all(len(r.out) == serve_constellation.MAX_NEW for r in res.report.requests)
    assert "OK" in capsys.readouterr().out
