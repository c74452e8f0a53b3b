"""The port's MoE family against the JAX reference, on the CPU.

Inputs come from numpy seeds (or the reference's own init, carried across
with ``weights.params_from_jax``); the reference runs in this process.

- ``capacity`` equals the reference's over a sweep of token counts, capacity
  factors and expert counts, bit for bit (integers).
- ``moe_apply`` against ``repro.models.moe.moe_apply`` on prefill-shaped
  (B > 1, S > 1), decode-shaped (B > 1, S 1) and (1, 1) inputs, at capacity
  factor 4.0 (no drops) and 0.5 (binding: fewer slots than assignments, so
  drops are certain and asserted), with 4 experts top-2 (the smoke config)
  and 16 experts top-4, and with planted router ties (two router columns
  equal, so the two experts' probabilities tie exactly). The reference's
  dispatched tokens, expert outputs and result are read at its
  ``shard_activation`` calls (the test patches that name in the reference's
  module with a recording identity). Bit for bit: ``top_e`` against
  ``jax.lax.top_k`` of the reference's routing, the port's token table
  against the one the reference's dispatched tokens show, the drop count,
  and the port's ``combine`` of the reference's own expert outputs against
  the reference's result (the combine's slot order and bf16 rounding after
  each add). Within tolerance: the output, float32 compute within 1e-5 of
  its largest magnitude (the products summed in another order); bf16 within
  2e-2 of it (``jax.nn.silu`` on bf16 rounds the sigmoid to bf16 before its
  product, ``torch.nn.functional.silu`` rounds once; measured below 8e-3);
  ``moe_aux`` and ``moe_zloss`` within rtol 1e-5.
- Decode groups: ``groups=k`` equals the reference run on each of the k runs
  of rows alone.
- Gradients of a scalar of ``moe_apply`` (a weighted sum of the output plus
  both aux losses) with respect to x, the router and the three expert
  weights, against ``jax.grad``, float32: within 1e-5 of each gradient's
  largest magnitude, at a binding capacity.
- The qwen3-moe-30b-a3b and kimi-k2-1t-a32b smoke configs: ``loss_fn``
  (total, ``ce_loss``, ``moe_aux``, ``moe_zloss``) within rtol 2e-5 and every
  gradient within 1e-4 of its largest magnitude (float32 compute; kimi's
  bf16 params give bf16 gradients, each held to 1e-2 of its scale: one bf16
  rounding of a sum taken in another order); one ``build_train_step`` step
  against the reference's jitted step (metrics within rtol 1e-5; float32
  params as in ``test_torch_train``; kimi's bf16 params within one bf16 ulp
  of each entry, and its int8 moments, dequantized, within one code step of
  their row's scale).
- The int8 AdamW moments' ``_quantize`` against ``jax.jit`` of the
  reference's, bit for bit, over rows whose scales run from 1e-8 to 1e2.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import archs as j_archs
from repro.launch import steps as j_steps
from repro.models import moe as j_moe
from repro.models import registry as j_registry
from repro.optim import adamw as j_adamw
from repro_torch.configs import archs
from repro_torch.launch import steps
from repro_torch.models import moe, registry
from repro_torch.optim import adamw
from repro_torch.pytree import tree_leaves
from repro_torch.weights import params_from_jax, state_from_jax

ARCHS = ("qwen3-moe-30b-a3b", "kimi-k2-1t-a32b")


def _cfgs(arch="qwen3-moe-30b-a3b", experts=None, top_k=None, cf=None, **kw):
    out = []
    for pkg in (j_archs, archs):
        c = pkg.smoke_cfg(pkg.get(arch))
        m = dataclasses.replace(c.moe, **{k: v for k, v in (
            ("n_experts", experts), ("top_k", top_k), ("capacity_factor", cf)) if v is not None})
        out.append(c.replace(moe=m, **kw))
    return tuple(out)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _scale_close(got, want, frac, what):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=frac * float(np.abs(want).max()),
                               err_msg=what)


# ---------------------------------------------------------------------------
# capacity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("experts,top_k", [(4, 2), (128, 8), (384, 8)])
def test_capacity_matches_reference(experts, top_k):
    jcfg, tcfg = _cfgs(experts=experts, top_k=top_k)
    for cf in (0.5, 1.0, 1.25, 2.0, 4.0):
        jc = jcfg.replace(moe=dataclasses.replace(jcfg.moe, capacity_factor=cf))
        tc = tcfg.replace(moe=dataclasses.replace(tcfg.moe, capacity_factor=cf))
        for tokens in list(range(1, 70)) + [100, 127, 128, 129, 512, 1000, 4096, 8192]:
            assert moe.capacity(tokens, tc) == j_moe.capacity(tokens, jc), (cf, tokens)
    assert moe.capacity(512, _cfgs("qwen3-moe-30b-a3b")[1].replace(
        moe=archs.get("qwen3-moe-30b-a3b").moe)) == 40


# ---------------------------------------------------------------------------
# moe_apply against the reference
# ---------------------------------------------------------------------------

def _reference_run(monkeypatch, p, x, cfg):
    """The reference's ``moe_apply`` with its ``shard_activation`` calls
    recorded: (out, aux, dispatched tokens (G, E, C, D), expert outputs y)."""
    seen = []

    def record(t, names):
        seen.append(t)
        return t

    monkeypatch.setattr(j_moe, "shard_activation", record)
    out, aux = j_moe.moe_apply(p, x, cfg)
    monkeypatch.undo()
    xg, _, y, _ = seen[0], seen[1], seen[2], seen[3]
    return out, aux, xg, y


def _reference_routing(p, x, k):
    """The reference's routing (``moe_apply``'s first lines): the
    renormalised top-K weights and experts."""
    logits = jnp.einsum("gsd,de->gse", x.astype(jnp.float32), p["router"])
    top_w, top_e = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    top_w = top_w / jnp.maximum(top_w.sum(-1, keepdims=True), 1e-9)
    return np.asarray(top_w), np.asarray(top_e)


def _table_of(xg, x_pad) -> np.ndarray:
    """The token index of each dispatched row: (G, E*C), S for the zero row.
    The inputs' rows are distinct, so each dispatched row names one."""
    G, E, C, D = xg.shape
    rows = xg.reshape(G, E * C, D)
    out = np.empty((G, E * C), np.int64)
    for g in range(G):
        eq = (rows[g][:, None, :] == x_pad[g][None, :, :]).all(-1)
        assert (eq.sum(-1) == 1).all()
        out[g] = eq.argmax(-1)
    return out


CASES = {
    # name: (B, S, experts, top_k, capacity factor, planted ties)
    "prefill": (3, 16, 4, 2, 4.0, False),
    "prefill-binding": (3, 16, 4, 2, 0.5, False),
    "prefill-16e-binding": (2, 24, 16, 4, 0.5, False),
    "decode-binding": (6, 1, 4, 2, 0.5, False),
    "decode-16e": (8, 1, 16, 4, 1.25, False),
    "single-token": (1, 1, 4, 2, 0.5, False),
    "ties": (3, 16, 4, 2, 0.5, True),
    "ties-16e": (2, 24, 16, 4, 1.0, True),
}


def _case_inputs(name, dtype):
    B, S, E, K, cf, ties = CASES[name]
    jcfg, tcfg = _cfgs(experts=E, top_k=K, cf=cf, compute_dtype=dtype)
    p, _ = j_moe.init_moe(jax.random.PRNGKey(3), jcfg)
    if ties:   # experts 1 and 2 (and 5 and 9) score alike for every token
        r = p["router"].at[:, 2].set(p["router"][:, 1])
        if E > 9:
            r = r.at[:, 9].set(r[:, 5])
        p = dict(p, router=r)
    x = np.random.default_rng(sum(map(ord, name))).standard_normal(
        (B, S, tcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    return jcfg, tcfg, p, jx, tx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_moe_apply_matches_reference(monkeypatch, name, dtype):
    B, S, E, K, cf, ties = CASES[name]
    jcfg, tcfg, p, jx, tx = _case_inputs(name, dtype)
    tp = params_from_jax(jax.tree.map(np.asarray, p), "cpu")
    jout, jaux, jxg, jy = _reference_run(monkeypatch, p, jx, jcfg)
    tout, taux = moe.moe_apply(tp, tx, tcfg)

    # the port's routing and dispatch, on the groups the reference forms
    gx = tx.reshape(1, B, -1) if S == 1 and B > 1 else tx
    G, Sg = gx.shape[:2]
    C = moe.capacity(Sg, tcfg)
    r = moe.route(tp["router"], gx, K)
    d = moe.dispatch(r.top_e, r.top_w, E, C)
    ref_w, ref_e = _reference_routing(p, jx.reshape(G, Sg, -1), K)
    np.testing.assert_array_equal(r.top_e.numpy(), ref_e)
    _scale_close(r.top_w, ref_w, 1e-6, "top_w")
    x_pad = np.concatenate([_f32(gx), np.zeros((G, 1, gx.shape[-1]), np.float32)], 1)
    want_table = _table_of(_f32(jxg), x_pad)
    np.testing.assert_array_equal(d.table.numpy(), want_table)
    want_dropped = G * Sg * K - int((want_table < Sg).sum())
    assert int(d.dropped) == want_dropped
    if E * C < Sg * K:          # fewer slots than assignments: drops are certain
        assert want_dropped > 0
    if cf == 4.0:
        assert want_dropped == 0
    if ties:   # a tie broken inside the top-K and one at its edge
        te = r.top_e.reshape(-1, K).numpy()
        inside = ((te == 1).any(1) & (te == 2).any(1))
        edge = ((te == 1).any(1) & ~(te == 2).any(1))
        assert inside.any() and edge.any()
        where = np.argwhere(te[inside] == 1)[:, 1] < np.argwhere(te[inside] == 2)[:, 1]
        assert where.all()

    # combine: the reference's own expert outputs and weights, combined by
    # the port (its tables are the reference's, as checked above)
    y = torch.from_numpy(_f32(jy).copy()).to(tx.dtype)
    d_ref = moe.dispatch(r.top_e, torch.from_numpy(ref_w), E, C)
    got = moe.combine(y, d_ref).reshape(tout.shape)
    np.testing.assert_array_equal(_f32(got), _f32(jout))

    frac = 1e-5 if dtype == "float32" else 2e-2
    _scale_close(tout, jout, frac, f"{name} output")
    assert tout.dtype == tx.dtype and tout.shape == tx.shape
    for k in ("moe_aux", "moe_zloss"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("groups", [2, 3])
def test_decode_groups_match_reference_per_group(groups):
    """``groups=k`` on a (B, 1, D) decode batch: each run of B / k rows is
    one group, so its output equals the reference's on those rows alone."""
    jcfg, tcfg = _cfgs(experts=16, top_k=4, cf=0.5)
    p, _ = j_moe.init_moe(jax.random.PRNGKey(4), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, p), "cpu")
    B = 6
    x = np.random.default_rng(groups).standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
    tout, _ = moe.moe_apply(tp, torch.from_numpy(x), tcfg, groups=groups)
    one, _ = moe.moe_apply(tp, torch.from_numpy(x), tcfg)
    n = B // groups
    want = np.concatenate([_f32(j_moe.moe_apply(p, jnp.asarray(x[i:i + n]), jcfg)[0])
                           for i in range(0, B, n)])
    _scale_close(tout, want, 1e-5, "grouped decode")
    assert not np.allclose(_f32(one), want, rtol=1e-3, atol=1e-3)   # capacity binds
    with pytest.raises(ValueError, match="groups"):
        moe.moe_apply(tp, torch.from_numpy(x), tcfg, groups=4)


def test_count_drops_tallies_by_kind():
    jcfg, tcfg = _cfgs(cf=0.5)
    tp = params_from_jax(jax.tree.map(np.asarray, j_moe.init_moe(jax.random.PRNGKey(5),
                                                                 jcfg)[0]), "cpu")
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 8, 64)).astype(np.float32))
    with moe.count_drops() as tally:
        moe.moe_apply(tp, x, tcfg)
        moe.moe_apply(tp, x, tcfg)
        moe.moe_apply(tp, x[:, :1], tcfg)
    moe.moe_apply(tp, x, tcfg)
    K = tcfg.moe.top_k
    r = moe.route(tp["router"], x, K)
    d = moe.dispatch(r.top_e, r.top_w, 4, moe.capacity(8, tcfg))
    assert int(d.dropped) > 0
    assert [t.tolist() for t in tally["prefill"]] == [[2 * 8 * K, int(d.dropped)]] * 2
    assert [t.tolist()[0] for t in tally["decode"]] == [2 * K]
    assert moe._TALLY is None


def test_moe_grads_match_reference():
    jcfg, tcfg = _cfgs(experts=8, top_k=2, cf=0.75)
    p, _ = j_moe.init_moe(jax.random.PRNGKey(6), jcfg)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 12, tcfg.d_model)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)

    def jscalar(p, x):
        out, aux = j_moe.moe_apply(p, x, jcfg)
        return jnp.sum(out * g) + aux["moe_aux"] + aux["moe_zloss"]

    jgp, jgx = jax.grad(jscalar, argnums=(0, 1))(p, jnp.asarray(x))
    tp = params_from_jax(jax.tree.map(np.asarray, p), "cpu")
    for t in tp.values():
        t.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux = moe.moe_apply(tp, tx, tcfg)
    (torch.sum(out * torch.from_numpy(g)) + aux["moe_aux"] + aux["moe_zloss"]).backward()
    r = moe.route(tp["router"], tx, 2)
    assert int(moe.dispatch(r.top_e, r.top_w, 8, moe.capacity(12, tcfg)).dropped) > 0
    _scale_close(tx.grad, jgx, 1e-5, "d x")
    for k in ("router", "wi", "wg", "wo"):
        _scale_close(tp[k].grad, jgp[k], 1e-5, f"d {k}")


# ---------------------------------------------------------------------------
# the model: loss, gradients and the train step
# ---------------------------------------------------------------------------

def _compare_grads(got, want, what):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _compare_grads(got[k], want[k], f"{what}/{k}")
        return
    frac = 1e-2 if got.dtype == torch.bfloat16 else 1e-4
    _scale_close(got.grad, want, frac, what)


@pytest.mark.parametrize("cf", [None, 0.5])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_loss_and_grads_match_reference(arch, cf):
    jcfg, tcfg = _cfgs(arch, cf=cf, compute_dtype="float32")
    params, _ = j_registry.bundle(jcfg).init(jax.random.PRNGKey(1))
    toks = np.random.default_rng(12).integers(0, tcfg.vocab_size, (2, 17))
    jbatch = {"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
              "labels": jnp.asarray(toks[:, 1:], jnp.int32)}
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: j_registry.bundle(jcfg).loss_fn(p, jbatch), has_aux=True)(params)
    tp = params_from_jax(jax.tree.map(np.asarray, params), "cpu")
    assert {t.dtype for t in tree_leaves(tp)} >= (
        {torch.bfloat16} if arch == "kimi-k2-1t-a32b" else {torch.float32})
    for t in tree_leaves(tp):
        t.requires_grad_(True)
    tloss, tm = registry.bundle(tcfg).loss_fn(
        tp, {"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:])})
    tloss.backward()
    tloss, tm = tloss.detach(), {k: v.detach() for k, v in tm.items()}
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=2e-5)
    assert set(tm) == set(jm) == {"ce_loss", "moe_aux", "moe_zloss"}
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-5, err_msg=k)
    assert float(tm["moe_aux"]) > 0 and float(tm["moe_zloss"]) > 0
    assert float(tloss) == float(tm["ce_loss"] + tm["moe_aux"] + tm["moe_zloss"])
    _compare_grads(tp, jax.tree.map(np.asarray, jgrads), arch)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    a = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_train_step_matches_reference(arch):
    """One step of ``build_train_step`` against the reference's jitted step
    from the same state and batch. kimi-k2 keeps its published bf16 params
    and int8 moments."""
    jcfg, tcfg = _cfgs(arch, cf=0.5, compute_dtype="float32")
    opt_dtype = "int8" if arch == "kimi-k2-1t-a32b" else "float32"
    assert tcfg.opt_dtype == opt_dtype
    j_opt = j_adamw.OptConfig(peak_lr=3e-3, warmup_steps=1, decay_steps=10, dtype=opt_dtype)
    t_opt = adamw.OptConfig(peak_lr=3e-3, warmup_steps=1, decay_steps=10, dtype=opt_dtype)
    jstate = j_steps.init_state(jax.random.PRNGKey(2), jcfg, j_opt)
    tstate = state_from_jax(jax.tree.map(np.asarray, jstate), "cpu")
    toks = np.random.default_rng(5).integers(0, tcfg.vocab_size, (4, 17))
    jstate, jm = jax.jit(j_steps.build_train_step(jcfg, j_opt, None))(
        jstate, {"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
                 "labels": jnp.asarray(toks[:, 1:], jnp.int32)})
    tstate, tm = steps.build_train_step(tcfg, t_opt)(
        tstate, {"tokens": torch.from_numpy(toks[:, :-1]),
                 "labels": torch.from_numpy(toks[:, 1:])})
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    jflat = jax.tree_util.tree_flatten_with_path(jstate["params"])[0]
    for (path, want), got in zip(jflat, tree_leaves(tstate["params"])):
        want, got = np.asarray(want.astype(jnp.float32)), _f32(got)
        what = f"params{jax.tree_util.keystr(path)}"
        if arch == "kimi-k2-1t-a32b":
            assert (np.abs(got - want) <= _bf16_ulp(want)).all(), what
        else:
            assert float(np.abs(got - want).max()) <= 3e-3, what
            assert int((np.abs(got - want) > 1e-6).sum()) <= 1e-4 * got.size + 2, what
    for part in ("mu", "nu"):
        jleaves = jax.tree_util.tree_leaves(
            jstate["opt"][part], is_leaf=lambda t: isinstance(t, j_adamw.QTensor))
        tleaves = list(adamw._flat_with_q(tstate["opt"][part]))
        assert len(jleaves) == len(tleaves)
        for want, got in zip(jleaves, tleaves):
            if isinstance(want, j_adamw.QTensor):
                assert isinstance(got, adamw.QTensor) and got.q.dtype == torch.int8
                w = np.asarray(want.q, np.float32) * np.asarray(want.scale)
                step = np.asarray(want.scale)
                np.testing.assert_allclose(_f32(adamw._load(got)), w, rtol=0,
                                           atol=float(step.max()) * 1.01 + 1e-30)
            else:
                _scale_close(got, want, 1e-5, part)


# ---------------------------------------------------------------------------
# the int8 moments' quantizer
# ---------------------------------------------------------------------------

def test_int8_quantize_matches_jitted_reference_bitwise():
    """``adamw._quantize`` equals ``jax.jit`` of the reference's bit for bit:
    the scale is ``max(absmax, 1e-12) * fl(1/127)`` (the multiply XLA makes
    of ``/ 127.0`` under jit), the codes a true division rounded half to
    even; rows span scales 1e-8 to 1e2, with an all-zero row."""
    rng = np.random.default_rng(21)
    rows = [rng.standard_normal((64, 96)) * 10.0 ** rng.uniform(-8, 2, (64, 1))
            for _ in range(4)]
    x = np.concatenate(rows).astype(np.float32)
    x[7] = 0.0
    x[9, :3] = [1.5, -2.5, 0.5]     # halves at the code grid
    jq = jax.jit(j_adamw._quantize)(jnp.asarray(x))
    tq = adamw._quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.scale.numpy().view(np.uint32),
                                  np.asarray(jq.scale).view(np.uint32))
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
    assert tq.q.dtype == torch.int8 and tq.scale.dtype == torch.float32
