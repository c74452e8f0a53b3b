"""The port's hybrid family (jamba-1.5-large-398b) against the JAX reference,
on the CPU.

The smoke config (``archs.smoke_cfg``: 16 layers in 2 units of 1 attention
and 7 Mamba-2 layers, d_model 64, 4 experts top-2 on every second layer,
Mamba head dim 8 in 2 groups, chunk 8); reference params carried across
with ``weights.params_from_jax``. The MoE layers' loss, gradients and train
step are cases of ``tests/test_torch_moe.py``, its short prefill and decode
cases of ``tests/test_torch_serving_moe.py``.

- ``scan_unit`` and ``n_units`` equal the reference's for the published
  config, its long_500k cell (``force_local``, window 4096) and the smoke
  config.
- The param tree's paths, shapes and dtypes equal the reference's, for the
  smoke config, the card cell (one unit, 4 experts) and the published
  config (the port's as meta tensors, the reference's by ``jax.eval_shape``).
- The long-context variant (smoke, ``force_local``, window 16): a 24-token
  prefill (past the window, and a multiple of the chunk, as the reference's
  scan requires) and 24 decode ticks, fed the reference's greedy
  tokens: the logits, the attention ring and every Mamba layer's ``ssm`` and
  ``conv`` state after every tick, float32 compute within rtol 2e-5 with an
  absolute floor of 2e-5 x the tensor's largest magnitude (the dense and MoE
  serving tests' bound), greedy tokens equal, so routing is held exactly.
  bf16 compute runs with top-k = n_experts (every token to every expert,
  the routing weights still computed): at top-2 the two packages' bf16
  roundings, which differ (the reference's scan rounds W to bf16, the port
  keeps it in float32 as the Pallas kernel does; the reference's ``silu``
  rounds its sigmoid first), flip near-tied routing choices at random init
  somewhere in 16 layers and 24 ticks, moving single state entries by up to
  30% of the tensor's scale (measured), in either package against the
  float32 run; at top-4 single entries still differ by up to 12% of a
  state's largest magnitude, the two packages alike against the float32
  run, so the bf16 bound is on each tensor's root-mean-square relative
  difference ``||a - b|| / ||b||``: within 2e-2 (the MoE serving tests'
  bound over 2 layers, there on the largest magnitude) plus twice the
  reference's own bf16 spread on that tensor (its bf16 run against its
  float32 run fed the same tokens: up to 3.5e-2, measured), and no farther
  from the float32 run than 2e-2 plus 1.5 x that spread: the port's bf16
  is as accurate as the reference's.
- ``ModelDecoder`` with two replicas folded into one batch at different
  ``pos``: each replica's tokens equal a one-replica decoder's run of its
  own waves, and its caches (ring and Mamba states) agree at float32
  rounding.
- ``init_params`` for every arch, with one unit and with two, is bit for bit
  a copy of the draw order it had before the one-unit case was changed (draw
  a unit, copy it into its slot of the stack); with one unit the stacked
  leaves are the drawn unit's own storage, not a second allocation.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import _path_str
from repro.configs import archs as j_archs
from repro.models import registry as j_registry
from repro.models import transformer as j_transformer
from repro.models.config import SHAPES as J_SHAPES
from repro_torch.checkpoint.checkpoint import _flatten_with_paths
from repro_torch.configs import archs
from repro_torch.launch import steps
from repro_torch.models import registry, transformer
from repro_torch.models.config import SHAPES
from repro_torch.models.layers import dtype_of, init_embedding, init_rmsnorm
from repro_torch.optim import adamw
from repro_torch.pytree import tree_leaves, tree_map
from repro_torch.weights import params_from_jax
from test_torch_serving import _snapshot

ARCH = "jamba-1.5-large-398b"
# the prompt is past the window (the prefill writes the ring) and a multiple
# of the smoke chunk of 8, which the reference's SSD scan asserts
WINDOW, PROMPT, TICKS, MAX_LEN = 16, 24, 24, 48


def _card_cell(pkg):
    """The ``[hybrid]`` card cell's config: one unit, 4 of 16 experts."""
    c = pkg.get(ARCH)
    return c.replace(n_layers=8, moe=dataclasses.replace(c.moe, n_experts=4))


def _configs(kind):
    """(reference, port) configs of a kind."""
    if kind == "published":
        return j_archs.get(ARCH), archs.get(ARCH)
    if kind == "long_500k":
        return (j_archs.cfg_for_cell(j_archs.get(ARCH), J_SHAPES["long_500k"]),
                archs.cfg_for_cell(archs.get(ARCH), SHAPES["long_500k"]))
    if kind == "card cell":
        return _card_cell(j_archs), _card_cell(archs)
    j, t = j_archs.smoke_cfg(j_archs.get(ARCH)), archs.smoke_cfg(archs.get(ARCH))
    if kind == "smoke long":
        return (j.replace(force_local=True, sliding_window=WINDOW),
                t.replace(force_local=True, sliding_window=WINDOW))
    return j, t


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else
                      np.asarray(jnp.asarray(x).astype(jnp.float32)), np.float32)


def _rms_rel(a, b) -> float:
    """||a - b|| / ||b||."""
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def ref_params():
    jcfg, _ = _configs("smoke")
    return jax.tree.map(np.asarray, j_registry.bundle(jcfg).init(jax.random.PRNGKey(0))[0])


# ---------------------------------------------------------------------------
# the unit and the param tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["published", "long_500k", "smoke"])
def test_scan_unit_matches_reference(kind):
    jcfg, tcfg = _configs(kind)
    got = [dataclasses.astuple(d) for d in transformer.scan_unit(tcfg)]
    want = [dataclasses.astuple(d) for d in j_transformer.scan_unit(jcfg)]
    assert got == want and len(got) == 8
    assert transformer.n_units(tcfg) == j_transformer.n_units(jcfg)
    assert [(m, f) for m, _, f, _ in got] == [("attn", "dense")] + [
        ("mamba", "moe" if j % 2 else "dense") for j in range(1, 8)]
    assert all(local == (kind == "long_500k") for _, local, _, _ in got)
    if kind == "long_500k":
        assert tcfg.sliding_window == 4096


@pytest.mark.parametrize("kind", ["smoke", "card cell", "published"])
def test_param_tree_matches_reference(kind):
    jcfg, tcfg = _configs(kind)
    want = jax.eval_shape(lambda: j_registry.bundle(jcfg).init(jax.random.PRNGKey(0))[0])
    if kind == "smoke":
        got = registry.bundle(tcfg).init(torch.Generator().manual_seed(0))
    else:
        got = steps.state_target(tcfg, adamw.OptConfig())["params"]
    jflat = jax.tree_util.tree_flatten_with_path(want)[0]
    tflat = _flatten_with_paths(got)
    assert [k for k, _ in tflat] == ["/".join(_path_str(p) for p in path) for path, _ in jflat]
    for (k, t), (_, j) in zip(tflat, jflat):
        assert tuple(t.shape) == tuple(j.shape), k
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype), k
    n = sum(t.numel() for t in tree_leaves(got))
    assert n == tcfg.param_count()
    if kind == "card cell":
        assert 15.7e9 < n < 15.8e9          # 58.6 GiB of f32 params


# ---------------------------------------------------------------------------
# serving: the long-context variant and the folded decoder
# ---------------------------------------------------------------------------

def _ref_trace(jcfg, params, toks, feed=None):
    """The reference's (logits, caches) after the prefill and after each of
    ``TICKS`` jitted decode ticks, as numpy, and the tokens it was fed: its
    own greedy ones, or ``feed``'s."""
    jb = j_registry.bundle(jcfg)
    prefill = jax.jit(lambda p, t: jb.prefill_fn(p, {"tokens": t}, MAX_LEN))
    decode = jax.jit(lambda p, c, t: jb.decode_fn(p, c, {"token": t}))
    jl, jc = prefill(params, jnp.asarray(toks, jnp.int32))
    trace, fed = [], []
    for step in range(TICKS + 1):
        trace.append(jax.tree.map(_np, (jl, jc)))
        if step == TICKS:
            break
        fed.append(np.argmax(trace[-1][0][:, -1], axis=-1) if feed is None else feed[step])
        jl, jc = decode(params, jc, jnp.asarray(fed[-1][:, None], jnp.int32))
    return trace, fed


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_long_context_prefill_and_decode_past_the_window(ref_params, compute_dtype):
    """float32: every tensor within rtol 2e-5 and 2e-5 of its scale of the
    reference's, the greedy tokens equal (routing held exactly). bf16, at
    top-k = n_experts (module docstring), by root-mean-square relative
    difference: within 2e-2 plus twice the reference's own bf16 spread on
    that tensor (its bf16 run against its float32 run fed the same tokens),
    and no farther from the float32 run than 2e-2 plus 1.5 x that spread."""
    bf16 = compute_dtype == "bfloat16"
    jcfg, tcfg = (c.replace(compute_dtype=compute_dtype) for c in _configs("smoke long"))
    if bf16:
        jcfg, tcfg = (c.replace(moe=dataclasses.replace(c.moe, top_k=c.moe.n_experts))
                      for c in (jcfg, tcfg))
    toks = np.random.default_rng(11).integers(0, tcfg.vocab_size, (3, PROMPT))
    want, fed = _ref_trace(jcfg, ref_params, toks)
    if bf16:
        f32, _ = _ref_trace(jcfg.replace(compute_dtype="float32"), ref_params, toks, fed)
    names = sorted(want[0][1]["units"])
    assert names == ["kv0"] + [f"mamba{j}" for j in range(1, 8)]
    tb, tp = registry.bundle(tcfg), params_from_jax(ref_params, "cpu")
    tl, tc = tb.prefill_fn(tp, {"tokens": torch.from_numpy(toks)}, MAX_LEN)
    assert tc["units"]["kv0"].k.shape[2] == WINDOW

    def tensors(logits, cache):
        return {"logits": logits, **{f"{n}.{f}": t for n in names
                                     for f, t in cache["units"][n]._asdict().items()}}

    for step in range(TICKS + 1):
        if step:
            if not bf16:
                np.testing.assert_array_equal(torch.argmax(tl[:, -1], dim=-1).numpy(),
                                              fed[step - 1])
            tl, tc = tb.decode_fn(tp, tc, {"token": torch.from_numpy(fed[step - 1][:, None])})
        got, ref = tensors(tl, tc), tensors(*want[step])
        assert set(got) == set(ref) and int(tc["pos"]) == PROMPT + step
        plain = tensors(*f32[step]) if bf16 else None
        for k, g in got.items():
            g, w, what = _np(g), ref[k], f"{k} at step {step}"
            assert g.shape == w.shape, what
            scale = float(np.abs(w).max())
            if not bf16:
                np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-5 * scale, err_msg=what)
                continue
            spread = _rms_rel(w, plain[k])
            assert _rms_rel(g, w) <= 2e-2 + 2 * spread, what
            assert _rms_rel(g, plain[k]) <= 2e-2 + 1.5 * spread, what


def _port_decoder(n_replicas, batch, params_np, cfg, max_len=40):
    from repro_torch.serving import ModelDecoder

    dec = ModelDecoder(cfg, n_replicas, batch, max_len, device="cpu")
    dec.params = params_from_jax(params_np, "cpu")
    return dec


def test_model_decoder_folds_replicas_at_different_pos(ref_params):
    """Two replicas folded into one batch, admitted at different times so
    their ``pos`` differ in the shared decode steps (rope, ring slot and
    kv_len per lane; each Mamba state advanced per lane; one MoE decode
    group per replica): each replica's tokens equal a one-replica decoder's
    run of its own waves, and its caches agree at float32 rounding (rtol
    1e-5: the folded matmuls have more rows)."""
    _, tcfg = _configs("smoke long")
    rng = np.random.default_rng(4)
    wave_a = [rng.integers(0, 128, n).astype(np.int32) for n in (7, 12)]
    wave_b = [rng.integers(0, 128, n).astype(np.int32) for n in (17, 30)]
    both = _port_decoder(2, 2, ref_params, tcfg)
    solo = [_port_decoder(1, 2, ref_params, tcfg) for _ in range(2)]
    streams, solo_streams = {0: [], 1: []}, {0: [], 1: []}

    def prefill(r, w):
        streams[r].append(both.prefill_waves({r: w})[r])
        solo_streams[r].append(solo[r].prefill_waves({0: w})[0])

    def step(active):
        toks = both.step(np.array(active))
        for r in (0, 1):
            if active[r]:
                streams[r].append(toks[r].tolist())
                solo_streams[r].append(solo[r].step(np.array([True]))[0].tolist())

    prefill(0, wave_a)                     # bucket 16
    step([True, False])
    step([True, False])
    prefill(1, wave_b)                     # bucket 32, replica 0 at pos 18
    for _ in range(5):                     # pos 18-22 and 32-36, rings wrapped
        step([True, True])
    assert [int(p) for p in both._cache["pos"]] == [16 + 7, 32 + 5]
    assert streams == solo_streams
    for r in (0, 1):
        got, _ = _snapshot(both, r)
        want, _ = _snapshot(solo[r], 0)
        assert len(got) == 2 + 2 * 7     # the ring's k, v and 7 Mamba layers' ssm, conv
        for a, b in zip(got, want):
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# init_params: the draw order and the one-unit stack
# ---------------------------------------------------------------------------

def _init_params_before(gen, cfg):
    """``init_params`` as it was before the one-unit case drew the stack as
    views: the first unit drawn, a stacked copy allocated, each unit copied
    into its slot."""
    params = {"embed": init_embedding(gen, cfg)}
    U = transformer.n_units(cfg)
    first = transformer.init_unit(gen, cfg)
    units = tree_map(lambda t: t.new_empty((U,) + tuple(t.shape)), first)
    for u in range(U):
        one = first if u == 0 else transformer.init_unit(gen, cfg)
        tree_map(lambda dst, src: dst[u].copy_(src), units, one)
    params["units"] = units
    params["final_ln"] = init_rmsnorm(cfg.d_model, dtype_of(cfg.param_dtype), gen.device)
    if cfg.enc_dec:
        params["encoder"] = transformer.init_encoder(gen, cfg)
    return params


@pytest.mark.parametrize("units", [1, 2])
@pytest.mark.parametrize("arch", sorted(archs.ARCHS))
def test_init_params_draws_as_before(arch, units, monkeypatch):
    cfg = archs.smoke_cfg(archs.get(arch))
    cfg = cfg.replace(n_layers=units * len(transformer.scan_unit(cfg)))
    want = _init_params_before(torch.Generator().manual_seed(3), cfg)
    drawn = []
    real = transformer.init_unit

    def init_unit(gen, c):
        drawn.append(real(gen, c))
        return drawn[-1]

    monkeypatch.setattr(transformer, "init_unit", init_unit)
    got = transformer.init_params(torch.Generator().manual_seed(3), cfg)
    assert len(drawn) == units
    flat_got, flat_want = tree_leaves(got), tree_leaves(want)
    assert len(flat_got) == len(flat_want)
    for g, w in zip(flat_got, flat_want):
        assert g.dtype == w.dtype and g.shape == w.shape and g.is_contiguous()
        assert torch.equal(g.view(torch.uint8), w.view(torch.uint8))
    stacked = tree_leaves(got["units"])
    if units == 1:
        # the stack is the drawn unit itself: the same storage, no other
        for s, d in zip(stacked, tree_leaves(drawn[0])):
            assert s.untyped_storage().data_ptr() == d.untyped_storage().data_ptr()
            assert s.untyped_storage().nbytes() == d.numel() * d.element_size()
    else:
        for s, d in zip(stacked, tree_leaves(drawn[0])):
            assert s.untyped_storage().data_ptr() != d.untyped_storage().data_ptr()
            assert s.untyped_storage().nbytes() == units * d.numel() * d.element_size()
