"""The port's dense training slice against the JAX reference, on the CPU.

Inputs come from numpy seeds (or the reference's own init, carried across
with ``weights``); the reference runs in this process on the CPU.

- ``flash_attention_train``: forward and dq/dk/dv against ``jax.grad``
  through the reference's ``flash_attention_train``, on the blocked path
  (S a multiple of the blocks: the blocked forward and the manual backward
  on both sides) and the naive path (S not: autograd through
  ``naive_attention`` on both sides); causal, windows whose edges fall
  inside a block, softcap 50 and none, G 1, 2 and 4, one non-causal
  window. float32: within 2e-5 of each tensor's largest magnitude (the
  same algebra, summed in another order; XLA computes ``x / cap`` as a
  reciprocal multiply inside its scan). bf16: within 1e-2 of the scale
  (p is rounded to bf16 before PV on both sides, and eager PyTorch rounds
  each bf16 op where XLA may fuse; measured below 4e-3).
- The dense ``loss_fn`` and every param's gradient against
  ``jax.value_and_grad`` of the reference's ``loss_fn`` for the smoke
  configs of gemma2-9b, gemma2-27b, granite-20b (MQA, 2-matrix MLP) and
  qwen2-72b (QKV bias, untied head, rope theta 1e6), float32 compute:
  the loss within rtol 2e-5, each gradient within 1e-4 of its largest
  magnitude (a gradient sums every token's and head's term, and a small
  entry carries the rounding of large ones: measured below 2e-5).
- ``steps.build_train_step`` at micro 1 and micro 2: params, AdamW moments,
  count, step and metrics after 2 steps against the reference's jitted
  step from the same state and batches, float32 compute: metrics within
  rtol 1e-5; all but 1e-4 of the params' entries within 1e-6, and every
  entry within the summed learning rate so far. Adam's update is ``mu /
  (sqrt(nu) + 1e-8)``: where a gradient entry is itself about 1e-8 (the
  rounding floor of the sums that make it), a relative difference of a
  few percent in it moves that entry's update by a share of the lr
  (measured: 2 to 5 entries of 131 648 off by more than 1e-6, by 1-3% of
  the lr). The moments within 1e-5 of each leaf's scale after the first
  step (measured below 8e-7), and 5e-4 after the second, whose gradients
  are taken at params that differ by those entries (measured up to
  1.1e-4 for nu, 5.7e-5 for mu, at micro 2).
- ``cases.check_first_step``, the card's comparison of a train step on the
  kernels with one on their plain versions, on hand-made first steps: it
  fails a gradient 0.1% off, a large entry's sign flipped and an entry
  dropped, and passes a sign flip within its mu tolerance of zero.
- ``train.main(["--smoke", "--device", "cpu", ...])`` against the
  reference's ``train.main``, both restoring the same step-0 checkpoint
  written by the reference (so both start from its init): the losses of 3
  steps within rtol 2e-3 (bf16 compute, the smoke default: eager PyTorch
  and XLA round bf16 ops at different places; measured below 5e-4).
- Checkpoints: a tree saved by the reference (f32 params, int8 AdamW
  moments with f32 scales, bf16 leaves, int32 counters) restores in the
  port bit for bit, and the port's save restores in the reference bit for
  bit; manifests name the same paths, dtypes and hashes.
- The telemetry export and report: the port's ``metrics_snapshot``,
  ``chrome_trace``, ``prometheus_text`` and ``mission_report`` of one
  recorder equal the reference's; the audit CLI writes a mission report
  with ``--report``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as j_ckpt
from repro.configs import archs as j_archs
from repro.launch import steps as j_steps
from repro.launch import train as j_train
from repro.models import attention as j_attention
from repro.models import registry as j_registry
from repro.optim import adamw as j_adamw
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import archs
from repro_torch.launch import steps, train
from repro_torch.models import attention, registry
from repro_torch.optim import adamw
from repro_torch.pytree import tree_leaves
from repro_torch.weights import params_from_jax, state_from_jax

DENSE_ARCHS = ("gemma2-9b", "gemma2-27b", "granite-20b", "qwen2-72b")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _scale_close(got, want, frac: float, what: str):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    bound = frac * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= bound, f"{what}: max |diff| {err:.3g} > {bound:.3g}"


# ---------------------------------------------------------------------------
# flash_attention_train
# ---------------------------------------------------------------------------

# (B, S, H, KV, causal, window, softcap, block, dtype); blocked when S % block == 0
ATTN_CASES = [
    (2, 32, 4, 4, True, None, 50.0, 8, "float32"),     # blocked, G 1
    (2, 32, 4, 2, True, 12, 50.0, 8, "float32"),       # blocked, G 2, window inside blocks
    (1, 32, 8, 2, True, 5, None, 16, "float32"),       # blocked, G 4, no softcap
    (1, 32, 4, 2, False, 9, 50.0, 8, "float32"),       # blocked, non-causal window
    (2, 20, 4, 2, True, None, 50.0, 8, "float32"),     # naive, G 2
    (1, 20, 8, 2, True, 6, None, 8, "float32"),        # naive, G 4, window
    (1, 20, 4, 4, True, 7, 50.0, 8, "float32"),        # naive, G 1
    (2, 32, 4, 2, True, 12, 50.0, 8, "bfloat16"),      # blocked, bf16
    (2, 20, 4, 2, True, None, 50.0, 8, "bfloat16"),    # naive, bf16
]


@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_attention_train_matches_reference(case):
    B, S, H, KV, causal, window, cap, block, dtype = case
    hd = 16
    rng = np.random.default_rng(S * 7 + H)
    q, g = (rng.standard_normal((B, S, H, hd)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, S, KV, hd)).astype(np.float32) for _ in range(2))
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jspec = j_attention.AttnSpec(causal=causal, window=window, softcap=cap,
                                 block_q=block, block_k=block)
    tspec = attention.AttnSpec(causal=causal, window=window, softcap=cap,
                               block_q=block, block_k=block)
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    jg = jnp.asarray(g, jdt)
    jout, vjp = jax.vjp(lambda a, b, c: j_attention.flash_attention_train(a, b, c, jspec),
                        jq, jk, jv)
    jgrads = vjp(jg)
    tq, tk, tv = (torch.tensor(x).to(tdt).requires_grad_(True) for x in (q, k, v))
    tout = attention.flash_attention_train(tq, tk, tv, tspec)
    tgrads = torch.autograd.grad(tout, (tq, tk, tv), torch.tensor(g).to(tdt))
    assert attention._divisible(tq, tk, tspec) == (S % block == 0)
    frac = 2e-5 if dtype == "float32" else 1e-2
    _scale_close(tout, jout, frac, "out")
    assert tout.dtype == tdt
    for name, got, want in zip(("dq", "dk", "dv"), tgrads, jgrads):
        assert got.dtype == tdt, name
        _scale_close(got, want, frac, name)


def test_blocked_backward_equals_plain_kernel_version():
    """The CPU path's blocked backward and the kernels' plain version
    (``ref.attention_bwd_ref``, one block) are the same function: equal
    within float32 summation order."""
    from repro_torch.kernels.flash_attention import ref

    rng = np.random.default_rng(3)
    B, S, H, KV, hd = 2, 32, 4, 2, 16
    q, g = (torch.tensor(rng.standard_normal((B, S, H, hd)), dtype=torch.float32)
            for _ in range(2))
    k, v = (torch.tensor(rng.standard_normal((B, S, KV, hd)), dtype=torch.float32)
            for _ in range(2))
    spec = attention.AttnSpec(causal=True, window=12, softcap=50.0, block_q=8, block_k=8)
    out, lse = attention._flash_forward(q, k, v, spec)
    kw = dict(causal=True, window=12, softcap=50.0)
    _scale_close(lse, ref.attention_lse_ref(q, k, **kw), 1e-6, "lse")
    want = ref.attention_bwd_ref(q, k, v, out, lse, g, **kw)
    for name, got, w in zip(("dq", "dk", "dv"),
                            attention._flash_backward(q, k, v, out, lse, g, spec), want):
        _scale_close(got, w, 2e-6, name)


# ---------------------------------------------------------------------------
# the dense loss and its gradients, four archs
# ---------------------------------------------------------------------------

def _cfgs(arch: str, **kw):
    j = j_archs.smoke_cfg(j_archs.get(arch)).replace(**kw)
    t = archs.smoke_cfg(archs.get(arch)).replace(**kw)
    return j, t


def _compare_trees(got, want, frac: float, what: str):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _compare_trees(got[k], want[k], frac, f"{what}/{k}")
        return
    if isinstance(want, tuple):
        for i, (g_, w_) in enumerate(zip(got, want)):
            _compare_trees(g_, w_, frac, f"{what}/{i}")
        return
    _scale_close(got, want, frac, what)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_dense_loss_and_grads_match_reference(arch):
    jcfg, tcfg = _cfgs(arch, compute_dtype="float32")
    params, _ = j_registry.bundle(jcfg).init(jax.random.PRNGKey(1))
    rng = np.random.default_rng(11)
    toks = rng.integers(0, tcfg.vocab_size, (2, 17))
    jbatch = {"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
              "labels": jnp.asarray(toks[:, 1:], jnp.int32)}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: j_registry.bundle(jcfg).loss_fn(p, jbatch), has_aux=True)(params)
    tp = params_from_jax(jax.tree.map(np.asarray, params), "cpu")
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    tloss, metrics = registry.bundle(tcfg).loss_fn(
        tp, {"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:])})
    tloss.backward()
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=2e-5)
    assert float(metrics["ce_loss"]) == float(tloss)
    tgrads = jax.tree.map(lambda x: x, {k: v for k, v in tp.items()})
    _compare_trees(_grads_of(tgrads), jax.tree.map(np.asarray, jgrads), 1e-4, arch)


def _grads_of(tree):
    if isinstance(tree, dict):
        return {k: _grads_of(v) for k, v in tree.items()}
    return tree.grad


# ---------------------------------------------------------------------------
# the train step, micro 1 and 2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("micro", [1, 2])
def test_train_step_matches_reference(micro):
    jcfg, tcfg = _cfgs("gemma2-9b", compute_dtype="float32", micro_steps=micro)
    j_opt = j_adamw.OptConfig(peak_lr=3e-3, warmup_steps=1, decay_steps=10)
    t_opt = adamw.OptConfig(peak_lr=3e-3, warmup_steps=1, decay_steps=10)
    jstate = j_steps.init_state(jax.random.PRNGKey(2), jcfg, j_opt)
    tstate = state_from_jax(jax.tree.map(np.asarray, jstate), "cpu")
    jstep = jax.jit(j_steps.build_train_step(jcfg, j_opt, None))
    tstep = steps.build_train_step(tcfg, t_opt)
    rng = np.random.default_rng(5)
    for i in range(2):
        toks = rng.integers(0, tcfg.vocab_size, (4, 17))
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
                                    "labels": jnp.asarray(toks[:, 1:], jnp.int32)})
        tstate, tm = tstep(tstate, {"tokens": torch.from_numpy(toks[:, :-1]),
                                    "labels": torch.from_numpy(toks[:, 1:])})
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
        for part in ("mu", "nu"):
            _compare_trees(tstate["opt"][part], jax.tree.map(np.asarray, jstate["opt"][part]),
                           1e-5 if i == 0 else 5e-4, f"step {i} {part}")
        flat = jax.tree_util.tree_flatten_with_path(jstate["params"])[0]
        lr_sum = (i + 1) * 3e-3
        off = total = 0
        for (path, want), got in zip(flat, tree_leaves(tstate["params"])):
            diff = np.abs(got.numpy() - np.asarray(want))
            off += int((diff > 1e-6).sum())
            total += diff.size
            assert float(diff.max()) <= lr_sum, \
                f"step {i} params{jax.tree_util.keystr(path)}: {float(diff.max()):.3g}"
        assert off <= 1e-4 * total, f"step {i}: {off} of {total} param entries off by > 1e-6"
    assert int(tstate["step"]) == int(jstate["step"]) == 2
    assert int(tstate["opt"]["count"]) == int(jstate["opt"]["count"]) == 2


def _first_step(g: torch.Tensor, opt):
    params = {"w": torch.linspace(-1.0, 1.0, g.numel()).reshape(g.shape)}
    state = {"params": params, "opt": adamw.init_opt_state(params, opt)}
    state["params"], state["opt"], metrics = adamw.apply_updates(
        params, {"w": g}, state["opt"], opt)
    metrics["loss"] = torch.tensor(2.0)
    return state, metrics


@pytest.mark.parametrize("change,caught", [
    ("none", False), ("scale 1.001", True), ("flip a gradient near eps", False),
    ("flip a large gradient", True), ("zero a gradient", True)])
def test_first_step_check(change, caught):
    """``cases.check_first_step`` (the card's train-step comparison) at its
    f32 limits: a gradient off by 0.1%, the sign of a large entry flipped
    or an entry dropped fail it; the sign of an entry within the mu
    tolerance of zero may flip (Adam's first step moves it by up to 2 lr),
    as two summation orders may do to it."""
    from repro_torch.kernels.flash_attention import cases

    opt = adamw.OptConfig(peak_lr=3e-3, warmup_steps=5, decay_steps=10, clip_norm=1e3)
    g = torch.from_numpy(np.random.default_rng(3).standard_normal((8, 16)).astype(np.float32))
    g[2, 5] = 3e-9
    want = _first_step(g, opt)
    h = g.clone()
    if change == "scale 1.001":
        h *= 1.001
    elif change == "flip a gradient near eps":
        h[2, 5] = -h[2, 5]
    elif change == "flip a large gradient":
        h[0, 0] = -h[0, 0]
    elif change == "zero a gradient":
        h[4, 4] = 0.0
    got = _first_step(h, opt)
    kw = dict(loss_rtol=1e-5, gnorm_rtol=1e-5, mu_rtol=1e-5)
    if caught:
        with pytest.raises(AssertionError, match="first step"):
            cases.check_first_step(*got, *want, opt, **kw)
    else:
        read = cases.check_first_step(*got, *want, opt, **kw)
        assert read["flips"] == (change != "none")


# ---------------------------------------------------------------------------
# the trainer's CLI
# ---------------------------------------------------------------------------

def test_train_main_matches_reference(tmp_path, capsys):
    argv = ["--arch", "gemma2-9b", "--smoke", "--steps", "3", "--seq", "16", "--batch", "4",
            "--restore", "--seed", "4"]
    cfg = j_archs.smoke_cfg(j_archs.get("gemma2-9b"))
    opt = j_adamw.OptConfig(peak_lr=3e-3, warmup_steps=5, decay_steps=10)
    start = j_steps.init_state(jax.random.PRNGKey(9), cfg, opt)
    for name in ("ref", "port"):
        j_ckpt.save(tmp_path / name, 0, start, async_save=False)
    want = j_train.main(argv + ["--ckpt", str(tmp_path / "ref")])
    got = train.main(argv + ["--ckpt", str(tmp_path / "port"), "--device", "cpu"])
    assert "restored checkpoint at step 0" in capsys.readouterr().out
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=2e-3)


# ---------------------------------------------------------------------------
# checkpoints across the two packages
# ---------------------------------------------------------------------------

def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        return t.reshape(-1).view(torch.uint8).numpy().copy()
    return np.frombuffer(np.ascontiguousarray(np.asarray(x)).tobytes(), np.uint8)


def _ref_tree():
    cfg = j_archs.smoke_cfg(j_archs.get("gemma2-9b"))
    state = j_steps.init_state(jax.random.PRNGKey(6), cfg,
                               j_adamw.OptConfig(dtype="int8"))
    # moments that are not all zeros, so their codes and scales carry bits
    noisy = jax.tree.map(lambda p: p * 0.01 + 0.003, state["params"])
    state["opt"]["mu"] = jax.tree.map(j_adamw._quantize, noisy)
    state["opt"]["count"] = jnp.asarray(5, jnp.int32)
    return {"state": state,
            "bf16": jax.tree.map(lambda p: p.astype(jnp.bfloat16), state["params"])}


def test_checkpoint_reference_to_port_bitwise(tmp_path):
    tree = _ref_tree()
    j_ckpt.save(tmp_path, 3, tree, async_save=False)
    target = state_from_jax(jax.tree.map(np.asarray, tree), "cpu")
    step, got = ckpt.restore(tmp_path, target=target, device="cpu")
    assert step == 3 and ckpt.latest_step(tmp_path) == 3
    want_flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    got_flat = ckpt._flatten_with_paths(got)
    assert [k for k, _ in got_flat] == [
        "/".join(j_ckpt._path_str(p) for p in path) for path, _ in want_flat]
    kinds = set()
    for (_, g_), (_, w_) in zip(got_flat, want_flat):
        kinds.add(str(np.asarray(w_).dtype))
        assert g_.dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16,
                            "int8": torch.int8, "int32": torch.int32}[str(np.asarray(w_).dtype)]
        np.testing.assert_array_equal(_bits(g_), _bits(w_))
    assert kinds == {"float32", "bfloat16", "int8", "int32"}


def test_checkpoint_port_to_reference_bitwise(tmp_path):
    tree = _ref_tree()
    port_tree = state_from_jax(jax.tree.map(np.asarray, tree), "cpu")
    ckpt.save(tmp_path, 8, port_tree, meta={"by": "port"}, keep=2)
    ckpt.save(tmp_path, 9, port_tree, keep=2)
    ckpt.save(tmp_path, 10, port_tree, keep=2)
    ckpt.wait_all()
    assert ckpt.all_steps(tmp_path) == j_ckpt.all_steps(tmp_path) == [9, 10]
    j_ckpt.save(tmp_path / "ref", 10, tree, async_save=False)
    step, back = j_ckpt.restore(tmp_path, target=tree)
    assert step == 10
    for (_, g_), (_, w_) in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                                jax.tree_util.tree_flatten_with_path(tree)[0]):
        assert g_.dtype == w_.dtype
        np.testing.assert_array_equal(_bits(g_), _bits(w_))
    import msgpack

    mine = msgpack.unpackb((tmp_path / "step_0000000010" / "manifest.msgpack").read_bytes())
    theirs = msgpack.unpackb(
        (tmp_path / "ref" / "step_0000000010" / "manifest.msgpack").read_bytes())
    assert mine["keys"] == theirs["keys"] and mine["tree_hash"] == theirs["tree_hash"]


def test_checkpoint_detects_corruption(tmp_path):
    import msgpack

    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    ckpt.save(tmp_path, 1, tree, async_save=False)
    man = tmp_path / "step_0000000001" / "manifest.msgpack"
    doc = msgpack.unpackb(man.read_bytes())
    doc["keys"]["w"]["sha256"] = "0" * 64
    man.write_bytes(msgpack.packb(doc, use_bin_type=True))
    with pytest.raises(IOError, match="sha256 mismatch for w"):
        ckpt.restore(tmp_path, target=tree, device="cpu")
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmp_path / "none", device="cpu")


# ---------------------------------------------------------------------------
# telemetry export and report
# ---------------------------------------------------------------------------

def test_telemetry_export_and_report_match_reference():
    from repro.telemetry import export as j_export
    from repro.telemetry import report as j_report
    from repro_torch import telemetry

    with telemetry.record_scope(tracing=True) as rec:
        rec.counter("fl.rounds", 3)
        rec.counter("fl.bytes", 1024)
        telemetry.set_gauge("fl.consensus", 0.25, rec=rec)
        telemetry.observe("groundseg.router.payload_age", 2.0, rec=rec)
        telemetry.observe("groundseg.router.payload_age", 5.0, rec=rec)
        with rec.span("fl.round", cat="round", round=0):
            with rec.span("fl.exchange", cat="exchange"):
                pass
        rec.event("fl.node_lost", node=3)
        mine = (telemetry.metrics_snapshot(rec), telemetry.chrome_trace(rec),
                telemetry.prometheus_text(rec), telemetry.mission_report(rec, title="t"))
        theirs = (j_export.metrics_snapshot(rec), j_export.chrome_trace(rec),
                  j_export.prometheus_text(rec), j_report.mission_report(rec, title="t"))
    for doc in (mine[3], theirs[3]):
        doc.pop("generated_unix_s")
    assert mine == theirs
    assert mine[0]["counters"]["fl.rounds"] == 3
    assert telemetry.render_markdown(mine[3]) == j_report.render_markdown(theirs[3])


def test_audit_cli_writes_mission_report(tmp_path, capsys):
    """The port's audit CLI takes the reference's ``--report PREFIX``."""
    from repro_torch.telemetry import audit

    prefix = tmp_path / "mission"
    assert audit.main(["--ci-smoke", "--windows", "3", "--report", str(prefix)]) == 0
    out = capsys.readouterr().out
    assert "0 violation(s)" in out and "wrote mission report" in out
    doc = __import__("json").loads((tmp_path / "mission.json").read_text())
    assert doc["title"] == "groundseg audit smoke" and doc["audit"]["ok"]
    assert (tmp_path / "mission.md").read_text().startswith("# groundseg audit smoke")
