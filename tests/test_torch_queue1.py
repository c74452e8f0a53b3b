"""The port's last helpers against the JAX reference, on the CPU.

- ``kernels.tdm_compress.ops.quantize_payload`` against the reference's
  (Pallas in interpret mode) bit for bit on shapes (7,), (3, 1000) and
  (2, 3, 513) at blocks 1024 and 256: the int8 codes (exactly ``x.size``
  of them), the blockwise scales, the shape, and the round trip through
  ``dequantize_payload`` in both packages.
- ``core.fused.spec_cache_stats`` / ``clear_spec_cache``: the same sequence
  of ``cached_spec`` calls on equal trees (the port's stacked on a node
  axis) gives the same hits, misses and sizes in both packages, before and
  after a clear.
- ``launch.elastic.restore_for_mesh`` on a checkpoint the port's trainer
  wrote: the restored state equals the one the trainer saved, bit for bit,
  and the reference's ``restore_for_mesh`` on a one-device mesh reads the
  same values.
- ``launch.quickstart``: parts 1-2 print the values the reference's
  relation, schedule and simulator functions give, and part 3's loss falls
  (part 3 shortened to 6 steps).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import archs as j_archs
from repro.core import fused as j_fused
from repro.core import ptbfla_sim as j_sim
from repro.core import schedule as j_schedule
from repro.core.relation import Relation as JRelation
from repro.kernels.tdm_compress import ops as j_ops
from repro.launch import elastic as j_elastic
from repro.launch.mesh import make_mesh
from repro.optim import adamw as j_adamw
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import archs
from repro_torch.core import fused
from repro_torch.kernels.tdm_compress import ops
from repro_torch.launch import elastic, quickstart, train
from repro_torch.optim import adamw
from repro_torch.pytree import tree_leaves, tree_map


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().contiguous().reshape(-1).view(torch.uint8).numpy().copy()
    return np.frombuffer(np.ascontiguousarray(np.asarray(x)).tobytes(), np.uint8)


# ---------------------------------------------------------------------------
# quantize_payload
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block", [1024, 256])
@pytest.mark.parametrize("shape", [(7,), (3, 1000), (2, 3, 513)])
def test_quantize_payload_matches_reference_bitwise(shape, block):
    rng = np.random.default_rng(sum(shape) + block)
    x = (rng.standard_normal(shape) * 10.0 ** rng.uniform(-3, 2, shape)).astype(np.float32)
    jq, js, jshape = j_ops.quantize_payload(jnp.asarray(x), block=block, interpret=True)
    jshape = tuple(int(d) for d in jshape)      # the jitted reference returns arrays
    tq, ts, tshape = ops.quantize_payload(torch.from_numpy(x), block=block)
    assert tshape == jshape == shape
    assert tq.dtype == torch.int8 and tq.numel() == x.size == jq.size
    assert ts.dtype == torch.float32 and ts.numel() == -(-x.size // block)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(ts), _bits(js))
    back = ops.dequantize_payload(tq, ts, tshape, block=block)
    jback = j_ops.dequantize_payload(jq, js, jshape, block=block, interpret=True)
    assert tuple(back.shape) == shape
    np.testing.assert_array_equal(_bits(back), _bits(jback))
    assert float(np.abs(back.numpy() - x).max()) <= float(ts.max()) / 2 * (1 + 1e-6)


# ---------------------------------------------------------------------------
# the layout cache's accessors
# ---------------------------------------------------------------------------

def test_spec_cache_stats_match_reference():
    """``cached_spec`` calls on equal layouts (the reference's trees, the
    port's stacked on a node axis of 2) give the same stats in both
    packages; a different shape or block is a miss; a clear empties the
    cache and its counters."""
    def trees(rows):
        j = {"a": jnp.zeros((rows, 5)), "b": jnp.ones((7,), jnp.float16)}
        t = {"a": torch.zeros((2, rows, 5)), "b": torch.ones((2, 7), dtype=torch.float16)}
        return j, t

    calls = [(3, 64), (3, 64), (4, 64), (3, 128), (3, 64)]
    for mod in (j_fused, fused):
        mod.clear_spec_cache()
        assert mod.spec_cache_stats() == {"hits": 0, "misses": 0, "size": 0}
    for rows, block in calls:
        j, t = trees(rows)
        j_fused.cached_spec(j, block=block)
        fused.cached_spec(t, block=block)
        assert fused.spec_cache_stats() == j_fused.spec_cache_stats()
    assert fused.spec_cache_stats() == {"hits": 2, "misses": 3, "size": 3}
    for mod in (j_fused, fused):
        mod.clear_spec_cache()
    assert fused.spec_cache_stats() == j_fused.spec_cache_stats() == \
        {"hits": 0, "misses": 0, "size": 0}
    j, t = trees(3)
    assert fused.cached_spec(t, block=64) is fused.cached_spec(t, block=64)
    j_fused.cached_spec(j, block=64)
    j_fused.cached_spec(j, block=64)
    assert fused.spec_cache_stats() == j_fused.spec_cache_stats() == \
        {"hits": 1, "misses": 1, "size": 1}


# ---------------------------------------------------------------------------
# restore_for_mesh
# ---------------------------------------------------------------------------

def test_restore_for_mesh_reads_the_trainers_checkpoint(tmp_path, monkeypatch):
    """The port's trainer saves at step 2 (its state captured as it saves);
    ``restore_for_mesh`` rebuilds that state bit for bit on the CPU, and the
    reference's ``restore_for_mesh`` on a one-device mesh reads the same
    values under the same paths."""
    saved = {}
    real_save = ckpt.save

    def save(ckpt_dir, step, state, **kw):
        saved[step] = tree_map(lambda t: t.detach().clone(), state)
        return real_save(ckpt_dir, step, state, **kw)

    monkeypatch.setattr(train.ckpt_lib, "save", save)
    train.main(["--arch", "mamba2-780m", "--smoke", "--steps", "2", "--seq", "16",
                "--batch", "2", "--ckpt", str(tmp_path), "--ckpt-every", "2",
                "--device", "cpu"])
    assert list(saved) == [2]
    cfg = archs.smoke_cfg(archs.get("mamba2-780m"))
    # the trainer's OptConfig for --steps 2
    opt = adamw.OptConfig(peak_lr=3e-3, warmup_steps=5, decay_steps=10)
    step, got = elastic.restore_for_mesh(str(tmp_path), cfg, opt, device="cpu")
    assert step == 2
    want_flat = ckpt._flatten_with_paths(saved[2])
    got_flat = ckpt._flatten_with_paths(got)
    assert [k for k, _ in got_flat] == [k for k, _ in want_flat]
    for (k, g), (_, w) in zip(got_flat, want_flat):
        assert g.device.type == "cpu" and g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=k)
    assert int(got["step"]) == 2

    jcfg = j_archs.smoke_cfg(j_archs.get("mamba2-780m"))
    jopt = j_adamw.OptConfig(peak_lr=3e-3, warmup_steps=5, decay_steps=10)
    jstep, jgot = j_elastic.restore_for_mesh(str(tmp_path), jcfg, jopt,
                                             make_mesh((1, 1), ("data", "model")))
    assert jstep == 2
    jflat = jax.tree_util.tree_flatten_with_path(jgot)[0]
    assert len(jflat) == len(got_flat)
    for (path, w), (k, g) in zip(jflat, got_flat):
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=f"{k} {path}")


def test_restore_for_mesh_target_takes_no_memory():
    """The target of a restore is the trainer's state as meta tensors, at
    any size: jamba-1.5-large-398b's 398 B params, nothing allocated."""
    from repro_torch.launch import steps

    cfg = archs.get("jamba-1.5-large-398b")
    target = steps.state_target(cfg, adamw.OptConfig())
    leaves = tree_leaves(target)
    assert {t.device.type for t in leaves} == {"meta"}
    n = sum(t.numel() for t in tree_leaves(target["params"]))
    assert n == cfg.param_count() and 398e9 < n < 399e9


# ---------------------------------------------------------------------------
# the quickstart
# ---------------------------------------------------------------------------

def test_quickstart_prints_the_reference_values(capsys, monkeypatch):
    """Parts 1-2 as the quickstart runs them; part 3 shortened to 6 steps of
    batch 4 x 32 tokens (the example's 15 of 8 x 64 take minutes on a CPU
    shared by test workers)."""
    argv = list(quickstart.TRAIN_ARGV)
    for flag, value in (("--steps", "6"), ("--batch", "4"), ("--seq", "32")):
        argv[argv.index(flag) + 1] = value
    monkeypatch.setattr(quickstart, "TRAIN_ARGV", argv)
    losses = quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    a, b, c = 0, 1, 2
    r2 = JRelation.from_pairs([(a, b), (b, a), (b, c), (c, b)])
    prop = JRelation.from_pairs([(a, b), (b, a)]).propagation(
        JRelation.from_pairs([(b, c), (c, b)]))
    n = 6
    data = {i: f"odata-{i}" for i in range(n)}
    _, sim_m = j_sim.run_schedule_getmeas(j_schedule.clique_multilink(n), data, n)
    _, sim_p = j_sim.run_schedule_get1meas(j_schedule.round_robin_tournament(n), data, n)
    for line in (f"R2 valid exchange: {r2.is_valid_exchange()}",
                 f"R2 == its inverse (P1): {r2.inverse().pairs == r2.pairs}",
                 f"b's peers (needs 2 antennas): {r2.peers_of(b)}",
                 f"R21∘R22 ∪ R22∘R21 = {sorted(prop.pairs)}",
                 f"getMeas  : 1 slot,  {sim_m.total_messages} messages",
                 f"get1meas : {n - 1} slots, {sim_p.total_messages} messages",
                 "same exchanged data either way (semantic equivalence)"):
        assert line in out.splitlines(), line
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert losses[-1] < 0.9 * losses[0]
    assert f"loss: {losses[0]:.3f} -> {losses[-1]:.3f}" in out
