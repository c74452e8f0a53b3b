"""The port as a package: it imports without JAX, names nothing of the JAX
package, and its launcher runs the slice end to end on the CPU when asked."""

from __future__ import annotations

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    for p in PKG.rglob("*.py")
)


def test_serving_slice_modules_are_covered():
    """The scans above reach the serving slice's modules: the SSD-scan kernel
    package, the Mamba-2 prefill/decode model, serving, the elastic host
    helpers, the auditor and both serving launchers."""
    want = {
        "repro_torch.kernels.ssd_scan.ops", "repro_torch.kernels.ssd_scan.ref",
        "repro_torch.kernels.ssd_scan.ssd_scan", "repro_torch.models.mamba2",
        "repro_torch.serving.engine", "repro_torch.serving.replica",
        "repro_torch.serving.requests", "repro_torch.serving.audit",
        "repro_torch.launch.elastic", "repro_torch.telemetry.audit",
        "repro_torch.launch.serve", "repro_torch.launch.serve_constellation",
    }
    assert want <= set(MODULES)
    assert (PKG / "csrc" / "ssd_scan.cu").is_file()


def test_dense_slice_modules_are_covered():
    """The scans above reach the dense serving slice's modules: attention
    (the model's and the kernel package) and its CUDA source."""
    want = {
        "repro_torch.models.attention", "repro_torch.models.transformer",
        "repro_torch.kernels.flash_attention.flash_attention",
        "repro_torch.kernels.flash_attention.ops", "repro_torch.kernels.flash_attention.ref",
    }
    assert want <= set(MODULES)
    assert (PKG / "csrc" / "flash_attention.cu").is_file()


def test_training_slice_modules_are_covered():
    """The scans above reach the dense training slice's modules (the step
    builders, the trainer, checkpoints, the telemetry export and report,
    the training attention's card cases) and the port names the training
    attention, its kernels and plain versions."""
    want = {
        "repro_torch.launch.steps", "repro_torch.launch.train",
        "repro_torch.checkpoint.checkpoint", "repro_torch.telemetry.export",
        "repro_torch.telemetry.report", "repro_torch.kernels.flash_attention.cases",
    }
    assert want <= set(MODULES)
    from repro_torch.kernels.flash_attention import flash_attention, ops, ref
    from repro_torch.models import attention

    for mod, names in (
        (attention, ("naive_attention", "flash_attention_train", "_flash_forward",
                     "_flash_backward")),
        (ops, ("flash_attention_bwd",)),
        (flash_attention, ("flash_attention_bwd",)),
        (ref, ("attention_bwd_ref", "attention_lse_ref")),
    ):
        assert all(callable(getattr(mod, n, None)) for n in names), mod.__name__


def test_paper_slice_modules_are_covered():
    """The scans above reach the modules that finish the paper's exchange
    layer: the simulator floor, the per-leaf compressors and the schedule
    optimizer; and the port names the two-level exchange and its oracle."""
    want = {
        "repro_torch.core.ptbfla_sim", "repro_torch.core.compress",
        "repro_torch.constellation.optimizer",
    }
    assert want <= set(MODULES)
    from repro_torch import telemetry
    from repro_torch.core import fl, fused, tdm
    from repro_torch.launch import fl_train

    for mod, names in (
        (fl, ("centralized_fla_sim", "decentralized_fla_sim", "tdm_fla_sim",
              "consensus_error", "rounds_to_consensus")),
        (tdm, ("gossip_avg_tree", "run_gossip_schedule", "neighbor_sum_int8",
               "neighbor_sum_topk", "choco_gossip_round", "hierarchical_gossip")),
        (fused, ("hierarchical_buffer_mix", "fused_hierarchical_round")),
        (telemetry, ("expected_hierarchical_collectives",)),
        (fl_train, ("build_hierarchical_fl_round",)),
    ):
        assert all(callable(getattr(mod, n, None)) for n in names), mod.__name__


def test_moe_slice_modules_are_covered():
    """The scans above reach the MoE family's module, and the port names its
    routing, dispatch, combine and drop tally."""
    assert "repro_torch.models.moe" in set(MODULES)
    from repro_torch.models import moe

    assert all(callable(getattr(moe, n, None)) for n in (
        "init_moe", "capacity", "route", "dispatch", "combine", "moe_apply", "count_drops"))


def test_imports_without_jax():
    """Every module of the port imports with ``jax`` made unimportable."""
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        f"for m in {[m.removesuffix('.__init__') for m in MODULES]!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'repro' or k.startswith('repro.') for k in sys.modules)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "ok"


_IMPORT = re.compile(r"^\s*(?:from|import)\s+(jax|jaxlib|repro)(?:[.\s]|$)", re.M)


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")))
def test_source_names_no_jax_or_reference_package(path):
    text = (ROOT / path).read_text()
    assert not _IMPORT.findall(text), f"{path} imports {_IMPORT.findall(text)}"


def test_launcher_runs_slice_on_cpu():
    """``main_tdm`` (the module's entry point) at the smoke widths: int8
    exchange, satellite 3 lost after round 0, finite decreasing loss."""
    from repro_torch.kernels.tdm_compress import tdm_compress as kern
    from repro_torch.launch import train_fl_constellation as tfc

    before = kern.launch_counts()
    res, _ = tfc.main_tdm(3, device="cpu", compression="int8", seq=16, fail_round=0)
    losses = [log.loss for log in res.logs]
    assert [log.alive for log in res.logs] == [8, 7, 7]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert kern.launch_counts() == before  # CPU tensors never reach a kernel


def test_pytree_leaf_order_matches_jax():
    """Leaf order is jax.tree.flatten's: dict keys sorted, NamedTuple fields
    in order, None empty. The fused layout depends on it."""
    import collections

    import jax

    from repro_torch.pytree import tree_flatten, tree_map, tree_unflatten

    NT = collections.namedtuple("NT", ["z", "a"])
    tree = {"b": [1, (2, None, 3)], "a": NT(z={"y": 4, "x": 5}, a=6), "c": {"q": 7}}
    leaves, td = tree_flatten(tree)
    assert leaves == jax.tree.leaves(tree)
    assert tree_unflatten(td, leaves) == tree
    assert tree_map(lambda v: v * 10, tree)["a"].z == {"y": 40, "x": 50}


def test_pytree_holds_no_reference_to_leaves():
    """Flatten/unflatten leave no reference cycle behind: a leaf is freed as
    soon as the caller drops it, without waiting for the cyclic collector
    (multi-GB parameter buffers depend on it)."""
    import gc
    import weakref

    import torch

    from repro_torch.pytree import tree_flatten, tree_map, tree_unflatten

    gc.disable()
    try:
        t = {"w": torch.zeros(4), "v": [torch.ones(2)]}
        ref = weakref.ref(t["w"])
        leaves, td = tree_flatten(t)
        tree_unflatten(td, leaves)
        tree_map(lambda x: x + 1, t)
        del t, leaves
        assert ref() is None
    finally:
        gc.enable()
