"""The port's two-level (pod x data) TDM exchange against the JAX reference.

A child process (this file run as a script, with 8 forced XLA host devices in
a 2 x 4 ``("pod", "data")`` mesh) runs ``repro.core.tdm.hierarchical_gossip``
leaf by leaf, ``repro.core.fused.fused_hierarchical_round`` (none and int8,
the plain jnp quantizer: ``quant_impl="ref"``) and each of its levels alone,
counts the compiled collective-permutes, and runs
``repro.launch.fl_train.build_hierarchical_fl_round`` for 2 rounds (one
local step each) on a 2-layer smoke mamba2. It writes everything to an
``.npz``. The port stacks the 8 nodes pod-major (row ``pod * 4 + data``),
the reference's ``P(("pod", "data"))`` order, on the relations of the
reference's worker: intra a clique of 4, inter the single edge (0, 1).

Tolerances. The port's uncompressed fused round equals its per-leaf
``hierarchical_gossip`` bit for bit (the reference's own claim). Against the
reference, each level is a Metropolis sum over M matchings that XLA fuses
into multiply-adds: a level is held to ``2 (M + 2) ulp(|x|max)`` (as in
``test_torch_exchange.py``), |x|max over the level's input. Under int8 each
level is compared from the reference's own input to that level: a
one-ulp difference in a level's input may flip an int8 code of the next
level, which is a code step, not an ulp. The whole int8 round is held to the
uncompressed round within 2% relative, as the reference's worker holds it.
The FL rounds follow ``test_torch_fl.py``: round 0's loss (before any
exchange) rtol 1e-5, round 1's rtol 1e-4, the final params an absolute 2e-4.
Under int8 the trained params enter the quantizer with last-bit differences
(the port's matmuls sum in another order), and a value on a rounding
boundary takes the neighbouring code: it then moves by one code step (its
block's absmax / 127) times the weight it is received with, at each level.
So the int8 round's params are held to 2e-4 everywhere but on at most 1e-3
of the entries, and there to 2e-4 plus one code step of the largest
magnitude at each level's weight (1/4 within a pod, 1/2 across pods).
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
N_PODS, N_DATA = 2, 4
N = N_PODS * N_DATA
SHAPES = {"w0": (3000,), "w1": (17, 33), "w2": (1025,), "w3": (5,)}
ROUNDS = 2
SEQ, ROWS = 16, 2
FL_MODES = ("none", "int8")


def _tree():
    rng = np.random.default_rng(7)
    return {k: (rng.normal(size=(N,) + s) * rng.uniform(0.5, 2.0, (N,) + (1,) * len(s)))
            .astype(np.float32) for k, s in SHAPES.items()}


def _cfgs(archs, adamw, ShapeConfig):
    cfg = archs.smoke_cfg(archs.get("mamba2-780m")).replace(
        compute_dtype="float32", n_layers=2)
    opt_cfg = adamw.OptConfig(peak_lr=5e-3, warmup_steps=2, decay_steps=100)
    return cfg, opt_cfg, ShapeConfig("fl", "train", SEQ, ROWS)


def _reference(out_path: str) -> None:
    """Child process: the reference on a 2 x 4 mesh of forced host devices."""
    import jax
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    from repro.configs import archs
    from repro.core import fused, tdm
    from repro.core.relation import Relation
    from repro.launch import fl_train
    from repro.launch.hlo_stats import collective_stats
    from repro.models.config import ShapeConfig
    from repro.optim import adamw
    from repro_torch.launch.train_fl_constellation import make_batch_fn

    mesh = Mesh(np.array(jax.devices()[:N]).reshape(N_PODS, N_DATA), ("pod", "data"))
    intra = Relation.clique(list(range(N_DATA)))
    inter = Relation.from_edges([(0, 1)], nodes=range(N_PODS))
    empty_intra = Relation.from_edges([], nodes=range(N_DATA))
    empty_inter = Relation.from_edges([], nodes=range(N_PODS))

    def jitted(f):
        def body(t):
            out = f(jax.tree.map(lambda x: x[0], t))
            return jax.tree.map(lambda x: x[None], out)

        return jax.jit(shard_map(body, mesh=mesh, in_specs=(P(("pod", "data")),),
                                 out_specs=P(("pod", "data")), check_rep=False))

    def fused_fn(comp, a=intra, b=inter):
        return jitted(lambda t: fused.fused_hierarchical_round(
            t, a, b, "data", "pod", N_DATA, N_PODS, compression=comp, quant_impl="ref"))

    tree = _tree()
    out = {}
    leaf = jitted(lambda t: jax.tree.map(lambda x: tdm.hierarchical_gossip(
        x, intra, inter, "data", "pod", N_DATA, N_PODS), t))(tree)
    for k, v in leaf.items():
        out[f"leaf/{k}"] = np.asarray(v)
    for comp in ("none", "int8"):
        f = fused_fn(comp)
        for k, v in f(tree).items():
            out[f"fused_{comp}/{k}"] = np.asarray(v)
        hlo = f.lower(tree).compile().as_text()
        out[f"permutes_{comp}"] = np.array(
            collective_stats(hlo).count_by_kind.get("collective-permute", 0.0))
        level1 = fused_fn(comp, b=empty_inter)(tree)
        for k, v in level1.items():
            out[f"{comp}_intra/{k}"] = np.asarray(v)
        for k, v in fused_fn(comp, a=empty_intra)(level1).items():
            out[f"{comp}_inter/{k}"] = np.asarray(v)

    cfg, opt_cfg, shape = _cfgs(archs, adamw, ShapeConfig)
    start = jax.tree.map(np.asarray, fl_train._stack_init(jax.random.PRNGKey(0), cfg, opt_cfg, N))
    flat, _ = jax.tree_util.tree_flatten_with_path(start)
    for path, leaf_ in flat:
        out["start/" + jax.tree_util.keystr(path)] = leaf_
    batch_fn = make_batch_fn(cfg, shape, N, 1)
    for comp in FL_MODES:
        fn = fl_train.build_hierarchical_fl_round(
            cfg, opt_cfg, mesh, N_PODS, N_DATA,
            fl_train.FLConfig(mode="tdm", local_steps=1, compression=comp), intra, inter)
        state = jax.tree.map(jax.numpy.array, start)   # donated
        losses = []
        for rnd in range(ROUNDS):
            state, loss = fn(state, jax.tree.map(jax.numpy.asarray, batch_fn(rnd)))
            losses.append(np.asarray(loss))
        out[f"fl_{comp}/loss"] = np.stack(losses)
        flat, _ = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, state["params"]))
        for path, leaf_ in flat:
            out[f"fl_{comp}/params/" + jax.tree_util.keystr(path)] = leaf_
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_hier") / "ref.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8 " + env.get("XLA_FLAGS", "")
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = f"{ROOT / 'src'}:{ROOT / 'tests'}:" + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, __file__, str(out)], capture_output=True, text=True,
        env=env, timeout=900, cwd=ROOT,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(out))


def _rels(empty=None):
    from repro_torch.core.relation import Relation

    intra = Relation.clique(list(range(N_DATA)))
    inter = Relation.from_edges([(0, 1)], nodes=range(N_PODS))
    if empty == "intra":
        intra = Relation.from_edges([], nodes=range(N_DATA))
    if empty == "inter":
        inter = Relation.from_edges([], nodes=range(N_PODS))
    return intra, inter


def _torch(tree):
    import torch

    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _prefixed(ref, prefix):
    return {k[len(prefix):]: v for k, v in ref.items() if k.startswith(prefix)}


def assert_level_close(got, want, x, n_matchings: int) -> None:
    """|got - want| <= 2 (M + 2) ulp(|x|max), |x|max over the level's input."""
    xmax = max(float(np.abs(v).max()) for v in x.values())
    bound = 2 * (n_matchings + 2) * float(np.spacing(np.float32(xmax)))
    for k in want:
        gap = float(np.abs(np.asarray(got[k], np.float64) - want[k]).max())
        assert gap <= bound, (k, gap, bound)


def _m(rel) -> int:
    from repro_torch.core.schedule import edge_coloring

    return len(edge_coloring(rel))


def test_level_lift_matches_level_colouring():
    """Each lifted matching is the level's matching in every pod (data) or
    at every data index (pod), in the level's colouring order, with the
    level's weights tiled or repeated."""
    from repro_torch.core import tdm

    intra, inter = _rels()
    diag, ms, ws = tdm.level_weight_vectors(intra, "data", N_DATA, N_PODS)
    d0, w0 = tdm.matching_weight_vectors(intra, N_DATA)
    assert len(ms) == len(tdm.edge_coloring(intra)) == 3
    np.testing.assert_array_equal(diag, np.tile(d0, N_PODS))
    for m, lm, w, lw in zip(tdm.edge_coloring(intra), ms, w0, ws):
        assert lm.pairs == {(p * N_DATA + i, p * N_DATA + j)
                            for p in range(N_PODS) for i, j in m.pairs}
        np.testing.assert_array_equal(lw, np.tile(w, N_PODS))
    diag, ms, ws = tdm.level_weight_vectors(inter, "pod", N_DATA, N_PODS)
    assert [m.pairs for m in ms] == [{(d, N_DATA + d) for d in range(N_DATA)}
                                     | {(N_DATA + d, d) for d in range(N_DATA)}]
    np.testing.assert_array_equal(ws[0], np.repeat([0.5, 0.5], N_DATA))
    with pytest.raises(ValueError, match="level"):
        tdm.level_weight_vectors(inter, "rack", N_DATA, N_PODS)


def test_fused_none_equals_per_leaf_bitwise():
    from repro_torch.core import fused, tdm

    tree = _torch(_tree())
    intra, inter = _rels()
    got = fused.fused_hierarchical_round(tree, intra, inter, N_DATA, N_PODS)
    for k, x in tree.items():
        assert np.array_equal(got[k].numpy(),
                              tdm.hierarchical_gossip(x, intra, inter, N_DATA, N_PODS).numpy())
        # clique intra + the one inter edge: every node holds the global mean
        np.testing.assert_allclose(got[k].numpy(), np.broadcast_to(
            x.numpy().mean(0, keepdims=True), x.shape), rtol=0, atol=1e-5 * float(x.abs().max()))


@pytest.mark.slow
def test_per_leaf_hierarchical_gossip_matches_reference(ref):
    from repro_torch.core import tdm

    tree = _tree()
    intra, inter = _rels()
    got = {k: tdm.hierarchical_gossip(v, intra, inter, N_DATA, N_PODS).numpy()
           for k, v in _torch(tree).items()}
    # the inter level starts from the intra level's output (the pod means)
    assert_level_close(got, _prefixed(ref, "leaf/"), tree, _m(intra) + _m(inter))


@pytest.mark.slow
@pytest.mark.parametrize("comp", ["none", "int8"])
def test_fused_levels_match_reference(ref, comp):
    """Each level from the reference's own input to it, impl="ref" on both
    sides."""
    from repro_torch.core import fused

    tree = _tree()
    intra, inter = _rels()
    e_intra, _ = _rels("intra")
    _, e_inter = _rels("inter")
    level1 = fused.fused_hierarchical_round(
        _torch(tree), intra, e_inter, N_DATA, N_PODS, compression=comp, quant_impl="ref")
    want1 = _prefixed(ref, f"{comp}_intra/")
    assert_level_close({k: v.numpy() for k, v in level1.items()}, want1, tree, _m(intra))
    level2 = fused.fused_hierarchical_round(
        _torch(want1), e_intra, inter, N_DATA, N_PODS, compression=comp, quant_impl="ref")
    assert_level_close({k: v.numpy() for k, v in level2.items()},
                       _prefixed(ref, f"{comp}_inter/"), want1, _m(inter))


@pytest.mark.slow
def test_fused_rounds_match_reference(ref):
    """The whole rounds: none within the two levels' bound of the
    reference's (which its worker holds to its per-leaf path bit for bit);
    int8 within 2% relative of none, as the reference's worker holds it."""
    from repro_torch.core import fused

    tree = _tree()
    intra, inter = _rels()
    none = fused.fused_hierarchical_round(_torch(tree), intra, inter, N_DATA, N_PODS)
    assert_level_close({k: v.numpy() for k, v in none.items()},
                       _prefixed(ref, "fused_none/"), tree, _m(intra) + _m(inter))
    int8 = fused.fused_hierarchical_round(_torch(tree), intra, inter, N_DATA, N_PODS,
                                          compression="int8", quant_impl="ref")
    for k in tree:
        rel_err = float((int8[k] - none[k]).norm() / none[k].norm())
        assert rel_err < 0.02, (k, rel_err)


@pytest.mark.slow
@pytest.mark.parametrize("comp", ["none", "int8"])
def test_gathers_match_oracle_and_reference_hlo(ref, comp):
    """Gathers of one fused round == the port's oracle == the reference's
    oracle == the reference's compiled collective-permutes:
    (M_intra + M_inter) x per x n_buckets, per 2 for int8."""
    import torch

    from repro.core.relation import Relation as JRel
    from repro.telemetry import expected_hierarchical_collectives as j_expected
    from repro_torch.core import fused, tdm
    from repro_torch.telemetry import expected_hierarchical_collectives

    intra, inter = _rels()
    tree = _torch(_tree())
    want = expected_hierarchical_collectives(intra, inter, 1, compression=comp)
    j_want = j_expected(JRel.clique(list(range(N_DATA))),
                        JRel.from_edges([(0, 1)], nodes=range(N_PODS)), 1, compression=comp)
    before = tdm.gather_count()
    fused.fused_hierarchical_round(tree, intra, inter, N_DATA, N_PODS, compression=comp)
    issued = tdm.gather_count() - before
    per = 2 if comp == "int8" else 1
    assert issued == want["collective-permute"] == j_want["collective-permute"] \
        == ref[f"permutes_{comp}"] == (3 + 1) * per
    # two dtype buckets: twice the gathers
    tree["w3"] = tree["w3"].to(torch.bfloat16)
    before = tdm.gather_count()
    fused.fused_hierarchical_round(tree, intra, inter, N_DATA, N_PODS, compression=comp)
    assert tdm.gather_count() - before == expected_hierarchical_collectives(
        intra, inter, 2, compression=comp)["collective-permute"] == 2 * issued


def test_topk_is_refused():
    from repro_torch.core import fused
    from repro_torch.telemetry import expected_hierarchical_collectives

    intra, inter = _rels()
    with pytest.raises(ValueError, match="compression"):
        fused.fused_hierarchical_round(_torch(_tree()), intra, inter, N_DATA, N_PODS,
                                       compression="topk")
    with pytest.raises(ValueError, match="oracle"):
        expected_hierarchical_collectives(intra, inter, 1, compression="topk")


def _unkeystr(d: dict, prefix: str) -> dict:
    """{prefix + "['a']['b']": leaf} -> nested dict."""
    tree: dict = {}
    for key, leaf in d.items():
        if not key.startswith(prefix):
            continue
        parts = [p.strip("'") for p in key[len(prefix):].strip("[]").split("][")]
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return tree


@pytest.mark.slow
@pytest.mark.parametrize("comp", FL_MODES)
def test_hierarchical_fl_round_matches_reference(ref, comp):
    from repro_torch.configs import archs
    from repro_torch.launch import fl_train
    from repro_torch.launch.train_fl_constellation import make_batch_fn
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import adamw
    from repro_torch.weights import state_from_jax, to_numpy

    cfg, opt_cfg, shape = _cfgs(archs, adamw, ShapeConfig)
    intra, inter = _rels()
    state = state_from_jax(_unkeystr(ref, "start/"), device="cpu")
    fn = fl_train.build_hierarchical_fl_round(
        cfg, opt_cfg, N_PODS, N_DATA,
        fl_train.FLConfig(mode="tdm", local_steps=1, compression=comp), intra, inter)
    batch_fn = make_batch_fn(cfg, shape, N, 1)
    losses = []
    for rnd in range(ROUNDS):
        state, loss = fn(state, fl_train.batch_to_device(batch_fn(rnd), "cpu"))
        losses.append(loss.numpy())
    losses = np.stack(losses)
    want = ref[f"fl_{comp}/loss"]
    assert np.isfinite(losses).all()
    np.testing.assert_allclose(losses[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(losses[1:], want[1:], rtol=1e-4)
    got = to_numpy(state["params"])
    want = _unkeystr(ref, f"fl_{comp}/params/")
    pairs = []

    def collect(g, w):
        if isinstance(w, dict):
            for k in w:
                collect(g[k], w[k])
        else:
            pairs.append((np.asarray(g, np.float64).ravel(), np.asarray(w, np.float64).ravel()))

    collect(got, want)
    gap = np.concatenate([np.abs(g - w) for g, w in pairs])
    if comp == "none":
        assert gap.max() <= 2e-4, gap.max()
        return
    step = max(float(np.abs(w).max()) for _, w in pairs) / 127
    assert gap.max() <= 2e-4 + step * (1 / 4 + 1 / 2), (gap.max(), step)
    assert (gap > 2e-4).mean() <= 1e-3, (gap > 2e-4).sum()


def test_hierarchical_fl_round_refuses_topk():
    from repro_torch.configs import archs
    from repro_torch.launch import fl_train
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import adamw

    cfg, opt_cfg, _ = _cfgs(archs, adamw, ShapeConfig)
    intra, inter = _rels()
    with pytest.raises(ValueError, match="compression"):
        fl_train.build_hierarchical_fl_round(
            cfg, opt_cfg, N_PODS, N_DATA, fl_train.FLConfig(compression="topk"), intra, inter)


if __name__ == "__main__":
    _reference(sys.argv[1])
