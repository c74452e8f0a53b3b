"""The port's per-leaf compressed exchange against the JAX reference.

A child process (this file run as a script, with 8 forced XLA host devices)
runs ``repro.core.compress``, the compressed exchanges of ``repro.core.tdm``
and the per-leaf ``repro.core.fl.tdm_mix`` / ``tdm_fla_round(fused=False)``
under ``shard_map`` on fixed numpy inputs, counts the collective-permutes in
the compiled per-leaf rounds, and writes everything to an ``.npz``. The port
runs the same inputs stacked on the node axis.

Tolerances. int8 codes and scales, top-k values and indices (rows with ties
planted at the k-th boundary, +-T and NaN included) and the CHOCO public copy
x_hat (pure selection) are compared bit for bit. Every mix is a sum of
weighted terms that XLA fuses into multiply-adds (one rounding each) where
the port rounds product and sum apart; each of the M matchings'
accumulations and the two final steps add at most 1.5 ulp of the largest
magnitude a row's sums hold. That magnitude is bounded by
``(1 + deg_i) |x|max`` over the row and its peers, so mixes and the CHOCO
sums are held to ``2 (M + 2) ulp((1 + deg_i) |x|max)`` per row, float32.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
N = 8
L = 2048
K = 16                  # per-leaf top-k budget (fits the smallest leaf, 33)
EDGES = {
    # max degree 3 (several matchings), node 7 isolated
    "mesh": [(0, 1), (1, 2), (2, 3), (3, 0), (0, 2), (4, 5), (5, 6), (4, 6)],
    # a ring through the seven live nodes (satellite 3's links dropped)
    "ring": [(0, 1), (1, 2), (2, 4), (4, 5), (5, 6), (6, 7), (7, 0)],
}


def _inputs():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((N, L)) * rng.uniform(0.1, 3.0, (N, 1))).astype(np.float32)
    res = (rng.standard_normal((N, L)) * 0.05).astype(np.float32)
    tree = {
        "b": rng.standard_normal((N, 5, 7)).astype(np.float32),
        "a": rng.standard_normal((N, 300)).astype(np.float32),
        "c": {"z": rng.standard_normal((N, 2000)).astype(np.float32),
              "y": rng.standard_normal((N, 33)).astype(np.float32)},
    }
    return x, res, tree


def _tied():
    """Rows with ties planted at the k-th boundary: the k-th largest |x| of
    each row is copied, with both signs, to positions before and after it,
    so the last places of the top-k go to the lower indices. Row 5 also
    holds NaNs (above every number in the reference's order), row 6 is all
    equal."""
    x, _, _ = _inputs()
    t = x.copy()
    rng = np.random.default_rng(4)
    for r in range(N):
        order = np.argsort(-np.abs(t[r]), kind="stable")
        kth = np.abs(t[r, order[K - 1]])
        spots = rng.choice(np.setdiff1d(np.arange(L), order[:K - 1]), 6, replace=False)
        t[r, spots] = kth * np.array([1, -1, 1, -1, 1, -1], np.float32)
    t[5, [7, 900, 1500]] = np.nan
    t[6] = np.float32(0.75)
    return t


def _tree_keys(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _tree_keys(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def _reference(out_path: str) -> None:
    """Child process: the reference on 8 forced host devices."""
    import jax
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    from repro.core import compress, fl, tdm
    from repro.core.relation import Relation
    from repro.launch.hlo_stats import collective_stats

    mesh = Mesh(np.array(jax.devices()[:N]), ("node",))

    def jitted(f):
        def body(*a):
            out = f(*jax.tree.map(lambda t: t[0], a))
            return jax.tree.map(lambda t: t[None], out)

        return jax.jit(shard_map(
            body, mesh=mesh, in_specs=P("node"), out_specs=P("node"), check_rep=False,
        ))

    def spmd(f, *args):
        return jax.tree.map(np.asarray, jitted(f)(*args))

    def permutes(f, *args):
        hlo = jitted(f).lower(*args).compile().as_text()
        return collective_stats(hlo).count_by_kind.get("collective-permute", 0.0)

    x, res, tree = _inputs()
    tied = _tied()
    out = {}
    out["int8/q"], out["int8/s"] = spmd(lambda v: tuple(compress.int8_compress(v)), x)
    out["int8/deq"] = spmd(lambda v: compress.int8_decompress(compress.int8_compress(v)), x)
    out["topk/vals"], out["topk/idxs"] = spmd(lambda v: tuple(compress.topk_compress(v, K)), tied)
    p, r = spmd(lambda v, e: compress.topk_with_error_feedback(v, e, K), x, res)
    out["ef/vals"], out["ef/idxs"], out["ef/res"] = p[0], p[1], r
    for name, edges in EDGES.items():
        rel = Relation.from_edges(edges, nodes=range(N))
        out[f"{name}/nsum_int8"] = spmd(lambda v: tdm.neighbor_sum_int8(v, rel, "node"), x)
        s, r = spmd(lambda v, e: tdm.neighbor_sum_topk(v, e, rel, "node", K), x, res)
        out[f"{name}/nsum_topk"], out[f"{name}/nsum_topk_res"] = s, r
        nx1, st1 = spmd(lambda v: tdm.choco_gossip_round(
            v, tdm.choco_init(v), rel, "node", N, K), x)
        nx2, st2 = spmd(lambda v, a, b: tdm.choco_gossip_round(
            v, tdm.ChocoState(a, b), rel, "node", N, K), nx1, st1.x_hat, st1.s)
        for tag, (nx, st) in (("1", (nx1, st1)), ("2", (nx2, st2))):
            out[f"{name}/choco{tag}"] = nx
            out[f"{name}/choco{tag}_xhat"] = st.x_hat
            out[f"{name}/choco{tag}_s"] = st.s
        cfg8 = fl.TDMFLAConfig(compression="int8", fused=False)
        out[f"{name}/mix_int8"] = spmd(lambda v: fl.tdm_mix(v, rel, "node", N, cfg8)[0], x)
        for comp in ("int8", "topk"):
            cfg = fl.TDMFLAConfig(compression=comp, topk_k=K, fused=False)

            def round_fn(t, cfg=cfg):
                mixed, resid = fl.tdm_fla_round(t, rel, "node", N, cfg)
                return mixed if comp == "int8" else (mixed, resid)

            got = spmd(round_fn, tree)
            mixed = got if comp == "int8" else got[0]
            for key, leaf in _tree_keys(mixed):
                out[f"{name}/leaf_{comp}/{key}"] = leaf
            if comp == "topk":
                for key, st in _tree_keys(got[1]):
                    out[f"{name}/leaf_topk_xhat/{key}"] = st.x_hat
                    out[f"{name}/leaf_topk_s/{key}"] = st.s
            out[f"{name}/permutes_{comp}"] = np.array(permutes(round_fn, tree))
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_compress") / "ref.npz"
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


def _rel(name):
    from repro_torch.core.relation import Relation

    return Relation.from_edges(EDGES[name], nodes=range(N))


def _t(a):
    import torch

    return torch.from_numpy(np.array(a))


def _torch_tree(tree):
    return {k: (_t(v) if not isinstance(v, dict) else _torch_tree(v)) for k, v in tree.items()}


def _numpy_tree(tree):
    return {k: (v.numpy() if not isinstance(v, dict) else _numpy_tree(v))
            for k, v in tree.items()}


def _matchings(rel) -> int:
    from repro_torch.core.schedule import edge_coloring

    return len(edge_coloring(rel))


def assert_mix_close(got, want, x, rel) -> None:
    """|got - want| <= 2 (M + 2) ulp((1 + deg_i) |x|max over row i and its
    peers), per row (module docstring)."""
    got, want, x = (np.asarray(a, dtype=np.float64) for a in (got, want, x))
    rowmax = np.abs(x).reshape(x.shape[0], -1).max(axis=1)
    mag = np.array([(1 + rel.degree(i)) * max([rowmax[i]] + [rowmax[j] for j in rel.peers_of(i)])
                    for i in range(x.shape[0])])
    bound = 2 * (_matchings(rel) + 2) * np.spacing(mag.astype(np.float32)).astype(np.float64)
    gap = np.abs(got - want).reshape(got.shape[0], -1).max(axis=1)
    assert (gap <= bound).all(), (gap, bound)


@pytest.mark.slow
def test_int8_codes_and_scales_bitwise(ref):
    from repro_torch.core import compress

    x, _, _ = _inputs()
    p = compress.int8_compress(_t(x))
    assert p.q.dtype.is_floating_point is False and tuple(p.scale.shape) == (N,)
    np.testing.assert_array_equal(p.q.numpy(), ref["int8/q"])
    np.testing.assert_array_equal(p.scale.numpy(), ref["int8/s"])
    np.testing.assert_array_equal(compress.int8_decompress(p).numpy(), ref["int8/deq"])


@pytest.mark.slow
def test_topk_selection_with_planted_ties_bitwise(ref):
    """Indices and values equal the reference's on rows whose k-th place is
    tied (and on a NaN row and an all-equal row): ties go to the lower index
    as ``jax.lax.top_k``'s do."""
    from repro_torch.core import compress

    p = compress.topk_compress(_t(_tied()), K)
    np.testing.assert_array_equal(p.indices.numpy(), ref["topk/idxs"])
    np.testing.assert_array_equal(p.values.numpy(), ref["topk/vals"])
    np.testing.assert_array_equal(p.indices[6].numpy(), np.arange(K))


@pytest.mark.slow
def test_topk_error_feedback_bitwise(ref):
    from repro_torch.core import compress

    x, res, _ = _inputs()
    p, r = compress.topk_with_error_feedback(_t(x), _t(res), K)
    np.testing.assert_array_equal(p.values.numpy(), ref["ef/vals"])
    np.testing.assert_array_equal(p.indices.numpy(), ref["ef/idxs"])
    np.testing.assert_array_equal(r.numpy(), ref["ef/res"])


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(EDGES))
def test_neighbor_sums_within_bound(ref, name):
    from repro_torch.core import tdm

    x, res, _ = _inputs()
    rel = _rel(name)
    assert_mix_close(tdm.neighbor_sum_int8(_t(x), rel).numpy(), ref[f"{name}/nsum_int8"], x, rel)
    s, r = tdm.neighbor_sum_topk(_t(x), _t(res), rel, K)
    # the residual is pure selection and one subtraction: bit for bit
    np.testing.assert_array_equal(r.numpy(), ref[f"{name}/nsum_topk_res"])
    assert_mix_close(s.numpy(), ref[f"{name}/nsum_topk"], x, rel)


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(EDGES))
def test_choco_round_within_bound(ref, name):
    """Two CHOCO rounds, the second from the reference's own first-round
    state: x_hat bit for bit, s and x within the bound."""
    from repro_torch.core import tdm

    x, _, _ = _inputs()
    rel = _rel(name)
    nx1, st1 = tdm.choco_gossip_round(_t(x), tdm.choco_init(_t(x)), rel, N, K)
    nx2, st2 = tdm.choco_gossip_round(
        _t(ref[f"{name}/choco1"]),
        tdm.ChocoState(_t(ref[f"{name}/choco1_xhat"]), _t(ref[f"{name}/choco1_s"])),
        rel, N, K)
    for tag, (nx, st) in (("1", (nx1, st1)), ("2", (nx2, st2))):
        np.testing.assert_array_equal(st.x_hat.numpy(), ref[f"{name}/choco{tag}_xhat"])
        assert_mix_close(st.s.numpy(), ref[f"{name}/choco{tag}_s"], x, rel)
        assert_mix_close(nx.numpy(), ref[f"{name}/choco{tag}"], x, rel)


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(EDGES))
def test_tdm_mix_int8_within_bound(ref, name):
    from repro_torch.core import fl

    x, _, _ = _inputs()
    rel = _rel(name)
    mixed, resid = fl.tdm_mix(_t(x), rel, N, fl.TDMFLAConfig(compression="int8", fused=False))
    assert resid is None
    assert_mix_close(mixed.numpy(), ref[f"{name}/mix_int8"], x, rel)


@pytest.mark.slow
@pytest.mark.parametrize("comp", ["int8", "topk"])
@pytest.mark.parametrize("name", sorted(EDGES))
def test_per_leaf_round_matches_reference(ref, name, comp):
    """``tdm_fla_round(fused=False)`` leaf by leaf: mixes (and the CHOCO
    state per leaf) within the bound, x_hat bit for bit, and the gathers
    equal the reference's compiled collective-permutes: 2 per matching per
    leaf under both compressions (int8: codes and scale; CHOCO: values and
    indices)."""
    from repro_torch.core import fl, tdm

    _, _, tree = _inputs()
    rel = _rel(name)
    before = tdm.gather_count()
    mixed, resid = fl.tdm_fla_round(
        _torch_tree(tree), rel, N, fl.TDMFLAConfig(compression=comp, topk_k=K, fused=False))
    issued = tdm.gather_count() - before
    n_leaves = len(list(_tree_keys(tree)))
    assert issued == 2 * _matchings(rel) * n_leaves == ref[f"{name}/permutes_{comp}"]
    x = dict(_tree_keys(tree))
    for key, got in _tree_keys(_numpy_tree(mixed)):
        assert_mix_close(got, ref[f"{name}/leaf_{comp}/{key}"], x[key], rel)
    if comp == "topk":
        for key, st in _tree_keys(resid):
            np.testing.assert_array_equal(st.x_hat.numpy(), ref[f"{name}/leaf_topk_xhat/{key}"])
            assert_mix_close(st.s.numpy(), ref[f"{name}/leaf_topk_s/{key}"], x[key], rel)


def test_per_leaf_choco_state_round_trips():
    """The CHOCO states a per-leaf round returns, passed back, reach each
    leaf's next round as its own state (a NamedTuple per leaf is one
    residual, not two leaves)."""
    import torch

    from repro_torch.core import fl, tdm

    _, _, tree = _inputs()
    rel = _rel("mesh")
    cfg = fl.TDMFLAConfig(compression="topk", topk_k=K, fused=False)
    mixed, res = fl.tdm_fla_round(_torch_tree(tree), rel, N, cfg)
    again, res2 = fl.tdm_fla_round(mixed, rel, N, cfg, residuals=res)
    for (key, x), (_, st), (_, got), (_, st2) in zip(
            _tree_keys(mixed), _tree_keys(res), _tree_keys(again), _tree_keys(res2)):
        want, want_st = tdm.choco_gossip_round(x, st, rel, N, K)
        assert torch.equal(got, want) and torch.equal(st2.x_hat, want_st.x_hat), key
        assert torch.equal(st2.s, want_st.s), key


def test_compression_ratio_matches_reference():
    from repro.core import compress as j_compress
    from repro_torch.core import compress

    for shape, k, mode in (((5, 7), 4, "topk"), ((300,), None, "int8"), ((9,), None, "none")):
        assert compress.compression_ratio(shape, k, mode) == j_compress.compression_ratio(
            shape, k, mode)
    with pytest.raises(ValueError):
        compress.compression_ratio((3,), None, "zstd")


def test_topk_rejects_budget_above_leaf():
    import torch

    from repro_torch.core import compress

    with pytest.raises(ValueError, match="top-k"):
        compress.topk_compress(torch.zeros(2, 3), 4)


if __name__ == "__main__":
    _reference(sys.argv[1])
