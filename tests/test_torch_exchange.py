"""The port's stacked TDM exchange and fused engine against the JAX reference.

A child process (this file run as a script, with 8 forced XLA host devices;
``jax.vmap`` cannot express the partial permutations of a matching) runs
``repro.core.tdm`` and ``repro.core.fused`` under ``shard_map`` on fixed
numpy inputs and writes the results to an ``.npz``. The relations include
an isolated node (it sends and receives nothing). The reference's
compressed paths run through their plain jnp versions (``impl="ref"``),
which its own tests hold bit-identical to the Pallas kernels.

Tolerances. Pure data movement (get_meas / get1_meas), int8 codes and
scales, and top-k selections are compared bit for bit. Every mix is a sum of
weighted terms, which XLA fuses into multiply-adds (one rounding each) where
the port rounds the product and the sum separately; Metropolis weights are
at most 1 and every term is at most the row's largest magnitude |x|max. Each
of the M matchings' accumulations then adds at most 1.5 ulp(|x|max) of gap,
and the self term and final step one more each, so mixes are held to
``2 (M + 2) ulp(|x|max)`` per row, in the buffer's dtype.
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
L = 3 * 1024            # three blocks per node
TOPK_K = 40             # per-leaf budget; fused scales it by the leaf count
EDGES = {
    # max degree 3 (several matchings), node 7 isolated
    "mesh": [(0, 1), (1, 2), (2, 3), (3, 0), (0, 2), (4, 5), (5, 6), (4, 6)],
    # a ring through the seven live nodes (satellite 3's links dropped)
    "ring": [(0, 1), (1, 2), (2, 4), (4, 5), (5, 6), (6, 7), (7, 0)],
}


def _inputs():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((N, L)) * rng.uniform(0.1, 3.0, (N, 1))).astype(np.float32)
    tree = {
        "b": rng.standard_normal((N, 5, 7)).astype(np.float32),
        "a": rng.standard_normal((N, 300)).astype(np.float32),
        "c": {"z": rng.standard_normal((N, 2000)).astype(np.float32),
              "y": rng.standard_normal((N, 33)).astype(np.float32)},
    }
    return x, tree


def _tree_keys(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _tree_keys(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def _reference(out_path: str) -> None:
    """Child process: the reference collectives on 8 forced host devices."""
    import jax
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    from repro.core import fl, fused, tdm
    from repro.core.relation import Relation
    from repro.kernels.tdm_compress import ref as q_ref

    mesh = Mesh(np.array(jax.devices()[:N]), ("node",))

    def spmd(f, *args):
        def body(*a):
            out = f(*jax.tree.map(lambda t: t[0], a))
            return jax.tree.map(lambda t: t[None], out)

        return jax.tree.map(np.asarray, jax.jit(shard_map(
            body, mesh=mesh, in_specs=P("node"), out_specs=P("node"), check_rep=False,
        ))(*args))

    x, tree = _inputs()
    out = {}
    q, s = spmd(lambda v: q_ref.quantize_ref(v), x)
    out["quant/q"], out["quant/s"] = q, s
    d, v, i = spmd(lambda v: q_ref.topk_sparsify_ref(v, 5), x)
    out["topk/dense"], out["topk/vals"], out["topk/idxs"] = d, v, i
    for name, edges in EDGES.items():
        rel = Relation.from_edges(edges, nodes=range(N))
        pd, mask = spmd(lambda v: tdm.get_meas(v, rel, "node", N), x)
        out[f"{name}/get_meas"], out[f"{name}/get_meas_mask"] = pd, mask
        pd, mask = spmd(lambda v: tdm.get1_meas(v, rel, "node", N), x)
        out[f"{name}/get1_meas"], out[f"{name}/get1_meas_mask"] = pd, mask
        out[f"{name}/gossip_avg"] = spmd(lambda v: tdm.gossip_avg(v, rel, "node", N), x)
        out[f"{name}/gossip_avg_serial"] = spmd(
            lambda v: tdm.gossip_avg_serial(v, rel, "node", N), x)
        out[f"{name}/int8_gossip"] = spmd(
            lambda v: fused.int8_gossip(v, rel, "node", N, impl="ref"), x)
        new_x, st = spmd(lambda v: fused.choco_fused_round(
            v, tdm.choco_init(v), rel, "node", N, 3 * 7, impl="ref"), x)
        out[f"{name}/choco"], out[f"{name}/choco_xhat"], out[f"{name}/choco_s"] = (
            new_x, st.x_hat, st.s)
        for comp in ("none", "int8", "topk"):
            cfg = fl.TDMFLAConfig(compression=comp, topk_k=TOPK_K)
            mixed, _ = spmd(
                lambda t: fused.fused_tdm_fla_round(t, rel, "node", N, cfg, quant_impl="ref"),
                tree)
            for key, leaf in _tree_keys(mixed):
                out[f"{name}/fused_{comp}/{key}"] = leaf
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_exchange") / "ref.npz"
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


def _ulp(v: np.ndarray, dtype=np.float32) -> np.ndarray:
    return np.spacing(np.abs(v).astype(dtype)).astype(np.float64)


def assert_mix_close(got, want, x, n_matchings: int) -> None:
    """|got - want| <= 2 (M + 2) ulp(|x|max) per row (module docstring)."""
    got, want, x = (np.asarray(a, dtype=np.float64) for a in (got, want, x))
    rowmax = np.abs(x).reshape(x.shape[0], -1).max(axis=1)
    bound = 2 * (n_matchings + 2) * _ulp(rowmax)
    gap = np.abs(got - want).reshape(got.shape[0], -1).max(axis=1)
    assert (gap <= bound).all(), (gap, bound)


def _matchings(rel) -> int:
    from repro_torch.core.schedule import edge_coloring

    return len(edge_coloring(rel))


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(EDGES))
def test_get_meas_bitwise(ref, name):
    from repro_torch.core import tdm

    x, _ = _inputs()
    rel = _rel(name)
    for fn in ("get_meas", "get1_meas"):
        pd, mask = getattr(tdm, fn)(_t(x), rel, N)
        np.testing.assert_array_equal(pd.numpy(), ref[f"{name}/{fn}"])
        np.testing.assert_array_equal(mask.numpy(), ref[f"{name}/{fn}_mask"])
    # the isolated / dropped node receives nothing
    idle = [v for v in range(N) if rel.degree(v) == 0]
    for v in idle:
        assert not mask[v].any() and not pd[v].any()


@pytest.mark.parametrize("name", sorted(EDGES))
def test_get_meas_matches_paper_simulator(name):
    """getMeas against the port's paper-faithful message-passing simulator,
    and get1meas slot by slot over the relation's matchings."""
    from repro_torch.core import tdm
    from repro_torch.core.ptbfla_sim import run_schedule_get1meas, run_schedule_getmeas
    from repro_torch.core.schedule import TDMSchedule

    x, _ = _inputs()
    rel = _rel(name)
    got, _ = run_schedule_getmeas(TDMSchedule((rel,)), {i: x[i] for i in range(N)}, N)
    pd, mask = tdm.get_meas(_t(x), rel, N)
    for i in range(N):
        for p, j in enumerate(rel.peers_of(i)):
            assert bool(mask[i, p])
            np.testing.assert_array_equal(pd[i, p].numpy(), got[i][0][j])
    matchings = tdm.edge_coloring(rel)
    sched = TDMSchedule(tuple(matchings))
    got1, _ = run_schedule_get1meas(sched, {i: x[i] for i in range(N)}, N)
    for t, m in enumerate(matchings):
        pd, _ = tdm.get1_meas(_t(x), m, N)
        for i in range(N):
            for j in m.peers_of(i):
                np.testing.assert_array_equal(pd[i, 0].numpy(), got1[i][t][j])


@pytest.mark.parametrize("name", sorted(EDGES))
def test_simulator_copy_matches_reference_simulator(name):
    """The port's simulator delivers what the reference's delivers, on the
    same relation, data and seed, bit for bit."""
    from repro.core.ptbfla_sim import run_schedule_getmeas as j_run
    from repro.core.relation import Relation as JRel
    from repro.core.schedule import TDMSchedule as JSched
    from repro_torch.core.ptbfla_sim import run_schedule_getmeas
    from repro_torch.core.schedule import TDMSchedule

    x, _ = _inputs()
    data = {i: x[i] for i in range(N)}
    got, sim = run_schedule_getmeas(TDMSchedule((_rel(name),)), data, N, seed=3)
    want, j_sim = j_run(JSched((JRel.from_edges(EDGES[name], nodes=range(N)),)), data, N, seed=3)
    assert sorted(got) == sorted(want)
    for i in want:
        assert sorted(got[i]) == sorted(want[i])
        for t in want[i]:
            assert list(got[i][t]) == list(want[i][t])
            for j in want[i][t]:
                np.testing.assert_array_equal(got[i][t][j], want[i][t][j])
    assert [(n.n_sent, n.n_received, n.n_buffered) for n in sim.nodes] == [
        (n.n_sent, n.n_received, n.n_buffered) for n in j_sim.nodes]


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(EDGES))
def test_gossip_within_fma_bound(ref, name):
    from repro_torch.core import fused, tdm

    x, _ = _inputs()
    rel = _rel(name)
    m = _matchings(rel)
    assert_mix_close(tdm.gossip_avg(_t(x), rel, N).numpy(), ref[f"{name}/gossip_avg"], x, m)
    assert_mix_close(tdm.gossip_avg_serial(_t(x), rel, N).numpy(),
                     ref[f"{name}/gossip_avg_serial"], x, m)
    assert_mix_close(fused.int8_gossip(_t(x), rel, N).numpy(), ref[f"{name}/int8_gossip"], x, m)
    new_x, st = fused.choco_fused_round(_t(x), tdm.choco_init(_t(x)), rel, N, 3 * 7)
    # x_hat is pure selection: bit for bit
    np.testing.assert_array_equal(st.x_hat.numpy(), ref[f"{name}/choco_xhat"])
    assert_mix_close(st.s.numpy(), ref[f"{name}/choco_s"], x, m)
    assert_mix_close(new_x.numpy(), ref[f"{name}/choco"], x, m)


@pytest.mark.slow
def test_int8_codes_and_topk_selection_bitwise(ref):
    from repro_torch.kernels.tdm_compress import ops

    x, _ = _inputs()
    q, s = ops.quantize(_t(x))
    np.testing.assert_array_equal(q.numpy(), ref["quant/q"])
    np.testing.assert_array_equal(s.numpy(), ref["quant/s"])
    d, v, i = ops.topk_sparsify(_t(x), k=5)
    np.testing.assert_array_equal(d.numpy(), ref["topk/dense"])
    np.testing.assert_array_equal(v.numpy(), ref["topk/vals"])
    np.testing.assert_array_equal(i.numpy(), ref["topk/idxs"])


@pytest.mark.slow
@pytest.mark.parametrize("comp", ["none", "int8", "topk"])
@pytest.mark.parametrize("name", sorted(EDGES))
def test_fused_round_matches_reference(ref, name, comp):
    from repro_torch.core import fl, fused

    _, tree = _inputs()
    rel = _rel(name)
    cfg = fl.TDMFLAConfig(compression=comp, topk_k=TOPK_K)
    mixed, _ = fused.fused_tdm_fla_round(
        {k: (_t(v) if not isinstance(v, dict) else {kk: _t(vv) for kk, vv in v.items()})
         for k, v in tree.items()}, rel, N, cfg)
    got = dict(_tree_keys({k: (v.numpy() if not isinstance(v, dict) else
                               {kk: vv.numpy() for kk, vv in v.items()})
                           for k, v in mixed.items()}))
    flat = np.concatenate([a.reshape(N, -1) for _, a in _tree_keys(tree)], axis=1)
    for key, want in _tree_keys_from(ref, f"{name}/fused_{comp}/"):
        assert got[key].shape == want.shape
        assert_mix_close(got[key], want, flat, _matchings(rel))


def _tree_keys_from(ref, prefix):
    for k, v in ref.items():
        if k.startswith(prefix):
            yield k[len(prefix):], v


@pytest.mark.parametrize("comm", ["getmeas", "get1meas"])
@pytest.mark.parametrize("name", sorted(EDGES))
def test_fused_uncompressed_equals_per_leaf_bitwise(name, comm):
    from repro_torch.core import fl
    from repro_torch.pytree import tree_leaves

    _, tree = _inputs()
    t = {k: (_t(v) if not isinstance(v, dict) else {kk: _t(vv) for kk, vv in v.items()})
         for k, v in tree.items()}
    rel = _rel(name)
    fused_out, _ = fl.tdm_fla_round(t, rel, N, fl.TDMFLAConfig(comm=comm))
    leaf_out, _ = fl.tdm_fla_round(t, rel, N, fl.TDMFLAConfig(comm=comm, fused=False))
    for a, b in zip(tree_leaves(fused_out), tree_leaves(leaf_out)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("comp", ["none", "int8", "topk"])
@pytest.mark.parametrize("name", sorted(EDGES))
def test_gathers_per_round_match_oracle(name, comp):
    """Row gathers issued by one fused round == the reference's static
    collective oracle (which its tests hold against compiled HLO)."""
    import torch

    from repro.core.relation import Relation as JRel
    from repro.telemetry import expected_tdm_collectives
    from repro_torch.core import fl, tdm

    _, tree = _inputs()
    t = {"a": _t(tree["a"]), "h": _t(tree["b"]).to(torch.bfloat16)}
    rel = _rel(name)
    before = tdm.gather_count()
    fl.tdm_fla_round(t, rel, N, fl.TDMFLAConfig(compression=comp, topk_k=TOPK_K))
    issued = tdm.gather_count() - before
    want = expected_tdm_collectives(
        JRel.from_edges(EDGES[name], nodes=range(N)), 2, compression=comp)
    assert issued == want["collective-permute"] > 0


if __name__ == "__main__":
    _reference(sys.argv[1])
