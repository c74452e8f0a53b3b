"""The port's copy of the rate-aware schedule optimizer against the JAX
package's, and the FL drivers that run on its schedules.

Each optimizer case mirrors one test of ``test_schedule_optimizer.py``: it
runs the reference's ``repro.constellation.optimizer`` and the port's copy on
the same contact plans and requires the same winner, the same oracle cost
of every strategy, and the same schedule slot by slot (relation, time step,
start, duration, bottleneck rate and delay), then checks the reference test's
property on the port. Host code: bit for bit.

The drivers: ``run_constellation_fl(optimize="rate")`` and
``run_groundseg_fl(optimize="rate")`` run in a child process (this file run
as a script, with 8 forced XLA host devices) for 2 rounds of uncompressed
exchange on the one-layer mamba2-780m smoke model, and the port runs them
from the same start state on the same batches. The tolerances are
``test_torch_fl.py``'s: the relation sequence (links per round) and routing
counts exact; round 0's loss rtol 1e-5 (it comes before any exchange);
round 1's loss rtol 1e-4; the consensus distance rtol 1e-3; the final params
an absolute 2e-4 (the port's matmuls sum in another order). AdamW divides
each gradient by its own running magnitude, so an entry whose gradient is
the small remainder of a cancellation turns those last-bit differences
into a relative difference of its step (on this data, one entry of a leaf
of 65 536 at 2.4e-4, its second moment 1/20 of the leaf's median). So at
most 1e-4 of a leaf's entries may exceed 2e-4, and none may exceed
``2 peak_lr`` per local step, the most two AdamW steps can part.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from proptest import given, st_contact_plan, st_float, st_int, st_weighted_relation
from repro.constellation import cost as j_cost
from repro.constellation import optimizer as j_opt
from repro.constellation.contact_plan import ContactPlan as JPlan
from repro.constellation.links import Link as JLink
from repro.core.relation import Relation as JRel
from repro_torch.constellation import cost
from repro_torch.constellation import optimizer as opt
from repro_torch.constellation.contact_plan import ContactPlan
from repro_torch.constellation.links import Link, LinkBudget
from repro_torch.core.relation import Relation

ROOT = pathlib.Path(__file__).resolve().parents[1]
PAYLOAD = 1 << 16
N_SATS, N_GROUND = 6, 2
ROUNDS = 2
SEQ, ROWS = 16, 2
FL_PAYLOAD = 1 << 22


def _plan(jp: JPlan) -> ContactPlan:
    return ContactPlan(
        n_nodes=jp.n_nodes, times=jp.times, step_s=jp.step_s,
        graphs=tuple({e: Link(range_km=l.range_km, delay_s=l.delay_s, rate_bps=l.rate_bps)
                      for e, l in g.items()} for g in jp.graphs),
    )


def _slots(sched):
    return [(s.t_index, sorted(s.relation.pairs), s.start_s, s.duration_s, s.min_rate_bps,
             s.max_delay_s) for s in sched.slots]


def _same_result(res, jres):
    assert res.strategy == jres.strategy
    assert {k: dataclasses.astuple(v) for k, v in res.costs.items()} == {
        k: dataclasses.astuple(v) for k, v in jres.costs.items()}
    assert _slots(res.schedule) == _slots(jres.schedule)


def _per_step_union(sched, n_steps: int):
    unions = [frozenset() for _ in range(n_steps)]
    for slot in sched.slots:
        unions[slot.t_index] = unions[slot.t_index] | slot.relation.pairs
    return unions


# ------------------------------------------------ the never-worse oracle
@given(st_contact_plan(max_nodes=10, max_steps=4, p=0.5),
       st_int(1, 3), st_float(0.0, 3.0), cases=40)
def test_optimizer_never_loses_to_greedy(jplan, antennas, acquisition_s):
    plan = _plan(jplan)
    kw = dict(antennas=antennas, payload_bytes=PAYLOAD, acquisition_s=acquisition_s)
    res = opt.optimize_schedule(plan, **kw)
    _same_result(res, j_opt.optimize_schedule(jplan, **kw))
    assert res.chosen.time_s <= res.baseline.time_s + 1e-9
    assert res.speedup >= 1.0 - 1e-12
    recomputed = cost.schedule_cost(res.schedule, PAYLOAD, "getmeas", acquisition_s=acquisition_s)
    assert recomputed.time_s == pytest.approx(res.chosen.time_s)
    assert res.chosen.bytes_on_isl == res.baseline.bytes_on_isl
    greedy = plan.schedule(**kw)
    n_steps = len(plan.times)
    assert _per_step_union(res.schedule, n_steps) == _per_step_union(greedy, n_steps)
    res.schedule.tdm.validate_antennas(antennas)


@given(st_contact_plan(max_nodes=8, max_steps=3, p=0.5), cases=25)
def test_schedule_optimize_rate_wires_through(jplan):
    """``ContactPlan.schedule(optimize=...)`` reaches the copied optimizer
    (the import in ``contact_plan.py`` no longer fails) and returns the
    reference's schedule."""
    plan = _plan(jplan)
    greedy = plan.schedule(antennas=2, payload_bytes=PAYLOAD)
    rated = plan.schedule(antennas=2, payload_bytes=PAYLOAD, optimize="rate")
    assert _slots(rated) == _slots(jplan.schedule(antennas=2, payload_bytes=PAYLOAD,
                                                  optimize="rate"))
    assert cost.schedule_cost(rated, PAYLOAD).time_s <= cost.schedule_cost(
        greedy, PAYLOAD).time_s + 1e-9
    alias = plan.schedule(antennas=2, payload_bytes=PAYLOAD, optimize="greedy")
    assert [s.relation.pairs for s in alias.slots] == [s.relation.pairs for s in greedy.slots]


@given(st_contact_plan(max_nodes=8, max_steps=3, p=0.6), st_int(1, 4), cases=25)
def test_max_slots_truncates_winner_after_full_plan_scoring(jplan, max_slots):
    plan = _plan(jplan)
    kw = dict(antennas=1, payload_bytes=PAYLOAD, acquisition_s=1.0)
    full = opt.optimize_schedule(plan, **kw)
    res = opt.optimize_schedule(plan, max_slots=max_slots, **kw)
    _same_result(res, j_opt.optimize_schedule(jplan, max_slots=max_slots, **kw))
    assert len(res.schedule) <= max_slots
    assert res.strategy == full.strategy and res.costs == full.costs
    assert [s.relation.pairs for s in res.schedule.slots] == [
        s.relation.pairs for s in full.schedule.slots[:max_slots]]


def test_colorer_and_optimize_are_mutually_exclusive():
    plan = ContactPlan(n_nodes=2, times=(0.0,),
                       graphs=({(0, 1): Link(1000.0, 0.003, 1e6)},), step_s=60.0)
    with pytest.raises(ValueError, match="mutually exclusive"):
        plan.schedule(optimize="rate", colorer=lambda r, l, b, p: [r])


def test_optimize_mode_validation_and_single_strategy():
    graphs = ({(0, 1): (1000.0, 0.003, 1e6), (2, 3): (2000.0, 0.006, 1e8)},)
    plan = ContactPlan(n_nodes=4, times=(0.0,), step_s=60.0,
                       graphs=tuple({e: Link(*v) for e, v in g.items()} for g in graphs))
    jplan = JPlan(n_nodes=4, times=(0.0,), step_s=60.0,
                  graphs=tuple({e: JLink(*v) for e, v in g.items()} for g in graphs))
    with pytest.raises(ValueError, match="optimize mode"):
        opt.optimize_schedule(plan, mode="warp")
    for name in opt.STRATEGIES:
        res = opt.optimize_schedule(plan, mode=name, payload_bytes=PAYLOAD)
        _same_result(res, j_opt.optimize_schedule(jplan, mode=name, payload_bytes=PAYLOAD))
        assert res.chosen.time_s <= res.baseline.time_s + 1e-9
        assert set(res.costs) <= set(opt.STRATEGIES)
    assert opt.STRATEGIES == j_opt.STRATEGIES


# ------------------------------------------------------ mwm decomposition
@given(st_weighted_relation(max_nodes=12, p=0.5), cases=40)
def test_mwm_peeling_is_partition_into_matchings(relw):
    jrel, rates = relw
    matchings = opt.mwm_peeling(Relation.from_pairs(jrel.pairs, nodes=jrel.nodes), rates)
    assert [m.pairs for m in matchings] == [m.pairs for m in j_opt.mwm_peeling(jrel, rates)]
    for m in matchings:
        assert m.is_matching()
    assert sorted(e for m in matchings for e in m.edge_list()) == sorted(jrel.edge_list())


def test_mwm_prefers_heavy_edges_first():
    rates = {(0, 1): 1e9, (1, 2): 1e5}
    fast_first = opt.mwm_peeling(Relation.from_edges([(0, 1), (1, 2)]), rates)
    assert fast_first[0].pairs == Relation.from_edges([(0, 1)]).pairs
    assert [m.pairs for m in fast_first] == [
        m.pairs for m in j_opt.mwm_peeling(JRel.from_edges([(0, 1), (1, 2)]), rates)]


# ------------------------------------------------------------- slew model
def test_slew_penalty_charged_only_on_fresh_edges():
    g = {(0, 1): Link(1000.0, 0.0, 8 * PAYLOAD)}  # transfer = exactly 1 s
    plan = ContactPlan(n_nodes=2, times=(0.0, 100.0), graphs=(g, g), step_s=100.0)
    jg = {(0, 1): JLink(1000.0, 0.0, 8 * PAYLOAD)}
    jplan = JPlan(n_nodes=2, times=(0.0, 100.0), graphs=(jg, jg), step_s=100.0)
    sched = plan.schedule(payload_bytes=PAYLOAD, acquisition_s=5.0)
    assert _slots(sched) == _slots(jplan.schedule(payload_bytes=PAYLOAD, acquisition_s=5.0))
    assert sched.slots[0].duration_s == pytest.approx(6.0)
    assert sched.slots[1].duration_s == pytest.approx(1.0)
    est = cost.schedule_cost(sched, PAYLOAD, "getmeas", acquisition_s=5.0)
    assert est.time_s == pytest.approx(sched.busy_s)
    assert dataclasses.astuple(est) == dataclasses.astuple(j_cost.schedule_cost(
        jplan.schedule(payload_bytes=PAYLOAD, acquisition_s=5.0), PAYLOAD, "getmeas",
        acquisition_s=5.0))
    assert plan.schedule(payload_bytes=PAYLOAD).slots[0].duration_s == pytest.approx(1.0)


def test_link_budget_slew_penalty_s():
    from repro.constellation.links import LinkBudget as JBudget

    assert LinkBudget().slew_penalty_s() == 0.0
    agile = LinkBudget(slew_rate_deg_s=10.0, acquisition_s=2.0)
    j_agile = JBudget(slew_rate_deg_s=10.0, acquisition_s=2.0)
    for deg in (90.0, 0.0):
        assert agile.slew_penalty_s(slew_deg=deg) == j_agile.slew_penalty_s(slew_deg=deg)
    assert agile.slew_penalty_s(slew_deg=90.0) == pytest.approx(11.0)


def test_order_for_overlap_keeps_links_warm():
    a = Relation.from_edges([(0, 1)])
    b = Relation.from_edges([(2, 3)])
    prev = Relation.from_edges([(2, 3)])
    assert opt.order_for_overlap([a, b], prev)[0].pairs == b.pairs
    assert opt.order_for_overlap([a, b], None)[0].pairs == a.pairs


def test_edge_times_include_propagation():
    links = {(0, 1): Link(range_km=3000.0, delay_s=0.01, rate_bps=8 * PAYLOAD)}
    j_links = {(0, 1): JLink(range_km=3000.0, delay_s=0.01, rate_bps=8 * PAYLOAD)}
    assert opt.edge_times_s(links, PAYLOAD) == j_opt.edge_times_s(j_links, PAYLOAD)
    assert opt.edge_times_s(links, PAYLOAD)[(0, 1)] == pytest.approx(1.01)


@given(st_contact_plan(max_nodes=8, max_steps=3, p=0.5), cases=10)
def test_windowed_optimizer_matches_reference(jplan):
    """Warm-started windows: the same winners and schedules, window by
    window, and the same recorder counters."""
    from repro import telemetry as j_tel
    from repro_torch import telemetry

    plan = _plan(jplan)
    wo = opt.WindowedOptimizer(antennas=1, payload_bytes=PAYLOAD, acquisition_s=1.0)
    jwo = j_opt.WindowedOptimizer(antennas=1, payload_bytes=PAYLOAD, acquisition_s=1.0)
    with telemetry.record_scope() as rec, j_tel.record_scope() as jrec:
        for _ in range(3):
            _same_result(wo.optimize(plan), jwo.optimize(jplan))
    for name in ("optimizer.warm_start.hit", "optimizer.warm_start.race", "optimizer.races"):
        assert rec.get_counter(name) == jrec.get_counter(name)


# ---------------------------------------------------- the FL drivers on it
def _setup(archs, adamw, ShapeConfig, scenario, n_ground: int):
    cfg = archs.smoke_cfg(archs.get("mamba2-780m")).replace(
        compute_dtype="float32", n_layers=1)
    opt_cfg = adamw.OptConfig(peak_lr=5e-3, warmup_steps=2, decay_steps=100)
    n_sats = N_SATS if n_ground else N_SATS + N_GROUND
    scn = scenario.build_scenario(scenario.ScenarioSpec(
        shells=(scenario.ShellSpec(planes=2, per_plane=n_sats // 2),), n_ground=n_ground,
        steps=4, max_range_km=14_000.0,
    ))
    return cfg, opt_cfg, ShapeConfig("fl", "train", SEQ, ROWS), scn


def _drive(fl_train, scenario, archs, adamw, ShapeConfig, make_batch_fn, state_of, mesh_args):
    """Both drivers with optimize="rate", 2 rounds, from ``state_of()``:
    constellation FL (8 satellites, one antenna each, 0.5 s acquisition)
    and hierarchical ground-segment FL (6 satellites, sinks 6 and 7)."""
    out = {}
    cfg, opt_cfg, shape, scn = _setup(archs, adamw, ShapeConfig, scenario, 0)
    n = scn.n_nodes
    state, logs = fl_train.run_constellation_fl(
        cfg, opt_cfg, *mesh_args, n, fl_train.FLConfig(mode="tdm", local_steps=1),
        scn.plan, state_of(), make_batch_fn(cfg, shape, n, 1), rounds=ROUNDS,
        optimize="rate", antennas=1, payload_bytes=FL_PAYLOAD, acquisition_s=0.5)
    out["constellation"] = (state, logs, ("n_links", "alive"))
    cfg, opt_cfg, shape, scn = _setup(archs, adamw, ShapeConfig, scenario, N_GROUND)
    gs_cfg = fl_train.GroundSegConfig(mode="hierarchical", sink_sync_every=2)
    state, logs = fl_train.run_groundseg_fl(
        cfg, opt_cfg, *mesh_args, n, fl_train.FLConfig(mode="tdm", local_steps=1), gs_cfg,
        scn.plan, state_of(), make_batch_fn(cfg, shape, n, 1), sinks=scn.ground_ids,
        rounds=ROUNDS, optimize="rate", antennas=2, payload_bytes=FL_PAYLOAD)
    out["groundseg"] = (state, logs, ("delivered", "covered", "alive", "pooled"))
    return out


def _reference(out_path: str) -> None:
    """Child process: the JAX reference's drivers on 8 forced host devices."""
    import jax

    from repro.configs import archs
    from repro.constellation import scenario
    from repro.launch import fl_train
    from repro.models.config import ShapeConfig
    from repro.optim import adamw
    from repro_torch.launch.train_fl_constellation import make_batch_fn

    cfg, opt_cfg, _, _ = _setup(archs, adamw, ShapeConfig, scenario, 0)
    start = jax.tree.map(np.asarray, fl_train._stack_init(
        jax.random.PRNGKey(0), cfg, opt_cfg, N_SATS + N_GROUND))
    out = {}
    flat, _ = jax.tree_util.tree_flatten_with_path(start)
    for path, leaf in flat:
        out["start/" + jax.tree_util.keystr(path)] = leaf
    mesh = jax.make_mesh((N_SATS + N_GROUND,), ("data",))
    runs = _drive(fl_train, scenario, archs, adamw, ShapeConfig, make_batch_fn,
                  lambda: jax.tree.map(jax.numpy.array, start), (mesh,))
    for name, (state, logs, fields) in runs.items():
        out[f"{name}/loss"] = np.array([lg.loss for lg in logs])
        out[f"{name}/consensus"] = np.array([lg.consensus for lg in logs])
        for f in fields:
            out[f"{name}/{f}"] = np.array([getattr(lg, f) for lg in logs])
        flat, _ = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, state["params"]))
        for path, leaf in flat:
            out[f"{name}/params/" + jax.tree_util.keystr(path)] = leaf
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_optimizer") / "ref.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8 " + env.get("XLA_FLAGS", "")
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = f"{ROOT / 'src'}:{ROOT / 'tests'}:" + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, __file__, str(out)], capture_output=True, text=True,
                          env=env, timeout=900, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(out))


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


@pytest.fixture(scope="module")
def port_runs(reference):
    from repro_torch.configs import archs
    from repro_torch.constellation import scenario
    from repro_torch.launch import fl_train
    from repro_torch.launch.train_fl_constellation import make_batch_fn
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import adamw
    from repro_torch.weights import state_from_jax

    return _drive(fl_train, scenario, archs, adamw, ShapeConfig, make_batch_fn,
                  lambda: state_from_jax(_unkeystr(reference, "start/"), device="cpu"), ())


@pytest.mark.slow
@pytest.mark.parametrize("name", ["constellation", "groundseg"])
def test_driver_with_rate_optimizer_matches_reference(reference, port_runs, name):
    from repro_torch.weights import to_numpy

    state, logs, fields = port_runs[name]
    assert len(logs) == ROUNDS
    for f in fields:
        np.testing.assert_array_equal([getattr(lg, f) for lg in logs], reference[f"{name}/{f}"])
    loss = np.array([lg.loss for lg in logs])
    cons = np.array([lg.consensus for lg in logs])
    assert np.isfinite(loss).all() and np.isfinite(cons).all()
    np.testing.assert_allclose(loss[0], reference[f"{name}/loss"][0], rtol=1e-5)
    np.testing.assert_allclose(loss[1:], reference[f"{name}/loss"][1:], rtol=1e-4)
    np.testing.assert_allclose(cons, reference[f"{name}/consensus"], rtol=1e-3)
    want = _unkeystr(reference, f"{name}/params/")
    most = 2 * 5e-3 * ROUNDS        # 2 peak_lr per local step, one step a round

    def compare(g, w, path=""):
        if isinstance(w, dict):
            for k in w:
                compare(g[k], w[k], f"{path}/{k}")
            return
        gap = np.abs(np.asarray(g, np.float64) - w)
        assert (gap > 2e-4).mean() <= 1e-4, (path, int((gap > 2e-4).sum()))
        assert gap.max() <= most, (path, gap.max())

    compare(to_numpy(state["params"]), want)


def test_rate_and_greedy_train_alike_when_antennas_cover_degree():
    """The reference's documented property: with zero slew and an antenna
    budget covering each step's degree, greedy and rate emit the same
    relations, so training is bit for bit the same. The rounds' relations
    are read off the ``fl.build_schedule`` span's schedule and the logs;
    the oracle check of every round's gathers runs inside the driver."""
    import torch

    from repro_torch import telemetry
    from repro_torch.configs import archs
    from repro_torch.constellation import scenario
    from repro_torch.launch import fl_train
    from repro_torch.launch.train_fl_constellation import make_batch_fn
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import adamw
    from repro_torch.pytree import tree_leaves

    cfg, opt_cfg, shape, scn = _setup(archs, adamw, ShapeConfig, scenario, 0)
    n = scn.n_nodes
    budget = max(r.max_degree() for r in scn.plan.relations())
    runs = {}
    for mode in ("greedy", "rate"):
        sched = scn.plan.schedule(antennas=budget, payload_bytes=FL_PAYLOAD, optimize=mode)
        with telemetry.record_scope(tracing=True) as rec:
            state, logs = fl_train.run_constellation_fl(
                cfg, opt_cfg, n, fl_train.FLConfig(mode="tdm", local_steps=1), scn.plan,
                fl_train._stack_init(0, cfg, opt_cfg, n, device="cpu"),
                make_batch_fn(cfg, shape, n, 1), rounds=2, optimize=mode, antennas=budget,
                payload_bytes=FL_PAYLOAD)
        assert [sp.name for sp in rec.spans].count("fl.build_schedule") == 1
        runs[mode] = ([s.relation.pairs for s in sched.slots], logs, state)
    (g_rels, g_logs, g_state), (r_rels, r_logs, r_state) = runs["greedy"], runs["rate"]
    assert g_rels == r_rels == [r.pairs for r in scn.plan.relations()]
    assert [(lg.n_links, lg.loss, lg.consensus) for lg in g_logs] == [
        (lg.n_links, lg.loss, lg.consensus) for lg in r_logs]
    for a, b in zip(tree_leaves(g_state), tree_leaves(r_state)):
        assert torch.equal(a, b)


def test_empty_schedule_falls_back_to_per_step_relations():
    """A plan with no feasible contact: the optimized schedule is empty and
    the rounds run on the (empty) per-step relations, local training only."""
    from repro_torch.configs import archs
    from repro_torch.launch import fl_train
    from repro_torch.launch.train_fl_constellation import make_batch_fn
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import adamw

    cfg = archs.smoke_cfg(archs.get("mamba2-780m")).replace(compute_dtype="float32", n_layers=1)
    opt_cfg = adamw.OptConfig(peak_lr=5e-3, warmup_steps=2, decay_steps=100)
    plan = ContactPlan(n_nodes=2, times=(0.0, 60.0), graphs=({}, {}), step_s=60.0)
    assert len(plan.schedule(optimize="rate")) == 0
    _, logs = fl_train.run_constellation_fl(
        cfg, opt_cfg, 2, fl_train.FLConfig(mode="tdm"), plan,
        fl_train._stack_init(0, cfg, opt_cfg, 2, device="cpu"),
        make_batch_fn(cfg, ShapeConfig("fl", "train", SEQ, ROWS), 2, 1), rounds=3,
        optimize="rate")
    assert [lg.n_links for lg in logs] == [0, 0, 0]
    assert all(np.isfinite(lg.loss) for lg in logs)


if __name__ == "__main__":
    _reference(sys.argv[1])
