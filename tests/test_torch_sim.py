"""The port's copy of the paper-faithful simulator and the three generic
algorithms against the JAX package's, on the same seeds.

Each case mirrors one test of ``test_ptbfla_sim.py`` or of the simulator part
of ``test_fl_algorithms.py``: it runs the reference and the port on the same
inputs and seeds and requires the same message trace (every ``sendMsg`` in
order: source, destination, message), the same per-node counters
(time slot, sent, received, buffered through ``timeSlotsMap``) and the same
results, then checks the property the reference's test checks. All of this
is host code and exact: bit for bit. The stacked exchange is then held to
the simulator: ``run_gossip_schedule`` of a hypercube schedule reaches the
mean in log2(n) slots, and ``gossip_avg_tree`` equals ``gossip_avg`` leaf by
leaf.
"""

from __future__ import annotations

import contextlib

import numpy as np
import pytest

from proptest import given, st_int, st_relation
from repro.core import fl as j_fl
from repro.core import ptbfla_sim as j_sim
from repro.core.gossip import metropolis_weights as j_metropolis
from repro.core.gossip import spectral_gap as j_spectral_gap
from repro.core.relation import Relation as JRel
from repro.core.schedule import TDMSchedule as JSched
from repro.core.schedule import clique_multilink as j_clique_multilink
from repro.core.schedule import hypercube_schedule as j_hypercube
from repro.core.schedule import round_robin_tournament as j_round_robin
from repro_torch.core import fl as p_fl
from repro_torch.core import ptbfla_sim as p_sim
from repro_torch.core.gossip import metropolis_weights, propagation_closure, spectral_gap
from repro_torch.core.relation import Relation
from repro_torch.core.schedule import TDMSchedule, clique_multilink, hypercube_schedule
from repro_torch.core.schedule import ring, round_robin_tournament


def _rel(jrel: JRel) -> Relation:
    return Relation.from_pairs(jrel.pairs, nodes=jrel.nodes)


def _sched(jsched: JSched) -> TDMSchedule:
    return TDMSchedule(tuple(_rel(r) for r in jsched))


@contextlib.contextmanager
def _traced(mod):
    """Record every send of ``mod.PTBFLASimulator`` as (src, dst, repr(msg))."""
    log = []
    orig = mod.PTBFLASimulator.send_msg

    def send(self, src, dst, msg):
        log.append((src, dst, repr(msg)))
        return orig(self, src, dst, msg)

    mod.PTBFLASimulator.send_msg = send
    try:
        yield log
    finally:
        mod.PTBFLASimulator.send_msg = orig


def _stats(sim):
    return sim.total_messages, [
        (n.node_id, n.time_slot, n.n_sent, n.n_received, n.n_buffered,
         sorted(n.time_slots_map))
        for n in sim.nodes
    ]


def _both(run_ref, run_port):
    """Run the reference and the port under tracing; require equal traces,
    and return both results."""
    with _traced(j_sim) as j_log:
        want = run_ref()
    with _traced(p_sim) as p_log:
        got = run_port()
    assert p_log == j_log
    return got, want


def _same_runs(got, want):
    (res_p, sim_p), (res_j, sim_j) = got, want
    assert res_p == res_j
    assert _stats(sim_p) == _stats(sim_j)


# ------------------------------------------------------------ single slot
@given(st_relation(max_nodes=10, p=0.5), st_int(0, 10_000), cases=40)
def test_getmeas_delivers_peer_data_in_order(jrel, seed):
    n = (max(jrel.nodes) + 1) if jrel.nodes else 2
    data = {i: f"odata-{i}" for i in range(n)}
    got, want = _both(
        lambda: j_sim.run_schedule_getmeas(JSched((jrel,)), data, n, seed=seed),
        lambda: p_sim.run_schedule_getmeas(TDMSchedule((_rel(jrel),)), data, n, seed=seed))
    _same_runs(got, want)
    received = got[0]
    for i in range(n):
        peers = jrel.peers_of(i)
        assert (list(received[i][0].keys()) == peers) if peers else received[i] == {}
        for p in peers:
            assert received[i][0][p] == f"odata-{p}"


def _slot_data(n):
    return {i: (lambda i=i: (lambda t: (i, t)))() for i in range(n)}


@given(st_int(0, 10_000), cases=20)
def test_timeslotsmap_buffers_fast_peers(seed):
    n = 4
    data = _slot_data(n)
    got, want = _both(
        lambda: j_sim.run_schedule_getmeas(
            JSched(tuple(j_clique_multilink(n)[0] for _ in range(4))), data, n, seed=seed),
        lambda: p_sim.run_schedule_getmeas(
            TDMSchedule(tuple(clique_multilink(n)[0] for _ in range(4))), data, n, seed=seed))
    _same_runs(got, want)
    for i in range(n):
        for t in range(4):
            for p in [j for j in range(n) if j != i]:
                assert got[0][i][t][p] == (p, t)


def test_timeslotsmap_actually_used():
    n = 4
    data = _slot_data(n)
    buffered = []
    for seed in range(25):
        got, want = _both(
            lambda: j_sim.run_schedule_getmeas(
                JSched(tuple(j_clique_multilink(n)[0] for _ in range(6))), data, n, seed=seed),
            lambda: p_sim.run_schedule_getmeas(
                TDMSchedule(tuple(clique_multilink(n)[0] for _ in range(6))), data, n,
                seed=seed))
        _same_runs(got, want)
        buffered.append(sum(node.n_buffered for node in got[1].nodes))
    assert sum(buffered) > 0


def _drain(gen):
    try:
        while True:
            gen.send(None)
    except StopIteration as s:
        return s.value


@pytest.mark.parametrize("mod", [j_sim, p_sim], ids=["reference", "port"])
def test_skip_slot_odata_none(mod):
    sim = mod.PTBFLASimulator(2)
    node = sim.nodes[0]
    gen_or_val = sim.get_meas(node, [], None)
    assert not hasattr(gen_or_val, "send") or _drain(gen_or_val) is None
    assert (node.time_slot, node.n_sent) == (1, 0)


def test_get1meas_rejects_multilink_slot():
    msgs = []
    for mod, sched in ((j_sim, JSched((JRel.from_edges([(0, 1), (1, 2)]),))),
                       (p_sim, TDMSchedule((Relation.from_edges([(0, 1), (1, 2)]),)))):
        with pytest.raises(ValueError, match="pairwise") as exc:
            mod.run_schedule_get1meas(sched, {i: i for i in range(3)}, 3)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("mod", [j_sim, p_sim], ids=["reference", "port"])
def test_invalid_schedule_deadlocks_detected(mod):
    sim = mod.PTBFLASimulator(2)

    def prog_a(node):
        res = yield from sim.get_meas(node, [1], "x")  # waits for 1 forever
        return res

    def prog_b(node):
        if False:
            yield
        return None

    with pytest.raises(RuntimeError, match="deadlock"):
        sim.run({0: prog_a, 1: prog_b})


# --------------------------------------------------------- full schedules
@given(st_int(2, 9), st_int(0, 1000), cases=20)
def test_round_robin_equals_multilink_semantics(n, seed):
    data = {i: f"d{i}" for i in range(n)}
    rr, rr_j = _both(lambda: j_sim.run_schedule_get1meas(j_round_robin(n), data, n, seed=seed),
                     lambda: p_sim.run_schedule_get1meas(round_robin_tournament(n), data, n,
                                                         seed=seed))
    ml, ml_j = _both(lambda: j_sim.run_schedule_getmeas(j_clique_multilink(n), data, n, seed=seed),
                     lambda: p_sim.run_schedule_getmeas(clique_multilink(n), data, n, seed=seed))
    _same_runs(rr, rr_j)
    _same_runs(ml, ml_j)
    for i in range(n):
        got_rr = {p: v for slot in rr[0][i].values() for p, v in slot.items()}
        got_ml = {p: v for slot in ml[0][i].values() for p, v in slot.items()}
        assert got_rr == got_ml == {j: f"d{j}" for j in range(n) if j != i}


def _forwarding(mod, sched, n, seed):
    """Nodes forward everything they know, over ``sched``."""
    sim = mod.PTBFLASimulator(n, seed=seed)

    def make_prog(i):
        def prog(node):
            know = {i}
            for rel in sched:
                peers = rel.peers_of(i)
                got = yield from mod._as_gen(sim.get_meas(node, peers, sorted(know) if peers else None))
                for lst in got or ():
                    know.update(lst)
            return know

        return prog

    return sim.run({i: make_prog(i) for i in range(n)}), sim


@given(st_relation(max_nodes=8, p=0.4), st_relation(max_nodes=8, p=0.4), st_int(0, 1000),
       cases=20)
def test_data_propagation_matches_closure(r1, r2, seed):
    n = max([max(r1.nodes, default=0), max(r2.nodes, default=0)]) + 1
    jsched = JSched((r1.restrict(range(n)), r2.restrict(range(n))))
    sched = _sched(jsched)
    got, want = _both(lambda: _forwarding(j_sim, jsched, n, seed),
                      lambda: _forwarding(p_sim, sched, n, seed))
    _same_runs(got, want)
    reach = propagation_closure(sched, n)
    for j in range(n):
        assert got[0][j] == {i for i in range(n) if reach[i, j]}


def test_message_counts_match_theory():
    n = 6
    data = {i: i for i in range(n)}
    got, want = _both(
        lambda: j_sim.run_schedule_getmeas(JSched((JRel.clique(list(range(n))),)), data, n),
        lambda: p_sim.run_schedule_getmeas(TDMSchedule((Relation.clique(list(range(n))),)),
                                           data, n))
    _same_runs(got, want)
    assert got[1].total_messages == n * (n - 1)
    got, want = _both(lambda: j_sim.run_schedule_get1meas(j_round_robin(n), data, n),
                      lambda: p_sim.run_schedule_get1meas(round_robin_tournament(n), data, n))
    _same_runs(got, want)
    assert got[1].total_messages == n * (n - 1)


# ------------------------------------------- the three generic algorithms
@pytest.mark.parametrize("n_rounds,server,server_data", [(1, 0, 0.0), (20, 2, 8.0)])
def test_centralized_fla_sim(n_rounds, server, server_data):
    n = 6 if n_rounds == 1 else 4
    kw = dict(
        n_nodes=n, server_id=server, server_data=server_data, n_rounds=n_rounds,
        client_fn=(lambda m, d: m + d) if n_rounds == 1 else (lambda m, d: 0.5 * m + d),
        server_fn=lambda m, ups: float(np.mean(ups)),
        client_data=({i: float(i) for i in range(n) if i != server} if n_rounds == 1
                     else {i: 1.0 for i in range(n) if i != server}),
    )
    got, want = _both(lambda: j_fl.centralized_fla_sim(**kw), lambda: p_fl.centralized_fla_sim(**kw))
    assert got == want
    target = np.mean([float(i) for i in range(1, n)]) if n_rounds == 1 else 2.0
    assert got == pytest.approx(target, abs=1e-4)


@given(st_int(3, 9), st_int(0, 500), cases=15)
def test_decentralized_fla_uniform_average(n, seed):
    data = {i: float(i * i) for i in range(n)}

    def update(own, peers):
        return (own + sum(peers)) / n

    got, want = _both(lambda: j_fl.decentralized_fla_sim(n, update, data, n_rounds=1, seed=seed),
                      lambda: p_fl.decentralized_fla_sim(n, update, data, n_rounds=1, seed=seed))
    assert got == want
    for i in range(n):
        assert got[i] == pytest.approx(np.mean(list(data.values())))


def _walker_relations(mod_scenario):
    scn = mod_scenario.build_scenario(mod_scenario.ScenarioSpec(
        shells=(mod_scenario.ShellSpec(planes=3, per_plane=4),), n_ground=0, steps=60))
    return scn.relations()


def test_tdm_fla_consensus_over_walker():
    """The Walker visibility schedule (12 MEO satellites, one period):
    the port's stacked gossip in float64 equals the reference test's numpy
    Metropolis recursion to float64 rounding (rtol 1e-12: the port adds in
    matching order, numpy in peer order) and reaches consensus."""
    import torch

    from repro.constellation import scenario as j_scenario
    from repro_torch.constellation import scenario as p_scenario
    from repro_torch.core import tdm

    j_rels = _walker_relations(j_scenario)
    rels = _walker_relations(p_scenario)
    assert [r.pairs for r in rels] == [r.pairs for r in j_rels]
    n = 12
    init = np.array([[float(i), -float(i)] for i in range(n)])
    state = init.copy()
    for rel in j_rels:
        W = j_metropolis(rel, n)
        state = np.stack([W[i, i] * state[i] + sum(W[i, j] * state[j] for j in rel.peers_of(i))
                          for i in range(n)])
    got = tdm.run_gossip_schedule(torch.from_numpy(init), TDMSchedule(tuple(rels)), n).numpy()
    np.testing.assert_allclose(got, state, rtol=1e-12, atol=1e-12)
    target = init.mean(axis=0)
    assert max(np.linalg.norm(got[i] - target) for i in range(n)) < 1e-3


def test_tdm_fla_sim_local_plus_mix():
    n = 8
    init = {i: float(i) for i in range(n)}
    args = (lambda node, t, v: v, lambda own, peers: (own + peers[0]) / 2.0, init)
    (got, sim), (want, j_simr) = _both(lambda: j_fl.tdm_fla_sim(j_hypercube(n), n, *args),
                                       lambda: p_fl.tdm_fla_sim(hypercube_schedule(n), n, *args))
    assert got == want and _stats(sim) == _stats(j_simr)
    for i in range(n):
        assert got[i] == pytest.approx(np.mean(list(init.values())))
    assert sim.total_messages == n * (n.bit_length() - 1)


def test_tdm_fla_skip_slot_isolated_nodes():
    n = 4
    kw = dict(local_fn=lambda i, t, v: v,
              mix_fn=lambda own, peers: (own + sum(peers)) / (1 + len(peers)),
              init={i: float(i) for i in range(n)})
    (got, sim), (want, j_simr) = _both(
        lambda: j_fl.tdm_fla_sim(JSched((JRel.from_edges([(0, 1)], nodes=range(n)),)), n, **kw),
        lambda: p_fl.tdm_fla_sim(TDMSchedule((Relation.from_edges([(0, 1)], nodes=range(n)),)),
                                 n, **kw))
    assert got == want and _stats(sim) == _stats(j_simr)
    assert got == {0: 0.5, 1: 0.5, 2: 2.0, 3: 3.0}


def test_spectral_gap_orders_topologies():
    from repro.core.schedule import ring as j_ring

    n = 12
    gap_clique = spectral_gap(metropolis_weights(Relation.clique(list(range(n))), n))
    gap_ring = spectral_gap(metropolis_weights(ring(n), n))
    assert gap_clique == j_spectral_gap(j_metropolis(JRel.clique(list(range(n))), n))
    assert gap_ring == j_spectral_gap(j_metropolis(j_ring(n), n))
    assert gap_clique > gap_ring > 0


@pytest.mark.parametrize("tol", [1e-3, 1e-6, 1e-9])
def test_rounds_to_consensus_finite(tol):
    n = 8
    W = metropolis_weights(Relation.clique(list(range(n))), n)
    t = p_fl.rounds_to_consensus(W, tol=tol)
    assert t == j_fl.rounds_to_consensus(j_metropolis(JRel.clique(list(range(n))), n), tol=tol)
    assert 0 < t < 100
    assert p_fl.rounds_to_consensus(np.eye(4)) == -1   # no gap: never


def test_consensus_error_matches_reference():
    rng = np.random.default_rng(0)
    vals = [rng.standard_normal((3, 4)).astype(np.float32) for _ in range(5)]
    assert p_fl.consensus_error(vals) == j_fl.consensus_error(vals)
    assert p_fl.consensus_error([vals[0]] * 3) == 0.0


# -------------------------------------------- the stacked exchange vs the floor
def test_run_gossip_schedule_hypercube_reaches_mean_in_log2_slots():
    """Pairwise averaging over the 3 slots of an 8-node hypercube gives every
    node the mean; after 2 slots no node has it yet. The simulator's
    tdm_fla_sim with the same mix gives the same per-node values."""
    import torch

    from repro_torch.core import tdm

    n = 8
    sched = hypercube_schedule(n)
    assert len(sched) == 3
    x = torch.tensor([[1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0]]).T.contiguous()
    mean = x.mean()
    two = tdm.run_gossip_schedule(x, TDMSchedule(sched.slots[:2]), n)
    assert not torch.isclose(two, mean).any()
    got = tdm.run_gossip_schedule(x, sched, n)
    assert torch.equal(got, torch.full_like(x, float(mean)))
    sim, _ = p_fl.tdm_fla_sim(sched, n, lambda i, t, v: v,
                              lambda own, peers: (own + peers[0]) / 2.0,
                              {i: float(x[i, 0]) for i in range(n)})
    assert [sim[i] for i in range(n)] == got[:, 0].tolist()


def test_gossip_avg_tree_equals_gossip_avg_per_leaf():
    import torch

    from repro_torch.core import tdm

    rng = np.random.default_rng(5)
    n = 8
    tree = {"b": torch.from_numpy(rng.standard_normal((n, 5, 7)).astype(np.float32)),
            "a": [torch.from_numpy(rng.standard_normal((n, 300)).astype(np.float32))]}
    rel = Relation.from_edges([(0, 1), (1, 2), (2, 3), (3, 0), (0, 2), (4, 5), (5, 6)],
                              nodes=range(n))
    got = tdm.gossip_avg_tree(tree, rel, n)
    assert torch.equal(got["b"], tdm.gossip_avg(tree["b"], rel, n))
    assert torch.equal(got["a"][0], tdm.gossip_avg(tree["a"][0], rel, n))
