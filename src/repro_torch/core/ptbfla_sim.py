"""Paper-faithful PTB-FLA simulator: Algorithm 1 (`getMeas`) line-for-line.

This is the reproduction FLOOR: the paper's generic algorithm exactly as
published (§III.B, Algorithm 1), including the `timeSlotsMap` reorder buffer
for messages from *faster peers* in future slots, the skip-slot semantics
(`odata=None`), and the original pairwise `get1meas` primitive it
generalizes.

The paper runs one OS process per node over TCP. Here nodes are simulated
processes driven by a deterministic discrete-event scheduler with FIFO
channels and *adversarially chosen* interleavings (seeded), so tests can
exercise exactly the out-of-order situations the `timeSlotsMap` exists for —
a fast peer racing ahead and sending its slot-(t+1) message before this node
finished slot t.

The stacked exchange (:mod:`repro_torch.core.tdm`) is tested for equivalence
against this oracle.
"""

from __future__ import annotations

import random
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.schedule import TDMSchedule


class _Recv:
    """Sentinel yielded by a node coroutine when it blocks on rcvMsg()."""


@dataclass
class _Node:
    """One PTB-FLA application instance (paper: node n_i running a_i, t_i)."""

    node_id: int
    # PTB-FLA instance data (paper Algorithm 1, line 01)
    time_slot: int = 0
    time_slots_map: Dict[Tuple[int, int], list] = field(default_factory=dict)
    inbox: Deque[list] = field(default_factory=deque)

    # stats for the evaluation section
    n_sent: int = 0
    n_received: int = 0
    n_buffered: int = 0  # messages that went through timeSlotsMap


class PTBFLASimulator:
    """Deterministic discrete-event testbed running the paper's algorithms.

    ``programs[i]`` is a generator function taking (node, api) and yielding
    at every blocking receive; the scheduler interleaves ready nodes in a
    seeded random order, modelling nodes running at different speeds.
    """

    def __init__(self, n_nodes: int, seed: int = 0):
        self.nodes = [_Node(i) for i in range(n_nodes)]
        self.rng = random.Random(seed)
        self.total_messages = 0

    # -------------------------------------------------------- message layer
    def send_msg(self, src: int, dst: int, msg: list) -> None:
        """sendMsg(peerId, [timeSlot, nodeId, odata]) — FIFO per channel."""
        self.nodes[dst].inbox.append(list(msg))
        self.nodes[src].n_sent += 1
        self.total_messages += 1

    # -------------------------------------------------------- Algorithm 1
    def get_meas(self, node: _Node, peer_ids: Sequence[int], odata: Any):
        """The paper's getMeas, as a coroutine (yields while blocked on recv).

        Transcribed from Algorithm 1; line numbers in comments refer to the
        paper's listing.
        """
        # 03-06: odata None => skip this time slot
        if odata is None:
            node.time_slot += 1              # 05
            return None                      # 06 (generator: raise StopIteration w/ None)

        # 07-09: send own odata to the peers
        for peer_id in peer_ids:             # 08
            self.send_msg(node.node_id, peer_id, [node.time_slot, node.node_id, odata])  # 09

        # 10-26: then receive peers' odata
        peer_odatas: List[Any] = []          # 10
        for peer_id in peer_ids:             # 11
            if (node.time_slot, peer_id) in node.time_slots_map:       # 12
                msg = node.time_slots_map[(node.time_slot, peer_id)]   # 13
                del node.time_slots_map[(node.time_slot, peer_id)]     # 14
            else:                            # 15
                while True:                  # 16
                    while not node.inbox:    # rcvMsg blocks on empty inbox
                        yield _Recv()
                    msg = node.inbox.popleft()                          # 17
                    node.n_received += 1
                    peer_time_slot, peer_node_id, peer_odata = msg      # 18
                    if (peer_time_slot, peer_node_id) != (node.time_slot, peer_id):  # 19
                        node.time_slots_map[(peer_time_slot, peer_node_id)] = msg    # 20
                        node.n_buffered += 1
                        continue             # 21
                    break                    # 23
            peer_time_slot, peer_node_id, peer_odata = msg              # 25
            peer_odatas.append(peer_odata)   # 26
        node.time_slot += 1                  # 27
        return peer_odatas                   # 28

    def get1_meas(self, node: _Node, peer_id: Optional[int], odata: Any):
        """The ORIGINAL pairwise primitive the paper generalizes: exactly one
        peer per slot (single-antenna satellite); peer_id None skips."""
        if peer_id is None or odata is None:
            node.time_slot += 1
            return None
        result = yield from self.get_meas(node, [peer_id], odata)
        return result

    # ----------------------------------------------------------- scheduler
    def run(self, programs: Dict[int, Callable]) -> Dict[int, Any]:
        """Run one coroutine per node to completion with seeded interleaving.

        ``programs[i]`` = generator function(node) -> yields on blocked recv,
        returns the node's final result. Nodes not in ``programs`` idle.
        """

        results: Dict[int, Any] = {}
        gens: Dict[int, Any] = {}
        for i, prog in programs.items():
            gens[i] = prog(self.nodes[i])

        ready = list(gens.keys())
        blocked: List[int] = []
        steps = 0
        limit = 10_000_000
        while ready or blocked:
            # wake any blocked node whose inbox is non-empty
            still_blocked = []
            for i in blocked:
                if self.nodes[i].inbox:
                    ready.append(i)
                else:
                    still_blocked.append(i)
            blocked = still_blocked
            if not ready:
                raise RuntimeError(
                    f"deadlock: nodes {sorted(blocked)} blocked on recv with empty "
                    f"inboxes — schedule is not a valid exchange relation?"
                )
            # adversarial interleaving: run a random ready node one step
            i = ready.pop(self.rng.randrange(len(ready)))
            try:
                gens[i].send(None)  # first send(None) primes the generator
                # yielded => blocked on recv
                blocked.append(i)
            except StopIteration as stop:
                results[i] = stop.value
            steps += 1
            if steps > limit:  # pragma: no cover
                raise RuntimeError("scheduler step limit exceeded")
        return results


# ---------------------------------------------------------------------------
# Whole-schedule drivers (used by tests, benchmarks, and the FL layer)
# ---------------------------------------------------------------------------

def run_schedule_getmeas(
    schedule: TDMSchedule,
    data: Dict[int, Any],
    n_nodes: int,
    seed: int = 0,
) -> Tuple[Dict[int, Dict[int, Any]], PTBFLASimulator]:
    """Run a TDM schedule where each slot uses getMeas (multi-link).

    Returns ``received[node][slot] = {peer: odata}`` plus the simulator (for
    message stats). ``data[node]`` may be a constant or a fn(slot) -> odata.
    """
    sim = PTBFLASimulator(n_nodes, seed=seed)

    def make_prog(node_id: int):
        def prog(node: _Node):
            out: Dict[int, Dict[int, Any]] = {}
            for t, rel in enumerate(schedule):
                peer_ids = rel.peers_of(node_id)
                odata = data[node_id](t) if callable(data.get(node_id)) else data.get(node_id)
                if not peer_ids:
                    res = yield from _as_gen(sim.get_meas(node, peer_ids, None))
                else:
                    res = yield from _as_gen(sim.get_meas(node, peer_ids, odata))
                if res is not None:
                    out[t] = dict(zip(peer_ids, res))
            return out

        return prog

    results = sim.run({i: make_prog(i) for i in range(n_nodes)})
    return results, sim


def run_schedule_get1meas(
    schedule: TDMSchedule,
    data: Dict[int, Any],
    n_nodes: int,
    seed: int = 0,
) -> Tuple[Dict[int, Dict[int, Any]], PTBFLASimulator]:
    """Run a pairwise schedule (every slot must be a matching) with get1meas."""
    for t, rel in enumerate(schedule):
        if not rel.is_matching():
            raise ValueError(
                f"slot {t} has a node with >1 peers; get1meas supports only "
                f"pairwise exchange (the limitation the paper removes)"
            )
    sim = PTBFLASimulator(n_nodes, seed=seed)

    def make_prog(node_id: int):
        def prog(node: _Node):
            out: Dict[int, Dict[int, Any]] = {}
            for t, rel in enumerate(schedule):
                peers = rel.peers_of(node_id)
                peer = peers[0] if peers else None
                odata = data[node_id](t) if callable(data.get(node_id)) else data.get(node_id)
                res = yield from _as_gen(sim.get1_meas(node, peer, odata))
                if res is not None:
                    out[t] = {peer: res[0]}
            return out

        return prog

    results = sim.run({i: make_prog(i) for i in range(n_nodes)})
    return results, sim


def _as_gen(gen_or_value):
    """getMeas returns a generator (it may yield) — delegate; plain values
    (skip path returns immediately) pass through."""
    if hasattr(gen_or_value, "send"):
        result = yield from gen_or_value
        return result
    return gen_or_value
