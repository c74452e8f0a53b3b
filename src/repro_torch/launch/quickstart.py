"""Quickstart on the PyTorch port: the paper's universal TDM algorithm.

Counterpart of ``examples/quickstart.py``:

1. Build exchange relations (paper §II) and check their algebra.
2. Run the paper-faithful getMeas simulator (Algorithm 1).
3. Train a small LM for a few steps with the port's trainer
   (:func:`repro_torch.launch.train.main`, the example's arguments).

Run:  PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu]

Parts 1-2 run on the host; part 3 on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse

from repro_torch.core.ptbfla_sim import run_schedule_get1meas, run_schedule_getmeas
from repro_torch.core.relation import Relation
from repro_torch.core.schedule import clique_multilink, round_robin_tournament
from repro_torch.launch import train as train_lib

TRAIN_ARGV = ["--arch", "mamba2-780m", "--smoke", "--steps", "15",
              "--batch", "8", "--seq", "64", "--lr", "5e-3", "--log-every", "3"]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="torch device of part 3 (default: the card; 'cpu' runs the plain "
                        "versions)")
    args = p.parse_args(argv)

    # --- 1. relations: R2 = {(a,b),(b,a),(b,c),(c,b)} from the paper -------
    a, b, c = 0, 1, 2
    r2 = Relation.from_pairs([(a, b), (b, a), (b, c), (c, b)])
    print("R2 valid exchange:", r2.is_valid_exchange())
    print("R2 == its inverse (P1):", r2.inverse().pairs == r2.pairs)
    print("b's peers (needs 2 antennas):", r2.peers_of(b))

    # propagation (P2): a's data reaches c through b over two slots
    r21 = Relation.from_pairs([(a, b), (b, a)])
    r22 = Relation.from_pairs([(b, c), (c, b)])
    print("R21∘R22 ∪ R22∘R21 =", sorted(r21.propagation(r22).pairs))

    # --- 2. Algorithm 1 on a 6-node clique ---------------------------------
    n = 6
    data = {i: f"odata-{i}" for i in range(n)}
    got_multi, sim_m = run_schedule_getmeas(clique_multilink(n), data, n)
    got_pair, sim_p = run_schedule_get1meas(round_robin_tournament(n), data, n)
    print(f"\ngetMeas  : 1 slot,  {sim_m.total_messages} messages")
    print(f"get1meas : {n-1} slots, {sim_p.total_messages} messages")
    assert {p: v for s in got_multi[0].values() for p, v in s.items()} == {
        p: v for s in got_pair[0].values() for p, v in s.items()
    }
    print("same exchanged data either way (semantic equivalence)")

    # --- 3. train a reduced mamba2 for a few steps -------------------------
    print("\ntraining a reduced mamba2-780m (smoke config):")
    device = [] if args.device is None else ["--device", args.device]
    losses = train_lib.main(TRAIN_ARGV + device)
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f}")
    return losses


if __name__ == "__main__":
    main()
