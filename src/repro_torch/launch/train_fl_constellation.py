"""FL over a constellation's geometry-derived ISL visibility, on the PyTorch
port: the counterpart of ``examples/train_fl_constellation.py``.

Every node trains mamba2-780m (the smoke widths by default, the published
widths with ``--full-width``) on its own data shard, all nodes stacked on
one device. Two modes (``--mode``):

- ``tdm`` (default): decentralized FL. 8 MEO satellites in a 2-plane Walker
  pattern talk only through the universal TDM exchange over each
  contact-plan step's visibility relation; after round ``--fail-round``
  satellite 3 is lost and drops out of later relations (skip-slot
  semantics) while training goes on.
- ``groundseg``: the paper's centralized FLA over the ground segment. 6
  satellites and 2 ground stations (8 nodes): satellite params relay
  store-and-forward to the ground sinks along earliest-delivery routes,
  the sinks FedAvg (hierarchical: regional, pooled every other round), and
  the global model floods back on the downlink slots.
  ``--pipeline-depth 2`` overlaps round r's downlink with round r+1's
  uplink; ``--max-staleness K`` lets undelivered payloads persist up to K
  windows. Satellite 2 is lost after round ``min(6, rounds - 2)``.

    PYTHONPATH=src python -m repro_torch.launch.train_fl_constellation \\
        [--mode tdm|groundseg] [--device cuda|cpu] [--compression none|int8|topk] \\
        [--rounds 10] [--layers N] [--seq 32] [--full-width] \\
        [--pipeline-depth 1|2] [--max-staleness K]
"""

from __future__ import annotations

import argparse
from typing import Callable, Optional

import numpy as np

from repro_torch.configs import archs
from repro_torch.constellation import cost
from repro_torch.constellation.scenario import ScenarioSpec, ShellSpec, build_scenario
from repro_torch.data import pipeline
from repro_torch.launch import fl_train
from repro_torch.models.config import ShapeConfig
from repro_torch.optim import adamw

ROUNDS = 10
LOCAL_STEPS = 2
ROWS = 4                    # per-node batch rows per local step
N_SATS = 8
LOST_SATELLITE = 3
GS_SATS = 6                 # groundseg: satellites, plus GS_GROUND sinks
GS_GROUND = 2
GS_LOST_SATELLITE = 2
PAYLOAD_BYTES = 1 << 22     # payload size the schedule's slots are sized for


def setup(n_sats: int, rounds: int = ROUNDS, *, n_ground: int = 0,
          layers: Optional[int] = None, seq: int = 32, full_width: bool = False):
    """(model cfg, opt cfg, per-node batch shape, scenario) of the example:
    mamba2-780m, AdamW warming up over 2 steps, 4 rows x ``seq`` tokens per
    node and step, an O3b-style MEO shell with a 14,000 km ISL range gate
    and ``n_ground`` ground stations."""
    base = archs.get("mamba2-780m")
    cfg = base if full_width else archs.smoke_cfg(base)
    if layers is not None:
        cfg = cfg.replace(n_layers=layers)
    opt_cfg = adamw.OptConfig(peak_lr=5e-3, warmup_steps=2, decay_steps=100)
    shape = ShapeConfig("fl", "train", seq, ROWS)
    scn = build_scenario(ScenarioSpec(
        shells=(ShellSpec(planes=2, per_plane=n_sats // 2),),
        n_ground=n_ground,
        steps=max(rounds, 4),
        max_range_km=14_000.0,
    ))
    return cfg, opt_cfg, shape, scn


def make_batch_fn(cfg, shape, n_nodes: int, local_steps: int = LOCAL_STEPS) -> Callable:
    """round -> {"tokens", "labels"}: (n_nodes, local_steps, rows, seq) int32,
    node ``sat`` drawing from seed 1000 + sat (the example's data)."""
    def batch_fn(round_idx):
        per_node = []
        for sat in range(n_nodes):
            bs = [
                pipeline.host_batch(cfg, shape, step=round_idx * local_steps + h,
                                    seed=1000 + sat)
                for h in range(local_steps)
            ]
            per_node.append({k: np.stack([b[k] for b in bs]) for k in bs[0]})
        return {k: np.stack([pn[k] for pn in per_node]) for k in per_node[0]}

    return batch_fn


def main_tdm(rounds: int = ROUNDS, *, device=None, compression: str = "none",
             layers: Optional[int] = None, seq: int = 32, full_width: bool = False,
             fail_round: int = 6, on_round: Optional[Callable] = None):
    """Run the constellation FL example; returns (RunResult, scenario).
    ``on_round`` is called with each RoundLog after the example's own
    handling (printing, and losing satellite 3 after ``fail_round``)."""
    cfg, opt_cfg, shape, scn = setup(
        N_SATS, rounds, layers=layers, seq=seq, full_width=full_width
    )
    geom, plan = scn.geom, scn.plan
    fl_cfg = fl_train.FLConfig(mode="tdm", local_steps=LOCAL_STEPS, compression=compression)
    print(f"{N_SATS} satellites, Walker delta {geom.planes}-plane @ "
          f"{geom.altitude_km:.0f} km (period {geom.period_s / 60:.0f} min): "
          f"{len(plan.windows())} contact windows; model {cfg.name} "
          f"{cfg.n_layers} layers d={cfg.d_model}, compression {compression}")
    state = fl_train._stack_init(0, cfg, opt_cfg, N_SATS, device=device)
    alive = set(range(N_SATS))

    def handle(log):
        print(f"round {log.round:2d}  mean-loss {log.loss:7.4f}  "
              f"consensus-dist {log.consensus:.4f}  links {log.n_links}  "
              f"alive {log.alive}")
        if log.round == fail_round:
            alive.discard(LOST_SATELLITE)
            print(f"  !! satellite {LOST_SATELLITE} lost — rescheduling "
                  "(skip-slot semantics)")
        if on_round is not None:
            on_round(log)

    res = fl_train.run(fl_train.ConstellationRun(
        cfg, opt_cfg, N_SATS, fl_cfg, plan, state,
        make_batch_fn(cfg, shape, N_SATS),
        rounds=rounds, alive=alive, on_round=handle,
    ))
    if res.final is not None:
        print(f"done — {res.n_rounds} rounds (consensus {res.final.consensus:.4f})")
    return res, scn


def main_groundseg(rounds: int = ROUNDS, *, device=None, compression: str = "none",
                   pipeline_depth: int = 1, max_staleness: int = 0,
                   layers: Optional[int] = None, seq: int = 32, full_width: bool = False,
                   on_round: Optional[Callable] = None):
    """Run the ground-segment FL example; returns (RunResult, scenario).
    ``on_round`` is called with each GroundSegRoundLog after the example's
    own handling (printing, and losing satellite 2 after round
    ``min(6, rounds - 2)``)."""
    cfg, opt_cfg, shape, scn = setup(
        GS_SATS, rounds, n_ground=GS_GROUND, layers=layers, seq=seq,
        full_width=full_width,
    )
    geom, plan = scn.geom, scn.plan
    n_nodes = scn.n_nodes
    sinks = scn.ground_ids
    fl_cfg = fl_train.FLConfig(mode="tdm", local_steps=LOCAL_STEPS)
    gs_cfg = fl_train.GroundSegConfig(
        mode="hierarchical", sink_sync_every=2, compression=compression,
        pipeline_depth=pipeline_depth,
        max_staleness_windows=max_staleness,
    )
    est = cost.groundseg_mode_costs(
        plan, sinks, PAYLOAD_BYTES, antennas=2, pipeline_depth=pipeline_depth
    )
    print(f"{GS_SATS} satellites + {len(scn.ground_stations)} ground sinks, Walker "
          f"delta {geom.planes}-plane @ {geom.altitude_km:.0f} km (pipeline depth "
          f"{pipeline_depth}, staleness horizon {max_staleness}); model {cfg.name} "
          f"{cfg.n_layers} layers d={cfg.d_model}, compression {compression}")
    for mode in ("centralized", "gossip_getmeas"):
        rc = est[mode]
        print(f"  {mode:<16} est round {rc.time_s:9.1f} s, "
              f"{rc.bytes_on_isl / 1e9:.2f} GB on ISL")
    state = fl_train._stack_init(0, cfg, opt_cfg, n_nodes, device=device)
    alive = set(range(n_nodes))
    # lose a satellite one round before the end, so that a later round
    # exercises the rerouting (rounds=2: lost after round 0)
    fail_round = min(6, rounds - 2)

    def handle(log):
        print(f"round {log.round:2d}  sat-loss {log.loss:7.4f}  "
              f"consensus-dist {log.consensus:.4f}  delivered {log.delivered}/"
              f"{log.alive}  covered {log.covered}  carried {log.carried}  "
              f"dropped {log.dropped}  {'pooled' if log.pooled else 'regional'}")
        if log.round == fail_round:
            alive.discard(GS_LOST_SATELLITE)
            print(f"  !! satellite {GS_LOST_SATELLITE} lost — rerouting "
                  "(skip-slot semantics)")
        if on_round is not None:
            on_round(log)

    res = fl_train.run(fl_train.GroundSegRun(
        cfg, opt_cfg, n_nodes, fl_cfg, gs_cfg, plan, state,
        make_batch_fn(cfg, shape, n_nodes),
        sinks=sinks, rounds=rounds, alive=alive, on_round=handle,
        antennas=2, payload_bytes=PAYLOAD_BYTES,
    ))
    survivors = [v for v in range(GS_SATS) if v in alive]
    print("done — surviving satellites aggregated through the ground segment "
          f"(consensus {fl_train.consensus_distance(res.state['params'], rows=survivors):.4f})")
    return res, scn


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mode", choices=("tdm", "groundseg"), default="tdm")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--compression", choices=("none", "int8", "topk"), default="none",
                   help="groundseg takes none or int8")
    p.add_argument("--rounds", type=int, default=ROUNDS)
    p.add_argument("--layers", type=int, default=None,
                   help="override the model's depth")
    p.add_argument("--seq", type=int, default=32, help="tokens per row")
    p.add_argument("--full-width", action="store_true",
                   help="mamba2-780m's published widths instead of the smoke widths")
    p.add_argument("--fail-round", type=int, default=6,
                   help="tdm: satellite 3 is lost after this round")
    p.add_argument("--pipeline-depth", type=int, default=1, choices=(1, 2),
                   help="groundseg: overlap round r's downlink with round "
                        "r+1's uplink in one contact window")
    p.add_argument("--max-staleness", type=int, default=0,
                   help="groundseg: windows an undelivered payload persists "
                        "before it is dropped and reported")
    args = p.parse_args(argv)
    if args.mode == "groundseg":
        if args.compression == "topk":
            p.error("--mode groundseg takes --compression none or int8 (top-k/CHOCO "
                    "is stateful per relation and does not fit a one-shot relay hop)")
        main_groundseg(args.rounds, device=args.device, compression=args.compression,
                       pipeline_depth=args.pipeline_depth,
                       max_staleness=args.max_staleness, layers=args.layers,
                       seq=args.seq, full_width=args.full_width)
    else:
        main_tdm(args.rounds, device=args.device, compression=args.compression,
                 layers=args.layers, seq=args.seq, full_width=args.full_width,
                 fail_round=args.fail_round)


if __name__ == "__main__":
    main()
