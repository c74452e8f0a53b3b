"""Decentralized FL over a constellation's geometry-derived ISL visibility,
on the PyTorch port: the counterpart of ``examples/train_fl_constellation.py
--mode tdm``.

8 MEO satellites in a 2-plane Walker pattern, stacked as 8 FL nodes on one
device, each training mamba2-780m (the smoke widths by default, the
published widths with ``--full-width``) on its own data shard. Nodes talk
only through the universal TDM exchange over each contact-plan step's
visibility relation; after round ``--fail-round`` satellite 3 is lost and
drops out of later relations (skip-slot semantics) while training goes on.

    PYTHONPATH=src python -m repro_torch.launch.train_fl_constellation \\
        [--device cuda|cpu] [--compression none|int8|topk] [--rounds 10] \\
        [--layers N] [--seq 32] [--full-width]
"""

from __future__ import annotations

import argparse
from typing import Callable, Optional

import numpy as np

from repro_torch.configs import archs
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


def setup(n_sats: int, rounds: int = ROUNDS, *, layers: Optional[int] = None,
          seq: int = 32, full_width: bool = False):
    """(model cfg, opt cfg, per-node batch shape, scenario) of the example:
    mamba2-780m, AdamW warming up over 2 steps, 4 rows x ``seq`` tokens per
    node and step, an O3b-style MEO shell with a 14,000 km ISL range gate."""
    base = archs.get("mamba2-780m")
    cfg = base if full_width else archs.smoke_cfg(base)
    if layers is not None:
        cfg = cfg.replace(n_layers=layers)
    opt_cfg = adamw.OptConfig(peak_lr=5e-3, warmup_steps=2, decay_steps=100)
    shape = ShapeConfig("fl", "train", seq, ROWS)
    scn = build_scenario(ScenarioSpec(
        shells=(ShellSpec(planes=2, per_plane=n_sats // 2),),
        n_ground=0,
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


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--compression", choices=("none", "int8", "topk"), default="none")
    p.add_argument("--rounds", type=int, default=ROUNDS)
    p.add_argument("--layers", type=int, default=None,
                   help="override the model's depth")
    p.add_argument("--seq", type=int, default=32, help="tokens per row")
    p.add_argument("--full-width", action="store_true",
                   help="mamba2-780m's published widths instead of the smoke widths")
    p.add_argument("--fail-round", type=int, default=6,
                   help="satellite 3 is lost after this round")
    args = p.parse_args(argv)
    main_tdm(args.rounds, device=args.device, compression=args.compression,
             layers=args.layers, seq=args.seq, full_width=args.full_width,
             fail_round=args.fail_round)


if __name__ == "__main__":
    main()
