"""The TDM exchange on its own: one ``repro_torch.core.fl.tdm_fla_round`` a
slot over the deployment's contact relations in order, cycled, on the
stacked satellites' parameters, each slot mixing what the last one returned.
No local training. Each satellite's model is drawn separately from the
seed, so every block carries different values.

The reference checks slot 0, which mixes the benchmark's own weights, and
one slot drawn from the seed further down the chain, which mixes the
program's output of the slot before it; the window keeps both slots' input
and output (references only, nothing is copied in the window).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

from portbench import counts, weights
from portbench.refs import gossip

LEVELS = {"int8": 127, "int4": 7}


@dataclasses.dataclass
class Job:
    params: Any
    relations: list
    cfg: Any
    sample: List[int]
    kept: Dict[int, tuple] = dataclasses.field(default_factory=dict)


def setup(run) -> Job:
    from repro_torch.core import fl
    from repro_torch.core.relation import Relation

    t, dep = run.traffic, run.config["deployment"]
    n = dep["satellites"]
    if run.device.type == "cuda" and t["compression"] != "none":
        from repro_torch.kernels.tdm_compress import tdm_compress

        tdm_compress.library()
    rels = [Relation.from_edges([tuple(e) for e in r], nodes=range(n)) for r in dep["relations"]]
    cfg = fl.TDMFLAConfig(compression=t["compression"])
    x0 = weights.make(run.sizes, run.seed, run.device, nodes=n)
    lo, hi = t["sample_slot"]
    job = Job(x0, rels, cfg, sample=[0, int(run.rng(2).integers(lo, hi + 1))])
    fl.tdm_fla_round(x0, rels[0], n, cfg)        # warm: layout, kernels, allocations
    run.sync()
    return job


def window(run, job: Job) -> dict:
    from repro_torch.core import fl

    n = run.config["deployment"]["satellites"]
    units = 0
    params = job.params
    job.params = None
    run.open_window()
    while run.open():
        r = units % len(job.relations)
        out, _ = fl.tdm_fla_round(params, job.relations[r], n, job.cfg)
        if units in job.sample:
            job.kept[units] = (params, out, r)
        params = out
        units += 1
        run.done_unit(units)
    seconds = run.close_window()
    del params, out
    t = run.traffic
    padded = counts.padded(run.sizes.params(), t["block"])
    run.stats.update(slots=units, window_s=seconds - run.paused_s, rows=n, padded=padded, block=t["block"])
    return {"metrics": {"tdm_slot_ms": seconds / units * 1e3}, "attempted": units, "failed": 0}


def gaps(run, job: Job, control: bool = False):
    """The widest gap of a checked slot's output from the plain mix of its
    input, in units of each block's largest |value| (a slot the window did
    not reach reads as failed); with ``control``, also that of the plain mix
    with int4 payloads put in the program's place. Frees what it checked."""
    t, dep = run.traffic, run.config["deployment"]
    levels = LEVELS.get(t["compression"])
    kept, job.kept = job.kept, {}
    worst = 0.0 if all(s in kept for s in job.sample) else float("inf")
    ctl = 0.0
    for s in sorted(kept):
        x_in, x_out, r = kept.pop(s)
        x = gossip.flatten(x_in, t["block"])
        del x_in
        got = gossip.flatten(x_out, t["block"])
        del x_out
        edges = dep["relations"][r]
        worst = max(worst, gossip.mix_gap(got, x, edges, t["block"], levels))
        del got
        if control:
            low = gossip.mix_rows(x, edges, t["block"], LEVELS["int4"])
            ctl = max(ctl, gossip.mix_gap(low, x, edges, t["block"], levels))
            del low
        del x
    return worst, ctl


def check(run, job: Job, out) -> Dict[str, float]:
    return {"mix_gap": gaps(run, job)[0]}
