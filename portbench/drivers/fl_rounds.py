"""TDM-FLA training rounds through the port's FL driver.

The system under test is ``repro_torch.launch.fl_train``: one round is
``fl_train.run`` over one slot relation, that is ``run_tdm_rounds`` calling the
round its ``RoundFnCache`` builds for the relation (``local_steps`` AdamW steps
on each stacked satellite, then the fused TDM exchange). The state is the
benchmark's: its seeded weights, every satellite starting from the same
model, the optimizer's zero moments.

Set-up drives the first ``checked_rounds`` rounds through the same call the
window uses and keeps their readings: each round's loss, each satellite's
first moment after round 1 (the optimizer's view of the first gradients),
and each parameter's change after the last of them. After the window, the
plain reference (:mod:`portbench.refs.fltrain`) follows those rounds from
the seed, and the gaps are compared.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from portbench import harness, weights
from portbench.refs import fltrain


@dataclasses.dataclass
class Job:
    state: Any
    cache: Any
    relations: list
    program: fltrain.Readings


def batch(run, rnd: int) -> Dict[str, np.ndarray]:
    """Round ``rnd``'s tokens: (nodes, local_steps, rows, seq + 1) drawn
    uniformly over the vocabulary from the seed; tokens and labels overlap by
    one."""
    t = run.traffic
    n = run.config["deployment"]["satellites"]
    shape = (n, t["local_steps"], t["rows"], t["seq"] + 1)
    toks = run.rng(1, rnd).integers(0, run.config["vocab_size"], size=shape, dtype=np.int64)
    return {"tokens": toks[..., :-1].astype(np.int32), "labels": toks[..., 1:].astype(np.int32)}


def _round(run, job: Job, rnd: int, log: bool):
    from repro_torch.launch import fl_train

    rel = job.relations[rnd % len(job.relations)]
    res = fl_train.run(fl_train.TDMRun(job.cache, job.state, [rel], lambda _: batch(run, rnd),
                                       log_every=1 if log else 0))
    job.state = res.state
    return res.final


def leaf_norms(tree, n: int) -> Dict[str, np.ndarray]:
    return {k: t.detach().reshape(n, -1).double().norm(dim=1).cpu().numpy()
            for k, t in weights.leaves(tree)}


def setup(run) -> Job:
    from repro_torch.core.relation import Relation
    from repro_torch.launch import fl_train
    from repro_torch.optim import adamw
    from repro_torch.pytree import tree_map

    t, dep = run.traffic, run.config["deployment"]
    n = dep["satellites"]
    cfg = harness.program_config(run.config)
    if run.device.type == "cuda" and t["compression"] != "none":
        from repro_torch.kernels.tdm_compress import tdm_compress

        tdm_compress.library()                  # built on a checkout's first run
    opt_cfg = adamw.OptConfig(**t["optimizer"])
    p1 = weights.make(run.sizes, run.seed, run.device)
    one = {"params": p1, "opt": adamw.init_opt_state(p1, opt_cfg),
           "step": torch.zeros((), dtype=torch.int32, device=run.device)}
    state = tree_map(lambda x: x.unsqueeze(0).repeat((n,) + (1,) * x.dim()), one)
    del one, p1
    fl_cfg = fl_train.FLConfig(mode="tdm", local_steps=t["local_steps"],
                               compression=t["compression"])
    rels = [Relation.from_edges([tuple(e) for e in r], nodes=range(n)) for r in dep["relations"]]
    job = Job(state, fl_train.RoundFnCache(cfg, opt_cfg, n, fl_cfg), rels,
              fltrain.Readings(losses=[], mu={}, change={}))
    for rnd in range(t["checked_rounds"]):
        job.program.losses.append(float(_round(run, job, rnd, log=True).loss))
        if rnd == 0:
            job.program.mu = leaf_norms(job.state["opt"]["mu"], n)
    p0 = weights.make(run.sizes, run.seed, run.device)
    job.program.change = {
        k: (t_ - p0_leaf).reshape(n, -1).double().norm(dim=1).cpu().numpy()
        for (k, t_), (_, p0_leaf) in zip(weights.leaves(job.state["params"]),
                                          weights.leaves(p0))}
    del p0
    return job


def window(run, job: Job) -> dict:
    rnd = run.traffic["checked_rounds"]
    units = 0
    run.open_window()
    while run.open():
        _round(run, job, rnd + units, log=False)
        units += 1
        run.done_unit(units)
    seconds = run.close_window()
    nodes = run.config["deployment"]["satellites"]
    tokens = nodes * run.traffic["local_steps"] * run.traffic["rows"] * run.traffic["seq"]
    run.stats.update(round_flops=tokens * run.sizes.train_flops_per_token(), rounds=units)
    return {"metrics": {"fl_round_s": seconds / units}, "attempted": units, "failed": 0}


def check(run, job: Job, out) -> Dict[str, float]:
    program = job.program
    job.state = job.cache = None
    harness.free_device()
    ref = fltrain.follow(run, batch)
    return fltrain.gaps(program, ref)
