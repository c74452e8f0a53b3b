"""Constellation serving of NVIDIA-Nemotron-3-Nano (``nemotron_h``) through
the port's engine: ``ServingEngine`` -> ``ReplicaFleet`` -> ``ModelDecoder``
(handed the seeded weights, one copy for both replicas: two would not fit
the card) -> ``transformer.prefill`` / ``decode_step``.

Requests, admission, the window and the delivery are the ``serve`` driver's
(:mod:`portbench.drivers.serve`). This driver brings its own set-up and
check:

- set-up refuses at once, before anything is allocated, a program that has
  no ``nemotron-3-nano-30b-a3b`` arch or runs it at other sizes;
- the routing tally (``moe.count_routes``) is open through set-up in every
  run, and through the window in a traced run, whose decode sums go into
  ``run.stats`` (assignments, experts hit, and the least bytes the MoE
  layers move per tick, from :mod:`portbench.counts_nemotron_h`), with the
  least time of the routed experts' grouped products the profiled stretch
  holds (``moe_stretch_least_s``, read by ``serve_moe_roofline``);
- the check frees the program, makes the weights again from the seed and
  replays the sampled requests through the plain reference
  (:mod:`portbench.refs.nemotron_h`) over their left-padded sequences: the
  gaps of the served tokens' logits below the best, as :func:`gap_checks`
  reduces them (``logit_gap``, ``logit_gap_q90``), the requests finished in the window and not delivered whole
  (``undelivered``), and the assignments the tallied calls dropped
  (``dropped``: the grouping's offsets leave none out, so it reads 0 unless
  the grouping loses rows; an untraced run tallies set-up's calls only).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np
import torch

from portbench import harness, weights_nemotron_h
from portbench.drivers.serve import Job, _step, bucket, collect, requests
from portbench.drivers.serve import window as serve_window
from portbench.refs import nemotron_h as ref

ARCH = "nemotron-3-nano-30b-a3b"


@dataclasses.dataclass
class NemotronJob(Job):
    routes: List[Dict[str, List[Any]]] = dataclasses.field(default_factory=list)


def program_config(config: dict):
    """The port's config of the configuration's arch (its smoke config where
    the file says ``"arch_variant": "smoke"``, the tests' size, at the file's
    precision), its sizes checked against the file. Raises where the program
    has no such arch, before anything is allocated."""
    from repro_torch.configs import archs

    if config["arch"] not in archs.ARCHS:
        raise ValueError(f"the program has no arch {config['arch']!r}")
    cfg = archs.get(config["arch"])
    prec = config["precision"]
    if config.get("arch_variant") == "smoke":
        cfg = archs.smoke_cfg(cfg).replace(param_dtype=prec["params"],
                                          compute_dtype=prec["compute"])
    cfg = cfg.replace(n_layers=int(config["num_hidden_layers"]))
    mb, m = cfg.mamba, cfg.moe
    have = {"hidden_size": cfg.d_model, "vocab_size": cfg.vocab_size,
            "hybrid_override_pattern": cfg.pattern, "mamba_num_heads": mb.heads,
            "mamba_head_dim": mb.head_dim, "n_groups": mb.n_groups,
            "ssm_state_size": mb.d_state, "conv_kernel": mb.d_conv, "chunk_size": mb.chunk,
            "num_attention_heads": cfg.n_heads, "num_key_value_heads": cfg.n_kv_heads,
            "head_dim": cfg.head_dim, "n_routed_experts": m.n_experts,
            "num_experts_per_tok": m.top_k, "moe_intermediate_size": m.d_ff,
            "moe_shared_expert_intermediate_size": m.shared_d_ff,
            "routed_scaling_factor": m.routed_scale, "norm_eps": cfg.norm_eps,
            "tie_word_embeddings": cfg.tie_embeddings, "mlp_hidden_act": cfg.act}
    bad = {k: (v, config[k]) for k, v in have.items() if v != config[k]}
    if bad or not (m.dropless and not cfg.gated_mlp and not cfg.rope and mb.norm_per_group):
        raise ValueError(f"{config['arch']} in the program differs from {config['name']}: "
                         f"{bad}")
    if (cfg.param_dtype, cfg.compute_dtype) != (prec["params"], prec["compute"]):
        raise ValueError(f"{config['arch']} runs {cfg.param_dtype}/{cfg.compute_dtype}, "
                         f"{config['name']} states {prec}")
    return cfg


def make_weights(run) -> dict:
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        run.config["precision"]["params"]]
    return weights_nemotron_h.make(run.sizes, run.seed, run.device, dtype)


def setup(run) -> NemotronJob:
    cfg = program_config(run.config)
    from repro_torch.core.relation import Relation
    from repro_torch.models import moe
    from repro_torch.serving import ModelDecoder, ReplicaFleet, ServingEngine

    t, dep = run.traffic, run.config["deployment"]
    lanes, reps = t["lanes"], dep["replicas"]
    max_len = bucket(t["prompt_len"][1]) + t["max_new"][1] + 1
    with moe.count_routes() as tally:
        dec = ModelDecoder(cfg, len(reps), lanes, max_len, device=run.device,
                           params=make_weights(run))
        # every shape the window meets: prefill of one or both replicas at
        # the prompts' buckets, decode of one or both
        rng = run.rng(4)
        for b in sorted({bucket(t["prompt_len"][0]), bucket(t["prompt_len"][1])}):
            waves = {r: [rng.integers(0, run.config["vocab_size"], b).astype(np.int32)] * lanes
                     for r in range(len(reps))}
            dec.prefill_waves(waves)
            dec.prefill_waves({0: waves[0]})
        for active in ([True] + [False] * (len(reps) - 1), [True] * len(reps)):
            dec.step(np.array(active))
        fleet = ReplicaFleet(reps, lanes, dec)
        slots = [Relation.from_edges([tuple(e) for e in r], nodes=range(dep["nodes"]))
                 for r in dep["slots"]]
        eng = ServingEngine(slots, dep["nodes"], dep["gateways"], fleet,
                            decode_steps_per_slot=t["decode_steps_per_slot"])
        reqs = requests(run)
        arrivals: Dict[int, List[Any]] = {}
        for req in reqs:
            arrivals.setdefault(req.arrival_slot, []).append(req)
        job = NemotronJob(dec, eng, reqs, {}, arrivals)
        full = set()
        for _ in range(t["warmup_max_slots"]):
            admitted = _step(job)
            for rep in reps:
                if sum(reqs[rid].replica == rep for rid in admitted) == lanes:
                    full.add(rep)
            if full == set(reps):
                break
    job.routes.append(tally)
    return job


def _decode_sums(run, tally: Dict[str, List[torch.Tensor]]) -> dict:
    """The decode calls' sums, and the least bytes the MoE layers move per
    tick (each call's experts hit, its tokens)."""
    calls = tally.get("decode", [])
    if not calls:
        return {}
    rows = torch.stack(calls).double().cpu()            # (calls, [assignments, hit, dropped])
    k = run.sizes.num_experts_per_tok
    per_call = [run.sizes.moe_call_least_bytes(float(h), float(a) / k) for a, h, _ in rows]
    ticks = len(calls) / run.sizes.count("E")
    return {"moe_decode_calls": len(calls), "moe_decode_ticks": ticks,
            "moe_decode_assignments": float(rows[:, 0].sum()),
            "moe_decode_hit": float(rows[:, 1].sum()),
            "moe_decode_least_bytes_per_tick": sum(per_call) / ticks}


def _stretch_least_s(run, tally: Dict[str, List[torch.Tensor]], marks: dict) -> dict:
    """The least time of the routed experts' grouped products in the MoE
    calls the profiled stretch holds (the tally's calls between its start
    and its stop), as ``serve_moe_roofline`` sets it against the device time
    of those products."""
    p = run.traffic["profile"]
    a, b = marks.get(p["first"]), marks.get(p["first"] + p["units"])
    if a is None or b is None:
        return {}
    calls = [e for k in tally for e in tally[k][a.get(k, 0):b.get(k, 0)]]
    if not calls:
        return {}
    rows = torch.stack(calls).double().cpu()            # (calls, [assignments, hit, dropped])
    least = sum(run.sizes.routed_least_s(float(h), float(n)) for n, h, _ in rows)
    return {"moe_stretch_calls": len(calls), "moe_stretch_least_s": least}


def _mark_stretch(run, tally: Dict[str, List[torch.Tensor]]) -> dict:
    """Note the tally's lengths where the profiled stretch starts and stops
    (after the units ``done_unit`` starts and stops it on)."""
    marks: Dict[int, Dict[str, int]] = {}
    p = run.traffic["profile"]
    done_unit = run.done_unit

    def done(units: int) -> None:
        done_unit(units)
        if units in (p["first"], p["first"] + p["units"]):
            marks[units] = {k: len(v) for k, v in tally.items()}

    run.done_unit = done
    return marks


def window(run, job: NemotronJob) -> dict:
    if not run.trace:
        return serve_window(run, job)
    from repro_torch import telemetry
    from repro_torch.models import moe

    with moe.count_routes() as tally:
        marks = _mark_stretch(run, tally)
        out = serve_window(run, job)
    job.routes.append(tally)
    run.stats.update(_decode_sums(run, tally))
    run.stats.update(_stretch_least_s(run, tally, marks))
    run.stats["dropped_spans"] = telemetry.get_recorder().counters.get(
        "telemetry.dropped_spans", 0.0)
    return out


def dropped(job: NemotronJob) -> float:
    """Assignments the tallied MoE calls dropped."""
    rows = [e for t in job.routes for calls in t.values() for e in calls]
    return float(torch.stack(rows)[:, 2].sum()) if rows else 0.0


def ref_logits(run, params, seq, first: int, n: int, prec: str = "f32") -> torch.Tensor:
    tok = torch.as_tensor(seq, device=run.device).long()
    with torch.no_grad():
        h = ref.hidden(params, tok, run.config, prec)
        return ref.logits(params, h[first:first + n], prec)


def gaps(run, seqs, served, control: bool = False):
    """The gaps by which each served token's logit lies below the plain
    model's best at its position, and with ``control`` those of the tokens
    the float8 control puts first at the same positions: two lists of
    float32 tensors, one a checked request, its positions in order (the
    control's empty without it)."""
    got_gaps, ctl_gaps = [], []
    with ref.exact_matmuls():
        params = make_weights(run)
        for (seq, first), toks in zip(seqs, served):
            lg = ref_logits(run, params, seq, first, len(toks))
            want = lg.max(dim=-1).values
            got = lg.gather(1, torch.as_tensor(toks, device=run.device)[:, None])[:, 0]
            got_gaps.append((want - got).cpu())
            if control:
                top = ref_logits(run, params, seq, first, len(toks), "fp8").argmax(dim=-1)
                ctl_gaps.append((want - lg.gather(1, top[:, None])[:, 0]).cpu())
    return got_gaps, ctl_gaps


def gap_checks(per_request: List[torch.Tensor]) -> Dict[str, float]:
    """The check's readings of the checked requests' gaps (each inf where no
    token was checked):

    - ``logit_gap``: the largest of the requests' median gaps, so that a
      fault in one lane shows;
    - ``logit_gap_q90``: the 90th percentile over every checked position.

    Neither the widest gap nor the first served token's is a check here:
    with random weights a flip of a near-tied routing choice (sigmoid
    routing is discontinuous) moves a position's hidden state as much as
    the float8 control does, in float32 too, so single gaps reach the
    control's (:func:`first_gap` goes to ``run.stats``)."""
    reqs = [g for g in per_request if g.numel()]
    if not reqs:
        return dict.fromkeys(("logit_gap", "logit_gap_q90"), float("inf"))
    return {"logit_gap": max(float(g.median()) for g in reqs),
            "logit_gap_q90": float(torch.cat(reqs).quantile(0.9))}


def first_gap(per_request: List[torch.Tensor]) -> float:
    """The median over the checked requests of their first served token's
    gap (the prefill's output); inf where none was checked."""
    firsts = [g[0] for g in per_request if g.numel()]
    return float(torch.stack(firsts).median()) if firsts else float("inf")


def release(job: NemotronJob) -> None:
    """Free the program's state: params, caches, engine."""
    job.decoder.params = None
    job.decoder = job.engine = None
    harness.free_device()


def check(run, job: NemotronJob, out) -> Dict[str, float]:
    seqs, served, undelivered = collect(run, job)
    drops = dropped(job)
    release(job)
    run.stats["checked_tokens"] = sum(len(t) for t in served)
    got, _ = gaps(run, seqs, served)
    if any(g.numel() for g in got):
        run.stats["logit_gap_max"] = float(torch.cat(got).max())
        run.stats["logit_gap_first"] = first_gap(got)
    return {**gap_checks(got), "undelivered": float(undelivered), "dropped": drops}
