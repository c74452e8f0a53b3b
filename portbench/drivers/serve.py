"""Constellation serving through the port's engine: ``ServingEngine.step``
with a ``ModelDecoder`` (one tick a slot) over the deployment's TDM slots,
requests arriving at the gateways at a fixed rate a slot.

Requests: prompt lengths and new-token counts are the evenly spaced
quantiles of their ranges, the same set for every seed, each list shuffled
by the seed; prompt tokens are drawn uniformly over the vocabulary; greedy
decoding; gateways alternate. The rate is far above what the replicas
serve (their waves take ~100 slots for 16 requests each), so their queues
grow through the run and a replica never waits for work; set-up serves until
each replica has admitted a full wave, so the window sees steady waves.

Each token is timed by the host clock when the step that made it returns
(the step copies its tokens to the host). After the window the engine runs on
until every request finished in the window is delivered; a sample of them
(the longest, and others drawn from the seed) is replayed through the plain
model over its left-padded prompt and its served tokens.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List

import numpy as np
import torch

from portbench import harness, weights
from portbench.refs import mamba2


@dataclasses.dataclass
class Job:
    decoder: Any
    engine: Any
    requests: List[Any]
    slot_of: Dict[int, int]                     # rid -> the slot it was admitted in
    arrivals: Dict[int, List[Any]]
    done: List[int] = dataclasses.field(default_factory=list)   # finished in the window


def requests(run) -> List[Any]:
    from repro_torch.serving import requests as rq

    t = run.traffic
    N = t["requests"]
    q = (np.arange(N) + 0.5) / N
    (p_lo, p_hi), (m_lo, m_hi) = t["prompt_len"], t["max_new"]
    plen = run.rng(3, 0).permutation(np.rint(p_lo + q * (p_hi - p_lo)).astype(np.int64))
    new = run.rng(3, 1).permutation(np.rint(m_lo + q * (m_hi - m_lo)).astype(np.int64))
    rng = run.rng(3, 2)
    gws = run.config["deployment"]["gateways"]
    rate = t["arrivals_per_slot"]
    return [rq.InferenceRequest(
        rid=k, gateway=int(gws[k % len(gws)]),
        prompt=rng.integers(0, run.config["vocab_size"], int(plen[k])).astype(np.int32),
        max_new=int(new[k]), arrival_slot=int(k // rate)) for k in range(N)]


def bucket(plen: int) -> int:
    """The prefill's prompt length: the power of two, at least 8, that holds
    the call's longest prompt (prompts are left-padded with token 0)."""
    b = 8
    while b < plen:
        b *= 2
    return b


def _step(job: Job) -> List[int]:
    """One engine slot (its arrivals first); returns the rids admitted."""
    eng = job.engine
    for req in job.arrivals.pop(eng.slot, ()):
        eng.submit(req)
    eng.step()
    admitted = list(eng.records[-1].admitted)
    for rid in admitted:
        job.slot_of[rid] = eng.records[-1].slot
    return admitted


def setup(run) -> Job:
    from repro_torch.core.relation import Relation
    from repro_torch.serving import ModelDecoder, ReplicaFleet, ServingEngine

    t, dep = run.traffic, run.config["deployment"]
    cfg = harness.program_config(run.config)
    lanes, reps = t["lanes"], dep["replicas"]
    max_len = bucket(t["prompt_len"][1]) + t["max_new"][1] + 1
    dec = ModelDecoder(cfg, len(reps), lanes, max_len, seed=0, device=run.device)
    dec.params = weights.make(run.sizes, run.seed, run.device)
    # every shape the window meets: prefill of one or both replicas at the
    # prompts' buckets, decode of one or both
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
    job = Job(dec, eng, reqs, {}, arrivals)
    full = set()
    for _ in range(t["warmup_max_slots"]):
        admitted = _step(job)
        for rep in reps:
            if sum(reqs[rid].replica == rep for rid in admitted) == lanes:
                full.add(rep)
        if full == set(reps):
            break
    return job


def window(run, job: Job) -> dict:
    t = run.traffic
    sizes = run.sizes
    live: Dict[int, Any] = {}
    seen: Dict[int, int] = {}
    times: Dict[int, List[float]] = {}
    done: List[int] = []
    flops = 0.0
    units = 0
    # the waves in flight when the window opens: their later tokens count,
    # the gap from a token before the window to one inside it does not
    for sat in job.engine.fleet.replica_ids:
        for req in job.engine.fleet.lanes[sat]:
            if req is not None and not req.done:
                live[req.rid], seen[req.rid], times[req.rid] = req, len(req.out), []
    run.open_window()
    while run.open():
        admitted = _step(job)
        now = time.perf_counter()
        for rid in admitted:
            live[rid] = job.requests[rid]
            seen[rid] = 0
            times[rid] = []
            flops += len(job.requests[rid].prompt) * sizes.prompt_flops_per_token()
        for rid, req in list(live.items()):
            n = len(req.out)
            for k in range(seen[rid], n):
                times[rid].append(now)
                flops += sizes.generated_flops(from_decode=k > 0)
            seen[rid] = n
            if req.done:
                done.append(rid)
                del live[rid]
        units += 1
        run.done_unit(units)
    seconds = run.close_window()
    s0, s1 = run.stretch_clock          # the profiled stretch slows what it holds
    gaps = [b - a for ts in times.values() for a, b in zip(ts, ts[1:])
            if b <= s0 or a >= s1]
    tokens = sum(len(ts) for ts in times.values())
    if not gaps:
        raise RuntimeError("the window saw no request make two tokens")
    # deliver what the window finished
    extra = 0
    while extra < t["deliver_max_slots"] and not all(job.requests[r].delivered for r in done):
        _step(job)
        extra += 1
    queued = sum(job.engine.fleet.queued(s) for s in job.engine.fleet.replica_ids)
    run.stats.update(serve_flops=flops, window_s=seconds - run.paused_s, slots=units, tokens=tokens,
                     finished=len(done), queued_at_close=queued,
                     itl_p95_ms=float(np.percentile(gaps, 95)) * 1e3, itl_gaps=len(gaps))
    job.done[:] = done
    return {"metrics": {"serve_tokens_per_s": tokens / seconds},
            "attempted": len(done),
            "failed": sum(not job.requests[r].delivered for r in done)}


def sample(run, job: Job) -> List[Any]:
    """The checked requests: the one with the most served tokens, and
    others drawn from the seed among the rest finished in the window."""
    reqs = [job.requests[r] for r in job.done]
    if not reqs:
        return []
    longest = max(reqs, key=lambda r: (len(r.out), -r.rid))
    rest = [r for r in reqs if r is not longest]
    k = min(run.traffic["checked_requests"] - 1, len(rest))
    picks = run.rng(5).choice(len(rest), size=k, replace=False) if k else []
    return [longest] + [rest[i] for i in sorted(picks)]


def sequences(job: Job, reqs: List[Any]) -> List[tuple]:
    """(token ids the model saw, index of the first served position) per
    request: the prompt left-padded to its prefill call's bucket, then every
    served token but the last."""
    by_slot: Dict[int, int] = {}
    for rid, slot in job.slot_of.items():
        by_slot[slot] = max(by_slot.get(slot, 0), len(job.requests[rid].prompt))
    out = []
    for r in reqs:
        b = bucket(by_slot[job.slot_of[r.rid]])
        seq = np.concatenate([np.zeros(b - len(r.prompt), np.int64), r.prompt,
                              np.asarray(r.out[:-1], np.int64)])
        out.append((seq, b - 1))
    return out


def ref_logits(run, params, seq, first: int, n: int, prec: str = "f32") -> torch.Tensor:
    tok = torch.as_tensor(seq, device=run.device).long()[None]
    with torch.no_grad():
        h = mamba2.hidden(params, tok, run.sizes, run.config["norm_eps"], prec)
        return mamba2.logits(params, h[:, first:first + n], prec)[0]


def collect(run, job: Job):
    """What the check reads of the window, taken before the program's state
    is freed: the sampled requests' sequences and served tokens, and how
    many requests finished in the window were not delivered whole."""
    reqs = sample(run, job)
    undelivered = sum(not (job.requests[r].delivered
                           and len(job.requests[r].out) == job.requests[r].max_new)
                      for r in job.done)
    return sequences(job, reqs), [list(r.out) for r in reqs], undelivered


def gaps(run, seqs, served, control: bool = False):
    """The widest gap by which a served token's logit lies below the plain
    model's best at its position; with ``control``, also the widest gap of
    the tokens the float8 control puts first at the same positions."""
    worst = 0.0 if served else float("inf")
    ctl = 0.0
    with mamba2.exact_matmuls():
        params = weights.make(run.sizes, run.seed, run.device)
        for (seq, first), toks in zip(seqs, served):
            lg = ref_logits(run, params, seq, first, len(toks))
            want = lg.max(dim=-1).values
            got = lg.gather(1, torch.as_tensor(toks, device=run.device)[:, None])[:, 0]
            worst = max(worst, float((want - got).max()))
            if control:
                top = ref_logits(run, params, seq, first, len(toks), "fp8").argmax(dim=-1)
                ctl = max(ctl, float((want - lg.gather(1, top[:, None])[:, 0]).max()))
    return worst, ctl


def check(run, job: Job, out) -> Dict[str, float]:
    """The served tokens' widest logit gap over the sample, and the requests
    finished in the window that were not delivered whole (exact: limit 0)."""
    seqs, served, undelivered = collect(run, job)
    job.decoder.params = None
    job.decoder = job.engine = None
    harness.free_device()
    run.stats["checked_tokens"] = sum(len(t) for t in served)
    return {"logit_gap": gaps(run, seqs, served)[0], "undelivered": float(undelivered)}
