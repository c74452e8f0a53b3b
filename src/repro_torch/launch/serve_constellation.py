"""Constellation serving on the PyTorch port: TDM-slotted inference end to
end. Counterpart of ``examples/serve_constellation.py``.

Requests arrive at two ground stations, climb earliest-delivery contact-
graph routes to satellite model replicas, decode under the TDM slot
structure (wave discipline per replica, continuous batching across the
fleet), and return on downlink slots. Mid-run one replica satellite dies;
its batch drains, in-flight requests re-route to the surviving replica, and
the route-provenance auditor checks every hop (slot-legal links, no lost
requests). The run exits non-zero on a lost request or an audit violation.

The default decoder is the deterministic ``NullDecoder``. ``--model``
decodes with the real ``ModelDecoder`` on ``--arch`` (default gemma2-9b, the
reference example's model; mamba2-780m, the other dense configs and the MoE
configs qwen3-moe-30b-a3b and kimi-k2-1t-a32b work as well) at its published config, or its smoke config with ``--smoke`` (the
reference example's choice), with random weights from seed 0. Prompts are
drawn over the model's vocabulary. ``run`` takes the batch, the prompt
lengths and the number of new tokens for callers that serve other workloads.

    PYTHONPATH=src python -m repro_torch.launch.serve_constellation \\
        [--model [--arch gemma2-9b] [--smoke] [--device cuda|cpu]] [--requests 10]
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Callable, Optional, Sequence, Tuple

from repro_torch import telemetry
from repro_torch.constellation.scenario import smoke_scenario
from repro_torch.serving import (
    NullDecoder,
    ReplicaFleet,
    ServingEngine,
    audit_serving_run,
    synthesize_workload,
)

N_REQUESTS = 10
BATCH = 2
MAX_NEW = 6
PROMPT_LEN = (4, 12)
REPLICAS = (0, 3)            # one replica per orbital plane
NULL_VOCAB = 128             # synthesize_workload's default vocabulary


@dataclasses.dataclass
class ServeRun:
    report: object           # serving.ServeReport
    verdict: object          # telemetry.AuditReport
    engine: ServingEngine
    decoder: object


def model_decoder(arch: str, smoke: bool, n_replicas: int, batch: int,
                  prompt_len: Tuple[int, int], max_new: int, seed: int, device):
    """The torch ``ModelDecoder`` of ``arch`` (published or smoke config),
    its cache sized for the largest prompt bucket plus ``max_new``."""
    from repro_torch.configs import archs
    from repro_torch.serving import ModelDecoder

    cfg = archs.get(arch)
    if smoke:
        cfg = archs.smoke_cfg(cfg)
    max_len = ModelDecoder._bucket(prompt_len[1]) + max_new + 1
    return cfg, ModelDecoder(cfg, n_replicas, batch, max_len, seed=seed, device=device)


def run(*, decoder=None, vocab: int = NULL_VOCAB, requests: int = N_REQUESTS,
        batch: int = BATCH, max_new: int = MAX_NEW,
        prompt_len: Tuple[int, int] = PROMPT_LEN,
        log: Callable[[str], None] = print) -> ServeRun:
    """One serving run of the example's scenario: ``requests`` requests at
    one per slot, the first replica lost mid-epoch and restored, then the
    route-provenance audit. ``decoder`` defaults to the ``NullDecoder``."""
    scn = smoke_scenario()
    replicas = list(REPLICAS)
    log(f"{scn.n_sats} satellites + {len(scn.ground_stations)} ground "
        f"stations, {len(scn.slots())} TDM slots/epoch; replicas at "
        f"{replicas}, gateways at {sorted(scn.ground_ids)}")
    if decoder is None:
        decoder = NullDecoder(len(replicas), batch)
    fleet = ReplicaFleet(replicas, batch, decoder)
    eng = ServingEngine.from_scenario(scn, fleet)
    workload = synthesize_workload(
        requests, scn.ground_ids, rate_per_slot=1.0, max_new=max_new,
        prompt_len=prompt_len, vocab=vocab,
    )
    epoch = eng.epoch
    fail_at, restore_at = epoch // 2, epoch // 2 + max(2, epoch // 4)

    def on_slot(engine, slot):
        if slot == fail_at:
            log(f"  !! slot {slot}: replica satellite {replicas[0]} lost "
                "— draining its batch, re-routing")
            engine.fail(replicas[0])
        elif slot == restore_at:
            log(f"  slot {slot}: satellite {replicas[0]} restored")
            engine.restore(replicas[0])

    report = eng.run(workload, on_slot=on_slot)
    verdict = audit_serving_run(
        report.records, report.requests, eng.base_rels,
        gateways=eng.gateways, replicas=replicas,
    )
    return ServeRun(report, verdict, eng, decoder)


def summarize(res: ServeRun, log: Callable[[str], None] = print) -> None:
    summ = res.report.summary()
    log(
        f"\ndelivered {summ['delivered']}/{summ['n_requests']} requests in "
        f"{summ['n_slots']} slots ({summ['epochs']:.1f} epochs, "
        f"{summ.get('wall_s', 0):.1f} simulated s): "
        f"p50 latency {summ.get('latency_p50_slots', -1):.1f} slots, "
        f"p99 {summ.get('latency_p99_slots', -1):.1f}, "
        f"TTFT p50 {summ.get('ttft_p50_slots', -1):.1f}, "
        f"{summ['retries']} retries"
    )
    for r in res.report.delivered[:3]:
        log(f"  request {r.rid}: gateway {r.gateway} -> replica "
            f"{r.replica}, {len(r.out)} tokens {r.out[:4]}..., "
            f"{r.hops_up}+{r.hops_down} hops")
    v = res.verdict
    log(
        f"route-provenance audit: {v.n_hops} hops over "
        f"{v.n_windows} slots — "
        f"{'OK' if v.ok else f'{len(v.violations)} VIOLATIONS'}"
    )
    counters = telemetry.counters_snapshot()
    for name in sorted(n for n in counters if n.startswith("serve.")):
        log(f"  {name} = {counters[name]:g}")


def main(argv: Optional[Sequence[str]] = None) -> ServeRun:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", action="store_true",
                   help="decode with the real ModelDecoder (default: NullDecoder)")
    p.add_argument("--arch", default="gemma2-9b")
    p.add_argument("--smoke", action="store_true",
                   help="the arch's smoke config (default: its published config)")
    p.add_argument("--device", default=None,
                   help="torch device for --model (default: the CUDA card; "
                        "'cpu' runs the plain PyTorch versions of the kernels)")
    p.add_argument("--requests", type=int, default=N_REQUESTS)
    args = p.parse_args(argv)

    decoder, vocab = None, NULL_VOCAB
    if args.model:
        cfg, decoder = model_decoder(args.arch, args.smoke, len(REPLICAS), BATCH,
                                     PROMPT_LEN, MAX_NEW, 0, args.device)
        vocab = cfg.vocab_size
        print(f"decoder: {cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}"
              f"{', smoke config' if args.smoke else ''}) on {decoder.device}, "
              "every replica's lanes folded into one batch")
    else:
        print("decoder: deterministic NullDecoder (pass --model for the real thing)")
    res = run(decoder=decoder, vocab=vocab, requests=args.requests)
    summarize(res)
    if not res.verdict.ok or res.report.summary()["undelivered"]:
        raise SystemExit("serving run lost requests or failed its audit")
    return res


if __name__ == "__main__":
    main()
