"""The readings a cell's limits are set from: the program's compared numbers
over many seeds, and those of the control and of the planted faults.

    python3 portbench/readings.py --workload <cell> --seeds 1,2,3 --control 3 \
        [--seconds 15] [--device cuda]

One process; each seed builds the cell anew (set-up, a short window at the
cell's own load, the check). The first ``--control`` seeds also read the
control: the plain reference in the nearest precision below the
configuration's, put in the program's place (float8 products for the
model's bfloat16 compute; int4 payloads for the exchange's int8), and, for a
training cell, the planted faults (half of each batch left out, the exchange
left out, a gradient altered where it is produced). One JSON line a seed.
This is not part of a benchmark run.
"""

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def read_seed(cell, seed: int, seconds: float, device, control: bool) -> dict:
    from portbench import harness
    from portbench.drivers import fl_rounds, serve, tdm_slots
    from portbench.refs import fltrain

    run = harness.Run(cell, seed, seconds, False, device)
    line = {"seed": seed}
    if cell.kind == "fl_rounds":
        job = fl_rounds.setup(run)
        program = job.program
        job.state = job.cache = None
        harness.free_device()
        ref = fltrain.follow(run, fl_rounds.batch)
        line["program"] = fltrain.gaps(program, ref)
        norms = {"program": program, "reference": ref}
        if control:
            ctl = fltrain.follow(run, fl_rounds.batch, prec="fp8")
            line["control"] = fltrain.gaps(ctl, ref)
            norms["control"] = ctl
            line["faults"] = {}
            for f in ("half_batch", "no_exchange", "grad"):
                norms[f] = fltrain.follow(run, fl_rounds.batch, fault=f)
                line["faults"][f] = fltrain.gaps(norms[f], ref)
        line["losses"] = {"program": program.losses, "reference": ref.losses}
        # every (leaf, node) norm read, for other statistics of the same runs
        line["norms"] = {k: {"losses": r.losses,
                             **{part: {leaf: v.tolist() for leaf, v in getattr(r, part).items()}
                                for part in ("mu", "change", "grad") if getattr(r, part)}}
                         for k, r in norms.items()}
    elif cell.kind == "tdm_slots":
        job = tdm_slots.setup(run)
        out = tdm_slots.window(run, job)
        worst, ctl = tdm_slots.gaps(run, job, control=control)
        line["program"] = {"mix_gap": worst}
        if control:
            line["control"] = {"mix_gap": ctl}
        line["stats"] = {"slots": out["attempted"], "sample": job.sample}
    elif cell.kind == "serve":
        job = serve.setup(run)
        out = serve.window(run, job)
        seqs, served, undelivered = serve.collect(run, job)
        job.decoder.params = None
        job.decoder = job.engine = None
        harness.free_device()
        worst, ctl = serve.gaps(run, seqs, served, control=control)
        line["program"] = {"logit_gap": worst, "undelivered": undelivered}
        if control:
            line["control"] = {"logit_gap": ctl}
        line["stats"] = {k: run.stats[k] for k in ("finished", "queued_at_close", "tokens")}
        line["stats"]["checked_tokens"] = sum(len(t) for t in served)
        line["metrics"] = out["metrics"]
    harness.free_device()
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control", type=int, default=3, help="seeds that also read the control")
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from portbench import harness

    cell = harness.cell(args.workload)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        line = read_seed(cell, seed, args.seconds, args.device, i < args.control)
        line["s"] = round(time.perf_counter() - t, 1)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
