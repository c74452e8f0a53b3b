"""The readings ``serve_nemotron_chat``'s limits are set from, as
``readings.py`` gives them for the other cells: the program's compared
numbers over many seeds, and the control's (the plain reference with float8
products) over the first ``--control`` seeds.

    python3 portbench/readings_nemotron_h.py --seeds 1,2,3 --control 3 [--seconds 15]

One process; each seed builds the cell anew (set-up, a short window at the
cell's own load, the check). One JSON line a seed. This is not part of a
benchmark run.
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


def _gap_readings(per_request) -> dict:
    """The check's gap readings, and beside them the first served tokens'
    median gap, the widest gap, the overall median and each request's
    median, first gap and length."""
    import torch

    from portbench.drivers import serve_nemotron_h as drv

    reqs = [g for g in per_request if g.numel()]
    cat = torch.cat(reqs)
    return {**drv.gap_checks(per_request), "logit_gap_first": drv.first_gap(per_request),
            "logit_gap_max": float(cat.max()),
            "logit_gap_median": float(cat.median()),
            "requests": [[float(g.median()), float(g[0]), g.numel()] for g in reqs]}


def read_seed(cell, seed: int, seconds: float, device, control: bool) -> dict:
    from portbench import harness
    from portbench.drivers import serve_nemotron_h as drv

    run = harness.Run(cell, seed, seconds, False, device)
    job = drv.setup(run)
    out = drv.window(run, job)
    seqs, served, undelivered = drv.collect(run, job)
    drops = drv.dropped(job)
    drv.release(job)
    got, ctl = drv.gaps(run, seqs, served, control=control)
    line = {"seed": seed, "program": {**_gap_readings(got), "undelivered": undelivered,
                                      "dropped": drops}}
    if control:
        line["control"] = _gap_readings(ctl)
    line["stats"] = {k: run.stats[k] for k in ("finished", "queued_at_close", "tokens")}
    line["stats"]["checked_tokens"] = sum(len(t) for t in served)
    line["metrics"] = out["metrics"]
    harness.free_device()
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="serve_nemotron_chat")
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
