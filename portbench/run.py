"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with an NVIDIA card. Set-up builds
the system under test from the seed and warms every shape the cell uses; the
window then drives the timed path for ``--seconds``; the plain reference
then checks what the window produced. The last line of standard output is
the result (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` the per-layer metrics and ``breakdown``, and last
``checks``: each compared number beside its limit, which also close standard
error). Exits non-zero without a result when there is no card, when the
cell needs more cards than there are, or when JAX or the JAX package was
loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
# caches of the toolchain inside the checkout, at fixed paths (the port's
# own kernels build into build/repro_torch/ of the checkout)
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / "portbench" / sub)
os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness

    cell = harness.cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("portbench: no CUDA device; the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t0=T0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}; the port and the harness must not",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
