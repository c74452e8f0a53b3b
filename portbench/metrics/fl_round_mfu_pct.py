"""fl_round_mfu_pct: the model FLOPs of a round's local training (forward and
backward of every satellite's tokens, recomputation not counted; the
configuration's counts) over the mean ``fl.round`` span, against the H100's
989 TFLOP/s in bf16."""

import statistics

from portbench.counts import PEAK_BF16_FLOPS


def read(run):
    spans = run.span_ms("fl.round")
    if not spans or "round_flops" not in run.stats:
        return None
    return 100.0 * run.stats["round_flops"] / (statistics.fmean(spans) / 1e3 * PEAK_BF16_FLOPS)
