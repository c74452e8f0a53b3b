"""dequant_accumulate_roofline: the ``dequant_accumulate`` kernel's least
time (codes, scales, weights and accumulator read once, the accumulator
written once, at 3.35 TB/s) over its mean device time per launch in the
profiled stretch."""

from portbench import counts

PATTERN = r"dequant_acc_kernel"


def read(run):
    hit = run.devtrace.kernel(PATTERN) if run.devtrace is not None else None
    if hit is None or "padded" not in run.stats:
        return None
    seconds, launches = hit
    s = run.stats
    least = counts.seconds_at_hbm(
        counts.dequant_accumulate_bytes(s["rows"], s["padded"], s["block"]))
    return 100.0 * least / (seconds / launches)
