"""quantize_roofline: the ``quantize`` kernel's least time (x read once;
codes and scales written once, at 3.35 TB/s) over its mean device time per
launch in the profiled stretch."""

from portbench import counts

PATTERN = r"(^|[\s:])quantize_kernel\("


def read(run):
    hit = run.devtrace.kernel(PATTERN) if run.devtrace is not None else None
    if hit is None or "padded" not in run.stats:
        return None
    seconds, launches = hit
    s = run.stats
    least = counts.seconds_at_hbm(counts.quantize_bytes(s["rows"], s["padded"], s["block"]))
    return 100.0 * least / (seconds / launches)
