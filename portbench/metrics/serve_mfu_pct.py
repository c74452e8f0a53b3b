"""serve_mfu_pct: the model FLOPs of every real token the window processed
(prompt tokens without their padding, through every layer; each generated
token's head, and its decode step after a request's first) over the traced
window's length, against the H100's 989 TFLOP/s in bf16."""

from portbench.counts import PEAK_BF16_FLOPS


def read(run):
    s = run.stats
    if not s.get("window_s") or not s.get("serve_flops"):
        return None
    return 100.0 * s["serve_flops"] / (s["window_s"] * PEAK_BF16_FLOPS)
