"""tdm_slot_roofline: the least time of one mix (the stacked float32 params
read once and the mixed result written once, at 3.35 TB/s) over the slot's
time, the traced window's length over its slots. The same work, whatever
implements the mix."""

from portbench import counts


def read(run):
    s = run.stats
    if not s.get("slots") or not s.get("window_s"):
        return None
    least = counts.seconds_at_hbm(counts.mix_least_bytes(s["rows"], s["padded"]))
    return 100.0 * least / (s["window_s"] / s["slots"])
