"""The device's idle share of the profiled stretch: 1 - (the union of the
device's activities) / (the stretch's length), from ``torch.profiler``."""


def read(run):
    tr = run.devtrace
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * tr.idle_share
