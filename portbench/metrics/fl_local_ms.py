"""fl_local_ms: mean wall time of a round's local training, the program's
``fl.local_steps`` span (it ends in a synchronise while tracing is on), over
the traced window's rounds."""

import statistics


def read(run):
    spans = run.span_ms("fl.local_steps")
    return statistics.fmean(spans) if spans else None
