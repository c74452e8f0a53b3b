"""fl_exchange_ms: mean wall time of a round's TDM exchange, the program's
``fl.exchange`` span (flatten, quantize, gathers, dequant-accumulate, the
copy back; it ends in a synchronise while tracing is on)."""

import statistics


def read(run):
    spans = run.span_ms("fl.exchange")
    return statistics.fmean(spans) if spans else None
