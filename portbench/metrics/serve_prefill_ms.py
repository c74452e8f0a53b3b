"""serve_prefill_ms: mean wall time of a prefill call, the program's
``serve.prefill`` span (it ends in the copy of the first tokens to the
host), over the traced window."""

import statistics


def read(run):
    spans = run.span_ms("serve.prefill")
    return statistics.fmean(spans) if spans else None
