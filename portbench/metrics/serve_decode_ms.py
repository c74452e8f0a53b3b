"""serve_decode_ms: mean wall time of a fleet tick's model call, the
program's ``serve.decode`` span (it ends in the copy of the tick's tokens to
the host), over the traced window."""

import statistics


def read(run):
    spans = run.span_ms("serve.decode")
    return statistics.fmean(spans) if spans else None
