"""serve_itl_p95_ms: the 95th percentile of every gap between successive
tokens of one request, both inside the traced window, each token timed by
the host clock when the step that made it returns. A request's first token
is not timed against its arrival, so queueing does not enter; a prefill of
the other replica does. The cell is above capacity, so this tail stands
among the per-layer metrics; it moves with the tick, as the tokens per
second do."""


def read(run):
    return run.stats.get("itl_p95_ms")
