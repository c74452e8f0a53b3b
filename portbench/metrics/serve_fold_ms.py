"""serve_fold_ms: the stream time of a decode tick's cache traffic, the
replicas' caches folded into one batch (``serve.fold``) and written back
(``serve.write``), device spans summed inside each ``serve.decode``, mean
over the traced window's ticks."""

from portbench import spans


def read(run):
    return spans.phase_ms(run, "serve.decode", ("serve.fold", "serve.write"))
