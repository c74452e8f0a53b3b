"""serve_engine_ms: the engine's own host time in a slot (membership,
routing, admission and the per-slot counts, the model calls left out): a
``serve.slot`` span's wall time less the ``serve.prefill`` and
``serve.decode`` spans inside it, mean over the traced window's slots."""

import statistics

from portbench import spans


def read(run):
    per = [spans.host_ms(u) - sum(spans.host_ms(s) for s in inner
                                  if s.name in ("serve.prefill", "serve.decode"))
           for u, inner in spans.units(run, "serve.slot")]
    return statistics.fmean(per) if per else None
