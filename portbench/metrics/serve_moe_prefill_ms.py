"""serve_moe_prefill_ms: the stream time of a prefill call's MoE layers, the
program's ``model.moe`` device spans summed inside each ``serve.prefill``,
mean over the traced window's prefill calls."""

from portbench import spans


def read(run):
    return spans.phase_ms(run, "serve.prefill", ("model.moe",))
