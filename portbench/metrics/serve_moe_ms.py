"""serve_moe_ms: the stream time of a decode tick's MoE layers (routing,
experts, shared expert and combine), the program's ``model.moe`` device
spans summed inside each ``serve.decode``, mean over the traced window's
ticks."""

from portbench import spans


def read(run):
    return spans.phase_ms(run, "serve.decode", ("model.moe",))
