"""tdm_self_ms: the stream time of a slot's self term (each node's own
weight times its params, added to what arrived, cast back), the program's
``tdm.self`` device span inside each ``tdm.round``, mean over the traced
window's slots."""

from portbench import spans


def read(run):
    return spans.phase_ms(run, "tdm.round", ("tdm.self",))
