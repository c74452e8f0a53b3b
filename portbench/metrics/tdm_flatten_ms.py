"""tdm_flatten_ms: the stream time of a slot's flatten and unflatten, the
program's ``tdm.flatten`` and ``tdm.unflatten`` device spans summed inside
each ``tdm.round``, mean over the traced window's slots."""

from portbench import spans


def read(run):
    return spans.phase_ms(run, "tdm.round", ("tdm.flatten", "tdm.unflatten"))
