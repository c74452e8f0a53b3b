"""tdm_gather_ms: the stream time of a slot's row gathers (codes and scales,
each matching's ``index_select`` and the zeroed rows of the nodes outside
it), the program's ``tdm.gather`` device spans summed inside each
``tdm.round``, mean over the traced window's slots."""

from portbench import spans


def read(run):
    return spans.phase_ms(run, "tdm.round", ("tdm.gather",))
