"""tdm_codec_ms: the stream time of a slot's int8 codec, the quantize
(``tdm.quantize``) and each matching's dequant-accumulate with the
accumulator's zero fill (``tdm.fold``), device spans summed inside each
``tdm.round``, mean over the traced window's slots."""

from portbench import spans


def read(run):
    return spans.phase_ms(run, "tdm.round", ("tdm.quantize", "tdm.fold"))
