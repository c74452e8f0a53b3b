"""fl_forward_ms: the stream time of a round's forward passes (every
satellite's loss at every local step), the program's ``fl.local.forward``
device spans summed inside each ``fl.local_steps``, mean over the traced
window's rounds. Host-bound, it is mostly the stream waiting for the host."""

from portbench import spans


def read(run):
    return spans.phase_ms(run, "fl.local_steps", ("fl.local.forward",))
