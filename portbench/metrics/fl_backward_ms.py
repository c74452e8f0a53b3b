"""fl_backward_ms: the stream time of a round's backward passes
(``autograd.grad`` of every satellite's loss at every local step), the
program's ``fl.local.backward`` device spans summed inside each
``fl.local_steps``, mean over the traced window's rounds."""

from portbench import spans


def read(run):
    return spans.phase_ms(run, "fl.local_steps", ("fl.local.backward",))
