"""fl_optimizer_ms: the stream time of a round's optimizer steps (AdamW on
every satellite's params at every local step, and the step count), the
program's ``fl.local.optimizer`` device spans summed inside each
``fl.local_steps``, mean over the traced window's rounds."""

from portbench import spans


def read(run):
    return spans.phase_ms(run, "fl.local_steps", ("fl.local.optimizer",))
