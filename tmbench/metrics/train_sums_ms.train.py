"""train_sums_ms.train: host time a step packing literals and issuing the
class sums, the program's span ``train_step.sums``, in ms."""

from tmbench import program_spans


def read(run):
    return program_spans.mean_ms(run, "train", "train_step.sums")
