"""train_step_ms.train: host time a step inside ops.tm_train_step_kernel, the
program's span ``train_step``, in ms."""

from tmbench import program_spans


def read(run):
    return program_spans.mean_ms(run, "train", "train_step")
