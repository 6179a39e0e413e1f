"""train_prepare_ms.train: host time a step moving the batch and building the
step's packed masks and clause tables, the program's span
``train_step.prepare``, in ms."""

from tmbench import program_spans


def read(run):
    return program_spans.mean_ms(run, "train", "train_step.prepare")
