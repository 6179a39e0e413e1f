"""train_apply_ms.train: host time a step in the clamp that applies the delta,
the program's span ``train_step.apply``, in ms."""

from tmbench import program_spans


def read(run):
    return program_spans.mean_ms(run, "train", "train_step.apply")
