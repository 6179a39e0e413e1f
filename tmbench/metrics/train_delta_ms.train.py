"""train_delta_ms.train: host time a step issuing the fused training delta,
the program's span ``train_step.delta``, in ms."""

from tmbench import program_spans


def read(run):
    return program_spans.mean_ms(run, "train", "train_step.delta")
