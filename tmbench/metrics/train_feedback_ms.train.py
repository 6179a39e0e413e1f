"""train_feedback_ms.train: host time a step in the clamp, the feedback
scalars and the padding mask, the program's span ``train_step.feedback``,
in ms."""

from tmbench import program_spans


def read(run):
    return program_spans.mean_ms(run, "train", "train_step.feedback")
