"""prefill_step_ms.infer: host time a batch inside the prefill step (the
forward with the caches written and the last logits), the program's span
``prefill_step``, in ms."""

from tmbench import program_spans


def read(run):
    return program_spans.mean_ms(run, "infer", "prefill_step")
