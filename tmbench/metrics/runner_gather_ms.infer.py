"""runner_gather_ms.infer: host time a batch in run_compiled's dead-word
gather, the program's span ``run_compiled.gather``, in ms."""

from tmbench import program_spans


def read(run):
    return program_spans.mean_ms(run, "infer", "run_compiled.gather")
