"""run_compiled_ms.infer: host time a batch inside run_compiled, from entry to
return, the program's span ``run_compiled``, in ms."""

from tmbench import program_spans


def read(run):
    return program_spans.mean_ms(run, "infer", "run_compiled")
