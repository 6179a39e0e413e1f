"""term_infer_launch_ms.infer: host time a batch in the term_infer launch
call, the program's span ``term_infer.launch``, in ms."""

from tmbench import program_spans


def read(run):
    return program_spans.mean_ms(run, "infer", "term_infer.launch")
