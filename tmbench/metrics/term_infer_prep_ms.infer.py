"""term_infer_prep_ms.infer: host time a batch in term_infer's set-up of a
launch (tables, checks, scratch, ctypes arguments), the program's span
``term_infer.prep``, in ms."""

from tmbench import program_spans


def read(run):
    return program_spans.mean_ms(run, "infer", "term_infer.prep")
