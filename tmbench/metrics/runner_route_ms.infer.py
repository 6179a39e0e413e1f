"""runner_route_ms.infer: host time a batch in run_compiled's checks, engine
choice, device tables and schedule lookup, the program's span
``run_compiled.route``, in ms."""

from tmbench import program_spans


def read(run):
    return program_spans.mean_ms(run, "infer", "run_compiled.route")
