"""runner_rebuilds.infer: cache misses on run_compiled's factorized path in
the traced window (device tables, schedules, chain lengths), the calls of
the program's span ``run_compiled.build``; a sound run reads 0."""

from tmbench import program_spans


def read(run):
    got = program_spans.calls_match(run, "infer", "run_compiled")
    if got is None:
        return None
    return got.get("run_compiled.build", (0, 0))[0]
