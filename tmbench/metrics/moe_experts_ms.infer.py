"""moe_experts_ms.infer: host time a batch in the held experts' dispatch,
products and sum, the program's span ``moe_experts`` summed over the window
(one call an expert layer a batch) and divided by the window's batches, in
ms.  Nothing when
the span's calls are not a whole number a batch (not the window's), or
the program has no such span."""

from tmbench import program_spans

SPAN = "moe_experts"


def read(run):
    n = run.get("batches")
    if run.get("kind") != "infer" or not n:
        return None
    calls, ns = (program_spans.totals() or {}).get(SPAN, (0, 0))
    if not calls or calls % n:
        return None
    return ns / n / 1e6
