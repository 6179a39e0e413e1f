"""The program's host spans over a traced window (``repro_torch.spans``).

The program sums each span's calls and host nanoseconds while a torch
profiler records, and a ``--trace 1`` run profiles exactly the window, so
its totals are the window's.  A span is read only when it ran once a batch
(infer) or once a step (train) of the window: any other count means the
spans are not the window's, and the metric is left out.  A program without
spans gives nothing, and raises nothing.
"""

# what a span's calls are held to, by traffic kind
PER = {"infer": "batches", "train": "steps"}


def totals():
    """``{span: (calls, ns)}`` of the program, or None when it has no spans."""
    try:
        from repro_torch import spans
    except ImportError:
        return None
    return spans.totals()


def calls_match(run, kind: str, span: str):
    """The totals when ``run`` is of ``kind`` and ``span`` ran once a batch
    or step of its window, else None."""
    if run.get("kind") != kind:
        return None
    n, got = run[PER[kind]], totals()
    if not n or not got or got.get(span, (0, 0))[0] != n:
        return None
    return got


def mean_ms(run, kind: str, span: str):
    """``span``'s mean host ms a call in ``run``'s window, or None."""
    got = calls_match(run, kind, span)
    if got is None:
        return None
    calls, ns = got[span]
    return ns / calls / 1e6
