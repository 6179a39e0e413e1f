"""moe_pad_share.infer: the rows of the held experts' products that no
routed (token, expert) pair filled, over the rows they computed in the
window, in %: the program's counters ``moe_experts.pad_rows`` and
``moe_experts.rows``.  An exact dispatch reads 0.  Nothing when the
program has no such counters or the window computed no row."""

ROWS, PAD = "moe_experts.rows", "moe_experts.pad_rows"


def read(run):
    if run.get("kind") != "infer":
        return None
    try:
        from repro_torch import spans
    except ImportError:
        return None
    counts = getattr(spans, "counts", None)
    got = counts() if counts else {}
    if not got.get(ROWS):
        return None
    return 100.0 * got.get(PAD, 0) / got[ROWS]
