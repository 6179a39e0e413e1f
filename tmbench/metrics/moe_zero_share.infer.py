"""moe_zero_share.infer: the routed (token, expert) pairs that went to a
zero-compute (identity) expert, over all the routed pairs of the window, in
%: the program's counters ``moe.zero_pairs`` and ``moe.pairs``.  It moves
only with the routing, and is there to read ``moe_experts_ms.infer`` by.
Nothing when the program has no such counters or routed no pair."""

PAIRS, ZERO = "moe.pairs", "moe.zero_pairs"


def read(run):
    if run.get("kind") != "infer":
        return None
    try:
        from repro_torch import spans
    except ImportError:
        return None
    counts = getattr(spans, "counts", None)
    got = counts() if counts else {}
    if not got.get(PAIRS):
        return None
    return 100.0 * got.get(ZERO, 0) / got[PAIRS]
