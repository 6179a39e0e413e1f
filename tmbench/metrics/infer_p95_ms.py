"""infer_p95_ms: the 95th percentile of every batch's latency in the
window, from the copy's issue to the class sums on the host."""

import statistics


def read(run):
    if run["kind"] != "infer" or len(run["latencies_s"]) < 20:
        return None
    return statistics.quantiles(run["latencies_s"], n=20)[18] * 1e3
