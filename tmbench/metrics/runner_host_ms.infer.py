"""runner_host_ms.infer: the host's mean time in run_compiled a batch, from
entry to return (before the read-back), on the host clock."""

import statistics


def read(run):
    spans = (run.get("spans") or {}).get("runner")
    if run["kind"] != "infer" or not spans:
        return None
    return statistics.fmean(spans) * 1e3
