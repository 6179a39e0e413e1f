"""infer_rate: datapoints whose class sums reached the host in the window,
over the window."""


def read(run):
    if run["kind"] != "infer":
        return None
    return run["items"] / run["window_s"]
