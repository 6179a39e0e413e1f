"""idle_share.infer: the share of the traced window in which nothing ran on
the device, in percent."""


def read(run):
    tr = run.get("trace")
    if run["kind"] != "infer" or not tr:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
