"""infer_mfu: the bound of all the window's work (tmbench/work.py), summed
over its batches, over the traced window, in percent of the card's
peak."""


def read(run):
    tr, bounds = run.get("trace"), run.get("bounds") or {}
    if run["kind"] != "infer" or not tr or "step" not in bounds:
        return None
    return 100.0 * bounds["step"] / tr["window_s"]
