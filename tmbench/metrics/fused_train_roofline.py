"""fused_train_roofline: the bound of the window's fused training kernel
work (tmbench/work.py) over the device time of its launches, in percent.
Nothing when the steps launched none, or not one a step."""


def read(run):
    tr, bounds = run.get("trace"), run.get("bounds") or {}
    if run["kind"] != "train" or not tr or "fused_train" not in bounds:
        return None
    ops = [o for o in tr["ops"] if "fused_train_kernel" in o[2]]
    if len(ops) != run["steps"]:
        return None
    return 100.0 * bounds["fused_train"] / sum(t1 - t0 for t0, t1, _ in ops)
