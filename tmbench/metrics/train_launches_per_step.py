"""train_launches_per_step: device kernels (copies and sets left out) in
the traced window, a step."""

from tmbench.trace import is_copy


def read(run):
    tr = run.get("trace")
    if run["kind"] != "train" or not tr or not run["steps"]:
        return None
    return sum(not is_copy(n) for _, _, n in tr["ops"]) / run["steps"]
