"""train_rate: samples trained in the window, over the window."""


def read(run):
    if run["kind"] != "train":
        return None
    return run["items"] / run["window_s"]
