"""train.idle_share: the share of the traced train window in which no
device operation runs (benchmark/metrics/_trace.py)."""


def read(run):
    if run["kind"] != "train" or "dev" not in run or run["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - run["busy_s"] / run["traced_s"])
