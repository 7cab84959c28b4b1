"""train.launches_per_step: the port's kernel launches in the traced window
(ops/launches.py's counters, graph replays included) per train step."""


def read(run):
    if run["kind"] != "train" or not run["steps"] or not run["launches"]:
        return None
    return sum(run["launches"].values()) / run["steps"]
