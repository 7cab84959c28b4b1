"""neutex.device_ops_per_step: the device operations (kernels, copies,
sets) of the traced window per train step: what the host issues one by one
in an eager step, and what a graph of the step would launch at once."""


def read(run):
    if run["kind"] != "train" or "dev" not in run or not run["steps"]:
        return None
    t0, t1 = run["t0"], run["t1"]
    return sum(1 for _, s, e in run["dev"] if e > t0 and s < t1) / run["steps"]
