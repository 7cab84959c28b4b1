"""neutex.idle_in_autograd_share: the share of the traced train window in
which no device operation runs while the host is inside the eager step's
forward and backward (train/steps.py eager_step, span train.autograd,
which has no child span)."""
from benchmark.metrics import _spans


def read(run):
    if run["kind"] != "train":
        return None
    records = _spans.window(run)
    if records is None or not _spans.named(records, "train.autograd"):
        return None
    return _spans.idle_inside_share(run, records, "train.autograd")
