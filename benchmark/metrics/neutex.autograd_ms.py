"""neutex.autograd_ms: the median over the traced window's steps of the
host's time in the eager step's forward and backward (train/steps.py
eager_step, span train.autograd)."""
from benchmark.metrics import _spans


def read(run):
    if run["kind"] != "train":
        return None
    records = _spans.window(run)
    if records is None:
        return None
    return _spans.median_ms([r["end_ns"] - r["start_ns"]
                             for r in _spans.named(records, "train.autograd")])
